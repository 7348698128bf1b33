"""Roofline accounting for bench.py.

XLA's cost analysis reports (flops, bytes accessed) for a compiled
program.  The "light" time ``max(bytes / HBM peak, flops / tensor peak)``
is the floor the card's published peaks allow; utilization = light /
measured.  The peaks live in one table keyed by ``device_kind``; a device
that is not in it is an error, never a default.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense rates (no sparsity), at the full 700 W
# power limit.  A card set below it cannot hold these under load, so every
# share is reported beside the card's power limit.
_H100_SXM = {
    "hbm_gbs": 3350.0,
    "bf16_tflops": 989.0,
    "tf32_tflops": 495.0,
    "fp32_tflops": 67.0,
    "int8_tops": 1979.0,
    "source": "NVIDIA H100 SXM data sheet (dense, 700 W)",
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks_for(device_kind: str) -> dict:
    """Published peaks of ``device_kind`` (jax.devices()[0].device_kind)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


def xla_cost(jitfn, args):
    """(flops, bytes accessed) of the compiled program, from XLA."""
    c = jitfn.lower(*args).compile().cost_analysis()
    if isinstance(c, (list, tuple)):
        c = c[0]
    return float(c.get("flops", 0.0)), float(c.get("bytes accessed", 0.0))


def roofline_row(measured_ms, flops, bts, device_kind: str):
    """Light time and utilization at the measured time.  Flops are held to
    the bf16 tensor-core peak: the step's matmuls (raycast incidence) are
    bf16, everything else is elementwise and bandwidth-bound."""
    pk = peaks_for(device_kind)
    light_bw_ms = bts / pk["hbm_gbs"] / 1e6
    light_fl_ms = flops / pk["bf16_tflops"] / 1e9
    light_ms = max(light_bw_ms, light_fl_ms)
    return {
        "light_ms": light_ms,
        "bound": "HBM" if light_bw_ms >= light_fl_ms else "bf16",
        "util_pct": 100.0 * light_ms / measured_ms if measured_ms else 0.0,
        "achieved_gbs": bts / measured_ms / 1e6 if measured_ms else 0.0,
        "achieved_tfs": flops / measured_ms / 1e9 if measured_ms else 0.0,
    }
