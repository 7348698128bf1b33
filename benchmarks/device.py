"""The card a measurement runs on: presence check and nvidia-smi report.

A measurement that finds no GPU fails; it never falls back to the CPU.
nvidia-smi runs in a child process that does not touch JAX, so the one
JAX process keeps the card to itself.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """The JAX devices, if they are GPUs; raises SystemExit otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default devices are {devs[0].platform!r} "
            f"({devs}); this measurement runs only on the card")
    return devs


def nvidia_smi(query: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` output."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def describe(devs) -> dict:
    """The device keys every result line carries."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
