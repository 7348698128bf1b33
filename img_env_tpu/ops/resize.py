"""Bicubic resize as two small matmuls.

The reference downsamples each 400x400 view map to 48x48 with cv2
INTER_CUBIC (yaml_env.py:431-438).  cv2's cubic kernel (a = -0.75, 4 taps,
replicate border, no antialias on downscale) is separable, so the resize is
``A @ img @ B.T`` with precomputed sparse weight matrices, trivially batched
over robots.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_A = -0.75  # cv2's Catmull-Rom-like coefficient


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    w = np.where(
        ax <= 1,
        ((_A + 2) * ax - (_A + 3)) * ax * ax + 1,
        np.where(ax < 2, ((_A * ax - 5 * _A) * ax + 8 * _A) * ax - 4 * _A, 0.0),
    )
    return w


@functools.lru_cache(maxsize=16)
def resize_matrix(dst: int, src: int) -> np.ndarray:
    """[dst, src] row-stochastic cubic interpolation weights."""
    scale = src / dst
    m = np.zeros((dst, src), np.float64)
    for i in range(dst):
        f = (i + 0.5) * scale - 0.5
        base = int(np.floor(f))
        dx = f - base
        taps = np.array([base - 1, base, base + 1, base + 2])
        wts = _cubic_kernel(np.array([1 + dx, dx, 1 - dx, 2 - dx]))
        for t, wt in zip(taps, wts):
            m[i, min(max(t, 0), src - 1)] += wt
    return m


def resize_cubic(img: jnp.ndarray, out_hw, dtype=jnp.float32) -> jnp.ndarray:
    """Bicubic resize of [..., H, W] to [..., out_h, out_w]."""
    out_h, out_w = out_hw
    src_h, src_w = img.shape[-2], img.shape[-1]
    a = jnp.asarray(resize_matrix(out_h, src_h), dtype)
    b = jnp.asarray(resize_matrix(out_w, src_w), dtype)
    x = img.astype(dtype)
    # full f32: the result is rounded to uint8 levels, and a reduced-
    # precision pass (TF32) would flip pixels at the rounding boundary
    hi = jax.lax.Precision.HIGHEST
    x = jnp.einsum("oh,...hw->...ow", a, x, precision=hi)
    x = jnp.einsum("ow,...hw->...ho", b, x, precision=hi)
    return x


def sensor_map_from_view(view_u8: jnp.ndarray, out_hw, dtype=jnp.float32) -> jnp.ndarray:
    """Reference obs pipeline: cubic resize, saturate to uint8, /255
    (yaml_env.py:431-438; the float16 cast there is represented by `dtype`)."""
    x = resize_cubic(view_u8, out_hw, jnp.float32)
    # cv2 saturates the cubic overshoot back into uint8 range and rounds.
    x = jnp.clip(jnp.round(x), 0, 255)
    return (x / 255.0).astype(dtype)
