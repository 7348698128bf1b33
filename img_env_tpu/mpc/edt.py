"""Euclidean distance transforms for planning costs.

``edt2d`` is the exact Felzenszwalb & Huttenlocher two-pass squared EDT in
NumPy — run once on the host per static map (the map never changes within an
env, grid_map.cpp:28-38), so the per-step device cost of the static-clearance
term is a single gather.

``edt2d_device`` is an on-device variant (log-shift column scan + min-plus
parabola reduction) for maps stamped per episode, used when per-reset EDT of
the composed obstacle map is wanted inside jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_INF = 1e12


def _dt1d(f: np.ndarray) -> np.ndarray:
    """Exact 1D squared distance transform (lower envelope of parabolas)."""
    n = f.shape[0]
    d = np.empty(n)
    v = np.zeros(n, np.int64)
    z = np.empty(n + 1)
    k = 0
    v[0] = 0
    z[0] = -_INF
    z[1] = _INF
    for q in range(1, n):
        s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        while s <= z[k]:
            k -= 1
            s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        k += 1
        v[k] = q
        z[k] = s
        z[k + 1] = _INF
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        d[q] = (q - v[k]) ** 2 + f[v[k]]
    return d


def edt2d(occupied: np.ndarray, resolution: float = 1.0) -> np.ndarray:
    """Exact EDT (meters) of a boolean occupancy grid, host-side."""
    h, w = occupied.shape
    f = np.where(occupied, 0.0, _INF)
    for i in range(h):
        f[i] = _dt1d(f[i])
    for j in range(w):
        f[:, j] = _dt1d(f[:, j])
    return np.sqrt(f) * resolution


def edt2d_device(occupied: jnp.ndarray, resolution: float,
                 clip_cells: int = 128) -> jnp.ndarray:
    """On-device EDT, exact up to ``clip_cells`` then saturated.

    Column pass: log-shift (min,+) scan gives per-column vertical distance.
    Row pass: min-plus reduction against the parabola (j-k)^2 restricted to
    |j-k| <= clip_cells — planning costs saturate beyond the clearance band,
    so the clipped transform is exact where it matters.
    """
    h, w = occupied.shape
    g = jnp.where(occupied, 0.0, jnp.inf)
    # vertical nearest-occupied distance via log-shift passes (both directions)
    shift = 1
    while shift < h:
        up = jnp.concatenate([jnp.full((shift, w), jnp.inf), g[:-shift]], 0)
        dn = jnp.concatenate([g[shift:], jnp.full((shift, w), jnp.inf)], 0)
        g = jnp.minimum(g, jnp.minimum(up, dn) + shift)
        shift *= 2
    g2 = jnp.minimum(g, clip_cells) ** 2
    offs = jnp.arange(-clip_cells, clip_cells + 1)

    def body(carry, o):
        rolled = jnp.roll(g2, o, axis=1)
        # roll wraps; mask the wrapped region
        j = jnp.arange(w)
        valid = jnp.where(o >= 0, j >= o, j < w + o)
        cand = jnp.where(valid[None, :], rolled + o.astype(g2.dtype) ** 2, jnp.inf)
        return jnp.minimum(carry, cand), None

    d2, _ = jax.lax.scan(body, jnp.full((h, w), jnp.inf), offs)
    return jnp.sqrt(d2) * resolution
