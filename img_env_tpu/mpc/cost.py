"""Planning cost terms for the sampling/gradient MPC controllers.

The cost mirrors what the reference's reward punishes (SensorsPaperReward,
envs/wrapper/base.py:153-195) but as a smooth, differentiable field:

  * goal progress        — distance-to-goal, terminal weighted
  * static clearance     — EDT lookup of the static map + analytic distance
                           to the episode's sampled obstacle AABBs
  * pedestrian clearance — smooth hinge at ped_safety_space (0.7 m default)
  * control effort/smoothness

All terms are batched over [K rollouts, H horizon] and vmapped over robots.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class CostWeights(NamedTuple):
    goal: float = 4.0
    terminal_goal: float = 20.0
    collision: float = 400.0
    clearance: float = 30.0         # hinge weight inside the safety band
    safety_dist: float = 0.45       # robot_radius + margin (static band)
    ped_safety: float = 0.7         # ped_safety_space (base.py:164)
    ped_weight: float = 50.0        # matches the -50*(0.7-d) reward slope
    effort_v: float = 0.1
    effort_w: float = 0.05
    smooth: float = 0.2


class WorldCost(NamedTuple):
    """Static per-episode data the cost closes over."""

    edt: jnp.ndarray            # [H,W] meters to nearest static occupied
    resolution: float
    obs_aabb: jnp.ndarray       # [O,4] episode obstacle corners (world m)
    obs_valid: jnp.ndarray      # [O]
    robot_radius: float
    goal_field: Optional[jnp.ndarray] = None   # [H,W] geodesic m-to-goal
                                # (global guidance; None -> Euclidean goal
                                # term.  See geodesic_field.)


def static_distance(wc: WorldCost, xy: jnp.ndarray) -> jnp.ndarray:
    """Distance (m) from points [...,2] to the nearest static/episode obstacle.

    Map convention: row = x, col = y (ops/raster.world_to_cell) — visible
    only on non-square / asymmetric maps (e.g. configs/corridor.yaml).
    """
    cells = jnp.round(xy / wc.resolution).astype(jnp.int32)
    h, w = wc.edt.shape
    r = jnp.clip(cells[..., 0], 0, h - 1)
    c = jnp.clip(cells[..., 1], 0, w - 1)
    inb = ((cells[..., 0] >= 0) & (cells[..., 0] < h)
           & (cells[..., 1] >= 0) & (cells[..., 1] < w))
    d_map = jnp.where(inb, wc.edt[r, c], 0.0)

    # analytic distance to each obstacle AABB
    lo = jnp.minimum(wc.obs_aabb[:, 0:2], wc.obs_aabb[:, 2:4])  # [O,2]
    hi = jnp.maximum(wc.obs_aabb[:, 0:2], wc.obs_aabb[:, 2:4])
    p = xy[..., None, :]                                        # [...,1,2]
    dx = jnp.maximum(jnp.maximum(lo - p, p - hi), 0.0)          # [...,O,2]
    d_box = jnp.sqrt((dx ** 2).sum(-1) + 1e-12)
    d_box = jnp.where(wc.obs_valid, d_box, jnp.inf)
    d_box = jnp.min(d_box, axis=-1) if wc.obs_aabb.shape[0] else jnp.full(xy.shape[:-1], jnp.inf)
    return jnp.minimum(d_map, d_box)


def static_distance_smooth(wc: WorldCost, xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear-interpolated EDT + analytic AABB distance: C0, with nonzero
    gradients everywhere — required by the derivative-based (iLQR) solver;
    the sampling solvers use the cheaper nearest-cell ``static_distance``."""
    h, w = wc.edt.shape
    gx = xy[..., 0] / wc.resolution
    gy = xy[..., 1] / wc.resolution
    x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, h - 2)
    y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, w - 2)
    fx = jnp.clip(gx - x0, 0.0, 1.0)
    fy = jnp.clip(gy - y0, 0.0, 1.0)
    d00 = wc.edt[x0, y0]
    d01 = wc.edt[x0, y0 + 1]
    d10 = wc.edt[x0 + 1, y0]
    d11 = wc.edt[x0 + 1, y0 + 1]
    d_map = ((1 - fx) * (1 - fy) * d00 + (1 - fx) * fy * d01
             + fx * (1 - fy) * d10 + fx * fy * d11)

    lo = jnp.minimum(wc.obs_aabb[:, 0:2], wc.obs_aabb[:, 2:4])
    hi = jnp.maximum(wc.obs_aabb[:, 0:2], wc.obs_aabb[:, 2:4])
    p = xy[..., None, :]
    dx = jnp.maximum(jnp.maximum(lo - p, p - hi), 0.0)
    d_box = jnp.sqrt((dx ** 2).sum(-1) + 1e-9)
    d_box = jnp.where(wc.obs_valid, d_box, jnp.inf)
    d_box = jnp.min(d_box, axis=-1) if wc.obs_aabb.shape[0] else jnp.full(xy.shape[:-1], jnp.inf)
    # smooth-min keeps gradients from both terms near the crossover
    a = jnp.minimum(d_map, d_box)
    return a


def pooled_edt(edt, pool: int):
    """min-pool the full EDT once per solve (pool-aligned blocks).

    ``local_edt_patch`` used to dynamic-slice a FINE [PS, PS] window per
    robot and pool it afterwards — under the (scene, robot) vmap those
    slices become gathers that re-stream the whole [1066, 1066] per-scene
    EDT several times (~72 MB/scene per solve in the XLA cost analysis;
    the multi-scene act tax of benchmarks/README.md round 5).  Corners are
    pool-aligned by construction, so pool-then-slice is BIT-IDENTICAL to
    slice-then-pool — one full-map pass instead of many."""
    if pool <= 1:
        return edt
    h, w = edt.shape
    hp, wp = h // pool * pool, w // pool * pool
    return edt[:hp, :wp].reshape(hp // pool, pool,
                                 wp // pool, pool).min((1, 3))


def local_edt_patch(wc: WorldCost, pose_xy, patch_size: int, pool: int = 1,
                    edt_pooled=None):
    """One min-pooled window of ``wc.edt`` centred on the robot's cell.

    MPPI rollout positions stay within ``v_max * H * dt`` of the start, so a
    patch whose half-width covers that reach contains every cell the solver
    will ever look up — the patch read is one vectorized ``dynamic_slice``
    instead of K*H scalar gathers per robot.

    ``pool`` > 1 min-pools the window by pool x pool: the lookup then
    reports the block minimum, a CONSERVATIVE clearance (never larger than
    the true cell value), shrinking the one-hot selects ``pool^2``-fold.
    The MPC cost is a heuristic — no reference parity surface — so the
    deliberate bias toward caution is free performance.
    Pass ``edt_pooled=pooled_edt(wc.edt, pool)`` (computed ONCE per solve)
    to slice the pooled map directly — bit-identical values, pool^2 less
    per-robot gather traffic.
    Returns (patch [PS/pool, PS/pool], corner [2] int32 in fine cells).
    """
    h, w = wc.edt.shape
    ps_h = min((patch_size + pool - 1) // pool * pool, h // pool * pool)
    ps_w = min((patch_size + pool - 1) // pool * pool, w // pool * pool)
    cell = jnp.round(pose_xy / wc.resolution).astype(jnp.int32)
    corner = jnp.stack([
        jnp.clip((cell[0] - ps_h // 2) // pool * pool, 0,
                 (h - ps_h) // pool * pool),
        jnp.clip((cell[1] - ps_w // 2) // pool * pool, 0,
                 (w - ps_w) // pool * pool),
    ])
    if edt_pooled is not None and pool > 1:
        patch = jax.lax.dynamic_slice(
            edt_pooled, (corner[0] // pool, corner[1] // pool),
            (ps_h // pool, ps_w // pool))
        return patch, corner
    patch = jax.lax.dynamic_slice(wc.edt, (corner[0], corner[1]),
                                  (ps_h, ps_w))
    if pool > 1:
        patch = patch.reshape(ps_h // pool, pool,
                              ps_w // pool, pool).min((1, 3))
    return patch, corner


def static_distance_patch(wc: WorldCost, patch, corner, xy, pool: int = 1):
    """``static_distance`` with the map lookup served from a local patch.

    The nearest-cell EDT read becomes two one-hot contractions (row select
    as a matmul, column select as an elementwise reduce).  The row select
    runs at full f32 precision, so with ``pool`` == 1 the selected values
    equal the gather exactly; with ``pool`` > 1 they are the conservative
    block minima from ``local_edt_patch``.
    Out-of-map points return 0.0 exactly like ``static_distance``.
    """
    h, w = wc.edt.shape
    ps_h, ps_w = patch.shape
    cells = jnp.round(xy / wc.resolution).astype(jnp.int32)
    li = jnp.clip((cells[..., 0] - corner[0]) // pool, 0, ps_h - 1)
    lj = jnp.clip((cells[..., 1] - corner[1]) // pool, 0, ps_w - 1)
    row1h = (li[..., None] == jnp.arange(ps_h)).astype(patch.dtype)
    t1 = jnp.einsum("...i,ij->...j", row1h, patch,        # row select
                    precision=jax.lax.Precision.HIGHEST)
    col1h = (lj[..., None] == jnp.arange(ps_w)).astype(patch.dtype)
    d_map = (t1 * col1h).sum(-1)                          # one-term select
    inb = ((cells[..., 0] >= 0) & (cells[..., 0] < h)
           & (cells[..., 1] >= 0) & (cells[..., 1] < w))
    d_map = jnp.where(inb, d_map, 0.0)

    if wc.obs_aabb.shape[0] == 0:
        return d_map
    lo = jnp.minimum(wc.obs_aabb[:, 0:2], wc.obs_aabb[:, 2:4])
    hi = jnp.maximum(wc.obs_aabb[:, 0:2], wc.obs_aabb[:, 2:4])
    p = xy[..., None, :]
    dx = jnp.maximum(jnp.maximum(lo - p, p - hi), 0.0)
    d_box = jnp.sqrt((dx ** 2).sum(-1) + 1e-12)
    d_box = jnp.min(jnp.where(wc.obs_valid, d_box, jnp.inf), axis=-1)
    return jnp.minimum(d_map, d_box)


def ped_clearance(xy, t_idx, ped_pos, ped_vel, ped_r, dt: float):
    """Min distance to constant-velocity-predicted pedestrians.

    xy: [...,2] at horizon step t_idx (int array broadcastable to xy[...,0]).
    """
    if ped_pos.shape[0] == 0:
        return jnp.full(xy.shape[:-1], jnp.inf)
    t = (t_idx.astype(jnp.float32) + 1.0) * dt
    pred = ped_pos[None, ...] + ped_vel[None, ...] * t[..., None, None]  # [...,M,2]
    d = jnp.linalg.norm(xy[..., None, :] - pred, axis=-1) - ped_r[None, :]
    return jnp.min(d, axis=-1)


def ped_clearance_at(xy, ped_pos_t, ped_r):
    """Min distance to given per-step ped positions (any prediction head).

    xy: [...,2]; ped_pos_t: [M,2] predicted positions at this horizon step.
    """
    if ped_pos_t.shape[0] == 0:
        return jnp.full(xy.shape[:-1], jnp.inf)
    d = jnp.linalg.norm(xy[..., None, :] - ped_pos_t, axis=-1) - ped_r
    return jnp.min(d, axis=-1)


def geodesic_field(edt, resolution: float, goal_xy, robot_radius: float,
                   iters: int = 0) -> jnp.ndarray:
    """Geodesic distance-to-goal field over the robot-inflated free space.

    Min-plus wavefront on the grid (8-neighbourhood; straight step = res,
    diagonal = res*sqrt2), iterated to the map diameter — each iteration
    is nine shifted adds + a min, so the whole field is a handful of
    fused elementwise passes on the device.  Free space = ``edt > robot_radius``
    (C-space inflation); unreachable / occupied cells saturate at ``big``.

    This is the on-device analogue of the global planner the reference's
    BARN protocol runs under move_base: a purely local clearance-respecting
    MPC dead-ends in cave-like BARN worlds (the Euclidean goal term pulls
    into concave pockets); the per-step cost is one bilinear lookup (the
    field itself is recomputed once per SOLVE inside batched_mppi — cheap
    fused elementwise passes, but not free; cache it upstream if a
    workload ever makes it hot).

    Default iterations = 2*(h+w): the front advances one cell per
    iteration along the path, so this covers serpentine shortest paths up
    to twice the map semiperimeter; the saturation value ``big`` sits
    above the longest representable path so reachable cells are never
    clipped.  Raise ``iters`` for pathological mazes."""
    h, w = edt.shape
    free = edt > robot_radius
    n_it = iters if iters > 0 else 2 * (h + w)
    big = (n_it + 2.0) * resolution * 1.4142135   # > any reachable value
    gr = jnp.clip(jnp.round(goal_xy[0] / resolution).astype(jnp.int32),
                  0, h - 1)
    gc = jnp.clip(jnp.round(goal_xy[1] / resolution).astype(jnp.int32),
                  0, w - 1)
    d0 = jnp.full((h, w), big).at[gr, gc].set(0.0)
    straight, diag = resolution, resolution * 1.4142135

    def shift(a, dr, dc):
        a = jnp.roll(a, (dr, dc), (0, 1))
        if dr == 1:
            a = a.at[0, :].set(big)
        elif dr == -1:
            a = a.at[-1, :].set(big)
        if dc == 1:
            a = a.at[:, 0].set(big)
        elif dc == -1:
            a = a.at[:, -1].set(big)
        return a

    def body(_, d):
        nd = d
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nd = jnp.minimum(nd, shift(d, dr, dc) + straight)
        for dr, dc in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            nd = jnp.minimum(nd, shift(d, dr, dc) + diag)
        nd = jnp.where(free, nd, big)
        return nd.at[gr, gc].set(0.0)

    return jax.lax.fori_loop(0, n_it, body, d0)


def goal_distance(wc: WorldCost, xy, goal):
    """Goal-progress distance: bilinear geodesic-field lookup when the
    field is present, else straight-line (the classic MPPI goal term)."""
    if wc.goal_field is None:
        return jnp.linalg.norm(goal - xy, axis=-1)
    f = wc.goal_field
    h, w = f.shape
    gx = xy[..., 0] / wc.resolution
    gy = xy[..., 1] / wc.resolution
    x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, h - 2)
    y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, w - 2)
    fx = jnp.clip(gx - x0, 0.0, 1.0)
    fy = jnp.clip(gy - y0, 0.0, 1.0)
    return ((1 - fx) * (1 - fy) * f[x0, y0] + (1 - fx) * fy * f[x0, y0 + 1]
            + fx * (1 - fy) * f[x0 + 1, y0] + fx * fy * f[x0 + 1, y0 + 1])


def stage_cost(
    wc: WorldCost, w8: CostWeights,
    xy, goal, v, w, prev_v, prev_w,
    ped_pos_t, ped_r, local_edt=None,
):
    """One horizon step's cost; ped_pos_t are this step's predicted ped
    positions (from any prediction head, mpc/prediction.py).  local_edt:
    optional (patch, corner) from ``local_edt_patch`` — serves the static
    lookup without scalar gathers (same values)."""
    goal_d = goal_distance(wc, xy, goal)
    if local_edt is not None:
        patch, corner, pool = local_edt
        sd = static_distance_patch(wc, patch, corner, xy,
                                   pool) - wc.robot_radius
    else:
        sd = static_distance(wc, xy) - wc.robot_radius
    coll = (sd <= 0.0).astype(jnp.float32)
    hinge = jnp.maximum(w8.safety_dist - sd, 0.0)
    pd = ped_clearance_at(xy, ped_pos_t, ped_r) - wc.robot_radius
    ped_coll = (pd <= 0.0).astype(jnp.float32)
    ped_hinge = jnp.maximum(w8.ped_safety - pd, 0.0)
    return (
        w8.goal * goal_d
        + w8.collision * (coll + ped_coll)
        + w8.clearance * hinge
        + w8.ped_weight * ped_hinge
        + w8.effort_v * v ** 2 + w8.effort_w * w ** 2
        + w8.smooth * ((v - prev_v) ** 2 + (w - prev_w) ** 2)
    )


def terminal_cost(wc: WorldCost, w8: CostWeights, xy, goal):
    return w8.terminal_goal * goal_distance(wc, xy, goal)
