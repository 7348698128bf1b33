"""Batched Social Force Model (pedsim / Moussaid-Helbing).

Vectorized re-expression of pedsim's two-phase update
(src/3rdparty/pedsimros/src/ped_scene.cpp:167-182): all forces are computed
from the pre-step state with masked O(A^2) pairwise terms (the quadtree is
pure pruning — the social force already cuts off at 64 m^2, ped_agent.cpp:343),
then every agent moves simultaneously.

Reference behaviors preserved:
  * waypoint queue semantics including the initial non-consuming destination
    and r=0 waypoints that never complete (pedscene.h:39-47 pushes the goal
    with radius 1 followed by trajectory points with radius 0);
  * robots as waypoint-less SFM agents whose position is overwritten each
    step but whose internal velocity keeps integrating forces
    (pedscene.h:53-56, 72-81);
  * obstacles as *diagonal segments* from the AABB corners (pedscene.h:23-27);
  * velocity update v <- 0.5 v + a*h clamped to vmax (ped_agent.cpp:564-567)
    and the move-through-obstacle position clamp (ped_agent.cpp:519-553).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from img_env_tpu.constants import (
    SFM_CUTOFF_DIST_SQ,
    SFM_FACTOR_DESIRED,
    SFM_FACTOR_LOOKAHEAD,
    SFM_FACTOR_OBSTACLE,
    SFM_FACTOR_SOCIAL,
    SFM_GAMMA,
    SFM_LAMBDA,
    SFM_N,
    SFM_N_PRIME,
    SFM_NEIGHBORHOOD_RANGE,
    SFM_OBSTACLE_SIGMA,
    SFM_AGENT_RADIUS,
)


class SfmWaypointState(NamedTuple):
    """Cyclic waypoint queue per agent (pedsim Tagent::desiredForce)."""

    wp_xy: jnp.ndarray       # [A,W,2]
    wp_r: jnp.ndarray        # [A,W]
    wp_len: jnp.ndarray      # [A] int32 (0 for robots)
    dest_idx: jnp.ndarray    # [A] int32 current destination slot
    head: jnp.ndarray        # [A] int32 next fetch position
    has_dest: jnp.ndarray    # [A] bool


def waypoint_init(wp_xy, wp_r, wp_len) -> SfmWaypointState:
    a = wp_xy.shape[0]
    return SfmWaypointState(
        wp_xy=wp_xy,
        wp_r=wp_r,
        wp_len=wp_len,
        dest_idx=jnp.zeros(a, jnp.int32),
        head=jnp.zeros(a, jnp.int32),
        has_dest=wp_len > 0,
    )


def _desired_direction(pos, wp: SfmWaypointState) -> Tuple[jnp.ndarray, SfmWaypointState]:
    """desiredForce's waypoint management (ped_agent.cpp:236-306).

    Returns the unit desired direction and the post-step waypoint state.
    """
    a = pos.shape[0]
    # fetch if no destination (reached last step)
    need_fetch = jnp.logical_not(wp.has_dest) & (wp.wp_len > 0)
    fetched_idx = wp.head % jnp.maximum(wp.wp_len, 1)
    dest_idx = jnp.where(need_fetch, fetched_idx, wp.dest_idx)
    head = jnp.where(need_fetch, wp.head + 1, wp.head)
    has_dest = wp.has_dest | need_fetch

    dest = jnp.take_along_axis(wp.wp_xy, dest_idx[:, None, None], axis=1)[:, 0]
    dest_r = jnp.take_along_axis(wp.wp_r, dest_idx[:, None], axis=1)[:, 0]
    diff = dest - pos
    dist = jnp.linalg.norm(diff, axis=-1)
    dirn = jnp.where(
        (dist > 0)[:, None] & has_dest[:, None], diff / jnp.maximum(dist, 1e-30)[:, None], 0.0
    )
    reached = has_dest & (dist < dest_r)
    new_state = SfmWaypointState(
        wp_xy=wp.wp_xy, wp_r=wp.wp_r, wp_len=wp.wp_len,
        dest_idx=dest_idx, head=head,
        has_dest=has_dest & jnp.logical_not(reached),
    )
    return dirn, new_state


def _social_force(pos, vel, valid):
    """Pairwise Moussaid-Helbing interaction (ped_agent.cpp:316-404)."""
    diff = pos[None, :, :] - pos[:, None, :]          # [A,A,2] other - self
    dist_sq = jnp.sum(diff * diff, -1)
    a = pos.shape[0]
    eye = jnp.eye(a, dtype=bool)
    # quadtree neighborhood (square of half-width 20) then the 64 m^2 cutoff
    near = (
        valid[None, :] & valid[:, None] & jnp.logical_not(eye)
        & (jnp.abs(diff[..., 0]) <= SFM_NEIGHBORHOOD_RANGE)
        & (jnp.abs(diff[..., 1]) <= SFM_NEIGHBORHOOD_RANGE)
        & (dist_sq <= SFM_CUTOFF_DIST_SQ) & (dist_sq > 0)
    )
    dist = jnp.sqrt(jnp.maximum(dist_sq, 1e-30))
    diff_dir = diff / dist[..., None]
    vel_diff = vel[:, None, :] - vel[None, :, :]      # self - other
    ivec = SFM_LAMBDA * vel_diff + diff_dir
    ilen = jnp.linalg.norm(ivec, axis=-1)
    idir = ivec / jnp.maximum(ilen, 1e-30)[..., None]
    # angleTo: signed angle from idir to diff_dir.  The cross term is
    # idir x diff_dir = lambda (vel_diff x diff_dir) / ilen (diff_dir x
    # diff_dir = 0): exactly 0 when the two velocities are equal (every ped
    # at rest after a reset).  The literal product difference leaves a
    # rounding residual there whose sign — fused multiply-adds on a GPU
    # round it differently — would pick the direction of a full-size
    # sideways force.
    dot = jnp.clip(jnp.sum(idir * diff_dir, -1), -1.0, 1.0)
    crs = SFM_LAMBDA * (vel_diff[..., 0] * diff_dir[..., 1]
                        - vel_diff[..., 1] * diff_dir[..., 0]) / jnp.maximum(
                            ilen, 1e-30)
    theta = jnp.arctan2(crs, dot)
    theta_sign = jnp.where(theta == 0, 0.0, jnp.sign(theta))
    b = SFM_GAMMA * ilen
    b_safe = jnp.maximum(b, 1e-30)
    f_vel = -jnp.exp(-dist / b_safe - (SFM_N_PRIME * b * theta) ** 2)
    f_ang = -theta_sign * jnp.exp(-dist / b_safe - (SFM_N * b * theta) ** 2)
    left_normal = jnp.stack([-idir[..., 1], idir[..., 0]], -1)
    force = f_vel[..., None] * idir + f_ang[..., None] * left_normal
    return jnp.sum(jnp.where(near[..., None], force, 0.0), axis=1)


def _obstacle_force(pos, seg_a, seg_b, seg_valid):
    """Closest-obstacle repulsion (ped_agent.cpp:411-429).

    seg_a/seg_b: [S,2] diagonal segment endpoints.
    """
    if seg_a.shape[0] == 0:
        return jnp.zeros_like(pos)
    rel_end = seg_b - seg_a                            # [S,2]
    len_sq = jnp.maximum(jnp.sum(rel_end * rel_end, -1), 1e-30)
    relp = pos[:, None, :] - seg_a[None, :, :]         # [A,S,2]
    lam = jnp.sum(relp * rel_end[None], -1) / len_sq
    lam = jnp.clip(lam, 0.0, 1.0)
    closest = seg_a[None] + lam[..., None] * rel_end[None]
    diff = pos[:, None, :] - closest
    dsq = jnp.sum(diff * diff, -1)
    dsq = jnp.where(seg_valid[None, :], dsq, jnp.inf)
    min_idx = jnp.argmin(dsq, axis=1)
    min_diff = jnp.take_along_axis(diff, min_idx[:, None, None], axis=1)[:, 0]
    min_d = jnp.sqrt(jnp.take_along_axis(dsq, min_idx[:, None], axis=1))[:, 0]
    has_obs = jnp.isfinite(min_d)
    amount = jnp.exp(-(min_d - SFM_AGENT_RADIUS) / SFM_OBSTACLE_SIGMA)
    dirn = min_diff / jnp.maximum(min_d, 1e-30)[:, None]
    return jnp.where(has_obs[:, None], amount[:, None] * dirn, 0.0)


def _lookahead_force(pos, vel, desired_dir, valid):
    """"Look ahead" lane-changing force (ped_agent.cpp:439-480)."""
    pi = jnp.pi
    dxy = pos[None, :, :] - pos[:, None, :]            # other - self
    dist_sq = jnp.sum(dxy * dxy, -1)
    a = pos.shape[0]
    eye = jnp.eye(a, dtype=bool)
    near = (
        valid[None, :] & valid[:, None] & jnp.logical_not(eye)
        & (jnp.abs(dxy[..., 0]) <= SFM_NEIGHBORHOOD_RANGE)
        & (jnp.abs(dxy[..., 1]) <= SFM_NEIGHBORHOOD_RANGE)
        & (dist_sq < 400.0)
    )
    e = desired_dir
    at2v = jnp.arctan2(-e[:, 0], -e[:, 1])             # [A]
    at2d = jnp.arctan2(-dxy[..., 0], -dxy[..., 1])     # [A,A]
    at2v2 = jnp.arctan2(-vel[None, :, 0], -vel[None, :, 1])
    wrap = lambda x: jnp.where(x > pi, x - 2 * pi, jnp.where(x < -pi, x + 2 * pi, x))
    s = wrap(at2d - at2v[:, None])
    vv = wrap(at2v[:, None] - at2v2)
    opposite = jnp.abs(vv) > 2.5
    dec = near & opposite & (s < 0) & (s > -0.3)
    inc = near & opposite & (s > 0) & (s < 0.3)
    count = jnp.sum(inc.astype(jnp.int32) - dec.astype(jnp.int32), axis=1)
    lf = jnp.where(
        (count < 0)[:, None],
        0.5 * jnp.stack([e[:, 1], -e[:, 0]], -1),
        jnp.where(
            (count > 0)[:, None],
            0.5 * jnp.stack([-e[:, 1], e[:, 0]], -1),
            0.0,
        ),
    )
    return lf


def _move_clamp(pos, step_vec, seg_a, seg_b, seg_valid):
    """Obstacle line-intersection position clamp (ped_agent.cpp:519-553).

    Applied sequentially over obstacles in order; each intersection rewrites
    the desired position.
    """
    if seg_a.shape[0] == 0:
        return pos + step_vec
    vn = step_vec / jnp.maximum(
        jnp.linalg.norm(step_vec, axis=-1, keepdims=True), 1e-30
    )

    def body(k, p_des):
        p2, p3 = seg_a[k], seg_b[k]
        s1 = p_des - pos                                # [A,2]
        s2 = p3 - p2                                    # [2]
        denom = -s2[0] * s1[:, 1] + s1[:, 0] * s2[1]
        denom_safe = jnp.where(denom == 0, 1.0, denom)
        s = (-s1[:, 1] * (pos[:, 0] - p2[0]) + s1[:, 0] * (pos[:, 1] - p2[1])) / denom_safe
        t = (s2[0] * (pos[:, 1] - p2[1]) - s2[1] * (pos[:, 0] - p2[0])) / denom_safe
        hit = (
            seg_valid[k] & (denom != 0)
            & (s >= 0) & (s <= 1) & (t >= 0) & (t <= 1)
        )
        inter = pos + t[:, None] * s1
        clamped = inter - vn * 0.1
        return jnp.where(hit[:, None], clamped, p_des)

    return jax.lax.fori_loop(0, seg_a.shape[0], body, pos + step_vec)


def sfm_step(
    pos, vel, vmax, valid, wp: SfmWaypointState,
    seg_a, seg_b, seg_valid, h,
):
    """One Tscene::moveAgents(h). All agents (peds + robot mirrors) together.

    Returns (new_pos, new_vel, new_wp_state).
    """
    desired_dir, new_wp = _desired_direction(pos, wp)
    desired = desired_dir * vmax[:, None]
    social = _social_force(pos, vel, valid)
    obstacle = _obstacle_force(pos, seg_a, seg_b, seg_valid)
    lookahead = _lookahead_force(pos, vel, desired_dir, valid)

    accel = (
        SFM_FACTOR_DESIRED * desired
        + SFM_FACTOR_SOCIAL * social
        + SFM_FACTOR_OBSTACLE * obstacle
        + SFM_FACTOR_LOOKAHEAD * lookahead
    )

    new_pos = _move_clamp(pos, vel * h, seg_a, seg_b, seg_valid)
    new_vel = 0.5 * vel + accel * h
    speed = jnp.linalg.norm(new_vel, axis=-1, keepdims=True)
    new_vel = jnp.where(
        speed > vmax[:, None], new_vel / jnp.maximum(speed, 1e-30) * vmax[:, None], new_vel
    )
    new_pos = jnp.where(valid[:, None], new_pos, pos)
    new_vel = jnp.where(valid[:, None], new_vel, vel)
    return new_pos, new_vel, new_wp
