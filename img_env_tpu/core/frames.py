"""SE(2) frame algebra used throughout the engine.

All transforms are represented as ``(tx, ty, yaw)`` triples or as arrays whose
last dimension holds ``(x, y[, yaw])``.  Functions are written to vmap cleanly
over arbitrary leading batch dimensions and to stay fully inside XLA.

Conventions follow the reference simulator (tf-based, z-up planar):
  * ``world_from_base(pose)`` maps base-frame points to world frame where
    ``pose = (x, y, theta)`` is the robot pose.
  * The egocentric *view* frame is related to the base frame by a rotation of
    ``VIEW_YAW`` (the literal 3.14159 the reference feeds tf, agent.cpp:84-88)
    and a translation of (half_h, half_w).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from img_env_tpu.constants import VIEW_YAW

# f32 rotations feed cell rounding (raster, collision codes): full f32, never
# the reduced-precision (TF32 / bf16-pass) matmul modes
_EXACT = jax.lax.Precision.HIGHEST


def rot2d(theta):
    """Rotation matrices with shape ``theta.shape + (2, 2)``."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def apply_se2(pose, pts):
    """Apply ``pose=(x, y, theta)`` to points ``pts[..., 2]``.

    ``pose[..., :2]`` broadcasts against the leading dims of ``pts``.
    """
    r = rot2d(pose[..., 2])
    rotated = jnp.einsum("...ij,...pj->...pi", r, pts, precision=_EXACT)
    return rotated + pose[..., None, :2]


def apply_rot(theta, pts):
    """Rotate points by ``theta`` (no translation)."""
    r = rot2d(theta)
    return jnp.einsum("...ij,...pj->...pi", r, pts, precision=_EXACT)


def inv_se2(pose):
    """Inverse of an SE(2) pose triple."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    return jnp.stack([-(c * x + s * y), -(-s * x + c * y), -pose[..., 2]], axis=-1)


def world_to_base(pose, pts_world):
    """Map world points into the frame of ``pose``."""
    d = pts_world - pose[..., None, :2]
    r = rot2d(-pose[..., 2])
    return jnp.einsum("...ij,...pj->...pi", r, d, precision=_EXACT)


def wrap_angle(a):
    """Wrap to (-pi, pi]."""
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


def goal_in_base(pose, goal_xy):
    """Goal position and heading expressed in the robot base frame.

    Replicates ``Agent::get_state`` (agent.cpp:156-184): the target frame is
    anchored at the goal with the yaw the robot had when the goal was set; the
    reference stores ``target_pose_.z = robot_pose_.z`` at ``set_goal`` time.
    Here we return the base-frame goal vector and the yaw difference
    ``goal_yaw - pose_yaw`` (== the reference's state yaw for state_dim 3/5,
    since tf composes the same rotations).
    """
    d = goal_xy - pose[..., :2]
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    bx = c * d[..., 0] + s * d[..., 1]
    by = -s * d[..., 0] + c * d[..., 1]
    return bx, by


def base_to_view(pts_base, half_extent):
    """Base-frame points -> view-frame, reference tf convention.

    ``tf_view_base_`` (agent.cpp:84-88) is the *view->base* transform with
    yaw VIEW_YAW and origin (half, half); ``base2view`` applies its inverse:
    ``view = R(-VIEW_YAW) @ base - R(-VIEW_YAW) @ (half, half)``.  VIEW_YAW is
    *almost* pi, so this is approximately ``half - base`` with a ~2.65e-6 skew
    the reference also has.
    """
    c, s = jnp.cos(VIEW_YAW), jnp.sin(VIEW_YAW)
    bx, by = pts_base[..., 0], pts_base[..., 1]
    vx = c * bx + s * by - (c * half_extent + s * half_extent)
    vy = -s * bx + c * by - (-s * half_extent + c * half_extent)
    return jnp.stack([vx, vy], axis=-1)


def view_to_base(pts_view, half_extent):
    """View-frame points -> base frame: apply ``tf_view_base_`` directly."""
    c, s = jnp.cos(VIEW_YAW), jnp.sin(VIEW_YAW)
    vx, vy = pts_view[..., 0], pts_view[..., 1]
    bx = c * vx - s * vy + half_extent
    by = s * vx + c * vy + half_extent
    return jnp.stack([bx, by], axis=-1)
