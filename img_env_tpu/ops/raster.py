"""Occupancy composition and collision codes as on-device scatters.

The reference mutates one shared uint8 grid per robot (N full-map copies per
step, img_env.cpp:620-629).  Here the same *cell-quantized* semantics are
expressed as layered boolean occupancy built once per scene per step:

  * ``obs_map``   — static map + per-episode obstacles (uint8, value 0 =
                    obstacle), built at reset by scattering the reference's
                    0.01 m footprint point clouds (bit-identical cells).
  * ``ped layer`` — two bool maps: *strong* cells (right-leg stamps, which the
                    reference lets overwrite obstacle cells, agent.cpp:758-772)
                    and *weak* cells (left legs / circle peds, which do not).
  * ``robot layer`` — a deduplicated count map plus an id map; "another robot
                    covers cell c from robot i's perspective" is
                    ``count[c] >= 2 or (count[c] == 1 and id[c] != i)``.

Collision codes replicate ``Agent::draw`` (agent.cpp:285-327): per footprint
point the cell category is (0=obstacle, 1=ped, 2=robot in draw-priority order
obstacle > ped > robot) and the returned code is the *last* nonzero hit in
point order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from img_env_tpu.constants import CELL_FREE_MIN


def round_half_away(x):
    """C++ ``round()`` semantics (half away from zero)."""
    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))


def world_to_cell(pts, resolution):
    """[..., 2] world points -> [..., 2] int32 cell indices (row=x, col=y)."""
    return round_half_away(pts / resolution).astype(jnp.int32)


def transform_points(pose, pts):
    """Rigid transform of base-frame points by pose [..., 3]."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    x = c[..., None] * pts[..., 0] - s[..., None] * pts[..., 1] + pose[..., 0:1]
    y = s[..., None] * pts[..., 0] + c[..., None] * pts[..., 1] + pose[..., 1:2]
    return jnp.stack([x, y], axis=-1)


def _flat_idx(cells, shape_hw):
    """Clip-free flattened indices; out-of-map points get a sentinel bucket."""
    h, w = shape_hw
    m, n = cells[..., 0], cells[..., 1]
    inside = (m >= 0) & (m < h) & (n >= 0) & (n < w)
    flat = jnp.where(inside, m * w + n, h * w)  # sentinel row
    return flat, inside


def scatter_occupancy(cells, valid, shape_hw) -> jnp.ndarray:
    """bool [H, W]: cell covered by any valid point."""
    h, w = shape_hw
    flat, inside = _flat_idx(cells, shape_hw)
    buf = jnp.zeros((h * w + 1,), jnp.int32)
    buf = buf.at[flat.reshape(-1)].max(
        jnp.where((valid & inside).reshape(-1), 1, 0), mode="drop"
    )
    return buf[: h * w].reshape(h, w).astype(bool)


def scatter_count(cells, valid, shape_hw) -> jnp.ndarray:
    """int32 [H, W]: number of valid points per cell."""
    h, w = shape_hw
    flat, inside = _flat_idx(cells, shape_hw)
    buf = jnp.zeros((h * w + 1,), jnp.int32)
    buf = buf.at[flat.reshape(-1)].add(
        jnp.where((valid & inside).reshape(-1), 1, 0), mode="drop"
    )
    return buf[: h * w].reshape(h, w)


def scatter_presence(cells, valid, shape_hw) -> jnp.ndarray:
    """int32 [H, W]: number of *agents* (leading dim of cells) covering a cell.

    Each agent's duplicate cell hits (several 0.01 m samples per 0.015 m cell)
    are deduplicated by sorting its flattened cell ids and keeping first
    occurrences, so each agent contributes at most 1 per cell.
    cells: [A, P, 2]; valid: [A, P].
    """
    h, w = shape_hw
    flat, inside = _flat_idx(cells, shape_hw)           # [A,P]
    flat = jnp.where(valid & inside, flat, h * w)
    s = jnp.sort(flat, axis=1)
    first = jnp.concatenate(
        [jnp.ones((s.shape[0], 1), bool), s[:, 1:] != s[:, :-1]], axis=1
    )
    weight = jnp.where(first & (s < h * w), 1, 0)
    buf = jnp.zeros((h * w + 1,), jnp.int32)
    buf = buf.at[s.reshape(-1)].add(weight.reshape(-1), mode="drop")
    return buf[: h * w].reshape(h, w)


def scatter_max_id(cells, valid, shape_hw) -> jnp.ndarray:
    """int32 [H, W]: 1 + index of the highest-indexed agent covering a cell
    (0 = no agent).  cells: [A, P, 2]; valid: [A, P]."""
    h, w = shape_hw
    flat, inside = _flat_idx(cells, shape_hw)
    ids = jnp.broadcast_to(
        jnp.arange(1, cells.shape[0] + 1, dtype=jnp.int32)[:, None], flat.shape
    )
    buf = jnp.zeros((h * w + 1,), jnp.int32)
    buf = buf.at[flat.reshape(-1)].max(
        jnp.where((valid & inside).reshape(-1), ids.reshape(-1), 0), mode="drop"
    )
    return buf[: h * w].reshape(h, w)


def stamp_value(grid: jnp.ndarray, cells, valid, value: int) -> jnp.ndarray:
    """Write ``value`` into covered in-map cells of a uint8 grid."""
    h, w = grid.shape
    flat, inside = _flat_idx(cells, (h, w))
    flat = jnp.where(valid & inside, flat, h * w)
    buf = jnp.concatenate([grid.reshape(-1), jnp.zeros((1,), grid.dtype)])
    buf = buf.at[flat.reshape(-1)].set(jnp.asarray(value, grid.dtype), mode="drop")
    return buf[: h * w].reshape(h, w)


def draw_obstacles(
    static_map: jnp.ndarray, resolution: float, obs_pose, obs_points, obs_mask
) -> jnp.ndarray:
    """Compose the per-episode obstacle map (img_env.cpp:169-193).

    obs_pose: [O,3]; obs_points: [O,P,2] base-frame clouds; obs_mask: [O,P].
    Obstacle cells get value 0 wherever the cell is not already 0/1/2 — at
    reset the map holds only the static image, so this is a plain stamp of 0
    into non-obstacle cells; value-0 cells are left as-is (same result).
    """
    pts = transform_points(obs_pose, obs_points)          # [O,P,2]
    cells = world_to_cell(pts, resolution)
    return stamp_value(static_map, cells, obs_mask, 0)


class OccupancyLayers(NamedTuple):
    """Per-step composed occupancy for one scene."""

    obs_map: jnp.ndarray        # [H,W] uint8 static+obstacles
    ped_strong: jnp.ndarray     # [H,W] bool right-leg stamps (overwrite obstacles)
    ped_weak: jnp.ndarray       # [H,W] bool left-leg / circle-ped stamps
    robot_count: jnp.ndarray    # [H,W] int32 robot footprint sample counts
    robot_cells: jnp.ndarray    # [N,P,2] int32 cells of each robot's samples
    robot_cells_valid: jnp.ndarray  # [N,P] bool
    packed: jnp.ndarray         # [H,W] int32: bit0 = obs|ped occupied,
                                #  bits 1..2 = robot count capped at 2,
                                #  bits 3..14 = 1 + id of one covering robot
                                #  (<= 4095 robots), bit15 = reads-as-ped,
                                #  bit16 = reads-as-obstacle, bit17 = static
                                #  value-2 alias — the view fill and the
                                #  collision check each read ONE map, and
                                #  self-exclusion needs no own-footprint
                                #  gather: another robot covers the cell iff
                                #  count >= 2, or count == 1 with another id


def build_layers(
    obs_map: jnp.ndarray,
    resolution: float,
    robot_pose,        # [N,3]
    robot_points,      # [N,P,2]
    robot_mask,        # [N,P]
    ped_pose,          # [M,3] (yaw used for body rotation)
    ped_body_points,   # [M,Q,2]
    ped_body_mask,     # [M,Q]  (circle peds; zero-masked for leg peds)
    ped_left_points,   # [M,L,2] world-ready base-frame left-leg cloud + offset
    ped_left_mask,
    ped_right_points,  # [M,R,2]
    ped_right_mask,
) -> OccupancyLayers:
    """Scatter all dynamic agents into the layered occupancy."""
    hw = obs_map.shape

    if robot_points.shape[0] >= 4096:
        raise ValueError(
            "packed-map robot ids use bits 3..14 (<= 4095 robots)")
    rp = transform_points(robot_pose, robot_points)
    r_cells = world_to_cell(rp, resolution)
    robot_count = scatter_presence(r_cells, robot_mask, hw)

    pb = transform_points(ped_pose, ped_body_points)
    pl = transform_points(ped_pose, ped_left_points)
    pr = transform_points(ped_pose, ped_right_points)
    weak_pts = jnp.concatenate([pb, pl], axis=1)
    weak_mask = jnp.concatenate([ped_body_mask, ped_left_mask], axis=1)
    ped_weak = scatter_occupancy(world_to_cell(weak_pts, resolution), weak_mask, hw)
    ped_strong = scatter_occupancy(world_to_cell(pr, resolution), ped_right_mask, hw)

    static_occ = (obs_map < CELL_FREE_MIN) | ped_strong | ped_weak
    robot_id = scatter_max_id(r_cells, robot_mask, hw)
    # collision-category bits (cell_categories semantics), so the collision
    # check is ONE gather instead of four
    obs0 = obs_map == 0
    writable = jnp.logical_not(obs0 | (obs_map == 1) | (obs_map == 2))
    is_ped = (ped_strong | (ped_weak & writable)
              | ((obs_map == 1) & jnp.logical_not(obs0)))
    is_obs = obs0 & jnp.logical_not(ped_strong)
    packed = (static_occ.astype(jnp.int32)
              | (jnp.minimum(robot_count, 2) << 1)
              | (robot_id << 3)
              | (is_ped.astype(jnp.int32) << 15)
              | (is_obs.astype(jnp.int32) << 16)
              | ((obs_map == 2).astype(jnp.int32) << 17))

    return OccupancyLayers(
        obs_map=obs_map,
        ped_strong=ped_strong,
        ped_weak=ped_weak,
        robot_count=robot_count,
        robot_cells=r_cells,
        robot_cells_valid=robot_mask,
        packed=packed,
    )


def cell_categories(layers: OccupancyLayers) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(is_ped [H,W], is_obstacle [H,W]) with reference draw priority.

    A cell reads as ped (value 1) if a right leg stamped it (even over an
    obstacle) or a weak ped stamp landed on a non-obstacle cell; it reads as
    obstacle (value 0) only if the map value is 0 and no right leg overwrote.
    Static-map cells whose gray value happens to be exactly 1 also read as
    "ped" in the reference (value aliasing); preserved here.
    """
    obs0 = layers.obs_map == 0
    # weak stamps only land on cells that are not 0/1/2; value-1 cells already
    # read as ped, value-2 cells keep reading as robot.
    writable = jnp.logical_not(obs0 | (layers.obs_map == 1) | (layers.obs_map == 2))
    is_ped = (
        layers.ped_strong
        | (layers.ped_weak & writable)
        | ((layers.obs_map == 1) & jnp.logical_not(obs0))
    )
    is_obs = obs0 & jnp.logical_not(layers.ped_strong)
    return is_ped, is_obs


def view_occupied(layers: OccupancyLayers, include_robots: bool = True) -> jnp.ndarray:
    """bool [H,W]: cell value < 250 after full composition (agent.cpp:394)."""
    occ = (layers.obs_map < CELL_FREE_MIN) | layers.ped_strong | layers.ped_weak
    if include_robots:
        occ = occ | (layers.robot_count > 0)
    return occ


def _gather_map(grid: jnp.ndarray, cells, fill):
    h, w = grid.shape
    m = jnp.clip(cells[..., 0], 0, h - 1)
    n = jnp.clip(cells[..., 1], 0, w - 1)
    inside = (
        (cells[..., 0] >= 0)
        & (cells[..., 0] < h)
        & (cells[..., 1] >= 0)
        & (cells[..., 1] < w)
    )
    vals = grid[m, n]
    return jnp.where(inside, vals, fill), inside


def collision_codes(
    layers: OccupancyLayers,
    latched_collision,  # [N] int32 previous codes
    latched_arrive,     # [N] bool
) -> jnp.ndarray:
    """Reference collision codes per robot (agent.cpp:285-327, 356-361).

    A robot whose collision or arrival flag is already latched skips the check
    (``Agent::view`` early-returns, agent.cpp:358).
    """
    cells, valid = layers.robot_cells, layers.robot_cells_valid  # [N,P,2],[N,P]

    v, inside = _gather_map(layers.packed, cells, 0)   # ONE gather per point
    ped_hit = (v >> 15) & 1
    obs_hit = (v >> 16) & 1
    # robot_count counts distinct robots per cell, and a robot's own footprint
    # cells are own-covered by construction, so "another robot here" is
    # simply count >= 2.  Static-map gray value 2 aliases to "robot" too.
    other_robot = (((v >> 1) & 3) > 1) | (((v >> 17) & 1) > 0)

    # Draw-priority category per point; 0 = no hit.
    code = jnp.where(
        obs_hit > 0, 1, jnp.where(ped_hit > 0, 2, jnp.where(other_robot, 3, 0))
    )
    code = jnp.where(valid & inside, code, 0)

    # Last nonzero point wins (sequential overwrite in the C++ loop).
    p = code.shape[1]
    rev_any = jnp.flip(code != 0, axis=1)
    last_idx = p - 1 - jnp.argmax(rev_any, axis=1)
    fresh = jnp.where(
        jnp.any(code != 0, axis=1),
        jnp.take_along_axis(code, last_idx[:, None], axis=1)[:, 0],
        0,
    )
    keep = (latched_collision > 0) | latched_arrive
    return jnp.where(keep, latched_collision, fresh)
