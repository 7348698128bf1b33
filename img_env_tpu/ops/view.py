"""Egocentric view rendering + laser raycast.

The reference renders, per robot, a 400x400 window by per-pixel inverse
transform and then walks one integer Bresenham line per laser beam over it
(agent.cpp:356-624).  Here both stages are data-parallel:

  * the FOV fill is a pure gather: every view pixel maps to a world cell whose
    composed occupancy comes from the scene's layered maps (ops/raster.py) —
    no global-map copies, robots excluded from their own view via a small
    local own-footprint map;
  * the raycast uses a *closed form* of Bresenham's midpoint walk.  For the
    major-axis step u, the minor offset is ``floor((2*h*u - w) / (2*w)) + 1``
    (u >= 0), which reproduces the C++ loop's visited cells exactly, so laser
    hits are bit-identical while all beams evaluate in parallel.

Outputs per robot: the uint8 view map (shadow-traced like the reference when
use_laser), hits [R], hit points [R,2], angular map [72].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from img_env_tpu.constants import (
    ANGULAR_MAP_SIZE,
    CELL_FREE_MIN,
    CELL_SELF_IN_VIEW,
    CELL_UNSEEN,
    CELL_VIEW_FREE,
    LASER_MISS_DIST,
    VIEW_YAW,
)
from img_env_tpu.ops.raster import (
    OccupancyLayers,
    round_half_away,
    transform_points,
    world_to_cell,
)


class ViewParams(NamedTuple):
    """Static sensor geometry (hashable → usable as jit static arg)."""

    hpx: int
    wpx: int
    resolution: float
    half: float                 # height/2 in meters (view frame origin offset)
    angle_begin: float
    angle_end: float
    min_dist: float
    max_dist: float
    range_total: int
    use_laser: bool

    @staticmethod
    def from_config(cfg) -> "ViewParams":
        hpx, wpx = cfg.view_pixels
        return ViewParams(
            hpx=hpx,
            wpx=wpx,
            resolution=float(cfg.view_map_resolution),
            half=float(cfg.view_map_size[1]) / 2.0,
            angle_begin=float(cfg.view_angle_begin),
            angle_end=float(cfg.view_angle_end),
            min_dist=float(cfg.view_min_dist),
            max_dist=float(cfg.view_max_dist),
            range_total=int(cfg.range_total),
            use_laser=bool(cfg.use_laser),
        )


# ---------------------------------------------------------------------------
# Static per-config geometry (host-side numpy, hashed into the jaxpr).
# ---------------------------------------------------------------------------


def _pixel_base_coords(p: ViewParams) -> Tuple[np.ndarray, np.ndarray]:
    """Base-frame (x, y) of every view pixel center. [hpx, wpx] each."""
    i = np.arange(p.hpx, dtype=np.float64) * p.resolution
    j = np.arange(p.wpx, dtype=np.float64) * p.resolution
    xv, yv = np.meshgrid(i, j, indexing="ij")
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    xb = c * xv - s * yv + p.half
    yb = s * xv + c * yv + p.half
    return xb, yb


def _beam_endpoints(p: ViewParams) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(endpoint cells [R,2], beam angles [R], origin offset) for sensor at
    base origin; a nonzero sensor offset shifts the origin pixel instead."""
    max_range = math.hypot(p.half, p.half)
    astep = abs(p.angle_end - p.angle_begin) / p.range_total
    angles = p.angle_begin + astep * np.arange(p.range_total)
    xb = max_range * np.cos(angles)
    yb = max_range * np.sin(angles)
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    # base2view = inverse of tf_view_base_ (see core/frames.py)
    xvv = c * xb + s * yb - (c * p.half + s * p.half)
    yvv = -s * xb + c * yb - (-s * p.half + c * p.half)
    cells = np.stack(
        [np.where(xvv >= 0, np.floor(xvv / p.resolution + 0.5), np.ceil(xvv / p.resolution - 0.5)),
         np.where(yvv >= 0, np.floor(yvv / p.resolution + 0.5), np.ceil(yvv / p.resolution - 0.5))],
        axis=-1,
    ).astype(np.int32)
    return cells, angles, max_range


def sensor_origin_cell(p: ViewParams, sensor_base=(0.0, 0.0)) -> np.ndarray:
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    sx, sy = sensor_base
    xv = c * sx + s * sy - (c * p.half + s * p.half)
    yv = -s * sx + c * sy - (-s * p.half + c * p.half)
    r = lambda v: int(np.floor(v / p.resolution + 0.5)) if v >= 0 else int(np.ceil(v / p.resolution - 0.5))
    return np.array([r(xv), r(yv)], np.int32)


# ---------------------------------------------------------------------------
# FOV fill
# ---------------------------------------------------------------------------


def fov_mask(p: ViewParams, sensor_base=(0.0, 0.0)) -> np.ndarray:
    """Static [hpx, wpx] bool: pixel passes the angle/range gates
    (agent.cpp:381-385).  Depends only on geometry, not on the scene."""
    xb, yb = _pixel_base_coords(p)
    ang = np.arctan2(yb - sensor_base[1], xb - sensor_base[0])
    return (
        (ang > p.angle_begin)
        & (ang < p.angle_end)
        & (xb >= p.min_dist)
        & (xb <= p.max_dist)
    )


def gather_world_occupancy(
    layers: OccupancyLayers,
    resolution: float,
    pose,                 # [3] robot world pose
    pix_base_x,           # [hpx,wpx] static base-frame pixel coords
    pix_base_y,
    robot_id1,            # scalar int32: 1-based id of the viewing robot
):
    """Composed occupancy (cell value < 250) per view pixel, excluding self.

    ONE gather from the id-packed int32 map (raster.build_layers encoding:
    bit0 = static/ped occupied, bits 1..2 = robot count capped at 2,
    bits 3.. = 1 + one covering robot's id) instead of four separate map
    gathers — the view fill is gather-bound.  Self-exclusion by id
    needs no second (own-footprint) gather: another robot covers a cell iff
    count >= 2, or count == 1 with a different id (the reference instead
    draws only robots j != i into robot i's map copy, img_env.cpp:620-629).
    """
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    wx = c * pix_base_x - s * pix_base_y + pose[0]
    wy = s * pix_base_x + c * pix_base_y + pose[1]
    cm = round_half_away(wx / resolution).astype(jnp.int32)
    cn = round_half_away(wy / resolution).astype(jnp.int32)
    h, w = layers.obs_map.shape
    inside = (cm >= 0) & (cm < h) & (cn >= 0) & (cn < w)
    cmc = jnp.clip(cm, 0, h - 1)
    cnc = jnp.clip(cn, 0, w - 1)

    packed = layers.packed[cmc, cnc]
    static_occ = (packed & 1) > 0
    cnt = (packed >> 1) & 3
    vid = (packed >> 3) & 0xFFF
    other_robot = (cnt >= 2) | ((cnt == 1) & (vid != robot_id1))

    return inside & (static_occ | other_robot), inside


# ---------------------------------------------------------------------------
# Exact vectorized Bresenham raycast
# ---------------------------------------------------------------------------


def _bresenham_cells(p: ViewParams, origin: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Static [R, S, 2] visited cells per beam + [R, S] validity.

    Closed form of the C++ midpoint walk (agent.cpp:511-624): with
    w = |x2-x1| > h = |y2-y1|, visit u has x = x1 + dx*u and
    y = y1 + dy*(floor((2*h*u - w) / (2*w)) + 1); the loop visits
    u in [0, w) (endpoint excluded).  Symmetric for the steep case.
    """
    ends, _, _ = _beam_endpoints(p)
    x1, y1 = int(origin[0]), int(origin[1])
    r = ends.shape[0]
    wv = ends[:, 0] - x1
    hv = ends[:, 1] - y1
    dx = np.where(wv > 0, 1, -1)
    dy = np.where(hv > 0, 1, -1)
    aw, ah = np.abs(wv), np.abs(hv)
    smax = int(max(aw.max(initial=1), ah.max(initial=1)))
    u = np.arange(smax)[None, :]                      # [1,S]

    flat = aw > ah
    major = np.where(flat, aw, ah)[:, None]           # [R,1]
    minor = np.where(flat, ah, aw)[:, None]
    dmaj = np.where(flat, dx, dy)[:, None]
    dmin = np.where(flat, dy, dx)[:, None]
    # guard minor==... major>0 always (beams leave the origin)
    off = np.floor_divide(2 * minor * u - major, 2 * major) + 1
    off = np.where(u == 0, 0, off)                    # u=0 -> offset 0
    maj_c = (np.where(flat, x1, y1)[:, None]) + dmaj * u
    min_c = (np.where(flat, y1, x1)[:, None]) + dmin * off
    xs = np.where(flat[:, None], maj_c, min_c)
    ys = np.where(flat[:, None], min_c, maj_c)
    valid = u < major
    return np.stack([xs, ys], axis=-1).astype(np.int32), valid


def beam_walk_tables(ls: "LaserStatics", p: ViewParams):
    """Static walk structure for the exact laser-map trace.

    Returns (eff [R,S] bool — samples the C++ loop actually visits (in-map
    and before the first out-of-map cell, agent.cpp:536,562), nxt [R,S]
    int32 — the first step after s whose MINOR coordinate differs).

    ``nxt`` encodes the post-hit skip rule: the major coordinate strictly
    increases along a walk (the for-loop increments it every iteration,
    agent.cpp:532/580), so ``cur != end`` can only fail on the minor axis —
    the skip set after a hit at step s is exactly the contiguous run
    [s+1, nxt[s]) sharing the hit cell's minor coordinate.
    """
    cells, valid = ls.cells, ls.valid
    r, s = valid.shape
    hpx, wpx = p.hpx, p.wpx
    inb = ((cells[..., 0] >= 0) & (cells[..., 0] < hpx)
           & (cells[..., 1] >= 0) & (cells[..., 1] < wpx))
    oob = valid & ~inb
    first_oob = np.where(oob.any(1), oob.argmax(1), s)
    eff = valid & inb & (np.arange(s)[None, :] < first_oob[:, None])

    ends, _, _ = _beam_endpoints(p)
    x1, y1 = int(ls.origin[0]), int(ls.origin[1])
    flat = np.abs(ends[:, 0] - x1) > np.abs(ends[:, 1] - y1)   # x is major
    minor = np.where(flat[:, None], cells[..., 1], cells[..., 0])

    big = np.int32(2 ** 14)
    nxt = np.full((r, s), big, np.int32)
    if s >= 2:
        change = minor[:, 1:] != minor[:, :-1]
        for k in range(s - 2, -1, -1):
            nxt[:, k] = np.where(change[:, k], k + 1, nxt[:, k + 1])
    return eff, nxt


class LaserStatics(NamedTuple):
    """Host-precomputed raycast geometry for one sensor placement."""

    cells: np.ndarray          # [R,S,2]
    valid: np.ndarray          # [R,S]
    dists: np.ndarray          # [R,S] world distance origin->cell center
    angles: np.ndarray         # [R]
    angular_bin: np.ndarray    # [R] int32
    origin: np.ndarray         # [2]

    @staticmethod
    def build(p: ViewParams, sensor_base=(0.0, 0.0)) -> "LaserStatics":
        origin = sensor_origin_cell(p, sensor_base)
        cells, valid = _bresenham_cells(p, origin)
        d = np.hypot(
            (cells[..., 0] - origin[0]).astype(np.float64) * p.resolution,
            (cells[..., 1] - origin[1]).astype(np.float64) * p.resolution,
        )
        _, angles, _ = _beam_endpoints(p)
        astep = abs(p.angle_end - p.angle_begin) / p.range_total
        ang_map_step = abs(p.angle_end - p.angle_begin) / ANGULAR_MAP_SIZE
        bins = (astep * np.arange(p.range_total) / ang_map_step).astype(np.int32)
        bins = np.clip(bins, 0, ANGULAR_MAP_SIZE - 1)
        return LaserStatics(
            cells=cells, valid=valid, dists=d, angles=angles,
            angular_bin=bins, origin=origin,
        )


def raycast(source_occ: jnp.ndarray, st: LaserStatics, p: ViewParams):
    """hits [R], angular_map [72], first-hit sample index [R] (or S)."""
    hpx, wpx = source_occ.shape
    cells = jnp.asarray(st.cells)
    inb = (
        (cells[..., 0] >= 0) & (cells[..., 0] < hpx)
        & (cells[..., 1] >= 0) & (cells[..., 1] < wpx)
    )
    occ = source_occ[
        jnp.clip(cells[..., 0], 0, hpx - 1), jnp.clip(cells[..., 1], 0, wpx - 1)
    ]
    valid = jnp.asarray(st.valid)
    s = cells.shape[1]
    # The C++ walk returns when it leaves the map: samples after the first
    # out-of-map cell never register hits.
    oob = valid & jnp.logical_not(inb)
    first_oob = jnp.where(jnp.any(oob, axis=1), jnp.argmax(oob, axis=1), s)
    hit_mask = valid & inb & occ
    first_hit = jnp.where(jnp.any(hit_mask, axis=1), jnp.argmax(hit_mask, axis=1), s)
    has_hit = first_hit < first_oob

    dists = jnp.asarray(st.dists)
    hit_d = jnp.take_along_axis(dists, jnp.minimum(first_hit, s - 1)[:, None], axis=1)[:, 0]
    hits = jnp.where(has_hit, hit_d, LASER_MISS_DIST)

    bins = jnp.asarray(st.angular_bin)
    angular = jnp.full((ANGULAR_MAP_SIZE,), p.max_dist, hits.dtype)
    angular = angular.at[bins].min(hits)
    first_hit = jnp.where(has_hit, first_hit, s)
    return hits, angular, first_hit


# ---------------------------------------------------------------------------
# Full per-robot view render
# ---------------------------------------------------------------------------


class ViewStatics(NamedTuple):
    pix_base_x: np.ndarray     # [hpx,wpx]
    pix_base_y: np.ndarray
    gates: np.ndarray          # [hpx,wpx] bool
    pix_rho: np.ndarray        # [hpx,wpx] distance sensor->pixel (view units)
    pix_beam: np.ndarray       # [hpx,wpx] int32 nearest beam index
    laser: LaserStatics
    eff: np.ndarray            # [R,S] bool — visited samples (beam_walk_tables)
    nxt: np.ndarray            # [R,S] int32 — post-hit minor-run end

    @staticmethod
    def build(p: ViewParams, sensor_base=(0.0, 0.0)) -> "ViewStatics":
        xb, yb = _pixel_base_coords(p)
        gates = fov_mask(p, sensor_base)
        st = LaserStatics.build(p, sensor_base)
        ox, oy = st.origin[0] * p.resolution, st.origin[1] * p.resolution
        i = np.arange(p.hpx)[:, None] * p.resolution
        j = np.arange(p.wpx)[None, :] * p.resolution
        rho = np.hypot(i - ox, j - oy)
        ang = np.arctan2(yb - sensor_base[1], xb - sensor_base[0])
        astep = abs(p.angle_end - p.angle_begin) / p.range_total
        beam = np.clip(
            np.floor((ang - p.angle_begin) / astep), 0, p.range_total - 1
        ).astype(np.int32)
        eff, nxt = beam_walk_tables(st, p)
        return ViewStatics(
            pix_base_x=xb, pix_base_y=yb, gates=gates, pix_rho=rho,
            pix_beam=beam, laser=st, eff=eff, nxt=nxt,
        )


def render_robot_view(
    layers: OccupancyLayers,
    resolution: float,
    pose,
    robot_id1,           # scalar int32: 1-based id of this robot
    own_view_cells,      # [P,2] int32 own footprint cells in *view* pixel space
    own_view_valid,      # [P]
    vs: ViewStatics,
    p: ViewParams,
):
    """One robot's view map + laser. Returns (view_u8, hits, angular)."""
    occ, inside = gather_world_occupancy(
        layers, resolution, pose,
        jnp.asarray(vs.pix_base_x), jnp.asarray(vs.pix_base_y),
        robot_id1,
    )
    gates = jnp.asarray(vs.gates)
    source_occ = gates & occ     # cells the reference writes 0 into

    if p.use_laser:
        hits, angular, first_hit = raycast(source_occ, vs.laser, p)
        # Exact per-ray trace (agent.cpp:511-624): the laser map is a fresh
        # all-200 canvas (the GridMap deep-copy happens right after
        # empty_map(), BEFORE the FOV fill — agent.cpp:370-371) painted by
        # the beams in index order; last writer wins, so a priority
        # scatter-max with key (beam << 2 | code) reproduces it bit-for-bit.
        cells = jnp.asarray(vs.laser.cells)                    # [R,S,2]
        eff = jnp.asarray(vs.eff)
        nxt = jnp.asarray(vs.nxt)
        r, s = eff.shape
        big = jnp.int32(2 ** 14)
        sh = jnp.where(first_hit < s, first_hit, big).astype(jnp.int32)
        stail = jnp.where(
            first_hit < s,
            nxt[jnp.arange(r), jnp.clip(first_hit, 0, s - 1)], big)
        s_ids = jnp.arange(s, dtype=jnp.int32)[None, :]
        code = jnp.where(
            s_ids < sh[:, None], 2,
            jnp.where(s_ids == sh[:, None], 3,
                      jnp.where(s_ids >= stail[:, None], 1, 0)))
        key = jnp.where(eff & (code > 0),
                        jnp.arange(r, dtype=jnp.int32)[:, None] * 4 + code,
                        -1)
        flat = jnp.where(eff, cells[..., 0] * p.wpx + cells[..., 1], 0)
        canvas = jnp.full((p.hpx * p.wpx,), -1, jnp.int32)
        canvas = canvas.at[flat.reshape(-1)].max(key.reshape(-1))
        c = canvas & 3
        val = jnp.where(
            canvas < 0, CELL_UNSEEN,
            jnp.where(c == 2, CELL_VIEW_FREE,
                      jnp.where(c == 3, 0, CELL_UNSEEN)),
        ).astype(jnp.uint8).reshape(p.hpx, p.wpx)
    else:
        hits = jnp.full((p.range_total,), LASER_MISS_DIST)
        angular = jnp.full((ANGULAR_MAP_SIZE,), p.max_dist)
        # no-laser fill: out-of-world pixels keep 200 (the is_in_map gate
        # wraps both writes, agent.cpp:392-401)
        val = jnp.where(
            source_occ, 0,
            jnp.where(gates & inside, CELL_VIEW_FREE, CELL_UNSEEN)
        ).astype(jnp.uint8)

    # Stamp own footprint (value 100, agent.cpp:503).  Agent::draw only
    # writes when the cell is not occupied (0/1/2 branch precedes the
    # ``value >= 0`` write, agent.cpp:315-322) — view cells are 0/200/255
    # here, so occupied (0) pixels keep their value.
    m = jnp.clip(own_view_cells[:, 0], 0, p.hpx - 1)
    n = jnp.clip(own_view_cells[:, 1], 0, p.wpx - 1)
    ob = (
        own_view_valid
        & (own_view_cells[:, 0] >= 0) & (own_view_cells[:, 0] < p.hpx)
        & (own_view_cells[:, 1] >= 0) & (own_view_cells[:, 1] < p.wpx)
    )
    cur = val[m, n]
    val = val.at[m, n].set(
        jnp.where(ob & (cur != 0), jnp.uint8(CELL_SELF_IN_VIEW), cur)
    )
    return val, hits, angular


def own_view_cells(bbox_points, bbox_mask, p: ViewParams):
    """Footprint cells in view-pixel space (static per robot shape).

    ``Agent::draw(view_map, 100, "view_map")`` transforms base-frame bbox
    points with base2view and quantizes (agent.cpp:307-311).
    """
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    xb, yb = bbox_points[..., 0], bbox_points[..., 1]
    xv = c * xb + s * yb - (c * p.half + s * p.half)
    yv = -s * xb + c * yb - (-s * p.half + c * p.half)
    r = lambda v: np.where(v >= 0, np.floor(v / p.resolution + 0.5), np.ceil(v / p.resolution - 0.5))
    return np.stack([r(xv), r(yv)], axis=-1).astype(np.int32), bbox_mask
