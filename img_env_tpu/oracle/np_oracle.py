"""Pure-NumPy oracle of the reference simulator's step semantics.

This module is the ground truth for the test suite: a small, slow, sequential
re-implementation of the behaviors documented in SURVEY.md §8, written
directly from the C++ semantics (file:line citations inline).  The engine's
on-device stages are validated against it stage-by-stage and end-to-end.

It deliberately mirrors the *reference*, not the engine — double
precision, sequential loops, mutable grids — so that any disagreement points
at the engine.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from img_env_tpu.constants import (
    ARRIVE_DIST,
    ANGULAR_MAP_SIZE,
    CELL_FREE_MIN,
    CELL_OBSTACLE,
    CELL_PED,
    CELL_ROBOT,
    CELL_SELF_IN_VIEW,
    CELL_UNSEEN,
    CELL_VIEW_FREE,
    LASER_MISS_DIST,
    SUBSTEP_DT,
    VIEW_YAW,
)

# ---------------------------------------------------------------------------
# Speed limiter (speed_limit.cpp:92-173)
# ---------------------------------------------------------------------------


@dataclass
class OracleLimiter:
    has_velocity_limits: bool = False
    has_acceleration_limits: bool = False
    has_jerk_limits: bool = False
    min_velocity: float = 0.0
    max_velocity: float = 0.0
    min_acceleration: float = 0.0
    max_acceleration: float = 0.0
    min_jerk: float = 0.0
    max_jerk: float = 0.0

    def limit(self, v: float, v0: float, v1: float, dt: float) -> float:
        v = self.limit_jerk(v, v0, v1, dt)
        v = self.limit_acceleration(v, v0, dt)
        v = self.limit_velocity(v)
        return v

    def limit_velocity(self, v: float) -> float:
        if self.has_velocity_limits:
            v = min(max(self.min_velocity, v), self.max_velocity)
        return v

    def limit_acceleration(self, v: float, v0: float, dt: float) -> float:
        if not self.has_acceleration_limits:
            return v
        sign = lambda x: 0 if x == 0 else (1 if x > 0 else -1)
        v_sign, v0_sign = sign(v), sign(v0)
        tmp = v
        if v_sign + v0_sign != 0:
            dv_min, dv_max = self.min_acceleration * dt, self.max_acceleration * dt
            dv = v - v0
            dv_sign = sign(dv)
            clamp = lambda x, lo, hi: min(max(lo, x), hi)
            if dv_sign == v0_sign or dv_sign == v_sign:
                dv = dv_sign * clamp(abs(dv), dv_min, dv_max)
            else:
                dv = dv_sign * abs(clamp(-abs(dv), dv_min, dv_max))
            v = v0 + dv
        else:
            zero_dt = abs(v0 / self.min_acceleration)
            if zero_dt >= dt:
                v = v0_sign * (abs(v0) - abs(self.min_acceleration) * dt)
            else:
                v_dt = abs(v / self.max_acceleration)
                if zero_dt + v_dt >= dt:
                    v = v_sign * abs(self.max_acceleration * (dt - zero_dt))
                else:
                    v = tmp
        return v

    def limit_jerk(self, v: float, v0: float, v1: float, dt: float) -> float:
        if not self.has_jerk_limits:
            return v
        dv, dv0 = v - v0, v0 - v1
        dt2 = 2.0 * dt * dt
        da = min(max(self.min_jerk * dt2, dv - dv0), self.max_jerk * dt2)
        return v0 + dv0 + da


# ---------------------------------------------------------------------------
# Grid map (grid_map.cpp)
# ---------------------------------------------------------------------------


class OracleGrid:
    def __init__(self, data: np.ndarray, resolution: float):
        self.map = np.array(data, dtype=np.uint8)
        self.resolution = resolution

    @staticmethod
    def empty(height_px: int, width_px: int, resolution: float) -> "OracleGrid":
        return OracleGrid(np.full((height_px, width_px), CELL_UNSEEN, np.uint8), resolution)

    def world2map(self, x: float, y: float) -> Tuple[int, int]:
        # C++ round() is round-half-away-from-zero (grid_map.cpp:40-44);
        # Python's round() is half-to-even, so emulate explicitly.
        def _r(v: float) -> int:
            return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))

        return _r(x / self.resolution), _r(y / self.resolution)

    def map2world(self, m: int, n: int) -> Tuple[float, float]:
        return m * self.resolution, n * self.resolution

    def in_map(self, m: int, n: int) -> bool:
        return 0 <= m < self.map.shape[0] and 0 <= n < self.map.shape[1]


# ---------------------------------------------------------------------------
# Robot kinematics (agent.cpp:186-283)
# ---------------------------------------------------------------------------


def oracle_cmd(
    pose: np.ndarray,
    goal: np.ndarray,
    v: float,
    w: float,
    v_y: float,
    last0: np.ndarray,
    last1: np.ndarray,
    limiter_v: OracleLimiter,
    limiter_w: OracleLimiter,
    step_hz: float,
    ktype: str = "diff",
):
    """Returns (pose, last0, last1, (vx, vy), arrive)."""
    v = limiter_v.limit(v, last0[0], last1[0], step_hz)
    w = limiter_w.limit(w, last0[1], last1[1], step_hz)
    last1 = last0.copy()
    last0 = np.array([v, w], np.float64)

    is_arrive = False
    ox, oy, oth = pose
    vx = vy = 0.0
    cur = 0.0
    while cur <= step_hz:
        if ktype == "diff":
            ox += v * SUBSTEP_DT * math.cos(oth)
            oy += v * SUBSTEP_DT * math.sin(oth)
            vx = v * math.cos(oth)
            vy = v * math.sin(oth)
        else:
            ox += v * SUBSTEP_DT * math.cos(oth) - v_y * SUBSTEP_DT * math.sin(oth)
            oy += v * SUBSTEP_DT * math.sin(oth) + v_y * SUBSTEP_DT * math.cos(oth)
        oth += w * SUBSTEP_DT
        if math.hypot(ox - goal[0], oy - goal[1]) <= ARRIVE_DIST:
            is_arrive = True
            break
        cur += SUBSTEP_DT

    x, y, theta = pose
    dt = step_hz
    if w == 0:
        x += v * dt * math.cos(theta)
        y += v * dt * math.sin(theta)
        if ktype == "omni":
            x += -v_y * dt * math.sin(theta)
            y += v_y * dt * math.cos(theta)
        theta += w * dt
    else:
        vw = v / w
        x += -vw * math.sin(theta) + vw * math.sin(theta + w * dt)
        y += vw * math.cos(theta) - vw * math.cos(theta + w * dt)
        if ktype == "omni":
            vyw = v_y / w
            x += -vyw * math.cos(theta) + vyw * math.cos(theta + w * dt)
            y += -vyw * math.sin(theta) + vyw * math.sin(theta + w * dt)
        theta += w * dt
    new_pose = np.array([x, y, theta], np.float64)
    if math.hypot(x - goal[0], y - goal[1]) <= ARRIVE_DIST:
        is_arrive = True
    return new_pose, last0, last1, (vx, vy), is_arrive


# ---------------------------------------------------------------------------
# Footprint draw + collision (agent.cpp:285-327)
# ---------------------------------------------------------------------------


def oracle_draw(
    grid: OracleGrid,
    pose: np.ndarray,
    bbox: np.ndarray,
    value: int,
    frame: str = "world_map",
    half_extent: float = 3.0,
) -> int:
    """Stamp a footprint; returns the reference collision code (last hit wins)."""
    is_collision = 0
    c, s = math.cos(pose[2]), math.sin(pose[2])
    for px, py in np.asarray(bbox, np.float64):
        if frame == "world_map":
            wx = c * px - s * py + pose[0]
            wy = s * px + c * py + pose[1]
        elif frame == "view_map":
            wx, wy = _base2view(px, py, half_extent)
        else:  # "map"
            wx, wy = px, py
        m, n = grid.world2map(wx, wy)
        if grid.in_map(m, n):
            cell = grid.map[m, n]
            if cell == CELL_OBSTACLE:
                is_collision = 1
            elif cell == CELL_PED:
                is_collision = 2
            elif cell == CELL_ROBOT:
                is_collision = 3
            elif value >= 0:
                grid.map[m, n] = value
    return is_collision


def oracle_draw_leg(
    grid: OracleGrid,
    pose: np.ndarray,
    left_bbox: np.ndarray,
    right_bbox: np.ndarray,
    left_offset: Tuple[float, float],
    right_offset: Tuple[float, float],
    value: int,
) -> bool:
    """PedAgent::draw_leg (agent.cpp:737-774).

    Quirk preserved: the left leg refuses to overwrite obstacle cells (==0)
    while the right leg overwrites *anything* that is not already a ped cell.
    """
    is_collision = False
    c, s = math.cos(pose[2]), math.sin(pose[2])
    for px, py in np.asarray(left_bbox, np.float64):
        bx, by = px + left_offset[0], py + left_offset[1]
        wx = c * bx - s * by + pose[0]
        wy = s * bx + c * by + pose[1]
        m, n = grid.world2map(wx, wy)
        if grid.in_map(m, n):
            if grid.map[m, n] == CELL_OBSTACLE:
                is_collision = True
            elif value >= 0:
                grid.map[m, n] = value
    for px, py in np.asarray(right_bbox, np.float64):
        bx, by = px + right_offset[0], py + right_offset[1]
        wx = c * bx - s * by + pose[0]
        wy = s * bx + c * by + pose[1]
        m, n = grid.world2map(wx, wy)
        if grid.in_map(m, n):
            if grid.map[m, n] == CELL_PED:
                is_collision = True
            elif value >= 0:
                grid.map[m, n] = value
    return is_collision


def oracle_compose_scene(
    static_map: np.ndarray,
    resolution: float,
    obstacles: list,   # [(pose[3], bbox[P,2])]
    peds: list,        # [(pose[3], kind, payload)] kind in {"circle","leg"}
                       # circle payload: bbox; leg payload: (lb, rb, loff, roff)
    robots: list,      # [(pose[3], bbox[P,2])]
):
    """Replicates _reset obstacle draw + view_ped + view_robot layer stack
    (img_env.cpp:169-193, 594-629).  Returns (obs_map, peds_map,
    per-robot global maps)."""
    obs_grid = OracleGrid(static_map, resolution)
    for pose, bbox in obstacles:
        oracle_draw(obs_grid, pose, bbox, 0, "world_map")
    peds_grid = OracleGrid(obs_grid.map.copy(), resolution)
    for pose, kind, payload in peds:
        if kind == "circle":
            oracle_draw(peds_grid, pose, payload, CELL_PED, "world_map")
        else:
            lb, rb, loff, roff = payload
            oracle_draw_leg(peds_grid, pose, lb, rb, loff, roff, CELL_PED)
    robot_maps = []
    for i in range(len(robots)):
        g = OracleGrid(peds_grid.map.copy(), resolution)
        for j, (pose, bbox) in enumerate(robots):
            if j != i:
                oracle_draw(g, pose, bbox, CELL_ROBOT, "world_map")
        robot_maps.append(g)
    return obs_grid, peds_grid, robot_maps


# ---------------------------------------------------------------------------
# Egocentric view + laser (agent.cpp:356-509, 511-624)
# ---------------------------------------------------------------------------


def _base2view(xb: float, yb: float, half: float) -> Tuple[float, float]:
    # tf_base_view_ = (tf_view_base_)^-1 with tf_view_base_ = {yaw VIEW_YAW,
    # origin (half, half)} (agent.cpp:84-98).
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    vx = c * xb + s * yb - (c * half + s * half)
    vy = -s * xb + c * yb - (-s * half + c * half)
    return vx, vy


def _view2base(xv: float, yv: float, half: float) -> Tuple[float, float]:
    # tf_view_base_ applied directly (agent.cpp:100-106).
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    return c * xv - s * yv + half, s * xv + c * yv + half


def oracle_bresenham(
    x1: int, y1: int, x2: int, y2: int, source: OracleGrid, target: OracleGrid
) -> float:
    """Integer Bresenham walk writing the visibility trace (agent.cpp:511-624)."""
    hit = LASER_MISS_DIST
    x0w, y0w = target.map2world(x1, y1)
    w, h = x2 - x1, y2 - y1
    dx = 1 if w > 0 else -1
    dy = 1 if h > 0 else -1
    w, h = abs(w), abs(h)
    line_end = False
    end_x = end_y = -1

    def visit(x, y):
        nonlocal hit, line_end, end_x, end_y
        if not source.in_map(x, y):
            return False
        cur = source.map[x, y]
        if not line_end:
            if cur != 0:
                target.map[x, y] = CELL_VIEW_FREE
            elif end_x == -1:
                target.map[x, y] = 0
                line_end = True
                end_x, end_y = x, y
                cx, cy = target.map2world(x, y)
                hit = math.hypot(x0w - cx, y0w - cy)
        else:
            if x != end_x and y != end_y:
                target.map[x, y] = CELL_UNSEEN
        return True

    if w > h:
        f = 2 * h - w
        d1, d2 = 2 * h, (h - w) * 2
        x, y = x1, y1
        while x != x2:
            if not visit(x, y):
                return hit
            if f < 0:
                f += d1
            else:
                y += dy
                f += d2
            x += dx
    else:
        f = 2 * w - h
        d1, d2 = w * 2, (w - h) * 2
        x, y = x1, y1
        while y != y2:
            if not visit(x, y):
                return hit
            if f < 0:
                f += d1
            else:
                x += dx
                f += d2
            y += dy
    return hit


@dataclass
class OracleViewResult:
    view_map: np.ndarray
    hits: np.ndarray
    hit_points: np.ndarray
    angular_map: np.ndarray
    is_collision: int


def oracle_view(
    world_grid: OracleGrid,
    pose: np.ndarray,
    bbox: np.ndarray,
    sensor_base: Tuple[float, float] = (0.0, 0.0),
    view_size_m: Tuple[float, float] = (6.0, 6.0),
    view_resolution: float = 0.015,
    view_angle_begin: float = -1.570795,
    view_angle_end: float = 1.570795,
    view_min_dist: float = 0.0,
    view_max_dist: float = 10.0,
    use_laser: bool = True,
    range_total: int = 960,
) -> OracleViewResult:
    """Agent::view — collision draw, FOV fill, raycast, self-stamp."""
    width_m, height_m = view_size_m
    wpx = int(width_m / view_resolution)
    hpx = int(height_m / view_resolution)
    half = height_m / 2.0

    is_collision = oracle_draw(world_grid, pose, bbox, -1, "world_map")

    view = OracleGrid.empty(hpx, wpx, view_resolution)
    x0v, y0v = _base2view(sensor_base[0], sensor_base[1], half)
    x0i, y0i = view.world2map(x0v, y0v)

    c, s = math.cos(pose[2]), math.sin(pose[2])
    cv, sv = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    for i in range(hpx):
        for j in range(wpx):
            xv, yv = view.map2world(i, j)
            xb, yb = _view2base(xv, yv, half)
            ang = math.atan2(yb - sensor_base[1], xb - sensor_base[0])
            if (
                ang <= view_angle_begin
                or ang >= view_angle_end
                or xb < view_min_dist
                or xb > view_max_dist
            ):
                continue
            # view->world via tf_view_world = world_from_base * base_from_view
            wx = c * xb - s * yb + pose[0]
            wy = s * xb + c * yb + pose[1]
            m, n = world_grid.world2map(wx, wy)
            if world_grid.in_map(m, n):
                if world_grid.map[m, n] < CELL_FREE_MIN:
                    view.map[i, j] = 0
                else:
                    view.map[i, j] = CELL_VIEW_FREE

    hits: List[float] = []
    hpts: List[Tuple[float, float]] = []
    angular = [view_max_dist] * ANGULAR_MAP_SIZE
    if use_laser:
        laser_grid = OracleGrid(view.map.copy(), view_resolution)
        laser_grid.map[:] = CELL_UNSEEN  # GridMap copy happens pre-fill... see note
        # NOTE: the reference copies view_map_ into laser_map right after
        # empty_map() (agent.cpp:371), i.e. laser_map starts all-200, then
        # bresenham writes the trace into it and finally view_map_=laser_map.
        max_range = math.hypot(half, half)
        angle_step = abs(view_angle_end - view_angle_begin) / range_total
        ang_map_step = abs(view_angle_end - view_angle_begin) / ANGULAR_MAP_SIZE
        for k in range(range_total):
            cur_angle = view_angle_begin + angle_step * k
            ai = int(angle_step * k / ang_map_step)
            xb = max_range * math.cos(cur_angle)
            yb = max_range * math.sin(cur_angle)
            xv, yv = _base2view(xb, yb, half)
            xi, yi = view.world2map(xv, yv)
            hit = oracle_bresenham(x0i, y0i, xi, yi, view, laser_grid)
            hits.append(hit)
            if hit < angular[ai]:
                angular[ai] = hit
            hpts.append((hit * math.cos(cur_angle), hit * math.sin(cur_angle)))
        view = laser_grid

    oracle_draw(view, pose, bbox, CELL_SELF_IN_VIEW, "view_map", half)

    return OracleViewResult(
        view_map=view.map,
        hits=np.array(hits, np.float64),
        hit_points=np.array(hpts, np.float64) if hpts else np.zeros((0, 2)),
        angular_map=np.array(angular, np.float64),
        is_collision=is_collision,
    )
