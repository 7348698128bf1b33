"""Typed configuration tree.

The loader accepts the reference project's yaml files unchanged (same field
names as envs/cfg/test.yaml; schema mirrored from envs/env/yaml_env.py:133-181
and envs/utils/reset_helper.py), so existing experiment configs port directly.

On top of the reference schema we add engine fields (all optional, with
defaults chosen to match reference behavior):

  * ``num_scenes``      — batched independent scenes per device (replaces the
                           reference's one-ROS-node-per-scene parallelism).
  * ``sensor_mode``     — 'parity' renders the 400x400 view then cubic-resizes
                           like the reference; 'fast' renders the egocentric
                           window directly at the output resolution.
  * ``max_obs_segments``— cap on ORCA obstacle segments considered per agent.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

_DEF_MAP_DIR = os.path.join(os.path.dirname(__file__), "maps")


def _pad_list(lst: Sequence, n: int, pad_with_last: bool = True) -> list:
    lst = list(lst)
    if len(lst) >= n:
        return lst[:n]
    if not lst:
        raise ValueError("empty per-agent list cannot be padded")
    return lst + [lst[-1]] * (n - len(lst))


def _deep_tuple(x):
    """Recursively freeze nested pose lists — ``*_multi`` pose types carry a
    LIST of candidate regions per agent (reset_helper.py:239,274), so a pose
    entry may itself be a list of 4/6-element boxes."""
    if isinstance(x, (list, tuple)):
        return tuple(_deep_tuple(v) for v in x)
    return x


@dataclass(frozen=True)
class SpeedLimiterConfig:
    """ros_controllers-style limiter params (speed_limit.h:44-128)."""

    has_velocity_limits: bool = False
    has_acceleration_limits: bool = False
    has_jerk_limits: bool = False
    min_velocity: float = 0.0
    max_velocity: float = 0.6
    min_acceleration: float = -2.0
    max_acceleration: float = 2.0
    min_jerk: float = -2.0
    max_jerk: float = 2.0

    @staticmethod
    def from_dict(d: Optional[dict], default_min_v: float, default_max_v: float) -> "SpeedLimiterConfig":
        d = d or {}
        return SpeedLimiterConfig(
            has_velocity_limits=d.get("has_velocity_limits", False),
            has_acceleration_limits=d.get("has_acceleration_limits", False),
            has_jerk_limits=d.get("has_jerk_limits", False),
            min_velocity=d.get("min_velocity", default_min_v),
            max_velocity=d.get("max_velocity", default_max_v),
            min_acceleration=d.get("min_acceleration", -2.0),
            max_acceleration=d.get("max_acceleration", 2.0),
            min_jerk=d.get("min_jerk", -2.0),
            max_jerk=d.get("max_jerk", 2.0),
        )


@dataclass(frozen=True)
class RobotConfig:
    total: int = 1
    shape: Tuple[str, ...] = ("circle",)
    size: Tuple[Tuple[float, ...], ...] = (((0.0, 0.0, 0.17)),)
    begin_poses_type: Tuple[str, ...] = ("range",)
    begin_poses: Tuple[Any, ...] = ((0.5, 9.5, 0.5, 9.5),)
    target_poses_type: Tuple[str, ...] = ("range",)
    target_poses: Tuple[Any, ...] = ((0.5, 9.5, 0.5, 9.5),)
    sensor_cfgs: Tuple[Tuple[float, float], ...] = ((0.0, 0.0),)

    @staticmethod
    def from_dict(d: dict) -> "RobotConfig":
        n = int(d.get("total", 1))
        sensor = d.get("sensor_cfgs") or [[0.0, 0.0]]
        return RobotConfig(
            total=n,
            shape=tuple(_pad_list(d.get("shape", ["circle"]), n)),
            size=tuple(tuple(s) for s in _pad_list(d.get("size", [[0, 0, 0.17]]), n)),
            begin_poses_type=tuple(_pad_list(d.get("begin_poses_type", ["range"]), n)),
            begin_poses=_deep_tuple(_pad_list(d.get("begin_poses", [[0.5, 9.5, 0.5, 9.5]]), n)),
            target_poses_type=tuple(_pad_list(d.get("target_poses_type", ["range"]), n)),
            target_poses=_deep_tuple(_pad_list(d.get("target_poses", [[0.5, 9.5, 0.5, 9.5]]), n)),
            sensor_cfgs=tuple(tuple(s) for s in _pad_list(sensor, n)),
        )


@dataclass(frozen=True)
class ObjectConfig:
    total: int = 0
    shape: Tuple[str, ...] = ()
    size_range: Tuple[Tuple[float, ...], ...] = ()
    poses_type: Tuple[str, ...] = ()
    poses: Tuple[Any, ...] = ()

    @staticmethod
    def from_dict(d: Optional[dict]) -> "ObjectConfig":
        d = d or {}
        n = int(d.get("total", 0))
        if n == 0:
            return ObjectConfig()
        return ObjectConfig(
            total=n,
            shape=tuple(_pad_list(d.get("shape", ["circle"]), n)),
            size_range=tuple(tuple(s) for s in _pad_list(d.get("size_range", [[0.3, 0.3]]), n)),
            poses_type=tuple(_pad_list(d.get("poses_type", ["range"]), n)),
            poses=tuple(tuple(p) for p in _pad_list(d.get("poses", [[0.5, 9.5, 0.5, 9.5]]), n)),
        )


@dataclass(frozen=True)
class PedSimConfig:
    total: int = 0
    type: str = "rvoscene"  # pedscene | rvoscene | ervoscene | dataset | ''
    max_speed: Tuple[float, ...] = ()
    shape: Tuple[str, ...] = ()
    size: Tuple[Tuple[float, ...], ...] = ()
    begin_poses_type: Tuple[str, ...] = ()
    begin_poses: Tuple[Any, ...] = ()
    target_poses_type: Tuple[str, ...] = ()
    target_poses: Tuple[Any, ...] = ()
    go_back: str = "yes"
    ignore_obstacle: bool = False
    # Scripted per-ped waypoint lists [(x, y[, r]), ...] — the reference's
    # ``Agent.trajectory`` channel (img_env.cpp:220-250, cycled by
    # agent.cpp:839-843; r is the pedsim waypoint radius, pedscene.h:39-47).
    # Peds with an empty list use the sampled goal (+ return when go_back).
    waypoints: Tuple[Any, ...] = ()

    @staticmethod
    def from_dict(d: Optional[dict]) -> "PedSimConfig":
        d = d or {}
        n = int(d.get("total", 0))
        if n == 0:
            return PedSimConfig(total=0, type=d.get("type", "rvoscene"))
        return PedSimConfig(
            total=n,
            type=d.get("type", "rvoscene"),
            max_speed=tuple(_pad_list(d.get("max_speed", [0.5]), n)),
            shape=tuple(_pad_list(d.get("shape", ["circle"]), n)),
            size=tuple(tuple(s) for s in _pad_list(d.get("size", [[0, 0, 0.17]]), n)),
            begin_poses_type=tuple(_pad_list(d.get("begin_poses_type", ["range"]), n)),
            begin_poses=_deep_tuple(_pad_list(d.get("begin_poses", [[0.5, 9.5, 0.5, 9.5]]), n)),
            target_poses_type=tuple(_pad_list(d.get("target_poses_type", ["range"]), n)),
            target_poses=_deep_tuple(_pad_list(d.get("target_poses", [[0.5, 9.5, 0.5, 9.5]]), n)),
            go_back=d.get("go_back", "yes"),
            ignore_obstacle=bool(d.get("ignore_obstacle", False)),
            waypoints=_deep_tuple(_pad_list(d.get("waypoints", [[]]), n)),
        )


@dataclass(frozen=True)
class EnvConfig:
    # --- experiment identity -------------------------------------------------
    env_name: str = "test"
    cfg_name: str = "test"
    env_type: str = "robot_nav"
    robot_type: str = "diff"          # diff | omni
    test: bool = False
    cfg_type: str = "yaml"            # 'yaml' | 'bag': fixed-scenario replay
    init_pose_bag_name: str = ""      # ScenarioBank npz (record or replay)
    init_pose_bag_episodes: int = 0   # episodes in a generated bank

    # --- timing & episode ----------------------------------------------------
    control_hz: float = 0.4           # seconds of sim time per control step
    time_max: int = 100

    # --- geometry ------------------------------------------------------------
    robot_radius: float = 0.17
    ped_leg_radius: float = 0.1
    ped_safety_space: float = 0.7
    laser_max: float = 6.0
    laser_norm: bool = True

    # --- observation sizes ---------------------------------------------------
    image_batch: int = 1
    image_size: Tuple[int, int] = (48, 48)
    ped_image_size: Tuple[int, int] = (48, 48)
    state_batch: int = 3
    state_dim: int = 3
    state_normalize: bool = False
    laser_batch: int = 0
    act_dim: int = 2
    max_ped: int = 10
    ped_vec_dim: int = 7
    ped_image_r: float = 0.3

    # --- actions -------------------------------------------------------------
    discrete_action: bool = False
    discrete_actions: Tuple[Tuple[float, ...], ...] = ()
    continuous_actions: Tuple[Tuple[float, float], ...] = ((0.0, 0.6), (-0.9, 0.9))

    # --- sensor / view params (InitEnv scalars) ------------------------------
    use_laser: bool = True
    range_total: int = 1000
    view_angle_begin: float = -1.570795
    view_angle_end: float = 1.570795
    view_min_dist: float = 0.0
    view_max_dist: float = 10.0
    beep_r: float = 1.0
    ped_ca_p: float = 1.0
    relation_ped_robo: int = 1

    # --- maps ----------------------------------------------------------------
    map_file: str = "room_10.png"
    global_resolution: float = 0.1
    view_map_resolution: float = 0.015
    view_map_size: Tuple[float, float] = (6.0, 6.0)  # (width, height) meters

    # --- scenario sampling ---------------------------------------------------
    circle_ranges: Tuple[float, float] = (1.8, 2.0)
    target_min_dist: float = 1.0

    # --- external-sim frontend (gazebo_env.py:222-225) -----------------------
    start_global_pose: Tuple[float, ...] = (0.0, 0.0, 0.0)
    target_global_pose: Tuple[float, ...] = (0.0, 10.0)

    # --- ETH/UCY trajectory replay (PedTrajectoryDatasetWrapper surface) -----
    # Reference cfg keys kept verbatim (PedTrajectoryDatasetWrapper.py:92-110):
    # a csv path enables config-driven dataset replay; worlds are
    # (start_idx, end_idx) ped-id spans advanced every
    # ``repeated_time_per_env`` episodes.
    ped_traj_dataset: str = ""
    ped_dataset_worlds: Tuple[Tuple[int, int], ...] = ((0, 9),)
    ped_dataset_swapxy: bool = True
    ped_dataset_offset: Tuple[float, float, float] = (1.4, 14.4, 0.0)
    ped_dataset_fps: int = 15
    ped_dataset_start_t: float = 0.0
    ped_dataset_max_time: float = 20.0
    ped_dataset_scale: Tuple[float, float] = (1.0, 1.0)
    repeated_time_per_env: int = 10

    # --- sub-configs ---------------------------------------------------------
    robot: RobotConfig = field(default_factory=RobotConfig)
    object: ObjectConfig = field(default_factory=ObjectConfig)
    ped_sim: PedSimConfig = field(default_factory=PedSimConfig)
    speed_limiter_v: SpeedLimiterConfig = field(default_factory=lambda: SpeedLimiterConfig.from_dict(None, 0.0, 0.6))
    speed_limiter_w: SpeedLimiterConfig = field(default_factory=lambda: SpeedLimiterConfig.from_dict(None, -0.9, 0.9))

    # --- wrapper stack (reference names, applied innermost-first) ------------
    wrapper: Tuple[str, ...] = ()

    # --- engine extensions --------------------------------------------------
    num_scenes: int = 1               # batched scenes per program instance
    sensor_mode: str = "parity"       # 'parity' | 'fast' | 'reference'
    fast_sensor_scale: int = 3        # 'fast': view grid coarsened 3x (9x
                                      #   fewer gathers; lasers quantized to
                                      #   scale*view_resolution)
    max_obs_segments: int = 32        # ORCA obstacle segments per agent
                                      #   (kd-tree SPLITTING can ~double the
                                      #   per-agent segment count; 32 keeps
                                      #   the nearest-K filter non-binding
                                      #   on the test layouts)
    reset_trials: int = 64            # bounded rejection-sampling trials
    reset_redraws: int = 10           # whole-scenario re-draws when a sample
                                      #   reports ok=False (reference re-rolls
                                      #   circle layouts after 50 fails and
                                      #   retries reset <=10x,
                                      #   reset_helper.py:251-258,
                                      #   yaml_env.py:304-311)
    map_dir: str = _DEF_MAP_DIR

    # ------------------------------------------------------------------------
    @property
    def ped_image_resolution(self) -> float:
        # yaml_env.py:164 — 6 m window over the ped image.
        return 6.0 / self.ped_image_size[0]

    @property
    def view_pixels(self) -> Tuple[int, int]:
        # grid_map-style integer truncation (agent.cpp:82-83)
        return (
            int(self.view_map_size[1] / self.view_map_resolution),
            int(self.view_map_size[0] / self.view_map_resolution),
        )

    @property
    def n_substeps(self) -> int:
        """Iteration count of the C++ substep loop (agent.cpp:201-219).

        The reference accumulates ``cur += 0.05`` in doubles and loops while
        ``cur <= step_hz``; we simulate the same float accumulation so the
        count matches exactly for any control_hz.
        """
        from img_env_tpu.constants import SUBSTEP_DT

        cur, n = 0.0, 0
        while cur <= self.control_hz:
            n += 1
            cur += SUBSTEP_DT
        return n

    def resolve_map_path(self) -> str:
        for base in (self.map_dir, _DEF_MAP_DIR):
            p = os.path.join(base, self.map_file)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"map file {self.map_file!r} not found in {self.map_dir}")

    def replace(self, **kw) -> "EnvConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------------
    @staticmethod
    def from_dict(raw: dict) -> "EnvConfig":
        gm = raw.get("global_map", {}) or {}
        vm = raw.get("view_map", {}) or {}
        kw: dict = {}
        simple_fields = [
            "env_name", "cfg_name", "env_type", "robot_type", "test",
            "cfg_type", "init_pose_bag_name", "init_pose_bag_episodes",
            "control_hz", "time_max", "robot_radius", "ped_leg_radius",
            "ped_safety_space", "laser_max", "laser_norm", "image_batch",
            "state_batch", "state_dim", "state_normalize", "laser_batch",
            "act_dim", "max_ped", "ped_vec_dim", "ped_image_r",
            "discrete_action", "use_laser", "range_total",
            "view_angle_begin", "view_angle_end", "view_min_dist",
            "view_max_dist", "beep_r", "ped_ca_p", "relation_ped_robo",
            "target_min_dist", "num_scenes", "sensor_mode",
            "fast_sensor_scale", "max_obs_segments",
            "reset_trials",
            "reset_redraws", "map_dir",
        ]
        for f in simple_fields:
            if f in raw and raw[f] is not None:
                kw[f] = raw[f]
        if "image_size" in raw:
            kw["image_size"] = tuple(raw["image_size"])
        if "ped_image_size" in raw:
            kw["ped_image_size"] = tuple(raw["ped_image_size"])
        if "circle_ranges" in raw:
            kw["circle_ranges"] = tuple(raw["circle_ranges"])
        if "start_global_pose" in raw:
            kw["start_global_pose"] = tuple(raw["start_global_pose"])
        if "target_global_pose" in raw:
            kw["target_global_pose"] = tuple(raw["target_global_pose"])
        if "discrete_actions" in raw:
            kw["discrete_actions"] = tuple(tuple(a) for a in raw["discrete_actions"])
        if "continuous_actions" in raw:
            kw["continuous_actions"] = tuple(tuple(a) for a in raw["continuous_actions"])
        if "wrapper" in raw and raw["wrapper"]:
            kw["wrapper"] = tuple(raw["wrapper"])
        if raw.get("ped_traj_dataset"):
            # reference key names at the cfg top level
            # (PedTrajectoryDatasetWrapper._read_dataset)
            kw["ped_traj_dataset"] = str(raw["ped_traj_dataset"])
            kw["ped_dataset_swapxy"] = bool(raw.get("swapxy", True))
            kw["ped_dataset_offset"] = tuple(raw.get("offset", (1.4, 14.4, 0.0)))
            kw["ped_dataset_fps"] = int(raw.get("fps", 15))
            kw["ped_dataset_start_t"] = float(raw.get("start_t", 0.0))
            kw["ped_dataset_max_time"] = float(raw.get("max_time", 20.0))
            kw["ped_dataset_scale"] = (float(raw.get("scale_x", 1.0)),
                                       float(raw.get("scale_y", 1.0)))
            kw["ped_dataset_worlds"] = tuple(
                tuple(int(v) for v in w)
                for w in raw.get("ped_dataset_worlds", ((0, 9),)))
            kw["repeated_time_per_env"] = int(
                raw.get("repeated_time_per_env", 10))
        kw["map_file"] = gm.get("map_file", "room_10.png")
        kw["global_resolution"] = gm.get("resolution", 0.1)
        kw["view_map_resolution"] = vm.get("resolution", 0.015)
        kw["view_map_size"] = (vm.get("width", 6.0), vm.get("height", 6.0))
        kw["robot"] = RobotConfig.from_dict(raw.get("robot", {}) or {})
        kw["object"] = ObjectConfig.from_dict(raw.get("object"))
        ped_raw = dict(raw.get("ped_sim", {}) or {})
        if kw.get("ped_traj_dataset"):
            # the reference sets ped_sim.total from the active world's span
            # (PedTrajectoryDatasetWrapper.py:28); static shapes here mean
            # padding to the LARGEST world, so every world's peds fit
            max_span = max(int(e) - int(s) + 1
                           for s, e in kw["ped_dataset_worlds"])
            ped_raw["total"] = max(int(ped_raw.get("total", 0)), max_span)
        kw["ped_sim"] = PedSimConfig.from_dict(ped_raw)
        kw["speed_limiter_v"] = SpeedLimiterConfig.from_dict(raw.get("speed_limiter_v"), 0.0, 0.6)
        kw["speed_limiter_w"] = SpeedLimiterConfig.from_dict(raw.get("speed_limiter_w"), -0.9, 0.9)
        return EnvConfig(**kw)

    @staticmethod
    def from_yaml(path: str) -> "EnvConfig":
        return EnvConfig.from_dict(read_yaml(path))


def read_yaml(path: str) -> dict:
    """Reference-compatible raw yaml reader (envs/__init__.py:9-18)."""
    import yaml   # only config files need it; the simulator does not

    with open(path, "r", encoding="utf-8") as f:
        return yaml.load(f.read(), Loader=yaml.FullLoader)
