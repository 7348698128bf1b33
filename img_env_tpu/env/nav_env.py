"""The core navigation environment: jitted, functional reset/step.

One ``NavEnv`` owns the host-built static data (maps, footprints, sampler
spec, sensor geometry) and exposes pure functions over ``WorldState``:

    state, obs = env.reset(key)
    state, obs, reward, done, info = env.step(state, actions)

Everything inside runs in one XLA program per call — the reference's
Python <-> ROS <-> C++ round trip per step (SURVEY.md §3.3) collapses into a
single on-device step.  Batch over scenes with ``jax.vmap`` (see
parallel/sharded_env.py for the mesh version).

Step pipeline (ordering matches ImgEnv::_step, img_env.cpp:421-525):
  crowd step -> robot kinematics -> occupancy layers -> collision codes ->
  egocentric views + laser -> observation assembly -> reward/done.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from img_env_tpu.config import EnvConfig
from img_env_tpu.constants import ARRIVE_DIST
from img_env_tpu.core.state import (
    CrowdAuxState,
    Observation,
    ObstacleState,
    PedState,
    RobotState,
    WorldState,
)
from img_env_tpu.crowd import common as crowd_common
from img_env_tpu.crowd import gait as gait_mod
from img_env_tpu.crowd import orca as orca_mod
from img_env_tpu.crowd import sfm as sfm_mod
from img_env_tpu.dynamics.kinematics import batched_robot_cmd
from img_env_tpu.dynamics.limiter import LimiterParams
from img_env_tpu.env import maps as maps_mod
from img_env_tpu.env import observe, rewards
from img_env_tpu.env.sampler import (
    SamplerSpec,
    obstacle_corners,
    sample_scenario_retry,
)
from img_env_tpu.ops import painter as painter_mod
from img_env_tpu.ops import polar as polar_mod
from img_env_tpu.ops import raster
from img_env_tpu.ops.footprint import circle_points, rectangle_points
from img_env_tpu.ops.resize import sensor_map_from_view
from img_env_tpu.ops.view import (
    ViewParams,
    ViewStatics,
    own_view_cells,
    render_robot_view,
)


def _pad_clouds(clouds):
    pmax = max(max((c.shape[0] for c in clouds), default=1), 1)
    pts = np.zeros((len(clouds), pmax, 2), np.float32)
    msk = np.zeros((len(clouds), pmax), bool)
    for i, c in enumerate(clouds):
        pts[i, : c.shape[0]] = c
        msk[i, : c.shape[0]] = True
    return pts, msk


class SensorGroup(NamedTuple):
    """One distinct per-robot sensor placement (reset_helper.py:383-384:
    ``sensor_cfgs[j]`` per robot; agent.cpp:367-381 ``sensor_base_``).

    Robots sharing a sensor config share one polar/painter pipeline; a
    heterogeneous team runs one flat batch per group and stitches the
    results back in robot order (NavEnv._sensor_pass)."""

    idx: np.ndarray                # [k] member robot indices (global)
    sensor: Tuple[float, float]    # laser mount offset in the base frame
    view_statics: "ViewStatics"
    polar: "polar_mod.PolarStatics"
    painter: object                # PainterStatics or None
    own_view_cells: np.ndarray     # [k,P,2]
    own_view_valid: np.ndarray     # [k,P]
    own_slots: np.ndarray          # [k,P]
    own_slots_ok: np.ndarray       # [k,P]


class EnvStatics(NamedTuple):
    """Host-precomputed constants closed over by the jitted functions."""

    static_map: np.ndarray
    resolution: float
    robot_points: np.ndarray       # [N,P,2]
    robot_mask: np.ndarray         # [N,P]
    robot_radius: np.ndarray       # [N] last size element (for ped vectors)
    ped_body_points: np.ndarray    # [M,Q,2] circle-ped bodies
    ped_body_mask: np.ndarray
    ped_left_points: np.ndarray    # [M,L,2] leg clouds at leg-frame origin
    ped_left_mask: np.ndarray
    ped_right_points: np.ndarray
    ped_right_mask: np.ndarray
    ped_rest_left: np.ndarray      # [M,2] configured leg offsets
    ped_rest_right: np.ndarray
    ped_is_leg: np.ndarray         # [M]
    ped_r: np.ndarray              # [M] body radius, rounded 2dp
    ped_max_speed: np.ndarray      # [M]
    ped_wp_xy: np.ndarray          # [M,W,2] scripted waypoints (pad 0)
    ped_wp_r: np.ndarray           # [M,W] pedsim waypoint radii
    ped_wp_count: np.ndarray       # [M] scripted count (0 -> goal/go_back)
    obs_points: np.ndarray         # [O,P,2]
    obs_point_dist: np.ndarray     # [O,P]
    obs_base_mask: np.ndarray      # [O,P]
    obs_is_circle: np.ndarray      # [O]
    view_params: ViewParams
    view_statics: ViewStatics
    polar: polar_mod.PolarStatics  # matmul sensor pipeline (default path)
    own_view_cells: np.ndarray     # [N,P,2]
    own_view_valid: np.ndarray     # [N,P]
    own_slots: np.ndarray          # [N,P] sorted-slot footprint stamps
    own_slots_ok: np.ndarray       # [N,P]
    sampler: SamplerSpec
    limiter_v: LimiterParams
    limiter_w: LimiterParams
    orca_cfg: orca_mod.OrcaConfig
    painter: object = None         # painter_mod.PainterStatics (laser decode)
    # distinct sensor placements; the legacy fields above mirror group 0
    # (the only group for homogeneous teams — the common case)
    sensor_groups: Tuple[SensorGroup, ...] = ()


def build_statics(cfg: EnvConfig) -> EnvStatics:
    static_map = maps_mod.load_static_map(cfg)
    res = float(cfg.view_map_resolution)

    n, m, o = cfg.robot.total, cfg.ped_sim.total, cfg.object.total
    if n >= 4096:
        # the id-packed sensor map carries robot ids <= 4095
        # (ops/raster.py bit layout)
        raise ValueError("at most 4095 robots per scene (id-packed map)")

    rob_clouds = []
    rob_radius = np.zeros(n, np.float32)
    for i in range(n):
        sh, sz = cfg.robot.shape[i], cfg.robot.size[i]
        if sh == "circle":
            rob_clouds.append(circle_points(sz[0], sz[1], sz[2]))
        else:
            rob_clouds.append(rectangle_points(sz[0], sz[1], sz[2], sz[3]))
        rob_radius[i] = sz[-1]
    robot_points, robot_mask = _pad_clouds(rob_clouds)

    body_clouds, left_clouds, right_clouds = [], [], []
    rest_l = np.zeros((m, 2), np.float32)
    rest_r = np.zeros((m, 2), np.float32)
    is_leg = np.zeros(m, bool)
    ped_r = np.zeros(m, np.float32)
    ped_ms = np.zeros(m, np.float32)
    for j in range(m):
        sh = cfg.ped_sim.shape[j]
        sz = list(cfg.ped_sim.size[j])
        ped_ms[j] = cfg.ped_sim.max_speed[j]
        if sh == "leg":
            # init_ped duplicates the left leg spec mirrored in y
            # (reset_helper.py:400-404): sizes -> [x, y, r, x, -y, r]
            full = sz + [sz[0], -sz[1], sz[2]]
            left_clouds.append(circle_points(0.0, 0.0, full[2]))
            right_clouds.append(circle_points(0.0, 0.0, full[5]))
            body_clouds.append(np.zeros((0, 2), np.float32))
            rest_l[j] = full[0:2]
            rest_r[j] = full[3:5]
            is_leg[j] = True
            ped_r[j] = round(full[2], 2)
        else:
            body_clouds.append(circle_points(sz[0], sz[1], sz[2]))
            left_clouds.append(np.zeros((0, 2), np.float32))
            right_clouds.append(np.zeros((0, 2), np.float32))
            ped_r[j] = round(sz[2], 2)
    # scripted waypoint lists (Agent.trajectory channel, img_env.cpp:220-250)
    wp_lists = [list(cfg.ped_sim.waypoints[j]) if cfg.ped_sim.waypoints else []
                for j in range(m)]
    wmax = max([2] + [len(w) for w in wp_lists])
    wp_xy = np.zeros((m, wmax, 2), np.float64)
    wp_r = np.zeros((m, wmax), np.float64)
    wp_cnt = np.zeros(m, np.int64)
    for j in range(m):
        for k, wpt in enumerate(wp_lists[j]):
            wp_xy[j, k] = wpt[0], wpt[1]
            wp_r[j, k] = wpt[2] if len(wpt) > 2 else 0.0
        wp_cnt[j] = len(wp_lists[j])

    if m == 0:
        body_clouds = [np.zeros((0, 2), np.float32)]
        left_clouds = [np.zeros((0, 2), np.float32)]
        right_clouds = [np.zeros((0, 2), np.float32)]
    pb, pbm = _pad_clouds(body_clouds)
    pl, plm = _pad_clouds(left_clouds)
    pr, prm = _pad_clouds(right_clouds)
    if m == 0:
        pb, pbm = pb[:0], pbm[:0]
        pl, plm = pl[:0], plm[:0]
        pr, prm = pr[:0], prm[:0]

    obs_clouds, obs_dists, obs_circ = [], [], np.zeros(o, bool)
    for k in range(o):
        sh = cfg.object.shape[k]
        sr = cfg.object.size_range[k]
        if sh == "circle":
            c = circle_points(0.0, 0.0, max(sr[0], sr[1]))
            obs_clouds.append(c)
            obs_dists.append(np.hypot(c[:, 0], c[:, 1]))
            obs_circ[k] = True
        else:
            c = rectangle_points(sr[0], sr[1], sr[2], sr[3])
            obs_clouds.append(c)
            obs_dists.append(np.zeros(c.shape[0], np.float32))
    if o == 0:
        obs_clouds = [np.zeros((1, 2), np.float32)]
        obs_dists = [np.zeros(1, np.float32)]
    op, om = _pad_clouds(obs_clouds)
    od = np.zeros(op.shape[:2], np.float32)
    for k, dd in enumerate(obs_dists[: op.shape[0]]):
        od[k, : dd.shape[0]] = dd
    if o == 0:
        op, om, od = op[:0], om[:0], od[:0]

    vp = ViewParams.from_config(cfg)
    # 'fast' mode runs the identical polar pipeline on a coarser view grid:
    # 9x fewer fill gathers / matmul rows; lasers quantize to the coarse cell.
    if cfg.sensor_mode == "fast":
        sc = max(int(cfg.fast_sensor_scale), 1)
        vp_polar = vp._replace(
            hpx=vp.hpx // sc, wpx=vp.wpx // sc,
            resolution=vp.resolution * sc)
    else:
        vp_polar = vp

    # per-robot sensor placements grouped by distinct config
    # (reset_helper.py:383-384): one pipeline per group
    sensors = ([tuple(float(v) for v in cfg.robot.sensor_cfgs[i])
                for i in range(n)] if n else [(0.0, 0.0)])
    uniq = []
    for s_ in sensors:
        if s_ not in uniq:
            uniq.append(s_)
    groups = []
    for u in uniq:
        idx = np.asarray([i for i in range(n) if sensors[i] == u], np.int32)
        vs_g = ViewStatics.build(vp, u)
        ps_g = polar_mod.PolarStatics.build(
            vp_polar, u, image_size=tuple(cfg.image_size))
        k = len(idx)
        ovc = np.zeros((k,) + robot_points.shape[1:], np.int32)
        ovm = np.zeros((k,) + robot_mask.shape[1:], bool)
        oslots = np.full((k,) + robot_mask.shape[1:],
                         ps_g.n_slots - 1, np.int32)
        ook = np.zeros((k,) + robot_mask.shape[1:], bool)
        for gi, i in enumerate(idx):
            c_i, m_i = own_view_cells(robot_points[i], robot_mask[i], vp)
            ovc[gi], ovm[gi] = c_i, m_i
            c_p, m_p = own_view_cells(robot_points[i], robot_mask[i],
                                      vp_polar)
            oslots[gi], ook[gi] = polar_mod.own_slots_from_cells(
                ps_g, c_p, m_p)
        painter_g = (painter_mod.PainterStatics.build(ps_g, u)
                     if vp.use_laser and cfg.sensor_mode != "reference"
                     else None)
        groups.append(SensorGroup(
            idx=idx, sensor=u, view_statics=vs_g, polar=ps_g,
            painter=painter_g, own_view_cells=ovc, own_view_valid=ovm,
            own_slots=oslots, own_slots_ok=ook))
    g0 = groups[0]
    vs, ps = g0.view_statics, g0.polar
    ovc, ovm, oslots, ook = (g0.own_view_cells, g0.own_view_valid,
                             g0.own_slots, g0.own_slots_ok)

    return EnvStatics(
        static_map=static_map, resolution=res,
        robot_points=robot_points, robot_mask=robot_mask, robot_radius=rob_radius,
        ped_body_points=pb, ped_body_mask=pbm,
        ped_left_points=pl, ped_left_mask=plm,
        ped_right_points=pr, ped_right_mask=prm,
        ped_rest_left=rest_l, ped_rest_right=rest_r,
        ped_is_leg=is_leg, ped_r=ped_r, ped_max_speed=ped_ms,
        ped_wp_xy=wp_xy, ped_wp_r=wp_r, ped_wp_count=wp_cnt,
        obs_points=op, obs_point_dist=od, obs_base_mask=om, obs_is_circle=obs_circ,
        view_params=vp, view_statics=vs, polar=ps,
        own_view_cells=ovc, own_view_valid=ovm,
        own_slots=oslots, own_slots_ok=ook,
        sampler=SamplerSpec.from_config(cfg),
        limiter_v=LimiterParams.from_config(cfg.speed_limiter_v),
        limiter_w=LimiterParams.from_config(cfg.speed_limiter_w),
        orca_cfg=orca_mod.OrcaConfig(
            time_step=float(cfg.control_hz),
            max_obs_segments=int(cfg.max_obs_segments),
        ),
        painter=g0.painter,
        sensor_groups=tuple(groups),
    )


class NavEnv:
    """Gym-flavoured facade over the pure functions (single scene)."""

    def __init__(self, cfg: EnvConfig, jit: bool = True):
        self.cfg = cfg
        # opt-in warm start: statics are a pure function of (cfg, map,
        # package source) — serving fleets set IMG_ENV_TPU_STATICS_CACHE
        # to skip the ~5 s host-side table build (utils/statics_cache.py)
        from img_env_tpu.utils import statics_cache as _scache

        cache_key = (_scache.cache_key(cfg, cfg.resolve_map_path())
                     if _scache.cache_dir() else None)
        self.statics = (_scache.load("st-" + cache_key)
                        if cache_key else None)
        if self.statics is None:
            self.statics = build_statics(cfg)
            if cache_key:
                _scache.save("st-" + cache_key, self.statics)
        self.scene_type = cfg.ped_sim.type if cfg.ped_sim.total > 0 else "none"
        # Device tables are jit ARGUMENTS: the polar incidence matrices are
        # hundreds of MB and must not be baked into the HLO as constants.
        # Every platform runs the same table-driven sensor path, so the CPU
        # tests cover the code the GPU runs ('reference' mode has no tables).
        self._groups = tuple(self.statics.sensor_groups)
        self.hetero = len(self._groups) > 1

        def group_tables(g: SensorGroup):
            tables = polar_mod.make_tables(g.polar)
            # per-robot static self-stamp mask: the runtime stamp is one
            # elementwise select instead of a scatter
            return tables._replace(
                own_mask=jax.device_put(
                    jnp.asarray(polar_mod.own_mask_sorted(
                        g.polar, g.own_slots, g.own_slots_ok))),
                painter=(painter_mod.make_painter_tables(g.painter)
                         if g.painter is not None else None))

        if cfg.sensor_mode == "reference":
            self.sensor_tables = None
        else:
            # the jitted entry points take sensor_tables as ONE argument:
            # the group-0 tables when homogeneous, the tuple of group
            # tables when heterogeneous (_sensor_pass dispatches on it)
            tables = tuple(group_tables(g) for g in self._groups)
            self.sensor_tables = tables if self.hetero else tables[0]

        self._reset = jax.jit(self.reset_fn) if jit else self.reset_fn
        self._step = jax.jit(self.step_fn) if jit else self.step_fn

    # ------------------------------------------------------------------
    # reset
    # ------------------------------------------------------------------
    def reset_fn(self, key, carry: Optional[WorldState] = None, dataset=None,
                 sensor_tables=None, static_map=None):
        """dataset: optional (traj [M,T,2], vel [M,T,2], length [M]) replay
        arrays for the ``dataset`` scene type (ETH/UCY; img_env.cpp:361-386);
        ped initial pose/velocity then come from frame 0.
        sensor_tables: device tables (polar.make_tables) — pass through jit
        so the big static matrices stay runtime arguments."""
        state = self.reset_state_fn(key, carry, dataset, static_map)
        return self._observe(state, sensor_tables)

    def reset_state_fn(self, key, carry: Optional[WorldState] = None,
                       dataset=None, static_map=None) -> WorldState:
        """Scenario sampling + map/EDT build, WITHOUT the sensor pass.

        static_map: optional per-episode base occupancy map overriding the
        config's (heterogeneous scene batching: a BARN sweep / mixed-map
        curriculum runs different worlds in ONE program — the reference
        launches different (env_name, env_num) nodes, create_launch.py:25-34).
        Must share the configured map's resolution; shapes may differ from
        the config map but must agree across scenes of one batch."""
        st = self.statics
        cfg = self.cfg
        n, m = cfg.robot.total, cfg.ped_sim.total
        k_sample, k_state = jax.random.split(key)
        # bounded re-draws consume ScenarioSample.ok (reference recovery:
        # reset_helper.py:251-258, yaml_env.py:304-311)
        sc = sample_scenario_retry(k_sample, st.sampler)

        # obstacle map: stamp sampled footprints into the static map
        dyn_mask = jnp.asarray(st.obs_base_mask) & (
            jnp.logical_not(jnp.asarray(st.obs_is_circle))[:, None]
            | (jnp.asarray(st.obs_point_dist) <= sc.obs_circle_r[:, None])
        )
        base_map = (jnp.asarray(st.static_map) if static_map is None
                    else jnp.asarray(static_map))
        obs_map = raster.draw_obstacles(
            base_map, st.resolution,
            sc.obs_pose, jnp.asarray(st.obs_points), dyn_mask,
        )
        aabb = obstacle_corners(sc.obs_pose, st.sampler, sc.obs_circle_r)

        rob_init = sc.init_poses[:n]
        rob_goal = sc.target_poses[:n]
        ped_init = sc.init_poses[n:]
        ped_goal = sc.target_poses[n:]

        robots = RobotState(
            pose=rob_init,
            goal=rob_goal[:, :2],
            goal_yaw=rob_init[:, 2],
            vw_last0=jnp.zeros((n, 2)),
            vw_last1=(carry.robots.vw_last1 if carry is not None else jnp.zeros((n, 2))),
            vel_world=jnp.zeros((n, 2)),
            collision=jnp.zeros((n,), jnp.int32),
            arrive=jnp.zeros((n,), bool),
            beep=jnp.zeros((n,), jnp.int32),
        )

        # trajectory: scripted waypoints when configured (Agent.trajectory,
        # img_env.cpp:243-250), else [goal] (+[start] when going back,
        # reset_helper.py:337-342); cycled by agent.cpp:839-843 semantics.
        wmax = int(st.ped_wp_xy.shape[1]) if m else 2
        traj = jnp.zeros((m, wmax, 2))
        if m:
            traj = traj.at[:, 0].set(ped_goal[:, :2])
            traj = traj.at[:, 1].set(
                jnp.where(sc.go_back[:, None], ped_init[:, :2], ped_goal[:, :2])
            )
            scripted = jnp.asarray(st.ped_wp_count) > 0
            traj = jnp.where(scripted[:, None, None],
                             jnp.asarray(st.ped_wp_xy), traj)
            traj_len = jnp.where(
                scripted, jnp.asarray(st.ped_wp_count),
                jnp.where(sc.go_back, 2, 1)).astype(jnp.int32)
        else:
            traj_len = jnp.zeros((0,), jnp.int32)

        if dataset is not None:
            ds_traj, ds_vel, ds_len = (
                jnp.asarray(dataset[0]), jnp.asarray(dataset[1]),
                jnp.asarray(dataset[2], jnp.int32),
            )
            ped_init = jnp.concatenate(
                [ds_traj[:, 0], jnp.arctan2(ds_vel[:, 0, 1:2], ds_vel[:, 0, 0:1])],
                axis=-1,
            )
            ped_vel0 = ds_vel[:, 0]
        else:
            ds_traj = jnp.zeros((m, 1, 2))
            ds_vel = jnp.zeros((m, 1, 2))
            ds_len = jnp.ones((m,), jnp.int32)
            ped_vel0 = carry.peds.vel if carry is not None else jnp.zeros((m, 2))

        peds = PedState(
            pos=ped_init[:, :2],
            yaw=ped_init[:, 2],
            prev_pos=ped_init[:, :2],
            vel=ped_vel0,
            goal=ped_goal[:, :2],
            traj=traj,
            traj_len=traj_len,
            traj_idx=jnp.zeros((m,), jnp.int32),
            gait_state=(carry.peds.gait_state if carry is not None else jnp.zeros((m,), jnp.int32)),
            gait_residual=(carry.peds.gait_residual if carry is not None else jnp.zeros((m,))),
            leg_offset=jnp.stack(
                [jnp.asarray(st.ped_rest_left), jnp.asarray(st.ped_rest_right)], axis=1
            ) if m else jnp.zeros((0, 2, 2)),
            sfm_wp_idx=jnp.zeros((m,), jnp.int32),
            sfm_has_dest=jnp.ones((m,), bool),
            sfm_lastdest=jnp.full((m,), -1, jnp.int32),
            dataset_traj=ds_traj,
            dataset_vel=ds_vel,
            dataset_len=ds_len,
        )

        crowd_aux = CrowdAuxState(
            robot_vel=(carry.crowd_aux.robot_vel if carry is not None else jnp.zeros((n, 2)))
        )

        # rvoscene/ervoscene: apply RVO2's obstacle kd-tree segment
        # splitting once per episode (processObs; KdTree.cpp:131-257) — the
        # split pseudo-vertices change ORCA constraints near adjacent
        # rectangles, so the per-step solver reads these, not raw edges.
        segs = None
        if (self.scene_type in ("rvoscene", "ervoscene") and m > 0
                and not cfg.ped_sim.ignore_obstacle
                and aabb.shape[0] > 0):
            from img_env_tpu.crowd.obstacle_split import split_segments

            segs, _ = split_segments(
                aabb, jnp.ones(aabb.shape[0], bool))

        obstacles = ObstacleState(
            pose=sc.obs_pose,
            size=jnp.zeros((sc.obs_pose.shape[0], 4)),
            is_circle=jnp.asarray(st.obs_is_circle),
            aabb=aabb,
            segs=segs,
        )

        # episode-aware clearance field: EDT of static map + sampled
        # obstacles (the map is fresh per episode, img_env.cpp:169-193).
        # MpcController's WorldCost reads this instead of a host-side
        # static-only EDT, so MPC clearance sees the episode obstacles.
        from img_env_tpu.constants import CELL_FREE_MIN
        from img_env_tpu.mpc.edt import edt2d_device

        clip = int(min(256, max(64, math.ceil(2.0 / st.resolution))))
        obs_edt = edt2d_device(
            obs_map < CELL_FREE_MIN, st.resolution, clip_cells=clip)

        state = WorldState(
            robots=robots, peds=peds, crowd_aux=crowd_aux, obstacles=obstacles,
            obs_map=obs_map,
            obs_edt=obs_edt,
            step=jnp.asarray(0, jnp.int32),
            rng=k_state,
            prev_goal_dist=jnp.zeros((n,)),
            has_prev_dist=jnp.asarray(False),
        )
        return state

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------
    def step_fn(self, state: WorldState, actions, sensor_tables=None):
        """actions: [N,3] (v, w, v_y/beep)."""
        new_state, alive, beeps = self.advance_fn(state, actions)
        new_state, obs = self._observe(new_state, sensor_tables)
        return self._finish_step(new_state, obs, alive, beeps)

    def _finish_step(self, new_state, obs, alive, beeps):
        reward = rewards.base_reward(obs.is_collisions, obs.is_arrives)
        done = rewards.compute_dones(obs.is_collisions, obs.is_arrives)
        info = {
            "dones_info": jnp.zeros(obs.is_collisions.shape, jnp.int32),
            "beeps": beeps,
            "alive": alive,
        }
        return new_state, obs, reward, done, info

    def advance_fn(self, state: WorldState, actions):
        """Pre-observation step: crowd + robot dynamics + bookkeeping.

        Returns (state-before-observe, alive mask, beeps).  step_fn is
        advance_fn + _observe; the multi-scene batched env vmaps this part
        per scene but runs the sensor pipeline flat over all S*N robots
        (parallel/batched_env.py).
        """
        st = self.statics
        cfg = self.cfg
        n, m = cfg.robot.total, cfg.ped_sim.total

        dones_prev = rewards.compute_dones(
            state.robots.collision, state.robots.arrive.astype(jnp.int32)
        )
        alive = dones_prev == 0
        v = jnp.where(alive, actions[:, 0], 0.0)
        w = jnp.where(alive, actions[:, 1], 0.0)
        v_y = jnp.where(alive, actions[:, 2], 0.0)

        key_beep, key_next = jax.random.split(state.rng)

        # ---- crowd step (uses previous robot mirrors) ----
        peds, crowd_aux, beeps = self._crowd_step(state, v_y, key_beep)

        # ---- robots ----
        pose, l0, l1, vel, arrive_new = batched_robot_cmd(
            state.robots.pose, state.robots.goal,
            state.robots.vw_last0, state.robots.vw_last1,
            state.robots.vel_world,
            v, w, v_y, alive,
            st.limiter_v, st.limiter_w,
            float(cfg.control_hz), cfg.n_substeps, cfg.robot_type,
        )
        arrive = state.robots.arrive | arrive_new

        robots = RobotState(
            pose=pose, goal=state.robots.goal, goal_yaw=state.robots.goal_yaw,
            vw_last0=l0, vw_last1=l1, vel_world=vel,
            collision=state.robots.collision, arrive=arrive, beep=beeps,
        )

        new_state = WorldState(
            robots=robots, peds=peds, crowd_aux=crowd_aux,
            obstacles=state.obstacles, obs_map=state.obs_map,
            obs_edt=state.obs_edt,
            step=state.step + 1, rng=key_next,
            prev_goal_dist=state.prev_goal_dist,
            has_prev_dist=state.has_prev_dist,
        )
        return new_state, alive, beeps

    # ------------------------------------------------------------------
    def _crowd_step(self, state: WorldState, v_y, key):
        st = self.statics
        cfg = self.cfg
        n, m = cfg.robot.total, cfg.ped_sim.total
        peds = state.peds
        aux = state.crowd_aux

        sources, radii, beeps = crowd_common.sample_beeps(
            key, state.robots.pose, v_y, float(cfg.beep_r), float(cfg.ped_ca_p)
        )

        if m == 0 or self.scene_type in ("none", ""):
            return peds, aux, beeps

        goals, new_idx = crowd_common.advance_traj_goals(
            peds.pos, peds.traj, peds.traj_len, peds.traj_idx
        )

        rel = int(cfg.relation_ped_robo) == 1
        if self.scene_type in ("rvoscene", "ervoscene"):
            pref = orca_mod.pref_velocity(peds.pos, goals)
            rpos = state.robots.pose[:, :2] if rel else jnp.zeros((0, 2))
            rvel = state.robots.vel_world if rel else jnp.zeros((0, 2))
            # episode split segments (processObs analogue) from reset;
            # fall back to raw edges when the reset didn't build them
            if state.obstacles.segs is not None:
                seg = state.obstacles.segs
            else:
                seg = orca_mod.segments_from_aabbs(
                    state.obstacles.aabb,
                    jnp.ones(state.obstacles.aabb.shape[0], bool)
                    if not cfg.ped_sim.ignore_obstacle
                    else jnp.zeros(state.obstacles.aabb.shape[0], bool),
                )
            evac = (sources, radii) if self.scene_type == "ervoscene" else (None, None)
            new_pos, new_vel = orca_mod.orca_step(
                peds.pos, peds.vel, pref,
                jnp.full((m,), self.statics.orca_cfg.radius),
                jnp.asarray(st.ped_max_speed),
                jnp.ones((m,), bool),
                rpos, rvel,
                jnp.ones((rpos.shape[0],), bool),
                st.orca_cfg, seg,
                evac_sources=evac[0], evac_radii=evac[1],
            )
            new_aux = aux
        elif self.scene_type == "pedscene":
            # peds + robot mirrors as one SFM population
            all_pos = jnp.concatenate([peds.pos, state.robots.pose[:, :2]])
            all_vel = jnp.concatenate([peds.vel, aux.robot_vel])
            vmax = jnp.concatenate(
                [jnp.asarray(st.ped_max_speed), jnp.full((n,), 1.2)]
            )
            valid = jnp.concatenate(
                [jnp.ones((m,), bool), jnp.full((n,), rel)]
            )
            wq = 1 + state.peds.traj.shape[1]   # [goal] + trajectory slots
            wp = sfm_mod.SfmWaypointState(
                wp_xy=jnp.concatenate(
                    [self._sfm_wp_xy(state), jnp.zeros((n, wq, 2))]
                ),
                wp_r=jnp.concatenate(
                    [self._sfm_wp_r(state), jnp.zeros((n, wq))]
                ),
                wp_len=jnp.concatenate(
                    [1 + state.peds.traj_len, jnp.zeros((n,), jnp.int32)]
                ),
                dest_idx=jnp.concatenate(
                    [peds.sfm_wp_idx, jnp.zeros((n,), jnp.int32)]
                ),
                head=jnp.concatenate(
                    [peds.sfm_lastdest * 0 + self._sfm_head(state), jnp.zeros((n,), jnp.int32)]
                ),
                has_dest=jnp.concatenate(
                    [peds.sfm_has_dest, jnp.zeros((n,), bool)]
                ),
            )
            seg_a = state.obstacles.aabb[:, :2]
            seg_b = state.obstacles.aabb[:, 2:]
            seg_valid = jnp.ones(seg_a.shape[0], bool) if not cfg.ped_sim.ignore_obstacle else jnp.zeros(seg_a.shape[0], bool)
            new_all_pos, new_all_vel, new_wp = sfm_mod.sfm_step(
                all_pos, all_vel, vmax, valid, wp, seg_a, seg_b, seg_valid,
                float(cfg.control_hz),
            )
            new_pos = new_all_pos[:m]
            new_vel = new_all_vel[:m]
            new_aux = CrowdAuxState(robot_vel=new_all_vel[m:])
            peds = peds._replace(
                sfm_wp_idx=new_wp.dest_idx[:m],
                sfm_has_dest=new_wp.has_dest[:m],
                sfm_lastdest=new_wp.head[:m],   # head stored in lastdest slot
            )
        elif self.scene_type == "dataset":
            # verbatim trajectory replay: the k-th step after reset replays
            # index k (step_ increments only at the end of _step,
            # img_env.cpp:361-386, 518)
            new_pos, new_vel, _ = crowd_common.dataset_replay(
                state.step, peds.dataset_traj, peds.dataset_vel,
                peds.dataset_len,
            )
            new_aux = aux
        else:
            new_pos, new_vel = peds.pos, peds.vel
            new_aux = aux

        yaw = jnp.arctan2(new_vel[:, 1], new_vel[:, 0])
        move = jnp.linalg.norm(new_pos - peds.pos, axis=-1)
        gstate, gres, legs = gait_mod.update_gait(
            peds.gait_state, peds.gait_residual, move,
            jnp.asarray(st.ped_rest_left), jnp.asarray(st.ped_rest_right),
        )
        new_peds = peds._replace(
            pos=new_pos, yaw=yaw, prev_pos=peds.pos, vel=new_vel,
            traj_idx=new_idx, gait_state=gstate, gait_residual=gres,
            leg_offset=legs,
        )
        return new_peds, new_aux, beeps

    def _sfm_wp_xy(self, state):
        # pedsim queue = [goal (r=1)] + Agent.trajectory (pedscene.h:39-47)
        return jnp.concatenate(
            [state.peds.goal[:, None], state.peds.traj], axis=1)

    def _sfm_wp_r(self, state):
        m = self.cfg.ped_sim.total
        w = state.peds.traj.shape[1]
        scripted = (jnp.asarray(self.statics.ped_wp_count) > 0)[:, None]
        traj_r = jnp.where(scripted, jnp.asarray(self.statics.ped_wp_r),
                           jnp.zeros((m, w)))
        return jnp.concatenate([jnp.ones((m, 1)), traj_r], axis=1)

    def _sfm_head(self, state):
        return state.peds.sfm_lastdest  # head travels in the lastdest slot

    # ------------------------------------------------------------------
    def _sensor_pass(self, packed, poses, sensor_tables=None):
        """The matmul sensor pipeline, FLAT over robots.

        packed: id-packed map [H, W] or scene-batched [S, H, W]; poses:
        [B, 3] scene-major flat (B = S * robots-per-scene).  Returns
        (sensor_maps [B, h, w], hits [B, R], angular [B, 72]).

        Keeping all S scenes' robots in one flat axis lets the polar
        incidence / resize matmuls stream their static tables ONCE for all
        scenes (vmap re-streamed them per scene).
        """
        if self.hetero:
            return self._sensor_pass_grouped(packed, poses, sensor_tables)
        st = self.statics
        cfg = self.cfg
        ps = st.polar
        vp = st.view_params
        t = sensor_tables  # device tables as jit args (never baked)
        b = poses.shape[0]
        multi = packed.ndim == 3
        nps = b // packed.shape[0] if multi else b

        if multi:
            occ = jax.vmap(
                lambda pm, p: polar_mod.fill_sorted(
                    ps, pm, st.resolution, p, t=t)
            )(packed, poses.reshape(-1, nps, 3))
            occ = occ.reshape(b, -1)
        else:
            occ = polar_mod.fill_sorted(ps, packed, st.resolution, poses, t=t)

        if vp.use_laser:
            hits, angular, aux = polar_mod.raycast_batched(
                ps, occ, t=t, return_aux=True)
            # exact per-ray painter decode (agent.cpp:511-624): the laser
            # view map is an all-200 canvas painted by the beams in index
            # order — bit-identical to the sequential trace
            pt = t.painter if t is not None else None
            s_hit, s_tail = painter_mod.hit_steps(st.painter, *aux, t=pt)
            vals = painter_mod.paint_sorted(st.painter, s_hit, s_tail, t=pt)
        else:
            hits = jnp.full((b, vp.range_total), 6.0)
            angular = jnp.full((b, 72), vp.max_dist)
            inside = polar_mod.inside_sorted(
                ps, packed.shape[-2:], st.resolution, poses, t=t)
            vals = polar_mod.plain_values_sorted(ps, occ, inside, t=t)

        # own-footprint stamp: per-robot static masks tile over scenes
        own_mask = (t.own_mask if t is not None and t.own_mask is not None
                    else None)
        if own_mask is not None:
            if multi:
                vals = polar_mod.stamp_self_mask(
                    vals.reshape(-1, nps, vals.shape[-1]), own_mask[None]
                ).reshape(b, -1)
            else:
                vals = polar_mod.stamp_self_mask(vals, own_mask)
        else:
            slots = jnp.asarray(st.own_slots)
            ok = jnp.asarray(st.own_slots_ok)
            if multi:
                vals = jax.vmap(
                    lambda v: polar_mod.stamp_self_sorted(ps, v, slots, ok)
                )(vals.reshape(-1, nps, vals.shape[-1])).reshape(b, -1)
            else:
                vals = polar_mod.stamp_self_sorted(ps, vals, slots, ok)
        sensor_maps = polar_mod.sensor_maps_from_sorted(
            ps, vals, tuple(cfg.image_size), t=t)
        return sensor_maps, hits, angular

    # ------------------------------------------------------------------
    def _sensor_pass_grouped(self, packed, poses, sensor_tables=None):
        """Heterogeneous sensor configs: one flat pipeline per distinct
        sensor placement (SensorGroup), results stitched back in robot
        order.  sensor_tables is the per-group tuple (NavEnv.__init__).
        Reference: per-robot ``sensor_cfg`` (reset_helper.py:383-384)
        feeding ``Agent::sensor_base_`` (img_env.cpp:131-132)."""
        st = self.statics
        cfg = self.cfg
        vp = st.view_params
        b = poses.shape[0]
        multi = packed.ndim == 3
        s = packed.shape[0] if multi else 1
        n = b // s                       # robots per scene (all groups)
        tabs = (sensor_tables if sensor_tables is not None
                else (None,) * len(self._groups))

        outs = []
        order = []
        for g, t in zip(self._groups, tabs):
            ps = g.polar
            k = len(g.idx)
            flat_idx = (np.arange(s)[:, None] * n
                        + g.idx[None, :]).reshape(-1)
            order.append(flat_idx)
            poses_g = poses[jnp.asarray(flat_idx)]
            rids = jnp.tile(jnp.asarray(g.idx + 1, jnp.int32), (s,))

            if multi:
                occ = jax.vmap(
                    lambda pm, p: polar_mod.fill_sorted(
                        ps, pm, st.resolution, p, t=t,
                        rids=jnp.asarray(g.idx + 1, jnp.int32))
                )(packed, poses_g.reshape(s, k, 3))
                occ = occ.reshape(s * k, -1)
            else:
                occ = polar_mod.fill_sorted(
                    ps, packed, st.resolution, poses_g, t=t, rids=rids)

            if vp.use_laser:
                hits_g, ang_g, aux = polar_mod.raycast_batched(
                    ps, occ, t=t, return_aux=True)
                pt = t.painter if t is not None else None
                s_hit, s_tail = painter_mod.hit_steps(g.painter, *aux, t=pt)
                vals = painter_mod.paint_sorted(g.painter, s_hit, s_tail, t=pt)
            else:
                hits_g = jnp.full((s * k, vp.range_total), 6.0)
                ang_g = jnp.full((s * k, 72), vp.max_dist)
                inside = polar_mod.inside_sorted(
                    ps, packed.shape[-2:], st.resolution, poses_g, t=t)
                vals = polar_mod.plain_values_sorted(ps, occ, inside, t=t)

            own_mask = (t.own_mask if t is not None
                        and t.own_mask is not None else None)
            if own_mask is not None:
                vals = polar_mod.stamp_self_mask(
                    vals.reshape(s, k, vals.shape[-1]), own_mask[None]
                ).reshape(s * k, -1)
            else:
                slots = jnp.asarray(g.own_slots)
                ok = jnp.asarray(g.own_slots_ok)
                vals = jax.vmap(
                    lambda v: polar_mod.stamp_self_sorted(ps, v, slots, ok)
                )(vals.reshape(s, k, vals.shape[-1])).reshape(s * k, -1)
            sm_g = polar_mod.sensor_maps_from_sorted(
                ps, vals, tuple(cfg.image_size), t=t)
            outs.append((sm_g, hits_g, ang_g))

        inv = jnp.asarray(np.argsort(np.concatenate(order)))
        sensor_maps = jnp.concatenate([o[0] for o in outs])[inv]
        hits = jnp.concatenate([o[1] for o in outs])[inv]
        angular = jnp.concatenate([o[2] for o in outs])[inv]
        return sensor_maps, hits, angular

    # ------------------------------------------------------------------
    def _observe_multi(self, state: WorldState, sensor_tables=None
                       ) -> Tuple[WorldState, Observation]:
        """Scene-batched observation: every ``state`` leaf has a leading
        [S] axis.  Per-scene work (raster compositing, collision codes,
        ped maps) is vmapped; the sensor pipeline runs flat over S*N
        robots (see _sensor_pass).  Bit-identical to vmapping _observe
        (tests/test_multiscene_flat.py)."""
        st = self.statics
        cfg = self.cfg
        n, m = cfg.robot.total, cfg.ped_sim.total
        s = state.obs_map.shape[0]
        b = s * n

        def scene_layers(obs_map, rob_pose, peds, prev_coll, arrive):
            if m:
                ped_pose3 = jnp.concatenate(
                    [peds.pos, peds.yaw[:, None]], axis=-1)
                left_pts = (jnp.asarray(st.ped_left_points)
                            + peds.leg_offset[:, 0:1, :])
                right_pts = (jnp.asarray(st.ped_right_points)
                             + peds.leg_offset[:, 1:2, :])
                left_mask = jnp.asarray(st.ped_left_mask)
                right_mask = jnp.asarray(st.ped_right_mask)
                body_pts = jnp.asarray(st.ped_body_points)
                body_mask = jnp.asarray(st.ped_body_mask)
            else:
                ped_pose3 = jnp.zeros((0, 3))
                left_pts = right_pts = body_pts = jnp.zeros((0, 1, 2))
                left_mask = right_mask = body_mask = jnp.zeros((0, 1), bool)
            layers = raster.build_layers(
                obs_map, st.resolution,
                rob_pose, jnp.asarray(st.robot_points),
                jnp.asarray(st.robot_mask),
                ped_pose3, body_pts, body_mask,
                left_pts, left_mask, right_pts, right_mask,
            )
            coll = raster.collision_codes(layers, prev_coll, arrive)
            return layers.packed, coll

        packed, collision = jax.vmap(scene_layers)(
            state.obs_map, state.robots.pose, state.peds,
            state.robots.collision, state.robots.arrive)

        poses_flat = state.robots.pose.reshape(b, 3)
        sensor_maps, hits, angular = self._sensor_pass(
            packed, poses_flat, sensor_tables)

        vec = observe.vector_state(
            poses_flat, state.robots.goal.reshape(b, 2),
            state.robots.goal_yaw.reshape(b),
            state.robots.vw_last0.reshape(b, 2), int(cfg.state_dim),
        )
        if m:
            ped_vec, ped_map, ped_min = jax.vmap(
                lambda rp, pp, pv: observe.ped_vectors_and_map(
                    rp, pp, pv,
                    jnp.asarray(st.ped_r), jnp.asarray(st.robot_radius),
                    int(cfg.max_ped), int(cfg.ped_vec_dim),
                    int(cfg.ped_image_size[0]), float(cfg.ped_image_r),
                )
            )(state.robots.pose, state.peds.pos, state.peds.vel)
        else:
            ped_vec = jnp.zeros((s, n, 1 + cfg.ped_vec_dim * cfg.max_ped))
            ped_map = jnp.zeros(
                (s, n, 3, cfg.ped_image_size[0], cfg.ped_image_size[1]))
            ped_min = jnp.full((s, n), jnp.inf)

        dist = observe.goal_distances(vec).reshape(s, n)
        step_ds = jnp.where(
            state.has_prev_dist[:, None], state.prev_goal_dist - dist, 0.0)
        lasers = observe.norm_lasers(
            hits, float(cfg.laser_max), cfg.laser_norm)
        beam_ang = jnp.asarray(st.view_statics.laser.angles)
        hit_points = hits[..., None] * jnp.stack(
            [jnp.cos(beam_ang), jnp.sin(beam_ang)], -1)[None]

        sh = lambda x: x.reshape((s, n) + x.shape[1:])
        obs = Observation(
            vector_states=sh(vec),
            sensor_maps=sh(sensor_maps),
            is_collisions=collision,
            is_arrives=state.robots.arrive.astype(jnp.int32),
            lasers=sh(lasers),
            ped_vector_states=ped_vec,
            ped_maps=ped_map,
            step_ds=step_ds,
            ped_min_dists=ped_min,
            angular_maps=sh(angular),
            hit_points=sh(hit_points),
        )
        new_state = state._replace(
            robots=state.robots._replace(collision=collision),
            prev_goal_dist=dist,
            has_prev_dist=jnp.ones((s,), bool),
        )
        return new_state, obs

    # ------------------------------------------------------------------
    def _observe(self, state: WorldState, sensor_tables=None) -> Tuple[WorldState, Observation]:
        st = self.statics
        cfg = self.cfg
        n, m = cfg.robot.total, cfg.ped_sim.total

        ped_pose3 = jnp.concatenate(
            [state.peds.pos, state.peds.yaw[:, None]], axis=-1
        ) if m else jnp.zeros((0, 3))

        left_pts = jnp.asarray(st.ped_left_points) + state.peds.leg_offset[:, 0:1, :] if m else jnp.zeros((0, 1, 2))
        right_pts = jnp.asarray(st.ped_right_points) + state.peds.leg_offset[:, 1:2, :] if m else jnp.zeros((0, 1, 2))
        left_mask = jnp.asarray(st.ped_left_mask) if m else jnp.zeros((0, 1), bool)
        right_mask = jnp.asarray(st.ped_right_mask) if m else jnp.zeros((0, 1), bool)
        body_pts = jnp.asarray(st.ped_body_points) if m else jnp.zeros((0, 1, 2))
        body_mask = jnp.asarray(st.ped_body_mask) if m else jnp.zeros((0, 1), bool)

        layers = raster.build_layers(
            state.obs_map, st.resolution,
            state.robots.pose, jnp.asarray(st.robot_points), jnp.asarray(st.robot_mask),
            ped_pose3, body_pts, body_mask,
            left_pts, left_mask, right_pts, right_mask,
        )
        collision = raster.collision_codes(
            layers, state.robots.collision, state.robots.arrive
        )

        vp = st.view_params
        rid1 = jnp.arange(1, n + 1, dtype=jnp.int32)
        if cfg.sensor_mode == "reference":
            # per-robot gather path (kept for cross-checking; slower);
            # heterogeneous sensor groups render per group and stitch
            # (__init__ guarantees at least one group)
            outs, order = [], []
            for g in self._groups:
                order.append(g.idx)
                render = jax.vmap(
                    lambda pose, rid, vc, vm, vs=g.view_statics:
                    render_robot_view(
                        layers, st.resolution, pose, rid, vc, vm, vs, vp
                    )
                )
                outs.append(render(
                    state.robots.pose[jnp.asarray(g.idx)],
                    rid1[jnp.asarray(g.idx)],
                    jnp.asarray(g.own_view_cells),
                    jnp.asarray(g.own_view_valid)))
            inv = jnp.asarray(np.argsort(np.concatenate(order)))
            views = jnp.concatenate([o[0] for o in outs])[inv]
            hits = jnp.concatenate([o[1] for o in outs])[inv]
            angular = jnp.concatenate([o[2] for o in outs])[inv]
            sensor_maps = sensor_map_from_view(views, tuple(cfg.image_size))
        else:
            sensor_maps, hits, angular = self._sensor_pass(
                layers.packed, state.robots.pose, sensor_tables)

        vec = observe.vector_state(
            state.robots.pose, state.robots.goal, state.robots.goal_yaw,
            state.robots.vw_last0, int(cfg.state_dim),
        )
        if m:
            ped_vec, ped_map, ped_min = observe.ped_vectors_and_map(
                state.robots.pose, state.peds.pos, state.peds.vel,
                jnp.asarray(st.ped_r), jnp.asarray(st.robot_radius),
                int(cfg.max_ped), int(cfg.ped_vec_dim),
                int(cfg.ped_image_size[0]), float(cfg.ped_image_r),
            )
        else:
            ped_vec = jnp.zeros((n, 1 + cfg.ped_vec_dim * cfg.max_ped))
            ped_map = jnp.zeros((n, 3, cfg.ped_image_size[0], cfg.ped_image_size[1]))
            ped_min = jnp.full((n,), jnp.inf)

        dist = observe.goal_distances(vec)
        step_ds = jnp.where(state.has_prev_dist, state.prev_goal_dist - dist, 0.0)

        lasers = observe.norm_lasers(hits, float(cfg.laser_max), cfg.laser_norm)

        # AgentState extras (img_env.cpp:566-571): hit points are the raw hit
        # distances projected onto the beam directions (agent.cpp:434-436)
        beam_ang = jnp.asarray(st.view_statics.laser.angles)
        hit_points = hits[..., None] * jnp.stack(
            [jnp.cos(beam_ang), jnp.sin(beam_ang)], -1)[None]

        obs = Observation(
            vector_states=vec,
            sensor_maps=sensor_maps,
            is_collisions=collision,
            is_arrives=state.robots.arrive.astype(jnp.int32),
            lasers=lasers,
            ped_vector_states=ped_vec,
            ped_maps=ped_map,
            step_ds=step_ds,
            ped_min_dists=ped_min,
            angular_maps=angular,
            hit_points=hit_points,
        )
        new_state = state._replace(
            robots=state.robots._replace(collision=collision),
            prev_goal_dist=dist,
            has_prev_dist=jnp.asarray(True),
        )
        return new_state, obs

    # ------------------------------------------------------------------
    def reset(self, key, carry: Optional[WorldState] = None, dataset=None):
        return self._reset(key, carry, dataset, self.sensor_tables)

    def step(self, state, actions):
        return self._step(state, jnp.asarray(actions), self.sensor_tables)
