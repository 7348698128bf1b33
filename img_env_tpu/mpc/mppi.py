"""Sampling MPC: MPPI and CEM over the exact unicycle dynamics.

The planner rolls K perturbed action sequences over an H-step horizon with
the same closed-form arc kinematics and speed limiter the sim applies
(dynamics/kinematics.py — agent.cpp:186-283 semantics), scores them with the
smooth planning cost (mpc/cost.py), and returns the information-theoretic
MPPI weighting (or the CEM elite refit).

Shapes are dense: everything is [K, H, ...] tensors rolled with
``lax.scan`` over H and vmapped over robots.  Batch over scenes with
vmap/shard_map outside (mpc solves/s is a headline benchmark, BASELINE.md).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from img_env_tpu.dynamics.kinematics import _exact_pose_update
from img_env_tpu.dynamics.limiter import LimiterParams, limit_command
from img_env_tpu.mpc.cost import CostWeights, WorldCost, stage_cost, terminal_cost


class MppiConfig(NamedTuple):
    horizon: int = 12
    samples: int = 256
    lam: float = 1.0                 # temperature
    sigma_v: float = 0.15
    sigma_w: float = 0.3
    v_range: Tuple[float, float] = (0.0, 0.6)
    w_range: Tuple[float, float] = (-0.9, 0.9)
    elites: int = 32                 # CEM only
    cem_iters: int = 3               # CEM only
    avoid_k: int = 16                # other-robot tracks per planner: the
                                     # k CURRENTLY-nearest robots join the
                                     # clearance set (0 = all N-1).  The
                                     # min-clearance over constant-velocity
                                     # tracks is decided by near neighbours;
                                     # all-pairs scoring is O(N^2 K H)
    exact_cost: bool = False         # escape hatch: no k-nearest pruning,
                                     # no min-pooled EDT patch — every
                                     # lookup exact (the parity mode for
                                     # tests/test_mpc_approximations.py)
    goal_field: bool = False         # goal term follows a per-robot
                                     # geodesic distance-to-goal field
                                     # (cost.geodesic_field) instead of
                                     # straight-line distance: global
                                     # guidance for maze/cave worlds
                                     # (BARN), where Euclidean goal pull
                                     # dead-ends in concave pockets


class PlannerState(NamedTuple):
    nominal: jnp.ndarray   # [H,2] current nominal action plan (v,w)


def init_planner(cfg: MppiConfig) -> PlannerState:
    return PlannerState(nominal=jnp.zeros((cfg.horizon, 2)))


def _rollout_costs(
    actions,                 # [K,H,2]
    pose, vw0, vw1, goal,
    wc: WorldCost, w8: CostWeights,
    limiter_v: LimiterParams, limiter_w: LimiterParams,
    ped_traj, ped_r,         # [H,M,2] predicted ped positions (any head)
    dt: float, omni: bool, local_edt=None,
):
    k = actions.shape[0]
    pose0 = jnp.broadcast_to(pose, (k, 3))
    vw0 = jnp.broadcast_to(vw0, (k, 2))
    vw1 = jnp.broadcast_to(vw1, (k, 2))

    def body(carry, xs):
        pose, vw0, vw1, acc = carry
        act, ped_t = xs                                 # [K,2], [M,2]
        v = limit_command(limiter_v, act[:, 0], vw0[:, 0], vw1[:, 0], dt)
        w = limit_command(limiter_w, act[:, 1], vw0[:, 1], vw1[:, 1], dt)
        new_pose = jax.vmap(
            lambda p, vi, wi: _exact_pose_update(p, vi, wi, 0.0, dt, omni)
        )(pose, v, w)
        c = stage_cost(
            wc, w8, new_pose[:, :2], goal, v, w, vw0[:, 0], vw0[:, 1],
            ped_t, ped_r, local_edt=local_edt,
        )
        new_vw0 = jnp.stack([v, w], -1)
        return (new_pose, new_vw0, vw0, acc + c), None

    init = (pose0, vw0, vw1, jnp.zeros((k,)))
    (posef, _, _, acc), _ = jax.lax.scan(
        body, init, (jnp.swapaxes(actions, 0, 1), ped_traj)
    )
    return acc + terminal_cost(wc, w8, posef[:, :2], goal)


def mppi_plan(
    key, ps: PlannerState,
    pose, vw0, vw1, goal,
    wc: WorldCost,
    limiter_v: LimiterParams, limiter_w: LimiterParams,
    ped_traj, ped_r,
    cfg: MppiConfig, w8: CostWeights = CostWeights(),
    dt: float = 0.4, omni: bool = False, local_edt=None,
):
    """One MPPI solve for a single robot. Returns (action [2], new state).

    ped_traj: [H,M,2] predicted ped positions (mpc/prediction.py heads)."""
    h, kk = cfg.horizon, cfg.samples
    sigma = jnp.asarray([cfg.sigma_v, cfg.sigma_w])
    noise = jax.random.normal(key, (kk, h, 2)) * sigma
    cand = ps.nominal[None] + noise
    lo = jnp.asarray([cfg.v_range[0], cfg.w_range[0]])
    hi = jnp.asarray([cfg.v_range[1], cfg.w_range[1]])
    cand = jnp.clip(cand, lo, hi)

    costs = _rollout_costs(
        cand, pose, vw0, vw1, goal, wc, w8,
        limiter_v, limiter_w, ped_traj, ped_r, dt, omni, local_edt,
    )
    beta = jnp.min(costs)
    wts = jax.nn.softmax(-(costs - beta) / cfg.lam)
    plan = jnp.einsum("k,khd->hd", wts, cand,
                      precision=jax.lax.Precision.HIGHEST)
    action = plan[0]
    # receding horizon: shift, repeat last
    nominal = jnp.concatenate([plan[1:], plan[-1:]], axis=0)
    return action, PlannerState(nominal=nominal), jnp.sum(wts * costs)


def cem_plan(
    key, ps: PlannerState,
    pose, vw0, vw1, goal,
    wc: WorldCost,
    limiter_v: LimiterParams, limiter_w: LimiterParams,
    ped_traj, ped_r,
    cfg: MppiConfig, w8: CostWeights = CostWeights(),
    dt: float = 0.4, omni: bool = False,
):
    """Cross-entropy method with ``cem_iters`` refits of a diagonal Gaussian."""
    lo = jnp.asarray([cfg.v_range[0], cfg.w_range[0]])
    hi = jnp.asarray([cfg.v_range[1], cfg.w_range[1]])

    def one_iter(carry, key):
        mean, std = carry
        cand = mean[None] + jax.random.normal(key, (cfg.samples, cfg.horizon, 2)) * std[None]
        cand = jnp.clip(cand, lo, hi)
        costs = _rollout_costs(
            cand, pose, vw0, vw1, goal, wc, w8,
            limiter_v, limiter_w, ped_traj, ped_r, dt, omni,
        )
        _, idx = jax.lax.top_k(-costs, cfg.elites)
        elite = cand[idx]                       # [E,H,2]
        new_mean = elite.mean(0)
        new_std = elite.std(0) + 1e-4
        return (new_mean, new_std), costs[idx].mean()

    sigma0 = jnp.broadcast_to(
        jnp.asarray([cfg.sigma_v, cfg.sigma_w]), (cfg.horizon, 2))
    keys = jax.random.split(key, cfg.cem_iters)
    (mean, _), costs = jax.lax.scan(one_iter, (ps.nominal, sigma0), keys)
    action = mean[0]
    nominal = jnp.concatenate([mean[1:], mean[-1:]], axis=0)
    return action, PlannerState(nominal=nominal), costs[-1]


def batched_mppi(
    keys, ps_nominal, poses, vw0, vw1, goals,
    wc: WorldCost, limiter_v, limiter_w,
    ped_traj, ped_r, cfg: MppiConfig,
    w8: CostWeights = CostWeights(), dt: float = 0.4, omni: bool = False,
    robot_traj=None, robot_r=None,
):
    """vmap MPPI over N robots sharing one world. Returns ([N,2], [N,H,2], [N]).

    robot_traj [H,N,2] / robot_r [N]: predicted OTHER-robot positions —
    each robot's own column is pushed far away so it never avoids itself;
    the rest join the pedestrian clearance set (robots have no equivalent
    in the reference's reward, but independent per-robot planners would
    otherwise collide head-on in shared passages).

    With ``cfg.avoid_k > 0`` each planner scores only its k CURRENTLY-
    nearest other robots (plus all peds): the clearance term is a min over
    the set, which near-neighbours decide, and all-pairs scoring is
    O(N^2 K H) — at 200 robots it dominated the whole solve.
    """
    n = poses.shape[0]
    if robot_traj is not None and not cfg.exact_cost and 0 < cfg.avoid_k < n - 1:
        # k-nearest OTHER robots by current position (self at +inf)
        diff = poses[:, None, :2] - poses[None, :, :2]
        d2 = (diff ** 2).sum(-1) + jnp.where(
            jnp.eye(n, dtype=bool), jnp.inf, 0.0)               # [N,N]
        _, near_idx = jax.lax.top_k(-d2, cfg.avoid_k)           # [N,k]
    else:
        near_idx = None

    if near_idx is None:
        near_idx = jnp.zeros((n, 0), jnp.int32)   # unused placeholder

    # local EDT patch per robot: rollouts reach at most v_max*H*dt from the
    # start, so one dynamic_slice serves every static lookup of the solve
    from img_env_tpu.mpc.cost import (geodesic_field, local_edt_patch,
                                      pooled_edt)

    # per-robot geodesic goal fields (global guidance; one wavefront per
    # robot per solve — a few fused elementwise passes over the map)
    gfs = (jax.vmap(lambda g: geodesic_field(
        wc.edt, float(wc.resolution), g, wc.robot_radius))(goals)
        if cfg.goal_field else jnp.zeros((n, 0, 0)))

    vmax = max(abs(cfg.v_range[0]), abs(cfg.v_range[1]))
    reach_cells = int(np.ceil(vmax * cfg.horizon * dt
                              / float(wc.resolution))) + 2
    patch_size = (2 * reach_cells + 2 + 7) // 8 * 8
    # min-pool fine-resolution EDTs down to a ~96-wide select (conservative)
    pool = max(1, patch_size // 96)
    # pool the EDT ONCE per solve; per-robot slices read the pooled map
    # (bit-identical values, pool^2 less gather traffic under vmap)
    edt_p = None if cfg.exact_cost else pooled_edt(wc.edt, pool)

    def one(i, key, nom, pose, a0, a1, goal, nbr, gf):
        wc_i = wc._replace(goal_field=gf) if cfg.goal_field else wc
        local_edt = (None if cfg.exact_cost else
                     (*local_edt_patch(wc, pose[:2], patch_size, pool,
                                       edt_pooled=edt_p), pool))
        if robot_traj is not None:
            if nbr.shape[0] > 0:
                others = robot_traj[:, nbr, :]                  # [H,k,2]
                others_r = robot_r[nbr]
            else:
                far = jnp.full((robot_traj.shape[0], 2), 1e6)
                others = robot_traj.at[:, i, :].set(far)        # [H,N,2]
                others_r = robot_r
            avoid_traj = jnp.concatenate([ped_traj, others], axis=1)
            avoid_r = jnp.concatenate([ped_r, others_r])
        else:
            avoid_traj, avoid_r = ped_traj, ped_r
        act, st, c = mppi_plan(
            key, PlannerState(nom), pose, a0, a1, goal, wc_i,
            limiter_v, limiter_w, avoid_traj, avoid_r, cfg, w8, dt, omni,
            local_edt=local_edt,
        )
        return act, st.nominal, c

    return jax.vmap(one)(jnp.arange(n), keys, ps_nominal, poses, vw0, vw1,
                         goals, near_idx, gfs)
