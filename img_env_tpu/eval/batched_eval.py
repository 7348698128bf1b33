"""Scene-batched deterministic evaluation: every bank episode is a scene.

The sequential evaluator (examples/evaluate.py) steps one episode at a
time through the gym facade, one host round trip per step.  Here all E
bank episodes ride the scene axis of the flat multi-scene step
(parallel/batched_env.py): one reset + max_steps batched steps evaluate
the whole bank in ~max_steps round trips, with identical episode draws
(the same ScenarioBank keys seed the scenes).

THIS IS THE TRUSTED EVALUATOR: its outcome semantics are bit-identical to
the sequential wrapper stack (asserted in tests/test_eval_parity.py):

  * a robot's label is its FIRST terminal event, with the reference's
    InfoLogWrapper priority — arrive beats a same-step collision
    (base.py:234-254: collisions write dones_info, then arrive overrides);
  * timeout fires after ``cfg.time_max`` steps exactly like
    TimeLimitWrapper (base.py:215-231: ``elapsed > time_max``), so
    ``max_steps`` defaults to ``time_max + 1`` and a terminal event in
    that final step still wins over the timeout label;
  * scenes start fresh, exactly like the sequential facade's
    ``reset(carry=False)`` episode loop (examples/evaluate.py).

Beyond the dones_info outcomes it reports the reference's crowd-safety
numbers (per-episode min ped clearance; close-to-human rate with the
InfoLogWrapper 1 m threshold, base.py:241-254) and can return a full
``EpisodeRecorder`` so `eval/plots.compare_methods` renders the same
time/distance/extra-time table as the sequential path.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from img_env_tpu.constants import (DONE_ARRIVE, DONE_COLL_PED,
                                   DONE_COLL_ROBOT, DONE_COLL_STATIC,
                                   DONE_TIMEOUT)
from img_env_tpu.utils.metrics import batched_dones_summary


def evaluate_batched(
    cfg,
    policy_fn: Optional[Callable] = None,  # (key, obs) -> actions [S, N, >=2]
    episodes: int = 50,
    max_steps: Optional[int] = None,       # default: cfg.time_max + 1
    bank=None,                    # ScenarioBank (uses first `episodes` keys)
    seed: int = 0,
    mpc=None,                     # MppiConfig -> evaluate the MPC controller
    force_beep_off: bool = False,  # zero the beep channel (ERVO ablation)
    record: bool = False,          # also return an EpisodeRecorder
) -> Tuple[Dict, np.ndarray]:
    """Returns (summary dict, dones_info [episodes, N][, recorder])."""
    import jax
    import jax.numpy as jnp

    from img_env_tpu.eval.recorder import ScenarioBank
    from img_env_tpu.parallel.batched_env import BatchedNavEnv

    if bank is None:
        bank = ScenarioBank.generate(seed, episodes)
    if max_steps is None:
        # TimeLimitWrapper fires at elapsed > time_max (base.py:215-231);
        # run that final step so same-step events still beat the timeout
        max_steps = int(cfg.time_max) + 1
    keys = jnp.asarray(bank.keys[:episodes])
    s = int(keys.shape[0])
    env = BatchedNavEnv(cfg, mesh=None)
    n = cfg.robot.total

    ctl = None
    if mpc is not None:
        from img_env_tpu.mpc.controller import MpcController

        ctl = MpcController(env.core, mpc)
        mpc_states = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (s,) + x.shape), ctl.init_state())

        @jax.jit
        def mpc_act(key, states, mss):
            kk = jax.random.split(key, s)
            actions, mss, _ = jax.vmap(ctl.act_fn)(kk, states, mss)
            return actions, mss

    t0 = time.perf_counter()
    states, obs = env.reset(keys)
    key = jax.random.PRNGKey(seed + 1)
    dones_info = np.zeros((s, n), np.int64)
    arrive_step = np.zeros((s, n), np.int64)
    min_clear = np.full((s, n), np.inf)
    close_steps = np.zeros((s, n), np.int64)    # steps with ped < 1 m
    live_steps = np.zeros((s, n), np.int64)     # pre-terminal step count
    rec = None
    if record:
        from img_env_tpu.eval.recorder import EpisodeRecord, EpisodeRecorder

        rec = EpisodeRecorder(dt=float(cfg.control_hz))
        rec.episodes = [EpisodeRecord() for _ in range(s)]
        goals = np.asarray(states.robots.goal)          # [S,N,2]
        for i, e in enumerate(rec.episodes):
            e.goals = goals[i]

    for t in range(max_steps):
        key, k = jax.random.split(key)
        if ctl is not None:
            actions, mpc_states = mpc_act(k, states, mpc_states)
        else:
            actions = jnp.asarray(policy_fn(k, obs))
        if actions.shape[-1] < 3:
            actions = jnp.concatenate(
                [actions, jnp.zeros(actions.shape[:-1] + (1,))], -1)
        if force_beep_off:
            actions = actions.at[..., 2].set(0.0)
        states, obs, reward, done, info = env.step(states, actions)
        coll = np.asarray(obs.is_collisions)
        arr = np.asarray(obs.is_arrives)
        pmd = np.asarray(obs.ped_min_dists)
        fresh = dones_info == 0
        # InfoLogWrapper priority: collisions label first, arrive overrides
        # (base.py:234-254) — so a same-step arrive+collision is an arrive
        for code, val in ((1, DONE_COLL_STATIC), (2, DONE_COLL_PED),
                          (3, DONE_COLL_ROBOT)):
            dones_info[fresh & (coll == code)] = val
        dones_info[fresh & (arr > 0)] = DONE_ARRIVE
        arrive_step[fresh & (arr > 0)] = t + 1
        live_steps[fresh] += 1
        if np.isfinite(pmd).any():
            min_clear[fresh] = np.minimum(min_clear[fresh], pmd[fresh])
            close_steps[fresh & (pmd < 1.0)] += 1
        if rec is not None:
            poses = np.asarray(states.robots.pose)      # [S,N,3]
            acts = np.asarray(actions)
            for i, e in enumerate(rec.episodes):
                e.robot_poses.append(poses[i])
                e.robot_vws.append(acts[i, :, :2])
        if (dones_info > 0).all():
            break
    dones_info[dones_info == 0] = DONE_TIMEOUT
    if rec is not None:
        for i, e in enumerate(rec.episodes):
            e.dones_info = dones_info[i]
    wall = time.perf_counter() - t0

    summary = batched_dones_summary(dones_info)
    arrived = dones_info == DONE_ARRIVE
    finite = np.isfinite(min_clear)
    summary.update(
        episodes=s,
        avg_arrive_steps=(float(arrive_step[arrived].mean())
                          if arrived.any() else 0.0),
        wall_s=round(wall, 1),
    )
    if finite.any():
        summary["ped_min_dist_mean"] = float(min_clear[finite].mean())
        summary["close_to_human_rate"] = float(
            close_steps.sum() / max(live_steps.sum(), 1))
    out = (summary, dones_info)
    return out + (rec,) if record else out
