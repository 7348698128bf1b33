"""Headline benchmark: MPC rollouts/s on one GPU at the 200-robot /
200-obstacle config.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"device"} and one ``# `` stderr line per secondary cell.  The metric counts
candidate MPC rollouts evaluated per second — each rollout is a K-sample
MPPI candidate rolled H steps through the exact unicycle dynamics +
clearance costs — while the full sensor pipeline (raster, egocentric
views, laser) steps the world between solves.  ``vs_baseline`` is measured
against the BASELINE.json target of 10k rollouts/s (the reference
publishes no numbers, BASELINE.md).

Exits non-zero when JAX finds no GPU or when any cell fails.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

N_ROBOTS = 200
N_OBSTACLES = 200
N_PEDS = 200
MPPI_SAMPLES = 128
MPPI_HORIZON = 12
WARMUP = 3
ITERS = 20
TARGET_ROLLOUTS_PER_SEC = 10_000.0
S_SCENES, N_SCENE_ROBOTS = 4, 50


def _robots(n: int) -> dict:
    return {
        "total": n,
        "shape": ["circle"],
        "size": [[0.0, 0.0, 0.17]],
        "begin_poses_type": ["range"],
        "begin_poses": [[0.5, 15.5, 0.5, 15.5]],
        "target_poses_type": ["range"],
        "target_poses": [[0.5, 15.5, 0.5, 15.5]],
    }


def build(sensor_mode: str = "parity", n_robots: int = N_ROBOTS):
    """The headline scene: 200 robots, 200 circle obstacles, 16 m room,
    400x400 views at 0.015 m, 960-beam lasers."""
    from img_env_tpu.config import EnvConfig

    return EnvConfig.from_dict({
        "env_name": "bench200",
        "control_hz": 0.4,
        "robot": _robots(n_robots),
        "object": {
            "total": N_OBSTACLES,
            "shape": ["circle"],
            "size_range": [[0.1, 0.2]],
            "poses_type": ["range"],
            "poses": [[0.5, 15.5, 0.5, 15.5]],
        },
        "ped_sim": {"total": 0, "type": ""},
        "global_map": {"map_file": "room_16_empty.png", "resolution": 0.1},
        "view_map": {"resolution": 0.015, "width": 6.0, "height": 6.0},
        "range_total": 960,
        "max_ped": 10,
        "state_dim": 3,
        "sensor_mode": sensor_mode,
    })


def build_crowd(sensor_mode: str = "parity", n_robots: int = N_ROBOTS):
    """The crowd scene: 200 robots + 200 SFM leg pedestrians — the
    reference's headline scale ("200 robots and 200 obstacles have been
    simulated", README.md:12) with a live crowd model on top."""
    from img_env_tpu.config import EnvConfig

    return EnvConfig.from_dict({
        "env_name": "bench200ped",
        "control_hz": 0.4,
        "robot": _robots(n_robots),
        "object": {"total": 0},
        "ped_sim": {"total": N_PEDS, "type": "pedscene",
                    "max_speed": [0.5], "shape": ["leg"],
                    "size": [[0.0, 0.1, 0.1]],
                    "begin_poses_type": ["range"],
                    "begin_poses": [[0.5, 15.5, 0.5, 15.5]],
                    "target_poses_type": ["range"],
                    "target_poses": [[0.5, 15.5, 0.5, 15.5]],
                    "go_back": "yes"},
        "global_map": {"map_file": "room_16_empty.png", "resolution": 0.1},
        "view_map": {"resolution": 0.015, "width": 6.0, "height": 6.0},
        "range_total": 960, "max_ped": 10, "state_dim": 3,
        "sensor_mode": sensor_mode,
    })


def checksum(obs, with_peds: bool):
    """Sum of every observation surface, so XLA cannot dead-code-eliminate
    any part of the sensor pipeline out of a timed step."""
    c = (obs.sensor_maps.sum() + obs.lasers.sum()
         + obs.vector_states.sum())
    if with_peds:
        c = (c + obs.ped_vector_states.sum() + obs.ped_maps.sum()
             + obs.ped_min_dists.sum())
    return c


def make_control_step(env, ctl):
    """jit(key, state, mpc_state, tables) -> (key, state, mpc_state, chk):
    one MPC solve for every robot + one env step with the full sensor
    pipeline.  The big sensor tables travel as jit arguments."""
    import jax

    peds = env.cfg.ped_sim.total > 0

    @jax.jit
    def control_step(key, state, mpc_state, tables):
        k_plan, k_next = jax.random.split(key)
        actions, mpc_state, costs = ctl.act_fn(k_plan, state, mpc_state)
        state, obs, *_ = env.step_fn(state, actions, tables)
        return k_next, state, mpc_state, checksum(obs, peds) + costs.sum()

    return control_step


def _loop_ms(step, carry, iters: int):
    """ms/step of ``iters`` dispatched steps (state feeds the next step)."""
    import jax

    t0 = time.perf_counter()
    for _ in range(iters):
        carry = step(*carry)
    jax.block_until_ready(carry)
    return (time.perf_counter() - t0) / iters * 1e3, carry


def _single_scene_cell(cfg, seed: int):
    """One NavEnv + MpcController cell, timed in the step loop:
    (ms/step, jitted step, sensor tables, carry after the loop)."""
    import jax

    from img_env_tpu.env.nav_env import NavEnv
    from img_env_tpu.mpc.controller import MpcController
    from img_env_tpu.mpc.mppi import MppiConfig

    env = NavEnv(cfg)
    ctl = MpcController(
        env, MppiConfig(horizon=MPPI_HORIZON, samples=MPPI_SAMPLES))
    state, _ = env.reset(jax.random.PRNGKey(seed))
    step = make_control_step(env, ctl)
    tables = env.sensor_tables
    run = lambda k, s, m, c: step(k, s, m, tables)
    carry = (jax.random.PRNGKey(seed + 1), state, ctl.init_state(), 0.0)
    _, carry = _loop_ms(run, carry, WARMUP)
    ms, carry = _loop_ms(run, carry, ITERS)
    return ms, step, tables, carry


def main() -> int:
    from img_env_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from benchmarks.device import describe, nvidia_smi, require_gpu
    from benchmarks.roofline import roofline_row, xla_cost

    devs = require_gpu()
    device = describe(devs)
    print(f"# device: {device['kind']} x{device['count']}; nvidia-smi "
          f"name, power.limit: {nvidia_smi()}", file=sys.stderr)
    failed = []

    # headline: 200 robots, parity sensors — step loop, then the SAME step
    # iterated on-device via lax.scan (no per-step host dispatch, how the
    # PPO unroll consumes the env, train/ppo.py): the headline value
    ms_step, step, tables, carry = _single_scene_cell(build(), 0)
    rps = N_ROBOTS * MPPI_SAMPLES / ms_step * 1e3

    @jax.jit
    def control_scan(key, state, mpc_state, tables):
        def body(c, _):
            key, state, mpc_state, chk = step(*c, tables)
            return (key, state, mpc_state), chk
        c, chks = jax.lax.scan(body, (key, state, mpc_state), None,
                               length=ITERS)
        return c, chks.sum()

    key, state, mss, _ = carry
    (key, state, mss), chk = control_scan(key, state, mss, tables)
    jax.block_until_ready(chk)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        (key, state, mss), chk = control_scan(key, state, mss, tables)
    jax.block_until_ready(chk)
    ms_scan = (time.perf_counter() - t0) / (reps * ITERS) * 1e3
    rps_scan = N_ROBOTS * MPPI_SAMPLES / ms_scan * 1e3

    flops, bts = xla_cost(step, (key, state, mss, tables))
    rl = roofline_row(ms_scan, flops, bts, device["kind"])
    out = {
        "metric": "mpc_rollouts_per_sec_200robot_200obs_full_sensors",
        "value": round(rps_scan, 1),
        "unit": "rollouts/s",
        "vs_baseline": round(rps_scan / TARGET_ROLLOUTS_PER_SEC, 3),
        "ms_per_step_scan": round(ms_scan, 3),
        "ms_per_step": round(ms_step, 3),
        "value_step_loop": round(rps, 1),
        "roofline_light_ms": round(rl["light_ms"], 3),
        "roofline_util_scan_pct": round(rl["util_pct"], 1),
        "roofline_bound": rl["bound"],
        "device": device,
    }

    cells = [
        ("fast-mode", lambda: _single_scene_cell(build("fast"), 2)[0]),
        ("crowd-mode/parity", lambda: _single_scene_cell(
            build_crowd("parity"), 4)[0]),
        ("crowd-mode/fast", lambda: _single_scene_cell(
            build_crowd("fast"), 6)[0]),
        ("multi-scene", _multiscene_cell),
    ]
    for name, fn in cells:
        try:
            ms = fn()
        except Exception:   # one cell's failure is reported, the rest run
            traceback.print_exc()
            failed.append(name)
            print(f"# {name} FAILED", file=sys.stderr)
            continue
        robots = (S_SCENES * N_SCENE_ROBOTS if name == "multi-scene"
                  else N_ROBOTS)
        print(f"# {name}: {ms:.3f} ms/step, "
              f"{robots * MPPI_SAMPLES / ms * 1e3:.0f} rollouts/s "
              f"({device['kind']})", file=sys.stderr)

    print(json.dumps(out))
    print(
        f"# detail: {ITERS} control steps, {N_ROBOTS} robots, "
        f"K={MPPI_SAMPLES} H={MPPI_HORIZON}, 400x400 views + 960-beam "
        f"lasers; step loop {ms_step:.3f} ms/step, scan {ms_scan:.3f} "
        f"ms/step", file=sys.stderr)
    if failed:
        print(f"# failed cells: {failed}", file=sys.stderr)
        return 1
    return 0


def _multiscene_cell():
    """S scenes x 50 robots as ONE program on one card (scene raster
    vmapped, all S*N robots share one sensor pass; the reference fans out
    one ROS node per scene, create_launch.py:25-34)."""
    import jax
    import jax.numpy as jnp

    from img_env_tpu.mpc.controller import MpcController
    from img_env_tpu.mpc.mppi import MppiConfig
    from img_env_tpu.parallel.batched_env import BatchedNavEnv

    cfg = build(n_robots=N_SCENE_ROBOTS)
    benv = BatchedNavEnv(cfg, mesh=None)
    ctl = MpcController(
        benv.core, MppiConfig(horizon=MPPI_HORIZON, samples=MPPI_SAMPLES))
    states, _ = benv.reset(jax.random.split(jax.random.PRNGKey(5), S_SCENES))
    mss = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (S_SCENES,) + x.shape),
        ctl.init_state())
    @jax.jit
    def step(key, states, mss):
        k_plan, k_next = jax.random.split(key)
        kk = jax.random.split(k_plan, S_SCENES)
        actions, mss, costs = jax.vmap(ctl.act_fn)(kk, states, mss)
        states, obs, *_ = benv.step_fn(states, actions)
        return k_next, states, mss, checksum(obs, False) + costs.sum()

    run = lambda k, s, m, c: step(k, s, m)
    carry = (jax.random.PRNGKey(6), states, mss, 0.0)
    _, carry = _loop_ms(run, carry, WARMUP)
    ms, _ = _loop_ms(run, carry, ITERS)
    return ms


if __name__ == "__main__":
    sys.exit(main())
