"""Smoke run of the MPC control step on one NVIDIA GPU.

    python chip_smoke.py          # phases (a)-(f) on one card
    python chip_smoke.py --four   # 4 scenes x 50 robots sharded over 4 cards

Phases, all in this one process (it keeps the card to itself):

  (a) device   — JAX's devices and the card's name and power limit; no GPU
                 is an error, never a fallback to the CPU.
  (b) compile  — the bench200 control step (bench.build(): 200 robots, 200
                 obstacles, 400x400 parity views, 960-beam lasers, MPPI
                 K=128 H=12): compile seconds and memory_analysis().
  (c) steps    — a few control steps: shapes and finite values.
  (d) parity   — one seeded state, one control step on the GPU and the same
                 f32 program on the CPU device of this process; mismatch
                 counts per surface, held to the tolerances below.
  (e) crowd    — the same for 200 robots + 200 SFM leg pedestrians,
                 ped maps and ped vectors included.

The last line printed is the JSON result; every phase must pass.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import bench  # noqa: E402
from benchmarks.device import describe, nvidia_smi, require_gpu  # noqa: E402
from img_env_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Parity tolerances, GPU against the CPU on the same state and actions.
# Exact: laser hits (read from one static table), collision codes, dones,
# ped-map occupancy.  The rest were measured and traced on the H100
# (PERF.md, Findings):
#  * sensor_maps: the 48x48 cubic resize is a 16-tap f32 sum rounded to a
#    gray level; the GPU sums in another order (and fuses multiply-adds),
#    so a sum within an ulp of a .5 boundary rounds to the neighbouring
#    level: at most 1 level, on at most 1e-4 of the pixels.
#  * MPC actions: exp/cos/sin differ in the last bits between the CPU and
#    GPU math libraries, and the MPPI softmax over K=128 rollouts amplifies
#    that (7.6e-5 at most on the bench200 state): |gpu - cpu| <= 1e-3
#    (m/s, rad/s; 0.4 mm of travel in a 0.4 s step).
#  * ped vectors and ped-map velocities: cos/sin of the robot yaw.
MAX_LEVELS, MAX_LEVEL_SHARE = 1, 1e-4
CLOSE = {"actions": (0.0, 1e-3), "ped_vector_states": (1e-5, 1e-5),
         "ped_map_vel": (1e-5, 1e-5)}
STEPS = 3


def _probe(env, ctl):
    """jit(key, state, mpc_state, tables, actions_in) -> (actions, costs,
    state', mpc_state', obs, done): the MPC solve on ``state`` and the env
    step driven by ``actions_in`` — so the CPU side can step with the
    GPU's actions and the sensor comparison sees the same robot poses."""
    import jax

    @jax.jit
    def probe(key, state, mss, tables, actions_in):
        actions, mss2, costs = ctl.act_fn(key, state, mss)
        state2, obs, _, done, _ = env.step_fn(state, actions_in, tables)
        return actions, costs, state2, mss2, obs, done

    return probe


def _scene(cfg, seed):
    """(env, ctl, probe, state, mpc_state) built on the default device."""
    import jax

    from img_env_tpu.env.nav_env import NavEnv
    from img_env_tpu.mpc.controller import MpcController
    from img_env_tpu.mpc.mppi import MppiConfig

    env = NavEnv(cfg)
    ctl = MpcController(env, MppiConfig(horizon=bench.MPPI_HORIZON,
                                        samples=bench.MPPI_SAMPLES))
    state, _ = env.reset(jax.random.PRNGKey(seed))
    return env, ctl, _probe(env, ctl), state, ctl.init_state()


def _compile(probe, args, label):
    t0 = time.perf_counter()
    compiled = probe.lower(*args).compile()
    dt = time.perf_counter() - t0
    print(f"[{label}] compile {dt:.1f} s; memory_analysis: "
          f"{compiled.memory_analysis()}")
    return compiled


def _check_finite(label, tree):
    import jax

    bad = [jax.tree_util.keystr(p) for p, x in
           jax.tree_util.tree_flatten_with_path(tree)[0]
           if np.issubdtype(np.asarray(x).dtype, np.floating)
           and not np.isfinite(np.asarray(x)).all()
           and "ped_min_dists" not in jax.tree_util.keystr(p)]
    if bad:
        raise AssertionError(f"[{label}] non-finite values in {bad}")


def _steps(label, env, probe, state, mss):
    """Phase (c): a few control steps; shapes and finite values."""
    import jax

    n = env.cfg.robot.total
    tables = env.sensor_tables
    key = jax.random.PRNGKey(11)
    actions = jax.numpy.zeros((n, 3))
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        actions, costs, state, mss, obs, done = probe(
            k, state, mss, tables, actions)
    jax.block_until_ready(obs)
    hs, ws = env.cfg.image_size
    shapes = {"sensor_maps": (n, hs, ws),
              "lasers": (n, env.cfg.range_total),
              "actions": (n, 3), "dones": (n,)}
    got = {"sensor_maps": obs.sensor_maps.shape, "lasers": obs.lasers.shape,
           "actions": actions.shape, "dones": done.shape}
    if env.cfg.ped_sim.total:
        shapes["ped_maps"] = (n, 3) + tuple(env.cfg.ped_image_size)
        got["ped_maps"] = obs.ped_maps.shape
    if got != shapes:
        raise AssertionError(f"[{label}] shapes {got} != {shapes}")
    _check_finite(label, (actions, costs, state, obs))
    print(f"[{label}] {STEPS} control steps ok: shapes {got}")


def _compare(name, g, c):
    """(entries that differ, entries outside the tolerance, rule)."""
    g, c = np.asarray(g), np.asarray(c)
    diff = int(np.sum(g != c))
    if name == "sensor_maps":
        levels = np.rint(np.abs(g.astype(np.float64) - c) * 255.0)
        bad = int(np.sum(levels > MAX_LEVELS))
        if diff > MAX_LEVEL_SHARE * g.size:
            bad = diff
        return diff, bad, (f"<= {MAX_LEVELS} gray level on <= "
                           f"{MAX_LEVEL_SHARE:g} of pixels")
    if name in CLOSE:
        rtol, atol = CLOSE[name]
        bad = int(np.sum(~np.isclose(g, c, rtol=rtol, atol=atol)))
        return diff, bad, f"rtol {rtol:g}, atol {atol:g}"
    return diff, diff, "exact"


def _parity(label, env, probe, state, mss):
    """Phase (d): the GPU step against the same program on the CPU."""
    import jax

    cpu = jax.devices("cpu")[0]
    n = env.cfg.robot.total
    key = jax.random.PRNGKey(21)
    tables = env.sensor_tables
    acts_g, _, _, _, _, _ = probe(key, state, mss, tables,
                                  jax.numpy.zeros((n, 3)))
    acts_g, costs_g, _, _, obs_g, done_g = probe(key, state, mss, tables,
                                                 acts_g)
    to_cpu = lambda x: jax.device_put(x, cpu)
    t0 = time.perf_counter()
    acts_c, costs_c, _, _, obs_c, done_c = probe(
        to_cpu(key), to_cpu(state), to_cpu(mss), to_cpu(tables),
        to_cpu(acts_g))
    jax.block_until_ready(obs_c)
    print(f"[{label}] CPU reference step (compile + run) "
          f"{time.perf_counter() - t0:.1f} s")

    surfaces = {
        "sensor_maps": (obs_g.sensor_maps, obs_c.sensor_maps),
        "lasers": (obs_g.lasers, obs_c.lasers),
        "is_collisions": (obs_g.is_collisions, obs_c.is_collisions),
        "dones": (done_g, done_c),
        "actions": (acts_g, acts_c),
    }
    if env.cfg.ped_sim.total:
        surfaces.update({
            "ped_map_occ": (obs_g.ped_maps[:, 0], obs_c.ped_maps[:, 0]),
            "ped_map_vel": (obs_g.ped_maps[:, 1:], obs_c.ped_maps[:, 1:]),
            "ped_vector_states": (obs_g.ped_vector_states,
                                  obs_c.ped_vector_states),
        })
    failed = []
    for name, (g, c) in surfaces.items():
        diff, bad, rule = _compare(name, g, c)
        size = int(np.asarray(g).size)
        dmax = float(np.max(np.abs(np.asarray(g, np.float64)
                                   - np.asarray(c, np.float64))))
        print(f"[{label}] parity {name}: {diff} of {size} differ, {bad} "
              f"outside tolerance ({rule}); max abs diff {dmax:.3g}")
        if diff:
            _explain(label, name, g, c)
        if bad:
            failed.append(name)
    if failed:
        raise AssertionError(f"[{label}] parity failed for {failed}")


def _explain(label, name, g, c, k=5):
    """Print the first few mismatching entries of a surface."""
    g, c = np.asarray(g), np.asarray(c)
    idx = np.argwhere(g != c)[:k]
    for i in idx:
        i = tuple(int(v) for v in i)
        print(f"[{label}]   {name}{list(i)}: gpu {g[i]!r} cpu {c[i]!r}")


def run_one_card(devs):
    import jax

    env, ctl, probe, state, mss = _scene(bench.build(), 0)
    n = env.cfg.robot.total
    zeros = jax.numpy.zeros((n, 3))
    _compile(probe, (jax.random.PRNGKey(1), state, mss, env.sensor_tables,
                     zeros), "bench200")
    _steps("bench200", env, probe, state, mss)
    _parity("bench200", env, probe, state, mss)

    env_p, _, probe_p, state_p, mss_p = _scene(bench.build_crowd(), 2)
    _compile(probe_p, (jax.random.PRNGKey(1), state_p, mss_p,
                       env_p.sensor_tables, zeros), "crowd")
    _steps("crowd", env_p, probe_p, state_p, mss_p)
    _parity("crowd", env_p, probe_p, state_p, mss_p)


def run_four_cards(devs):
    """4 scenes x 50 robots sharded over make_mesh(scene=4) on four cards
    against the same 4 scenes on one card, from one seeded state."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from img_env_tpu.mpc.controller import MpcController
    from img_env_tpu.mpc.mppi import MppiConfig
    from img_env_tpu.parallel.batched_env import BatchedNavEnv
    from img_env_tpu.parallel.mesh import SCENE_AXIS, make_mesh

    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX has {len(devs)}")
    s = bench.S_SCENES
    cfg = bench.build(n_robots=bench.N_SCENE_ROBOTS)
    mesh = make_mesh(scene=s, model=1, devices=devs[:4])
    benv1 = BatchedNavEnv(cfg, mesh=None)
    benv4 = BatchedNavEnv(cfg, mesh=mesh)
    ctl = MpcController(benv1.core, MppiConfig(
        horizon=bench.MPPI_HORIZON, samples=bench.MPPI_SAMPLES))

    sharded = NamedSharding(mesh, P(SCENE_AXIS))

    def make(benv):
        def probe(key, states, mss):
            kk = jax.random.split(key, s)
            actions, mss, costs = jax.vmap(ctl.act_fn)(kk, states, mss)
            states, obs, _, done, _ = benv.step_fn(states, actions)
            return actions, states, mss, obs, done
        if benv.mesh is None:
            return jax.jit(probe)
        # every output keeps the scene sharding, so the next step takes
        # them as they are (zero-size leaves included)
        return jax.jit(probe, in_shardings=(
            NamedSharding(mesh, P()), sharded, sharded),
            out_shardings=sharded)

    states, _ = benv1.reset(jax.random.split(jax.random.PRNGKey(5), s))
    mss = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (s,) + x.shape), ctl.init_state())
    outs, times = {}, {}
    for label, benv, st, ms in (
            ("1 card", benv1, states, mss),
            ("4 cards", benv4, jax.device_put(states, sharded),
             jax.device_put(mss, sharded))):
        probe = make(benv)
        key = jax.random.PRNGKey(6)
        t0 = time.perf_counter()
        with mesh:
            compiled = probe.lower(key, st, ms).compile()
        print(f"[{label}] compile {time.perf_counter() - t0:.1f} s; "
              f"memory_analysis: {compiled.memory_analysis()}")
        res = []
        with mesh:
            for _ in range(STEPS):
                key, k = jax.random.split(key)
                a, st, ms, obs, done = compiled(k, st, ms)
                res.append((a, obs, done))
            jax.block_until_ready(res)
            t0 = time.perf_counter()
            for _ in range(bench.ITERS):
                key, k = jax.random.split(key)
                a, st, ms, o, d = compiled(k, st, ms)
            jax.block_until_ready((a, o, d))
        times[label] = (time.perf_counter() - t0) / bench.ITERS * 1e3
        outs[label] = res
        n_sh = len(res[-1][1].sensor_maps.sharding.device_set)
        _check_finite(label, res)
        print(f"[{label}] {s} scenes x {cfg.robot.total} robots on {n_sh} "
              f"device(s): {times[label]:.3f} ms/step")
    failed = []
    for i, ((a1, o1, d1), (a4, o4, d4)) in enumerate(
            zip(outs["1 card"], outs["4 cards"])):
        for name, x1, x4 in (
                ("sensor_maps", o1.sensor_maps, o4.sensor_maps),
                ("lasers", o1.lasers, o4.lasers),
                ("is_collisions", o1.is_collisions, o4.is_collisions),
                ("dones", d1, d4),
                ("actions", a1, a4)):
            diff, bad, rule = _compare(name, x1, x4)
            print(f"[4 cards vs 1] step {i} {name}: {diff} of "
                  f"{np.asarray(x1).size} differ, {bad} outside tolerance "
                  f"({rule})")
            if bad:
                failed.append((i, name))
    if failed:
        raise AssertionError(f"4-card result differs from 1 card: {failed}")
    print(f"[4 cards vs 1] ok; per-step time 1 card {times['1 card']:.3f} "
          f"ms, 4 cards {times['4 cards']:.3f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded multi-scene phase")
    args = ap.parse_args()

    enable_compile_cache()
    import jax

    devs = require_gpu()
    print(f"[device] jax.devices(): {devs}")
    print(f"[device] kind {devs[0].device_kind!r}, count {len(devs)}")
    print("[device] nvidia-smi --query-gpu=name,power.limit:")
    print(nvidia_smi())
    t0 = time.perf_counter()
    try:
        (run_four_cards if args.four else run_one_card)(devs)
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke FAILED after {time.perf_counter() - t0:.1f} s")
        return 1
    print(f"chip_smoke passed in {time.perf_counter() - t0:.1f} s "
          f"(jax {jax.__version__})")
    print(json.dumps({"ok": True, "device": describe(devs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
