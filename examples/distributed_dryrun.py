"""Two-process distributed dryrun: the multi-host path, exercised for real.

Spawns N worker processes on this machine (CPU backend, 2 virtual devices
each), each joining one ``jax.distributed`` job — the same code path a
multi-host GPU job uses, with the gRPC coordination service standing in for
the real fleet.  Every worker:

  1. ``initialize(coordinator, N, pid)`` and checks process_count,
  2. builds the GLOBAL [scene, model] mesh over all processes' devices
     (parallel/distributed.global_mesh — host-major scene layout),
  3. assembles a globally-sharded scene batch from its process-LOCAL key
     slice via ``process_local_batch``,
  4. runs env reset + one full PPO train step as one sharded program —
     gradients cross scene shards through compiler-inserted psums,
  5. checks the loss is finite and identical on every process.

    python examples/distributed_dryrun.py [--procs 2] [--port 9911]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCENES_PER_PROC = 2
DEVICES_PER_PROC = 2


def worker(pid: int, nproc: int, port: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEVICES_PER_PROC} "
        + os.environ.get("XLA_FLAGS", ""))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import numpy as np

    from img_env_tpu.parallel import distributed

    assert distributed.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    n_global = nproc * DEVICES_PER_PROC
    assert len(jax.devices()) == n_global
    assert len(jax.local_devices()) == DEVICES_PER_PROC

    from img_env_tpu.models.policy import PolicyConfig, init_policy
    from img_env_tpu.parallel.batched_env import BatchedNavEnv
    from img_env_tpu.train.ppo import PpoConfig, make_train_step
    from tests.test_parallel import tiny_cfg

    s_global = nproc * SCENES_PER_PROC
    cfg = tiny_cfg(robots=1, peds=1)
    mesh = distributed.global_mesh(scene=n_global, model=1)
    env = BatchedNavEnv(cfg, mesh=mesh, jit=False)

    # process-local scene keys -> one globally-sharded batch
    all_keys = np.stack(
        [np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
         for s in range(s_global)])
    local = all_keys[pid * SCENES_PER_PROC:(pid + 1) * SCENES_PER_PROC]
    keys_g = distributed.process_local_batch(
        mesh, (s_global,) + all_keys.shape[1:], local)
    keys_g = jax.vmap(jax.random.wrap_key_data)(keys_g)

    pcfg = PolicyConfig.from_env_config(cfg)
    model, params = init_policy(jax.random.PRNGKey(0), pcfg, batch=s_global)
    init_fn, train_step = make_train_step(env, model, PpoConfig(unroll=2))
    ts = init_fn(params)

    with mesh:
        states, obs = jax.jit(env.reset_fn)(keys_g)
        ts2, states, obs, metrics = jax.jit(train_step)(
            ts, states, obs, jax.random.PRNGKey(7))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    # the replicated loss must agree across processes: allgather a copy
    from jax.experimental import multihost_utils

    losses = multihost_utils.process_allgather(np.asarray(loss))
    assert np.allclose(losses, losses[0]), losses
    print(f"[proc {pid}] ok: devices={n_global} scenes={s_global} "
          f"loss={loss:.4f} (agrees on {nproc} processes)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", type=int, default=9911)
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.procs, args.port)
        return 0

    procs = []
    for pid in range(args.procs):
        env = dict(os.environ, PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(pid), "--procs", str(args.procs),
             "--port", str(args.port)],
            env=env, cwd=REPO))
    rcs = [p.wait(timeout=900) for p in procs]
    if any(rcs):
        print("FAILED:", rcs)
        return 1
    print(f"distributed dryrun ok: {args.procs} processes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
