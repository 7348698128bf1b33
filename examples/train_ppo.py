"""Sharded PPO training over the batched env — the end-to-end training demo.

    python examples/train_ppo.py [--scenes 8] [--updates 20] [--unroll 16]
    python examples/train_ppo.py --cpu --curve /tmp/ppo_curve  # learning demo

Scenes shard over the device mesh (1 real chip -> mesh of 1; on a pod slice
every chip takes scenes/n_dev scenes).  The whole update (rollout + GAE +
clipped PPO step) is ONE compiled program per call.

The env exists to TRAIN policies (the reference trains the Sensors-20 /
IROS-21 agents, README.md:159-186): with the default small config the
reward_mean and arrive_rate curves rise within ~50 updates;
``--curve PREFIX`` writes PREFIX.csv and PREFIX.png so the run leaves an
artifact (tests/test_ppo.py::test_reward_improves asserts the same trend).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cfg", nargs="?", default=None)
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--updates", type=int, default=20)
    ap.add_argument("--unroll", type=int, default=16)
    ap.add_argument("--robots", type=int, default=2)
    ap.add_argument("--peds", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--epochs", type=int, default=2,
                    help="PPO passes over each rollout (2 is stable; 4 "
                         "can collapse the tiny policy on easy configs)")
    ap.add_argument("--minibatches", type=int, default=2)
    ap.add_argument("--reward-scale", type=float, default=1.0,
                    help="scale rewards entering GAE (paper rewards span "
                         "+-500; 0.02 keeps the value loss in range)")
    ap.add_argument("--sigma0", type=float, default=-0.5,
                    help="initial log-std of the Gaussian policy head")
    ap.add_argument("--force-sigma", type=float, default=None,
                    help="override pi_log_std AFTER --restore (the "
                         "checkpoint carries its own annealed sigma; "
                         "polish stages shrink it explicitly)")
    ap.add_argument("--ent-coef", type=float, default=0.01,
                    help="entropy bonus weight (lower to let sigma anneal "
                         "in late curriculum stages)")
    ap.add_argument("--curve", default=None,
                    help="write PREFIX.csv + PREFIX.png learning curves")
    ap.add_argument("--save", default=None,
                    help="orbax checkpoint dir for the trained params "
                         "(evaluate.py --policy ckpt --ckpt DIR)")
    ap.add_argument("--restore", default=None,
                    help="warm-start params from a checkpoint dir — chain "
                         "invocations over configs for staged curricula "
                         "(the reference's stage_train workflow)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from img_env_tpu.config import EnvConfig
    from img_env_tpu.models.policy import PolicyConfig, init_policy
    from img_env_tpu.parallel.batched_env import BatchedNavEnv
    from img_env_tpu.parallel.mesh import make_mesh, tp_param_shardings
    from img_env_tpu.train.ppo import PpoConfig, make_train_step

    if args.cfg:
        cfg = EnvConfig.from_yaml(args.cfg)
    else:
        cfg = EnvConfig.from_dict({
            "robot": {
                "total": args.robots,
                "begin_poses_type": ["range"], "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
                "target_poses_type": ["range"], "target_poses": [[1.0, 9.0, 1.0, 9.0]],
            },
            "ped_sim": {
                "total": args.peds, "type": "rvoscene", "max_speed": [0.5],
                "begin_poses_type": ["range"], "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
                "target_poses_type": ["range"], "target_poses": [[1.0, 9.0, 1.0, 9.0]],
            },
            "global_map": {"map_file": "room_10.png", "resolution": 0.1},
            "view_map": {"resolution": 0.03, "width": 6.0, "height": 6.0},
            "range_total": 128,
            "max_ped": max(args.peds, 1),
            "sensor_mode": "fast",
        })

    n_dev = len(jax.devices())
    mesh = make_mesh(scene=n_dev, model=1)
    env = BatchedNavEnv(cfg, mesh=mesh, jit=False)
    import dataclasses as _dc

    pcfg = _dc.replace(PolicyConfig.from_env_config(cfg),
                       log_std_init=args.sigma0)
    model, params = init_policy(jax.random.PRNGKey(args.seed), pcfg, batch=2)
    if args.restore:
        from img_env_tpu.train import checkpoint as ckpt_mod

        params = ckpt_mod.restore(args.restore, like={"params": params})["params"]
        print(f"warm-started params from {args.restore}")
    if args.force_sigma is not None:
        import flax

        flat = flax.traverse_util.flatten_dict(params)
        for k in flat:
            if k[-1] == "pi_log_std":
                flat[k] = jnp.full_like(flat[k], args.force_sigma)
        params = flax.traverse_util.unflatten_dict(flat)
        print(f"pi_log_std forced to {args.force_sigma}")
    params = jax.device_put(params, tp_param_shardings(params, mesh))

    init_fn, train_step = make_train_step(
        env, model, PpoConfig(unroll=args.unroll, lr=args.lr,
                              epochs=args.epochs,
                              minibatches=args.minibatches,
                              ent_coef=args.ent_coef,
                              reward_scale=args.reward_scale))
    ts = init_fn(params)
    step = jax.jit(train_step)

    history = []
    keys = jax.random.split(jax.random.PRNGKey(args.seed + 1), args.scenes)
    with mesh:
        states, obs = jax.jit(env.reset_fn)(keys)
        key = jax.random.PRNGKey(args.seed + 2)
        t0 = time.perf_counter()
        last_u, last_t = 0, t0
        for u in range(args.updates):
            key, k = jax.random.split(key)
            ts, states, obs, metrics = step(ts, states, obs, k)
            # keep device scalars; fetching every update would barrier the
            # dispatch pipeline (floats are pulled at the periodic print
            # and when the curve is written)
            history.append((u + 1, metrics["reward_mean"],
                            metrics["arrive_rate"],
                            metrics["collision_rate"]))
            if (u + 1) % 5 == 0 or u == 0:
                # fetching the metrics waits for the update; rate is per
                # window, excluding compile
                loss = float(metrics["loss"])
                now = time.perf_counter()
                sps = ((u + 1 - last_u) * args.unroll * args.scenes
                       * cfg.robot.total / (now - last_t))
                last_u, last_t = u + 1, now
                print(f"update {u+1:4d}  loss {loss:9.4f}  "
                      f"reward {float(metrics['reward_mean']):8.3f}  "
                      f"arrive {float(metrics['arrive_rate']):5.2f}  "
                      f"collide {float(metrics['collision_rate']):5.2f}  "
                      f"entropy {float(metrics['entropy']):6.3f}  "
                      f"{sps:8.0f} robot-steps/s")

    h = np.asarray([[float(np.asarray(v)) for v in row] for row in history])
    k = max(len(h) // 5, 1)
    print(f"reward first-{k} mean {h[:k, 1].mean():.3f} -> "
          f"last-{k} mean {h[-k:, 1].mean():.3f}; "
          f"arrive {h[:k, 2].mean():.2f} -> {h[-k:, 2].mean():.2f}")
    if args.save:
        from img_env_tpu.train import checkpoint as ckpt_mod

        ckpt_mod.save(args.save, {"params": jax.device_get(ts.params)})
        print(f"saved params checkpoint to {args.save}")
    if args.curve:
        np.savetxt(
            args.curve + ".csv", h, delimiter=",", comments="",
            header="update,reward_mean,arrive_rate,collision_rate")
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(1, 2, figsize=(9, 3.2))
            axes[0].plot(h[:, 0], h[:, 1])
            axes[0].set_xlabel("update"); axes[0].set_ylabel("reward_mean")
            axes[1].plot(h[:, 0], h[:, 2], label="arrive")
            axes[1].plot(h[:, 0], h[:, 3], label="collide")
            axes[1].set_xlabel("update"); axes[1].legend()
            fig.tight_layout()
            fig.savefig(args.curve + ".png", dpi=110)
            print(f"wrote {args.curve}.csv/.png")
        except Exception as e:
            print(f"curve png skipped: {e}")
    print("done")


if __name__ == "__main__":
    main()
