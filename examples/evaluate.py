"""TestEpisode-style evaluation over a fixed scenario bank.

    python examples/evaluate.py [cfg.yaml] --episodes 20 --policy mpc \
        --bank /tmp/bank.npz --record /tmp/episodes.npz --plots /tmp/eval

Mirrors the reference's evaluation workflow (TestEpisodeWrapper +
init-pose bags + BagReader, SURVEY.md §4): every method evaluated against
the same ``--bank`` sees bit-identical episode sequences; metrics cover
arrive/collision/stuck rates, smoothness (jerk, w-variance, zero
crossings), and extra time/distance vs the straight-line optimum.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cfg", nargs="?", default="img_env_tpu/configs/test.yaml")
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--max-steps", type=int, default=0,
                    help="0 = cfg.time_max + 1 (the TimeLimitWrapper step)")
    ap.add_argument("--policy", choices=("random", "mpc", "ckpt"),
                    default="mpc")
    ap.add_argument("--ckpt", default="",
                    help="orbax checkpoint dir from train_ppo --save "
                         "(used with --policy ckpt; deterministic mean "
                         "actions; cfg must match the training config)")
    ap.add_argument("--bank", default="", help="ScenarioBank npz (shared across methods)")
    ap.add_argument("--record", default="", help="write episode npz here")
    ap.add_argument("--plots", default="", help="write trajectory/outcome PNGs here")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", action="store_true",
                    help="all episodes as parallel scenes (one flat "
                         "program, one host round trip per step).  This is the "
                         "TRUSTED evaluator — bit-identical outcomes to the "
                         "sequential loop (tests/test_eval_parity.py); "
                         "per-step smoothness (jerk/w-variance) still needs "
                         "the sequential path")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import numpy as np

    from img_env_tpu.config import EnvConfig, read_yaml
    from img_env_tpu.env.gymapi import make_env

    if args.batch:
        from img_env_tpu.config import EnvConfig
        from img_env_tpu.eval.batched_eval import evaluate_batched
        from img_env_tpu.eval.recorder import ScenarioBank

        cfg = EnvConfig.from_yaml(args.cfg)
        bank = (ScenarioBank.load(args.bank)
                if args.bank and os.path.exists(args.bank) else
                ScenarioBank.generate(0, args.episodes))
        if args.bank and not os.path.exists(args.bank):
            bank.save(args.bank)
        n_scenes = min(args.episodes, len(bank.keys))
        if args.policy == "mpc":
            from img_env_tpu.mpc import MppiConfig

            summary, dones = evaluate_batched(
                cfg, None, args.episodes, args.max_steps or None, bank=bank,
                mpc=MppiConfig(horizon=8, samples=64))
            for k, v in summary.items():
                print(f"  {k:22s} {v}")
            return
        if args.policy == "ckpt":
            from img_env_tpu.models.policy import load_ckpt_policy

            pf, params = load_ckpt_policy(
                cfg, args.ckpt, n_scenes * cfg.robot.total)

            def policy(key, obs):
                import jax.numpy as jnp

                s = obs.vector_states.shape[0]   # actual scene count
                flat = jax.tree_util.tree_map(
                    lambda x: x.reshape((-1,) + x.shape[2:]), obs)
                a = pf(params, flat)
                return jnp.asarray(a).reshape(s, cfg.robot.total, -1)
        else:
            rng_b = np.random.default_rng(0)

            def policy(key, obs):
                s = obs.vector_states.shape[0]
                return rng_b.uniform(
                    [0.0, -0.9], [0.6, 0.9],
                    (s, cfg.robot.total, 2))
        summary, dones = evaluate_batched(
            cfg, policy, args.episodes, args.max_steps or None, bank=bank)
        for k, v in summary.items():
            print(f"  {k:22s} {v}")
        return

    d = read_yaml(args.cfg)
    d["cfg_type"] = "bag"
    d["init_pose_bag_name"] = args.bank
    d["init_pose_bag_episodes"] = args.episodes
    # the eval loop manages episode boundaries itself (the reference's
    # TestEpisodeWrapper likewise runs without NeverStop auto-reset), and
    # both policies emit continuous (v, w) commands
    d["wrapper"] = [w for w in d.get("wrapper", []) if w != "NeverStopWrapper"]
    d["discrete_action"] = False
    env = make_env(d, seed=0, record=True)
    n = env.robot_total

    ctl = None
    policy_fn = None
    if args.policy == "mpc":
        from img_env_tpu.mpc import MpcController, MppiConfig

        ctl = MpcController(env.core, MppiConfig(horizon=8, samples=64))
    elif args.policy == "ckpt":
        from img_env_tpu.models.policy import load_ckpt_policy

        policy_fn, params = load_ckpt_policy(env.core.cfg, args.ckpt, n)

    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    max_steps = args.max_steps or int(env.cfg.time_max) + 1
    t0 = time.perf_counter()
    for ep in range(args.episodes):
        obs = env.reset(carry=False)
        ms = ctl.init_state() if ctl else None
        for step in range(max_steps):
            if ctl is not None:
                key, k = jax.random.split(key)
                actions, ms, _ = ctl.act(k, env._state, ms)
                actions = np.asarray(actions)[:, :2]
            elif policy_fn is not None:
                actions = np.asarray(policy_fn(params, env.last_raw_obs))
            else:
                actions = np.column_stack([
                    rng.uniform(0.0, 0.6, n), rng.uniform(-0.9, 0.9, n)])
            obs, reward, done, info = env.step(actions)
            if bool(np.asarray(info["all_down"])):
                break
        env.metrics.end_episode(np.asarray(info["dones_info"]))
        if env.recorder is not None:
            env.recorder.end_episode(np.asarray(info["dones_info"]))

    el = time.perf_counter() - t0
    print(f"{args.episodes} episodes in {el:.1f}s ({args.policy} policy)")
    for k, v in env.metrics.summary().items():
        print(f"  {k:22s} {v}")
    if env.recorder is not None:
        for k, v in env.recorder.summary().items():
            print(f"  {k:22s} {v:.4g}")
        if args.record:
            env.recorder.save(args.record)
            print(f"wrote {args.record}")
        if args.plots:
            from img_env_tpu.eval import plots

            os.makedirs(args.plots, exist_ok=True)
            plots.plot_trajectories(
                env.recorder, statics=env.core.statics,
                out=os.path.join(args.plots, "trajectories.png"))
            plots.plot_outcomes(
                env.recorder, out=os.path.join(args.plots, "outcomes.png"))
            try:
                plots.plot_ep_split(
                    env.recorder, statics=getattr(env.core, "statics", None),
                    out=os.path.join(args.plots, "ep_split.png"))
                plots.plot_vw_odom(
                    env.recorder,
                    out=os.path.join(args.plots, "vw_odom.png"))
            except ValueError:
                pass          # no completed episodes recorded
            print(f"wrote plots to {args.plots}/")


if __name__ == "__main__":
    main()
