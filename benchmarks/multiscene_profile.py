"""Where does the multi-scene (vmapped) step lose vs single-scene?

Times the evolving-state control loop (MPC act + env step, the bench.py
pattern) at fixed total robots split over S scenes on one GPU.  The reference runs one ROS node per scene;
our target is >=0.8x the single-scene per-robot rate on one chip
(VERDICT r3 #2).

    python benchmarks/multiscene_profile.py [--shapes 1x200,4x50,16x12]
    python benchmarks/multiscene_profile.py --legacy   # vmap-the-step path
"""
import argparse
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp, numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="1x200,4x50,16x12")
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--horizon", type=int, default=12)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--legacy", action="store_true",
                    help="vmap-the-whole-step path (pre round-4)")
    ap.add_argument("--no-act", action="store_true",
                    help="random actions instead of the MPC controller")
    args = ap.parse_args()

    import bench
    from benchmarks.device import require_gpu
    from img_env_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    require_gpu()
    from img_env_tpu.parallel.batched_env import BatchedNavEnv
    from img_env_tpu.mpc.controller import MpcController
    from img_env_tpu.mpc.mppi import MppiConfig

    rows = []
    for shape in args.shapes.split(","):
        s, n = (int(v) for v in shape.split("x"))
        cfg = bench.build(n_robots=n)
        env = BatchedNavEnv(cfg, mesh=None, legacy_vmap=args.legacy)
        ctl = MpcController(env.core, MppiConfig(
            horizon=args.horizon, samples=args.samples))
        keys = jax.random.split(jax.random.PRNGKey(5), s)
        states, _ = env.reset(keys)
        mss = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (s,) + x.shape), ctl.init_state())

        @jax.jit
        def control_step(key, states, mss):
            k_plan, k_next = jax.random.split(key)
            if args.no_act:
                actions = jax.random.uniform(
                    k_plan, (s, n, 3), minval=-0.3, maxval=0.3)
                costs = jnp.zeros(())
            else:
                kk = jax.random.split(k_plan, s)
                actions, mss, costs = jax.vmap(ctl.act_fn)(kk, states, mss)
            states, obs, *_ = env.step_fn(states, actions)
            chk = (obs.sensor_maps.sum() + obs.lasers.sum()
                   + obs.ped_maps.sum() + obs.ped_vector_states.sum()
                   + costs.sum())
            return k_next, states, mss, chk

        ks = jax.random.PRNGKey(0)
        ks, states, mss, chk = control_step(ks, states, mss)   # compile
        jax.block_until_ready(chk)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            ks, states, mss, chk = control_step(ks, states, mss)
        jax.block_until_ready(chk)
        dt = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"S={s:3d} N={n:4d}  {dt:7.2f} ms/ctl-step  "
              f"{dt * 1e3 / (s * n):7.1f} us/robot-step", flush=True)
        rows.append((s, n, dt))

    base = rows[0][2] * 1e3 / (rows[0][0] * rows[0][1])   # us/robot-step
    print("\n  S    N   ms/step  us/robot  vs single-scene")
    for s, n, dt in rows:
        pr = dt * 1e3 / (s * n)
        print(f"{s:3d} {n:4d} {dt:9.2f} {pr:9.1f}  {base / pr * 100:5.1f}%")


if __name__ == "__main__":
    main()
