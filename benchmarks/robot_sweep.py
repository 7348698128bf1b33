"""Robot-count scaling sweep of the full parity-sensor control step.

One GPU, bench.py's geometry (16 m room, 200 obstacles, 400x400 bit-exact
views + 960-beam lasers, MPPI K=128 H=12), sweeping the robot count.
Timing: the evolving-state loop from bench.py (state feeds the next step;
block_until_ready at the end).

Usage: python benchmarks/robot_sweep.py [N ...]   (default 50 100 200 400)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    import bench
    from benchmarks.device import require_gpu
    from img_env_tpu.env.nav_env import NavEnv
    from img_env_tpu.utils.compile_cache import enable_compile_cache
    from img_env_tpu.mpc.controller import MpcController
    from img_env_tpu.mpc.mppi import MppiConfig

    enable_compile_cache()
    require_gpu()
    counts = [int(a) for a in sys.argv[1:]] or [50, 100, 200, 400]
    iters, warmup = 20, 3
    print(f"backend={jax.default_backend()}  K={bench.MPPI_SAMPLES} "
          f"H={bench.MPPI_HORIZON}  {bench.N_OBSTACLES} obstacles, "
          f"parity sensors")
    for n in counts:
        env = NavEnv(bench.build(n_robots=n))
        ctl = MpcController(env, MppiConfig(horizon=bench.MPPI_HORIZON,
                                            samples=bench.MPPI_SAMPLES))
        key = jax.random.PRNGKey(0)
        state, _ = env.reset(key)
        ms = ctl.init_state()
        tables = env.sensor_tables

        @jax.jit
        def control_step(key, state, mpc_state, tables,
                         env=env, ctl=ctl):
            k_plan, k_next = jax.random.split(key)
            actions, mpc_state, costs = ctl.act_fn(k_plan, state, mpc_state)
            state, obs, *_ = env.step_fn(state, actions, tables)
            chk = obs.sensor_maps.sum() + obs.lasers.sum() + costs.sum()
            return k_next, state, mpc_state, chk

        for _ in range(warmup):
            key, state, ms, chk = control_step(key, state, ms, tables)
        jax.block_until_ready(chk)
        t0 = time.perf_counter()
        for _ in range(iters):
            key, state, ms, chk = control_step(key, state, ms, tables)
        jax.block_until_ready(chk)
        dt = time.perf_counter() - t0
        step_ms = dt / iters * 1e3
        print(f"N={n:4d}: {step_ms:7.2f} ms/step  "
              f"{iters * n * bench.MPPI_SAMPLES / dt:9.0f} rollouts/s  "
              f"{step_ms / n * 1e3:6.1f} us/robot-step")


if __name__ == "__main__":
    main()
