"""Scene-batched env + PPO training throughput on one GPU.

The reference scales by launching one ROS node per scene; here S scenes
step as one XLA program (parallel/batched_env.py).  Reports aggregate
robot-steps/s for the env and env-steps/s inside the full PPO update.
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp


def timed_ms(fn, args_of, name, iters=10):
    """ms per call of jitted ``fn`` over ``iters`` calls with varying
    inputs, after one compile call; waits with block_until_ready."""
    jax.block_until_ready(fn(*args_of(0)))
    t0 = time.perf_counter()
    for i in range(iters):
        out = fn(*args_of(i + 1))
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / iters * 1e3
    print(f"{name}: {ms:.3f} ms")
    return ms


def build_cfg(robots: int, peds: int):
    from img_env_tpu.config import EnvConfig

    return EnvConfig.from_dict({
        "env_name": "scale",
        "control_hz": 0.4,
        "robot": {
            "total": robots, "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
            "begin_poses_type": ["range"], "begin_poses": [[0.5, 9.5, 0.5, 9.5]],
            "target_poses_type": ["range"], "target_poses": [[0.5, 9.5, 0.5, 9.5]],
        },
        "object": {"total": 4, "shape": ["circle"], "size_range": [[0.1, 0.2]],
                   "poses_type": ["range"], "poses": [[0.5, 9.5, 0.5, 9.5]]},
        "ped_sim": ({"total": peds, "type": "pedscene", "max_speed": [0.5],
                     "shape": ["leg"], "size": [[0.0, 0.1, 0.1]],
                     "begin_poses_type": ["range"],
                     "begin_poses": [[0.5, 9.5, 0.5, 9.5]],
                     "target_poses_type": ["range"],
                     "target_poses": [[0.5, 9.5, 0.5, 9.5]]}
                    if peds else {"total": 0, "type": ""}),
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "view_map": {"resolution": 0.015, "width": 6.0, "height": 6.0},
        "range_total": 960, "max_ped": 10, "state_dim": 3,
        "sensor_mode": "fast",
    })


def main():
    from benchmarks.device import require_gpu
    from img_env_tpu.parallel.batched_env import BatchedNavEnv
    from img_env_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    require_gpu()
    S, N, M = 16, 8, 4
    cfg = build_cfg(N, M)
    env = BatchedNavEnv(cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    states, obs = env.reset(keys)
    jax.block_until_ready(obs.sensor_maps)
    print(f"{S} scenes x {N} robots x {M} peds, fast sensors")

    @jax.jit
    def step_sum(states, actions):
        s2, o2, r, d, i = env.step_fn(states, actions)
        return o2.sensor_maps.sum() + r.sum()

    acts = jnp.zeros((S, N, 3))
    ms = timed_ms(step_sum, lambda i: (states, acts.at[:, :, 0].add(0.001 * i)),
                  name="batched env step")
    if ms > 0:
        print(f"  -> {S * N / ms * 1e3:.0f} robot-steps/s aggregate")

    # PPO update throughput (rollout T steps + GAE + clipped update, 1 program)
    from img_env_tpu.models.policy import PolicyConfig, init_policy
    from img_env_tpu.train.ppo import PpoConfig, make_train_step

    T = 8
    pcfg = PolicyConfig(state_dim=int(cfg.state_dim))
    model, params = init_policy(jax.random.PRNGKey(1), pcfg)
    init_fn, train_step = make_train_step(env, model, PpoConfig(unroll=T))
    ts = init_fn(params)

    @jax.jit
    def upd_sum(ts, states, obs, key):
        ts2, s2, o2, metrics = train_step(ts, states, obs, key)
        return metrics["loss"] + metrics["reward_mean"]

    ms = timed_ms(upd_sum, lambda i: (ts, states, obs, jax.random.PRNGKey(i)),
                  name=f"PPO update (T={T} rollout + GAE + grad)")
    if ms > 0:
        print(f"  -> {S * N * T / ms * 1e3:.0f} env-steps/s inside training")


if __name__ == "__main__":
    main()
