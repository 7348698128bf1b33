"""The driver-facing bench configs must always build and step (CPU guard).

bench.py runs on the GPU; this test catches config/API drift early on the
CPU mesh (tiny robot counts — the
geometry pipeline statics dominate build time, so shrink the view too).
"""

import jax
import jax.numpy as jnp
import numpy as np


def _shrunk(d):
    d = dict(d)
    d["robot"] = dict(d["robot"], total=2)
    d["view_map"] = {"resolution": 0.05, "width": 6.0, "height": 6.0}
    d["range_total"] = 64
    if d.get("object", {}).get("total"):
        d["object"] = dict(d["object"], total=4)
    if d.get("ped_sim", {}).get("total"):
        d["ped_sim"] = dict(d["ped_sim"], total=3)
    return d


def test_bench200_config_steps():
    import bench
    from img_env_tpu.config import EnvConfig
    from img_env_tpu.env.nav_env import NavEnv
    from img_env_tpu.mpc.controller import MpcController
    from img_env_tpu.mpc.mppi import MppiConfig

    cfg = bench.build()
    assert cfg.robot.total == bench.N_ROBOTS
    assert cfg.object.total == bench.N_OBSTACLES

    # shrunken variant actually steps end-to-end with the MPC
    small = EnvConfig.from_dict(_shrunk({
        "env_name": "bench_guard",
        "control_hz": 0.4,
        "robot": {"total": 2, "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
                  "begin_poses_type": ["range"],
                  "begin_poses": [[0.5, 15.5, 0.5, 15.5]],
                  "target_poses_type": ["range"],
                  "target_poses": [[0.5, 15.5, 0.5, 15.5]]},
        "object": {"total": 4, "shape": ["circle"], "size_range": [[0.1, 0.2]],
                   "poses_type": ["range"], "poses": [[0.5, 15.5, 0.5, 15.5]]},
        "ped_sim": {"total": 0, "type": ""},
        "global_map": {"map_file": "room_16_empty.png", "resolution": 0.1},
        "range_total": 64, "max_ped": 10, "state_dim": 3,
    }))
    env = NavEnv(small)
    ctl = MpcController(env, MppiConfig(horizon=4, samples=16))
    key = jax.random.PRNGKey(0)
    state, obs = env.reset(key)
    ms = ctl.init_state()
    actions, ms, costs = ctl.act(key, state, ms)
    state, obs, reward, done, info = env.step(state, actions)
    assert np.asarray(obs.sensor_maps).shape == (2, 48, 48)
    assert np.isfinite(np.asarray(costs)).all()
    assert np.isfinite(np.asarray(reward)).all()
