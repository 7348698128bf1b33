"""What keeps the program runnable on the card's machine: no optional
packages on the main path, one compile-cache location, a peaks table that
refuses unknown devices, and measurement entry points that refuse a
CPU-only host instead of falling back to it."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"

_BUILD_WITHOUT_OPTIONAL = r'''
import importlib.abc, sys
BLOCKED = {"yaml", "cv2", "PIL", "flax", "orbax", "matplotlib"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked for this test: " + name)
        return None

sys.meta_path.insert(0, Block())
import jax
import jax.numpy as jnp
from img_env_tpu.config import EnvConfig
from img_env_tpu.env.nav_env import NavEnv
from img_env_tpu.mpc.controller import MpcController
from img_env_tpu.mpc.mppi import MppiConfig

cfg = EnvConfig.from_dict({
    "robot": {"total": 2, "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
              "target_poses": [[1.0, 9.0, 1.0, 9.0]]},
    "object": {"total": 2, "shape": ["circle"], "size_range": [[0.1, 0.2]],
               "poses": [[2.0, 8.0, 2.0, 8.0]]},
    "ped_sim": {"total": 2, "type": "pedscene", "shape": ["leg"],
                "size": [[0.0, 0.1, 0.1]],
                "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
                "target_poses": [[1.0, 9.0, 1.0, 9.0]]},
    "global_map": {"map_file": "room_10.png", "resolution": 0.1},
    "view_map": {"resolution": 0.1, "width": 6.0, "height": 6.0},
    "range_total": 32, "max_ped": 2,
})
env = NavEnv(cfg)
ctl = MpcController(env, MppiConfig(horizon=3, samples=8))
state, obs = env.reset(jax.random.PRNGKey(0))
actions, ms, costs = ctl.act(jax.random.PRNGKey(1), state, ctl.init_state())
state, obs, reward, done, info = env.step(state, actions)
jax.block_until_ready(obs.sensor_maps)
loaded = sorted(BLOCKED & {m.split(".")[0] for m in sys.modules})
print("built", tuple(obs.sensor_maps.shape), "loaded", loaded)
'''


def _run(args, cwd=REPO, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu")
    full.update(env)
    full.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=600)


def test_main_path_needs_no_optional_packages():
    """NavEnv + MpcController import, build and step with yaml, cv2, PIL,
    flax, orbax and matplotlib all unimportable."""
    r = _run(["-c", _BUILD_WITHOUT_OPTIONAL])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "built (2, 48, 48) loaded []" in r.stdout


@pytest.mark.parametrize("var_set", [True, False])
def test_compile_cache_placement(tmp_path, var_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache is the checkout's .jax_cache/."""
    code = ("import jax\n"
            "from img_env_tpu.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    full = dict(os.environ, JAX_PLATFORMS="cpu")
    full.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if var_set:
        want = full["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [want, want]


def test_peaks_table_h100_and_unknown_device():
    from benchmarks.roofline import peaks_for, roofline_row

    pk = peaks_for(H100)
    assert (pk["hbm_gbs"], pk["bf16_tflops"], pk["fp32_tflops"]) == (
        3350.0, 989.0, 67.0)
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for("Unknown Accelerator X")
    # 3.35 GB at 3350 GB/s is a 1 ms floor; measured 2 ms -> 50 %
    row = roofline_row(2.0, 1e9, 3.35e9, H100)
    assert row["bound"] == "HBM"
    assert row["light_ms"] == pytest.approx(1.0)
    assert row["util_pct"] == pytest.approx(50.0)
    with pytest.raises(KeyError):
        roofline_row(2.0, 1e9, 3.35e9, "cpu")


def test_measurement_refuses_cpu():
    from benchmarks.device import require_gpu

    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def test_chip_smoke_fails_without_gpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """A copy of the script without the rest of the repo fails, printing
    no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_gpu_step_matches_cpu(gpu_device):
    """One reset + control step of a small crowd scene on the card against
    the same program on the CPU device: collision codes, dones and laser
    hits exact, view pixels at most one gray level apart (PERF.md, the
    tolerances of chip_smoke.py)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from img_env_tpu.env.nav_env import NavEnv

    cfg = bench.build_crowd(n_robots=8).replace(view_map_resolution=0.05,
                                                range_total=128)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(gpu_device):
        env = NavEnv(cfg)
        state, _ = env.reset(jax.random.PRNGKey(0))
        acts = jnp.tile(jnp.asarray([[0.3, 0.2, 0.0]]), (8, 1))
        step = jax.jit(env.step_fn)
        out_g = step(state, acts, env.sensor_tables)
    out_c = step(*jax.device_put((state, acts, env.sensor_tables), cpu))
    (_, og, _, dg, _), (_, oc, _, dc, _) = out_g, out_c
    for a, b in ((og.is_collisions, oc.is_collisions), (dg, dc),
                 (og.lasers, oc.lasers), (og.ped_maps[:, 0], oc.ped_maps[:, 0])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    levels = np.rint(np.abs(np.asarray(og.sensor_maps, np.float64)
                            - np.asarray(oc.sensor_maps)) * 255)
    assert levels.max() <= 1
