"""Statistical parity of the scenario sampler vs the reference's EnvPos.

The on-device sampler (env/sampler.py) replaces the reference's unbounded
rejection loops (reset_helper.py:189-345) with fixed-trial masked
resampling.  PARITY.md claims the distributions agree; this test MEASURES
it: a faithful NumPy re-implementation of the reference's loop semantics
(`_envpos_oracle` below — unbounded inner loops, per-agent sequential
clearance, goal-fail-restarts-start coupling, circle re-rolls) generates
N scenarios, the jitted sampler generates N more, and two-sample KS
statistics on the begin/goal pose marginals must sit inside the
same-distribution band.

Critical value: D_crit(alpha=1e-3, n=m=2000) = 1.95*sqrt(2/2000) = 0.062.
We assert D < 0.06 per coordinate — tight enough to catch a wrong noise
sigma (0.5 -> 0.6 shifts circle-x D to ~0.10) or a missing annulus
rejection, loose enough for seed-to-seed variation (observed D ~0.02).
"""

import math
import random

import jax
import numpy as np
import pytest
from scipy.stats import ks_2samp

from img_env_tpu.config import EnvConfig
from img_env_tpu.env.sampler import SamplerSpec, sample_scenario_retry

N_SAMPLES = 2000
D_MAX = 0.06
VIEW = (2.5, 4.0, 2.5, 4.0)      # task_view (reset_helper.py:70)


# ---------------------------------------------------------------------------
# NumPy oracle: the reference's _reset_robot_ped loop semantics, verbatim
# (reset_helper.py:189-300) — unbounded loops, Python random module.
# ---------------------------------------------------------------------------

def _free_agents(x, y, poses, d=1.0):
    return all(p is None or math.hypot(x - p[0], y - p[1]) > d for p in poses)


def _free_obs(x, y, module2, obs):
    # free_check_obj (reset_helper.py:46-55): obs rows are (x, y, radius)
    return all(r == 0.0 or math.hypot(x - ox, y - oy) > module2 + r
               for ox, oy, r in obs)


def _rand_pose(xr, yr, tr):
    return [random.uniform(*xr), random.uniform(*yr), random.uniform(*tr)]


def _random_view(init_pose, pose_range):
    while True:
        p = _rand_pose((init_pose[0] - VIEW[1], init_pose[0] + VIEW[1]),
                       (init_pose[1] - VIEW[3], init_pose[1] + VIEW[3]),
                       (-3.14, 3.14))
        if (init_pose[0] - VIEW[0] <= p[0] <= init_pose[0] + VIEW[0]
                and init_pose[1] - VIEW[2] <= p[1] <= init_pose[1] + VIEW[2]):
            continue
        if (pose_range[0] <= p[0] <= pose_range[1]
                and pose_range[2] <= p[1] <= pose_range[3]):
            return p


def _envpos_oracle(agents, obs, circle_ranges, target_min_dist):
    """agents: list of (begin_type, begin_params, target_type, target_params,
    module_size).  Returns (init_poses [A,3], target_poses [A,3])."""
    a = len(agents)
    init = [None] * a
    target = [None] * a
    circle_range = random.uniform(*circle_ranges)
    circle_ok = False
    while not circle_ok:
        circle_ok = True
        for i, (bt, bp, tt_, tp_, mod) in enumerate(agents):
            if init[i] is not None and target[i] is not None:
                continue
            reset_init = True
            while reset_init:
                goal_fail = 0
                circle_fail = 0
                if "range" in bt:
                    while reset_init:
                        pr = bp
                        if "circle" in bt:
                            ang = random.uniform(-3.14, 3.14)
                            if "fix" in bt:
                                ang = -3.14 + (6.28 / a) * i
                            rp = [circle_range * math.cos(ang) + pr[0],
                                  circle_range * math.sin(ang) + pr[1],
                                  ang + 3.14]
                            rp[0] += random.gauss(0, 0.5)
                            rp[1] += random.gauss(0, 0.5)
                        else:
                            if "multi" in bt:
                                pr = pr[random.randint(0, len(pr) - 1)]
                            if len(pr) == 4:
                                rp = _rand_pose(pr[:2], pr[2:4], (-3.14, 3.14))
                            else:
                                rp = _rand_pose(pr[:2], pr[2:4], pr[4:6])
                        if (_free_agents(rp[0], rp[1], init)
                                and _free_obs(rp[0], rp[1], mod * 2, obs)):
                            init[i] = rp[:]
                            reset_init = False
                            break
                        if "circle" in bt:
                            circle_fail += 1
                            if circle_fail > 50:
                                circle_ok = False
                                for j, (btj, *_r) in enumerate(agents):
                                    if "circle" in btj:
                                        init[j] = target[j] = None
                if "circle_fix" in tt_ and init[i] is not None:
                    ang = init[i][2]
                    target[i] = [circle_range * math.cos(ang) + tp_[0],
                                 circle_range * math.sin(ang) + tp_[1],
                                 ang - 3.14]
                if "range" in tt_:
                    while True:
                        pr = tp_
                        if "circle" in tt_ and init[i] is not None:
                            ang = init[i][2]
                            rp = [circle_range * math.cos(ang) + pr[0],
                                  circle_range * math.sin(ang) + pr[1],
                                  ang - 3.14]
                            rp[0] += random.gauss(0, 0.5)
                            rp[1] += random.gauss(0, 0.5)
                        if "multi" in tt_:
                            pr = pr[random.randint(0, len(pr) - 1)]
                        if "view" in tt_:
                            rp = _random_view(init[i], pr)
                        elif len(pr) == 4:
                            rp = _rand_pose(pr[:2], pr[2:4], (-3.14, 3.14))
                        elif len(pr) == 6:
                            rp = _rand_pose(pr[:2], pr[2:4], pr[4:6])
                        if ((init[i][0] - rp[0]) ** 2
                                + (init[i][1] - rp[1]) ** 2
                                > target_min_dist ** 2
                                and _free_agents(rp[0], rp[1], target)
                                and _free_obs(rp[0], rp[1], mod * 2, obs)):
                            target[i] = rp[:]
                            break
                        goal_fail += 1
                        if goal_fail > 50:
                            reset_init = True
                            break
    return np.asarray(init), np.asarray(target)


# ---------------------------------------------------------------------------
# scenario cells
# ---------------------------------------------------------------------------

def _cfg(robot_over, n, target_min_dist=3.0, circle_ranges=None,
         obstacles=False):
    d = {
        "robot": dict(total=n, shape=["circle"], size=[[0.0, 0.0, 0.17]],
                      **robot_over),
        "ped_sim": {"total": 0, "type": ""},
        "object": (dict(total=2, shape=["circle", "circle"],
                        size_range=[[0.25, 0.25], [0.35, 0.35]],
                        poses_type=["fix", "fix"],
                        poses=[[4.0, 4.0, 0.0], [6.5, 6.0, 0.0]])
                   if obstacles else dict(total=0)),
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "target_min_dist": target_min_dist,
        "reset_trials": 256,
        "reset_redraws": 10,
    }
    if circle_ranges:
        d["circle_ranges"] = list(circle_ranges)
    return EnvConfig.from_dict(d)


_ORACLE_OBS = [(4.0, 4.0, 0.25), (6.5, 6.0, 0.35)]
_MOD = 0.17


def _sample_ours(cfg, n_samples, seed=0):
    spec = SamplerSpec.from_config(cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_samples)
    fn = jax.jit(jax.vmap(lambda k: sample_scenario_retry(k, spec)))
    s = fn(keys)
    assert bool(np.asarray(s.ok).all()), "sampler failed placements"
    return np.asarray(s.init_poses), np.asarray(s.target_poses)


def _ks_report(name, ours, oracle):
    """Per-coordinate two-sample KS on pose marginals; returns worst D."""
    worst = 0.0
    a = ours.shape[1]
    for i in range(a):
        for c, lbl in ((0, "x"), (1, "y")):
            d, p = ks_2samp(ours[:, i, c], oracle[:, i, c])
            worst = max(worst, d)
            assert d < D_MAX, (
                f"{name}: agent {i} {lbl} KS D={d:.4f} (p={p:.2g}) "
                f">= {D_MAX} — sampler marginal drifted from EnvPos")
    return worst


def test_range_with_obstacles_marginals():
    """'range' begin+target, obstacle + agent clearance + target_min_dist."""
    random.seed(11)
    n = 3
    cfg = _cfg(dict(
        begin_poses_type=["range"] * n,
        begin_poses=[[1.5, 8.5, 1.5, 8.5]] * n,
        target_poses_type=["range"] * n,
        target_poses=[[1.5, 8.5, 1.5, 8.5]] * n,
    ), n, obstacles=True)
    agents = [("range", [1.5, 8.5, 1.5, 8.5], "range",
               [1.5, 8.5, 1.5, 8.5], _MOD)] * n
    oi = np.zeros((N_SAMPLES, n, 3))
    ot = np.zeros((N_SAMPLES, n, 3))
    for s in range(N_SAMPLES):
        oi[s], ot[s] = _envpos_oracle(agents, _ORACLE_OBS, (1.8, 2.0), 3.0)
    ours_i, ours_t = _sample_ours(cfg, N_SAMPLES)
    d1 = _ks_report("range begin", ours_i, oi)
    d2 = _ks_report("range target", ours_t, ot)
    # goal distance-to-start distribution (the target_min_dist rejection)
    gd_ours = np.linalg.norm(ours_t[:, :, :2] - ours_i[:, :, :2],
                             axis=-1).ravel()
    gd_orac = np.linalg.norm(ot[:, :, :2] - oi[:, :, :2], axis=-1).ravel()
    d3, _ = ks_2samp(gd_ours, gd_orac)
    assert gd_ours.min() > 3.0 and gd_orac.min() > 3.0
    assert d3 < D_MAX
    print(f"range cell: worst D begin {d1:.4f} target {d2:.4f} dist {d3:.4f}")


def test_range_circle_marginals():
    """'range_circle' begin (noisy ring) + 'circle_fix' target (opposite)."""
    random.seed(13)
    n = 4
    cfg = _cfg(dict(
        begin_poses_type=["range_circle"] * n,
        begin_poses=[[5.0, 5.0]] * n,
        target_poses_type=["circle_fix"] * n,
        target_poses=[[5.0, 5.0]] * n,
    ), n, circle_ranges=(2.2, 2.6), target_min_dist=0.0)
    agents = [("range_circle", [5.0, 5.0], "circle_fix", [5.0, 5.0],
               _MOD)] * n
    oi = np.zeros((N_SAMPLES, n, 3))
    ot = np.zeros((N_SAMPLES, n, 3))
    for s in range(N_SAMPLES):
        oi[s], ot[s] = _envpos_oracle(agents, [], (2.2, 2.6), 0.0)
    ours_i, ours_t = _sample_ours(cfg, N_SAMPLES)
    _ks_report("circle begin", ours_i, oi)
    _ks_report("circle target", ours_t, ot)
    # ring radius marginal (catches a wrong noise sigma / circle_range use)
    r_ours = np.linalg.norm(ours_i[:, :, :2] - 5.0, axis=-1).ravel()
    r_orac = np.linalg.norm(oi[:, :, :2] - 5.0, axis=-1).ravel()
    d, _ = ks_2samp(r_ours, r_orac)
    assert d < D_MAX
    # begin theta marginal: stored angle + pi, no noise (reset_helper.py:236)
    dth, _ = ks_2samp(ours_i[:, :, 2].ravel(), oi[:, :, 2].ravel())
    assert dth < D_MAX


def test_range_view_target_marginals():
    """'range_view' target: [2.5,4] annulus-box around the start."""
    random.seed(17)
    n = 2
    box = [1.0, 9.0, 1.0, 9.0]
    cfg = _cfg(dict(
        begin_poses_type=["range"] * n,
        begin_poses=[[3.0, 7.0, 3.0, 7.0]] * n,
        target_poses_type=["range_view"] * n,
        target_poses=[box] * n,
    ), n, target_min_dist=0.0)
    agents = [("range", [3.0, 7.0, 3.0, 7.0], "range_view", box, _MOD)] * n
    oi = np.zeros((N_SAMPLES, n, 3))
    ot = np.zeros((N_SAMPLES, n, 3))
    for s in range(N_SAMPLES):
        oi[s], ot[s] = _envpos_oracle(agents, [], (1.8, 2.0), 0.0)
    ours_i, ours_t = _sample_ours(cfg, N_SAMPLES)
    _ks_report("view target", ours_t, ot)
    # offsets from start: the annulus-box shape itself
    off_ours = (ours_t[:, :, :2] - ours_i[:, :, :2]).reshape(-1, 2)
    off_orac = (ot[:, :, :2] - oi[:, :, :2]).reshape(-1, 2)
    for c in range(2):
        d, _ = ks_2samp(off_ours[:, c], off_orac[:, c])
        assert d < D_MAX
    # no offset may land in the inner exclusion box
    inner = (np.abs(off_ours[:, 0]) <= VIEW[0]) & \
            (np.abs(off_ours[:, 1]) <= VIEW[2])
    assert not inner.any()


def test_range_multi_marginals():
    """'range_multi' begin: uniform region choice per attempt."""
    random.seed(19)
    n = 2
    regions = [[1.0, 3.0, 1.0, 3.0], [6.0, 9.0, 6.0, 9.0]]
    cfg = _cfg(dict(
        begin_poses_type=["range_multi"] * n,
        begin_poses=[regions] * n,
        target_poses_type=["range"] * n,
        target_poses=[[1.0, 9.0, 1.0, 9.0]] * n,
    ), n, target_min_dist=0.0)
    agents = [("range_multi", regions, "range", [1.0, 9.0, 1.0, 9.0],
               _MOD)] * n
    oi = np.zeros((N_SAMPLES, n, 3))
    ot = np.zeros((N_SAMPLES, n, 3))
    for s in range(N_SAMPLES):
        oi[s], ot[s] = _envpos_oracle(agents, [], (1.8, 2.0), 0.0)
    ours_i, ours_t = _sample_ours(cfg, N_SAMPLES)
    _ks_report("multi begin", ours_i, oi)
    # region mixture weights: ~50/50 after clearance rejections
    frac_ours = (ours_i[:, :, 0] < 4.0).mean()
    frac_orac = (oi[:, :, 0] < 4.0).mean()
    assert abs(frac_ours - frac_orac) < 0.03
