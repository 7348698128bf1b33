"""Ped vectors and the 3-channel ped map against a sequential NumPy
oracle of the reference (yaml_env.py:392-458): peds sorted by base-frame
range², each drawn in order over the ±3 m window with the floor-div pixel
box and the circle test, later (farther) peds overwriting earlier pixels."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from img_env_tpu.env import observe

HS, R_IMG, MAX_PED = 48, 0.25, 10


def oracle_ped_obs(pose, ped_pos, ped_vel, ped_r, robot_r):
    m = len(ped_pos)
    res = 6.0 / HS
    c, s = math.cos(pose[2]), math.sin(pose[2])
    rows = []
    for j in range(m):
        dx, dy = ped_pos[j][0] - pose[0], ped_pos[j][1] - pose[1]
        px, py = c * dx + s * dy, -s * dx + c * dy
        vx = c * ped_vel[j][0] + s * ped_vel[j][1]
        vy = -s * ped_vel[j][0] + c * ped_vel[j][1]
        rows.append((px * px + py * py, j, px, py, vx, vy))
    rows.sort(key=lambda t: (t[0], t[1]))          # stable range order
    pmap = np.zeros((3, HS, HS))
    for _, j, px, py, vx, vy in rows:
        if not (-3.0 <= px <= 3.0 and -3.0 <= py <= 3.0):
            continue
        tx, ty = -px + 3.0, -py + 3.0
        for i in range(math.floor((tx - R_IMG) / res),
                       math.floor((tx + R_IMG) / res)):
            for k in range(math.floor((ty - R_IMG) / res),
                           math.floor((ty + R_IMG) / res)):
                if (0 <= i < HS and 0 <= k < HS
                        and ((i + 0.5) * res - tx) ** 2
                        + ((k + 0.5) * res - ty) ** 2 < R_IMG ** 2):
                    pmap[:, i, k] = (1.0, vx, vy)
    vec = np.zeros(1 + 7 * MAX_PED)
    vec[0] = m
    for q, (_, j, px, py, vx, vy) in enumerate(rows[:MAX_PED]):
        vec[1 + 7 * q: 8 + 7 * q] = (px, py, vx, vy, ped_r[j],
                                     ped_r[j] + robot_r,
                                     math.sqrt(px * px + py * py))
    if m:
        _, j, px, py, _, _ = rows[0]
        ped_min = math.sqrt(px * px + py * py) - (ped_r[j] + robot_r)
    else:
        ped_min = math.inf
    return vec, pmap, ped_min


def _check(poses, ped_pos, ped_vel, ped_r, rob_r):
    vec, pmap, pmin = observe.ped_vectors_and_map(
        jnp.asarray(poses), jnp.asarray(ped_pos), jnp.asarray(ped_vel),
        jnp.asarray(ped_r), jnp.asarray(rob_r), MAX_PED, 7, HS, R_IMG)
    for i in range(len(poses)):
        v, p, d = oracle_ped_obs(poses[i], ped_pos, ped_vel, ped_r, rob_r[i])
        np.testing.assert_allclose(np.asarray(vec[i]), v, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(np.asarray(pmap[i, 0]), p[0])
        np.testing.assert_allclose(np.asarray(pmap[i]), p, rtol=0,
                                   atol=1e-12)
        assert float(pmin[i]) == pytest.approx(d, abs=1e-12)
    return np.asarray(pmap)


@pytest.mark.parametrize("trial", range(3))
def test_ped_obs_matches_sequential_overwrite(rng, trial):
    n, m = 5, 23
    poses = np.column_stack([rng.uniform(1, 9, (n, 2)),
                             rng.uniform(-np.pi, np.pi, n)])
    ped_pos = rng.uniform(0, 10, (m, 2))
    ped_vel = rng.uniform(-1, 1, (m, 2))
    ped_r = rng.uniform(0.05, 0.3, m).round(2)
    pmap = _check(poses, ped_pos, ped_vel, ped_r, np.full(n, 0.17))
    assert pmap[:, 0].sum() > 0


def test_ped_map_overwrite_ties():
    """Two peds at the same position: the larger ORIGINAL index wins (the
    stable sort keeps index order among equal ranges, and the later drawn
    ped overwrites)."""
    poses = np.asarray([[5.0, 5.0, 0.3], [4.0, 6.0, -1.0]])
    ped_pos = np.asarray([[5.5, 5.2], [5.5, 5.2], [4.4, 6.1]])
    ped_vel = np.asarray([[0.1, 0.2], [0.3, -0.4], [0.0, 0.5]])
    pmap = _check(poses, ped_pos, ped_vel, np.full(3, 0.1),
                  np.full(2, 0.17))
    c, s = math.cos(0.3), math.sin(0.3)
    covered = pmap[0, 0] > 0
    np.testing.assert_allclose(pmap[0, 1][covered][0], c * 0.3 - s * 0.4)


def test_ped_obs_peds_outside_window():
    """Peds beyond the ±3 m window leave the map empty but still fill the
    range-sorted vector and the nearest-ped clearance."""
    poses = np.asarray([[5.0, 5.0, 0.0]])
    ped_pos = np.asarray([[9.5, 5.0], [5.0, 1.0], [1.2, 9.0]])
    ped_vel = np.zeros((3, 2))
    pmap = _check(poses, ped_pos, ped_vel, np.full(3, 0.1), np.full(1, 0.17))
    assert pmap.sum() == 0


def test_ped_obs_fewer_peds_than_max_ped(rng):
    """m < max_ped: the vector's unused ped slots stay zero."""
    poses = np.asarray([[3.0, 3.0, 1.0], [6.0, 4.0, -2.0]])
    ped_pos = rng.uniform(2, 7, (3, 2))
    ped_vel = rng.uniform(-1, 1, (3, 2))
    _check(poses, ped_pos, ped_vel, np.full(3, 0.2), np.full(2, 0.17))
