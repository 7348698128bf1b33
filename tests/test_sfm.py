"""Batched SFM vs sequential pedsim-semantics oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from img_env_tpu.crowd.sfm import SfmWaypointState, sfm_step, waypoint_init
from img_env_tpu.oracle.sfm_oracle import SfmOracleAgent, sfm_oracle_step


def _scene(rng, m=6, n_rob=2, n_obs=2):
    center = rng.uniform(3, 7, 2)
    pos = center + rng.uniform(-2.0, 2.0, (m + n_rob, 2))
    vel = rng.uniform(-0.5, 0.5, (m + n_rob, 2))
    vmax = np.concatenate([rng.uniform(0.4, 0.6, m), rng.uniform(1.0, 1.4, n_rob)])
    goals = center + rng.uniform(-4, 4, (m, 2))
    starts = pos[:m].copy()
    segs = []
    for _ in range(n_obs):
        c = center + rng.uniform(-2.5, 2.5, 2)
        w, h = rng.uniform(0.2, 0.5, 2)
        segs.append((np.array([c[0] - w, c[1] - h]), np.array([c[0] + w, c[1] + h])))
    return pos, vel, vmax, goals, starts, segs, m, n_rob


def _build_states(pos, vel, vmax, goals, starts, m, n_rob):
    """Waypoint lists like pedscene.h:39-47: goal(r=1), goal(r=0), start(r=0)."""
    a = m + n_rob
    wmax = 3
    wp_xy = np.zeros((a, wmax, 2))
    wp_r = np.zeros((a, wmax))
    wp_len = np.zeros(a, np.int32)
    agents = []
    for i in range(m):
        wp_xy[i] = [goals[i], goals[i], starts[i]]
        wp_r[i] = [1.0, 0.0, 0.0]
        wp_len[i] = 3
        agents.append(
            SfmOracleAgent(pos[i], vel[i], vmax[i],
                           [(goals[i], 1.0), (goals[i], 0.0), (starts[i], 0.0)])
        )
    for i in range(m, a):
        agents.append(SfmOracleAgent(pos[i], vel[i], vmax[i], []))
    wp = waypoint_init(jnp.asarray(wp_xy), jnp.asarray(wp_r), jnp.asarray(wp_len))
    return wp, agents


@pytest.mark.parametrize("trial", range(3))
def test_sfm_rollout_parity(rng, trial):
    pos, vel, vmax, goals, starts, segs, m, n_rob = _scene(rng)
    wp, agents = _build_states(pos, vel, vmax, goals, starts, m, n_rob)
    a = m + n_rob

    jpos, jvel = jnp.asarray(pos), jnp.asarray(vel)
    seg_a = jnp.asarray(np.stack([s[0] for s in segs]))
    seg_b = jnp.asarray(np.stack([s[1] for s in segs]))
    seg_valid = jnp.ones(len(segs), bool)
    valid = jnp.ones(a, bool)

    for step in range(20):
        jpos, jvel, wp = sfm_step(
            jpos, jvel, jnp.asarray(vmax), valid, wp, seg_a, seg_b, seg_valid, 0.4
        )
        sfm_oracle_step(agents, segs, 0.4)
        opos = np.stack([ag.p for ag in agents])
        ovel = np.stack([ag.v for ag in agents])
        np.testing.assert_allclose(np.asarray(jpos), opos, atol=1e-9, err_msg=f"step {step}")
        np.testing.assert_allclose(np.asarray(jvel), ovel, atol=1e-9, err_msg=f"step {step}")


def test_sfm_waypoint_cycle(rng):
    """A ped reaching its r=1 goal refetches it, then sticks on the r=0 copy
    — the reference's observable 'walk to goal and stay' behavior."""
    goals = np.array([[1.0, 0.0]])
    starts = np.array([[-3.0, 0.0]])
    pos = np.array([[0.5, 0.0], [50.0, 50.0]])  # within 1m of goal; far robot
    vel = np.zeros((2, 2))
    vmax = np.array([0.6, 1.2])
    wp, agents = _build_states(pos, vel, vmax, goals, starts, 1, 1)
    jpos, jvel = jnp.asarray(pos), jnp.asarray(vel)
    seg_a = jnp.zeros((0, 2))
    seg_b = jnp.zeros((0, 2))
    seg_valid = jnp.zeros((0,), bool)
    for step in range(12):
        jpos, jvel, wp = sfm_step(
            jpos, jvel, jnp.asarray(vmax), jnp.ones(2, bool), wp,
            seg_a, seg_b, seg_valid, 0.4,
        )
        sfm_oracle_step(agents, [], 0.4)
        np.testing.assert_allclose(np.asarray(jpos[0]), agents[0].p, atol=1e-9)
    # after cycling, destination is the r=0 goal copy (index 1), never reached
    assert int(wp.dest_idx[0]) == 1
    assert bool(wp.has_dest[0])


def test_social_force_at_rest_has_no_sideways_term(rng):
    """Agents at rest (every ped right after a reset): the interaction
    direction is the unit separation, the signed angle between them is
    exactly 0, so the force is the pure repulsion term — no sideways term
    whose sign would come from rounding."""
    import math

    from img_env_tpu.constants import SFM_GAMMA, SFM_N_PRIME
    from img_env_tpu.crowd.sfm import _social_force

    pos = rng.uniform(0, 4, (9, 2))
    got = np.asarray(_social_force(jnp.asarray(pos), jnp.zeros((9, 2)),
                                   jnp.ones(9, bool)))
    want = np.zeros((9, 2))
    for i in range(9):
        for j in range(9):
            d = pos[j] - pos[i]
            dist = math.hypot(*d)
            if i == j or dist * dist > 64.0:
                continue
            ddir = d / dist
            idir = ddir / math.hypot(*ddir)
            b = SFM_GAMMA * math.hypot(*ddir)
            want[i] += -math.exp(-dist / b - (SFM_N_PRIME * b * 0.0) ** 2) * idir
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
