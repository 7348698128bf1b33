"""Sequential NumPy oracle of pedsim's Social Force Model semantics."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from img_env_tpu.constants import (
    SFM_CUTOFF_DIST_SQ,
    SFM_FACTOR_DESIRED,
    SFM_FACTOR_LOOKAHEAD,
    SFM_FACTOR_OBSTACLE,
    SFM_FACTOR_SOCIAL,
    SFM_GAMMA,
    SFM_LAMBDA,
    SFM_N,
    SFM_N_PRIME,
    SFM_NEIGHBORHOOD_RANGE,
    SFM_OBSTACLE_SIGMA,
    SFM_AGENT_RADIUS,
)


def _norm(v):
    n = math.hypot(v[0], v[1])
    return v / n if n > 0 else np.zeros(2)


class SfmOracleAgent:
    def __init__(self, pos, vel, vmax, waypoints):
        """waypoints: list of (xy, r); empty for robot mirrors."""
        self.p = np.array(pos, float)
        self.v = np.array(vel, float)
        self.vmax = vmax
        self.wp = list(waypoints)
        self.dest = 0 if self.wp else None   # index into wp
        self.head = 0
        self.desired_dir = np.zeros(2)

    def desired_force(self):
        if self.dest is None and self.wp:
            self.dest = self.head % len(self.wp)
            self.head += 1
        if self.dest is None:
            self.desired_dir = np.zeros(2)
            return np.zeros(2)
        xy, r = self.wp[self.dest]
        diff = np.array(xy) - self.p
        d = math.hypot(diff[0], diff[1])
        self.desired_dir = _norm(diff)
        reached = d < r
        if reached:
            self.dest = None
        return _norm(self.desired_dir) * self.vmax


def _social(agent, others):
    force = np.zeros(2)
    for o in others:
        if o is agent:
            continue
        diff = o.p - agent.p
        if abs(diff[0]) > SFM_NEIGHBORHOOD_RANGE or abs(diff[1]) > SFM_NEIGHBORHOOD_RANGE:
            continue
        dsq = float(diff @ diff)
        if dsq > SFM_CUTOFF_DIST_SQ or dsq == 0:
            continue
        dist = math.sqrt(dsq)
        diff_dir = diff / dist
        vel_diff = agent.v - o.v
        ivec = SFM_LAMBDA * vel_diff + diff_dir
        ilen = math.hypot(ivec[0], ivec[1])
        idir = ivec / ilen if ilen > 0 else np.zeros(2)
        dot = max(-1.0, min(1.0, float(idir @ diff_dir)))
        # idir x diff_dir, written so it is exactly 0 for equal velocities
        # (the angle of parallel vectors), not a rounding residual
        crs = (SFM_LAMBDA * (vel_diff[0] * diff_dir[1]
                             - vel_diff[1] * diff_dir[0]) / ilen
               if ilen > 0 else 0.0)
        theta = math.atan2(crs, dot)
        tsign = 0.0 if theta == 0 else math.copysign(1.0, theta)
        b = SFM_GAMMA * ilen
        b_safe = max(b, 1e-30)
        f_vel = -math.exp(-dist / b_safe - (SFM_N_PRIME * b * theta) ** 2)
        f_ang = -tsign * math.exp(-dist / b_safe - (SFM_N * b * theta) ** 2)
        left = np.array([-idir[1], idir[0]])
        force = force + f_vel * idir + f_ang * left
    return force


def _obstacle(agent, segs):
    if not segs:
        return np.zeros(2)
    best, best_diff = math.inf, np.zeros(2)
    for a, b in segs:
        rel_end = b - a
        lam = float((agent.p - a) @ rel_end) / max(float(rel_end @ rel_end), 1e-30)
        lam = min(max(lam, 0.0), 1.0)
        closest = a + lam * rel_end
        diff = agent.p - closest
        dsq = float(diff @ diff)
        if dsq < best:
            best, best_diff = dsq, diff
    dist = math.sqrt(best) - SFM_AGENT_RADIUS
    return math.exp(-dist / SFM_OBSTACLE_SIGMA) * _norm(best_diff)


def _lookahead(agent, others):
    pi = math.pi
    e = agent.desired_dir
    count = 0
    for o in others:
        if o is agent:
            continue
        dx, dy = o.p[0] - agent.p[0], o.p[1] - agent.p[1]
        if abs(dx) > SFM_NEIGHBORHOOD_RANGE or abs(dy) > SFM_NEIGHBORHOOD_RANGE:
            continue
        if dx * dx + dy * dy >= 400.0:
            continue
        at2v = math.atan2(-e[0], -e[1])
        at2d = math.atan2(-dx, -dy)
        at2v2 = math.atan2(-o.v[0], -o.v[1])
        s = at2d - at2v
        if s > pi:
            s -= 2 * pi
        if s < -pi:
            s += 2 * pi
        vv = at2v - at2v2
        if vv > pi:
            vv -= 2 * pi
        if vv < -pi:
            vv += 2 * pi
        if abs(vv) > 2.5:
            if -0.3 < s < 0:
                count -= 1
            if 0 < s < 0.3:
                count += 1
    if count < 0:
        return np.array([0.5 * e[1], -0.5 * e[0]])
    if count > 0:
        return np.array([-0.5 * e[1], 0.5 * e[0]])
    return np.zeros(2)


def sfm_oracle_step(agents: List[SfmOracleAgent], segs, h):
    """Tscene::moveAgents: compute all forces, then move all."""
    forces = []
    for ag in agents:
        desired = ag.desired_force()
        look = _lookahead(ag, agents)
        soc = _social(ag, agents)
        obs = _obstacle(ag, segs)
        forces.append(
            SFM_FACTOR_DESIRED * desired
            + SFM_FACTOR_SOCIAL * soc
            + SFM_FACTOR_OBSTACLE * obs
            + SFM_FACTOR_LOOKAHEAD * look
        )
    for ag, a in zip(agents, forces):
        p_des = ag.p + ag.v * h
        vh = ag.v * h
        vn = _norm(vh)
        for p2, p3 in segs:
            s1 = p_des - ag.p
            s2 = p3 - p2
            denom = -s2[0] * s1[1] + s1[0] * s2[1]
            if denom == 0:
                continue
            s = (-s1[1] * (ag.p[0] - p2[0]) + s1[0] * (ag.p[1] - p2[1])) / denom
            t = (s2[0] * (ag.p[1] - p2[1]) - s2[1] * (ag.p[0] - p2[0])) / denom
            if 0 <= s <= 1 and 0 <= t <= 1:
                inter = ag.p + t * s1
                p_des = inter - vn * 0.1
        ag.p = p_des
        ag.v = 0.5 * ag.v + a * h
        sp = math.hypot(ag.v[0], ag.v[1])
        if sp > ag.vmax:
            ag.v = ag.v / sp * ag.vmax
