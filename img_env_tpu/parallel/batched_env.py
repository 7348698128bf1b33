"""Scene-batched, mesh-sharded environment.

``BatchedNavEnv`` vmaps the single-scene pure functions over a leading
``[S]`` scene axis and (optionally) pins that axis to the ``scene`` mesh
axis, so S scenes x N robots step as one XLA program — the on-device
replacement for the reference's one-ROS-node-per-scene fan-out
(create_launch.py:25-34, SURVEY.md §2.1 parallelism table).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from img_env_tpu.config import EnvConfig
from img_env_tpu.env.nav_env import NavEnv
from img_env_tpu.parallel.mesh import SCENE_AXIS


class BatchedNavEnv:
    """S independent scenes of the same config, stepped together.

    reset(keys [S,2]) -> (states, obs)       # every leaf gains a leading S
    step(states, actions [S,N,3]) -> (states, obs, reward [S,N], done, info)
    """

    def __init__(self, cfg: EnvConfig, mesh: Optional[Mesh] = None,
                 jit: bool = True, legacy_vmap: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.core = NavEnv(cfg, jit=False)
        tables = self.core.sensor_tables
        # The default path vmaps only the genuinely per-scene work (crowd,
        # dynamics, raster compositing) and runs the sensor pipeline FLAT
        # over all S*N robots (NavEnv._sensor_pass): the polar incidence
        # tables stream once instead of once per scene.  ``legacy_vmap``
        # keeps the plain vmap-the-whole-step path (parity reference;
        # 'reference' sensor mode has no flat pipeline and always uses it).
        self.flat_sensors = (not legacy_vmap
                             and cfg.sensor_mode != "reference")

        if self.flat_sensors:
            def reset_fn(keys, carry=None, static_maps=None):
                f = self.core.reset_state_fn
                # per-scene static maps (heterogeneous worlds — a BARN
                # sweep compiles once; reference: one ROS node per
                # (env_name, env_num), create_launch.py:25-34)
                sm_ax = None if static_maps is None else 0
                states = jax.vmap(
                    lambda key, c, m: f(key, c, static_map=m),
                    in_axes=(0, None if carry is None else 0, sm_ax),
                )(keys, carry, static_maps)
                out = self.core._observe_multi(states, tables)
                return self._constrain(out)

            def step_fn(states, actions):
                states, alive, beeps = jax.vmap(self.core.advance_fn)(
                    states, actions)
                states, obs = self.core._observe_multi(states, tables)
                out = self.core._finish_step(states, obs, alive, beeps)
                return self._constrain(out)
        else:
            def reset_fn(keys, carry=None, static_maps=None):
                out = jax.vmap(
                    lambda key, c, m: self.core.reset_fn(
                        key, c, sensor_tables=tables, static_map=m),
                    in_axes=(0, None if carry is None else 0,
                             None if static_maps is None else 0),
                )(keys, carry, static_maps)
                return self._constrain(out)

            def step_fn(states, actions):
                out = jax.vmap(
                    lambda s, a: self.core.step_fn(s, a, sensor_tables=tables)
                )(states, actions)
                return self._constrain(out)

        self.reset_fn = reset_fn
        self.step_fn = step_fn
        self._reset = jax.jit(reset_fn) if jit else reset_fn
        self._step = jax.jit(step_fn) if jit else step_fn

    def _constrain(self, tree):
        if self.mesh is None:
            return tree
        sh = NamedSharding(self.mesh, P(SCENE_AXIS))

        def c(x):
            if hasattr(x, "ndim") and x.ndim >= 1:
                return jax.lax.with_sharding_constraint(x, sh)
            return x

        return jax.tree_util.tree_map(c, tree)

    def reset(self, keys, carry=None, static_maps=None):
        """carry: optional previous [S]-batched WorldState — persists
        vw_last1 / gait phase across auto-resets exactly like the
        single-scene path (nav_env.reset_state_fn carry).
        static_maps: optional [S,H,W] per-scene base maps (heterogeneous
        worlds in one program; same resolution, shapes padded equal)."""
        return self._reset(keys, carry, static_maps)

    def step(self, states, actions):
        return self._step(states, jnp.asarray(actions))

def rollout_with_obs(env: BatchedNavEnv, states, obs, keys, policy_fn):
    """Scan ``len(keys)`` steps; policy_fn(key, obs) -> [S,N,3] actions.

    Returns (final_states, final_obs, rewards [T,S,N], dones [T,S,N]).
    Everything stays on device; one compiled program for the whole horizon.
    """

    def body(carry, key):
        states, obs = carry
        actions = policy_fn(key, obs)
        states, obs, reward, done, info = env.step_fn(states, actions)
        return (states, obs), (reward, done)

    (states, obs), (rewards, dones) = jax.lax.scan(body, (states, obs), keys)
    return states, obs, rewards, dones
