"""img_env_tpu — accelerator-native crowd-navigation simulation + MPC engine.

A from-scratch JAX/XLA re-architecture of the capabilities of
DRL-Navigation/img_env: batched multi-robot 2D navigation among pedestrian
crowds (ORCA / Social Force / emotional-ORCA / trajectory replay), grid-map
sensing (egocentric sensor maps, laser raycast, pedestrian maps), paper-exact
rewards and episode semantics, plus sampling/derivative-based MPC and
multi-chip sharding.

Public API:
    make_env(cfg)      — gym-style stateful facade (reference user surface)
    NavEnv             — jitted functional reset/step over WorldState
    EnvConfig          — typed config; loads reference yaml files unchanged
"""

from img_env_tpu.config import EnvConfig, read_yaml
from img_env_tpu.env.gymapi import ImgNavEnv, make_env
from img_env_tpu.env.nav_env import NavEnv

__version__ = "0.1.0"
__all__ = ["EnvConfig", "ImgNavEnv", "NavEnv", "make_env", "read_yaml"]
