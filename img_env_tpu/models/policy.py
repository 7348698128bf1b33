"""Crowd-navigation policy networks (flax).

The reference repo is the *environment* for two papers (README.md:159-186):

  * Chen et al. 2020 (Sensors-20): map-based DRL collision avoidance driven by
    the stacked 48x48 ``sensor_map`` + vector state.
  * Yao et al. 2021 (IROS-21): crowd-aware navigation adding the 3-channel
    ``ped_map`` (occupancy, vx, vy) and per-pedestrian 7-vectors.

``CrowdNavPolicy`` is the actor-critic that consumes exactly the
observation layout our env emits (core/state.py Observation + the
StateBatchWrapper stacking):

  sensor_maps [B, k, 48, 48]  -> conv trunk (k frames as channels)
  ped_maps    [B, 3, 48, 48]  -> conv trunk
  vector      [B, k*state_dim]-> MLP
  ped_vectors [B, 1+7*max_ped]-> masked self-attention over ped tokens
                                 (SARL-style crowd encoder, cf.
                                 envs/utils/sarl_helper.py:6-36)

Design notes:
  * feature dims are multiples of 8 and the fusion trunk is 256/128-wide;
  * convolutions run in NHWC with channel counts >=32;
  * everything is bf16-friendly — pass ``dtype=jnp.bfloat16`` for activations
    while params stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    state_dim: int = 3
    image_batch: int = 1
    image_size: Tuple[int, int] = (48, 48)
    max_ped: int = 10
    ped_vec_dim: int = 7
    use_ped_map: bool = True
    use_ped_vec: bool = True
    act_dim: int = 2             # (v, w); 3 adds the beep logit
    discrete_actions: int = 0    # >0 -> categorical head of this many actions
    hidden: int = 256
    crowd_dim: int = 64
    log_std_init: float = -0.5   # initial Gaussian exploration (continuous)
    dtype: Any = jnp.float32

    @staticmethod
    def from_env_config(cfg, dtype=jnp.float32) -> "PolicyConfig":
        return PolicyConfig(
            state_dim=cfg.state_dim,
            image_batch=max(cfg.image_batch, 1),
            image_size=tuple(cfg.image_size),
            max_ped=cfg.max_ped,
            ped_vec_dim=cfg.ped_vec_dim,
            use_ped_map=cfg.ped_sim.total > 0,
            use_ped_vec=cfg.ped_sim.total > 0,
            act_dim=cfg.act_dim,
            discrete_actions=len(cfg.discrete_actions) if cfg.discrete_action else 0,
            dtype=dtype,
        )


class ConvTrunk(nn.Module):
    """48x48xC -> 256 feature vector. NHWC, stride-2 downsampling."""

    features: Sequence[int] = (32, 64, 64)
    out: int = 256
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        # x: [B, C, H, W] (reference layout) -> NHWC
        x = jnp.transpose(x, (0, 2, 3, 1)).astype(self.dtype)
        for i, f in enumerate(self.features):
            x = nn.Conv(f, (3, 3), strides=(2, 2), padding="SAME",
                        dtype=self.dtype, name=f"conv{i}")(x)
            x = nn.relu(x)
        x = x.reshape(x.shape[0], -1)
        x = nn.Dense(self.out, dtype=self.dtype, name="proj")(x)
        return nn.relu(x)


class CrowdAttention(nn.Module):
    """One masked self-attention block over pedestrian tokens.

    Input is the reference ped_vector layout: [B, 1 + D*max_ped] where slot 0
    is the valid-ped count (yaml_env.py:449-458); invalid tokens are masked.
    """

    max_ped: int
    ped_vec_dim: int
    dim: int = 64
    heads: int = 4
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, ped_vec):
        b = ped_vec.shape[0]
        count = ped_vec[:, 0].astype(jnp.int32)
        toks = ped_vec[:, 1:].reshape(b, self.max_ped, self.ped_vec_dim)
        toks = toks.astype(self.dtype)
        mask = (jnp.arange(self.max_ped)[None, :]
                < jnp.minimum(count, self.max_ped)[:, None])
        h = nn.Dense(self.dim, dtype=self.dtype, name="embed")(toks)
        h = nn.relu(h)
        attn_mask = mask[:, None, None, :]  # [B,1,1,T] broadcast over heads+query
        h = h + nn.MultiHeadDotProductAttention(
            num_heads=self.heads, qkv_features=self.dim,
            dtype=self.dtype, name="attn",
        )(h, mask=attn_mask)
        h = nn.relu(nn.Dense(self.dim, dtype=self.dtype, name="mlp")(h))
        # masked mean-pool; zero when no peds visible
        w = mask.astype(self.dtype)[..., None]
        pooled = (h * w).sum(1) / jnp.maximum(w.sum(1), 1.0)
        return pooled


class PolicyOutput(Tuple):
    pass


class CrowdNavPolicy(nn.Module):
    """Actor-critic over the full observation tuple."""

    cfg: PolicyConfig

    @nn.compact
    def __call__(self, sensor_maps, vector_states, ped_maps=None, ped_vectors=None):
        c = self.cfg
        dt = c.dtype
        feats = [ConvTrunk(out=c.hidden, dtype=dt, name="sensor_trunk")(
            sensor_maps.astype(dt))]
        v = vector_states.reshape(vector_states.shape[0], -1).astype(dt)
        h = nn.relu(nn.Dense(64, dtype=dt, name="vec0")(v))
        feats.append(nn.relu(nn.Dense(64, dtype=dt, name="vec1")(h)))
        if c.use_ped_map and ped_maps is not None:
            feats.append(ConvTrunk(features=(32, 64, 64), out=128, dtype=dt,
                                   name="ped_trunk")(ped_maps.astype(dt)))
        if c.use_ped_vec and ped_vectors is not None:
            feats.append(CrowdAttention(
                max_ped=c.max_ped, ped_vec_dim=c.ped_vec_dim,
                dim=c.crowd_dim, dtype=dt, name="crowd_attn")(ped_vectors))
        x = jnp.concatenate(feats, axis=-1)
        x = nn.relu(nn.Dense(c.hidden, dtype=dt, name="fuse0")(x))
        x = nn.relu(nn.Dense(c.hidden, dtype=dt, name="fuse1")(x))

        value = nn.Dense(1, dtype=dt, name="value")(x)[:, 0]
        if c.discrete_actions > 0:
            logits = nn.Dense(c.discrete_actions, dtype=dt, name="pi_logits")(x)
            return logits.astype(jnp.float32), value.astype(jnp.float32)
        mean = nn.Dense(c.act_dim, dtype=dt, name="pi_mean")(x)
        log_std = self.param(
            "pi_log_std", nn.initializers.constant(c.log_std_init),
            (c.act_dim,))
        log_std = jnp.broadcast_to(log_std, mean.shape)
        return (mean.astype(jnp.float32), log_std.astype(jnp.float32),
                value.astype(jnp.float32))


def example_inputs(cfg: PolicyConfig, batch: int = 8):
    h, w = cfg.image_size
    sm = jnp.zeros((batch, cfg.image_batch, h, w), jnp.float32)
    vs = jnp.zeros((batch, cfg.state_dim), jnp.float32)
    pm = jnp.zeros((batch, 3, h, w), jnp.float32) if cfg.use_ped_map else None
    pv = (jnp.zeros((batch, 1 + cfg.ped_vec_dim * cfg.max_ped), jnp.float32)
          if cfg.use_ped_vec else None)
    return sm, vs, pm, pv


def init_policy(key, cfg: PolicyConfig, batch: int = 8):
    model = CrowdNavPolicy(cfg)
    sm, vs, pm, pv = example_inputs(cfg, batch)
    params = model.init(key, sm, vs, pm, pv)
    return model, params


def sample_action(key, dist, continuous_ranges=None):
    """Draw an action from the policy head output.

    dist: (mean, log_std, value) or (logits, value).
    Returns (action, log_prob, value).
    """
    if len(dist) == 3:
        mean, log_std, value = dist
        eps = jax.random.normal(key, mean.shape)
        act = mean + jnp.exp(log_std) * eps
        logp = (-0.5 * ((act - mean) / jnp.exp(log_std)) ** 2
                - log_std - 0.5 * np.log(2 * np.pi)).sum(-1)
        if continuous_ranges is not None:
            lo = jnp.asarray([r[0] for r in continuous_ranges])
            hi = jnp.asarray([r[1] for r in continuous_ranges])
            act = jnp.clip(act, lo, hi)
        return act, logp, value
    logits, value = dist
    act = jax.random.categorical(key, logits)
    logp = jax.nn.log_softmax(logits)[jnp.arange(logits.shape[0]), act]
    return act, logp, value


def load_ckpt_policy(env_cfg, ckpt_dir: str, batch: int):
    """Deterministic-eval policy from a ``train_ppo --save`` checkpoint.

    Returns ``(policy_fn, params)`` where ``policy_fn(params, obs)`` maps a
    raw ``Observation`` (core/state.py) to clipped mean actions [N, act_dim]
    — the shared loader behind ``evaluate.py --policy ckpt`` and
    ``compare_methods.py``.  ``env_cfg`` must match the training config
    (the orbax restore is shape-checked against a fresh init).
    """
    import jax

    from img_env_tpu.train import checkpoint as ckpt_mod

    pcfg = PolicyConfig.from_env_config(env_cfg)
    model, params0 = init_policy(jax.random.PRNGKey(0), pcfg, batch=batch)
    params = ckpt_mod.restore(ckpt_dir, like={"params": params0})["params"]
    use_ped = env_cfg.ped_sim.total > 0
    ranges = env_cfg.continuous_actions[: env_cfg.act_dim]
    lo = jnp.asarray([r[0] for r in ranges])
    hi = jnp.asarray([r[1] for r in ranges])

    @jax.jit
    def policy_fn(params, obs):
        sm = obs.sensor_maps[:, None]
        pm = obs.ped_maps if use_ped else None
        pv = obs.ped_vector_states if use_ped else None
        mean, _, _ = model.apply(params, sm, obs.vector_states, pm, pv)
        return jnp.clip(mean, lo, hi)

    return policy_fn, params
