"""The port's MoE layer (repro_torch.models.moe) on the CPU.

Mirrors tests/test_moe.py: the grouped one-hot dispatch equals a
per-token loop without capacity limits (the oracle, numpy here), tight
capacity drops tokens, and the shared expert adds its dense FF. Then
``moe_ff`` against the JAX package's on the same weights and seeded
inputs, in both dispatch branches: the per-choice sum (T < 4 *
group_size) and the fused dispatch (T >= 4 * group_size), with and
without capacity drops. Float32; the outputs within 1e-6 (the same
operations in the same order: a first run differed by under 1e-7 on
outputs of ~1e-2), the aux loss within 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoESpec as JMoESpec
from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_ff as jmoe_ff

from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.models.layers import Params
from repro_torch.models.moe import init_moe, moe_ff

torch.set_num_threads(1)


def _cfg(E=4, k=2, cap=99.0, shared=False, cls=(ModelConfig, MoESpec)):
    mc, ms = cls
    return mc(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
              num_kv_heads=2, d_ff=32, vocab=64, dtype="float32",
              moe=ms(num_experts=E, top_k=k, d_ff_expert=32, group_size=8,
                     capacity_per_choice=cap, shared_expert=shared))


def _silu(x):
    return x / (1.0 + np.exp(-x))


def _oracle(p, x, cfg):
    """Per-token loop, no capacity limits, renormalized top-k."""
    m = cfg.moe
    B, S, d = x.shape
    out = np.zeros((B, S, d), np.float64)
    rl = x.astype(np.float64) @ p["router"].detach().double().numpy()
    probs = np.exp(rl - rl.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    wg, wu, wd = (p[k].detach().double().numpy()
                  for k in ("ewg", "ewu", "ewd"))
    for b in range(B):
        for s in range(S):
            pr = probs[b, s]
            idx = np.argsort(-pr)[: m.top_k]
            wsum = pr[idx].sum()
            for e in idx:
                h = _silu(x[b, s] @ wg[e]) * (x[b, s] @ wu[e])
                out[b, s] += (pr[e] / wsum) * (h @ wd[e])
    return out


def _x(B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, 16)).astype(np.float32)


def test_moe_matches_per_token_oracle():
    cfg = _cfg()
    p = init_moe(torch.Generator().manual_seed(0), cfg)
    x = _x(2, 8)
    y, aux = moe_ff(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.detach().numpy(), _oracle(p, x, cfg),
                               rtol=2e-4, atol=2e-5)
    assert aux.item() > 0


def test_moe_capacity_drops_tokens():
    """With tight capacity some tokens lose experts; output stays finite
    and differs from the uncapped one."""
    cfg = _cfg(cap=0.5)
    p = init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_x(2, 8))
    y, _ = moe_ff(p, x, cfg)
    assert bool(torch.all(torch.isfinite(y)))
    y_full, _ = moe_ff(p, x, _cfg(cap=99.0))
    assert not torch.allclose(y, y_full)


def test_moe_shared_expert():
    cfg = _cfg(shared=True)
    p = init_moe(torch.Generator().manual_seed(0), cfg)
    x = _x(1, 8)
    y, _ = moe_ff(p, torch.from_numpy(x), cfg)
    sp = {k: p["shared"][k].detach().double().numpy()
          for k in ("wg", "wu", "wd")}
    shared = (_silu(x @ sp["wg"]) * (x @ sp["wu"])) @ sp["wd"]
    np.testing.assert_allclose(y.detach().numpy(),
                               _oracle(p, x, cfg) + shared,
                               rtol=2e-4, atol=2e-5)


def _port_params(jp):
    return Params(**{k: _port_params(v) if isinstance(v, dict)
                     else torch.from_numpy(np.asarray(v).copy())
                     for k, v in jp.items()})


@pytest.mark.parametrize("B,S,cap,shared", [
    (2, 8, 99.0, False),          # T=16 < 32: per-choice dispatch
    (2, 8, 0.5, True),            # per-choice, capacity drops
    (4, 8, 99.0, False),          # T=32 >= 32: fused dispatch
    (4, 16, 0.5, True),           # fused, capacity drops, 8 groups
])
def test_moe_ff_matches_jax(B, S, cap, shared):
    cfg = _cfg(cap=cap, shared=shared)
    jcfg = _cfg(cap=cap, shared=shared, cls=(JModelConfig, JMoESpec))
    jp = jinit_moe(jax.random.PRNGKey(0), jcfg)
    x = _x(B, S, seed=B * S)
    want, jaux = jax.jit(jmoe_ff, static_argnums=2)(jp, jnp.asarray(x),
                                                   jcfg)
    y, aux = moe_ff(_port_params(jax.tree.map(np.asarray, jp)),
                    torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    assert abs(aux.item() - float(jaux)) <= 1e-6
    if cap < 1:                   # the drops are the JAX package's drops
        y_full, _ = moe_ff(_port_params(jax.tree.map(np.asarray, jp)),
                           torch.from_numpy(x),
                           dataclasses.replace(cfg, moe=dataclasses.replace(
                               cfg.moe, capacity_per_choice=99.0)))
        assert not torch.allclose(y, y_full)
