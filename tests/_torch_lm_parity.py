"""Shared helpers of the LM parity tests against the JAX package
(tests/test_torch_models.py, tests/test_torch_models_bf16.py): the same
weights (the JAX ``init(PRNGKey(0))`` pytree, carried over by
``convert.lm_params_from_jax``) and the same seeded numpy inputs go
through both packages.

Tolerances. In float32 both packages do the same operations in the same
order, and a first run of this comparison showed differences of at most
3e-7 on logits of magnitude ~0.5 (and 1e-6 on the loss): the bounds, 1e-4
on logits and 1e-5 on the loss, leave room for another BLAS's summation
order and still catch any wrong operation (those move logits by 1e-2 or
more). In bfloat16 the two frameworks round intermediate results at
different places (XLA may keep a fused chain in float32), which moved
logits by up to 6e-3 in the same run: the bound is 5e-2, about two bf16
steps at the logits' magnitude of ~1, and the loss, a 1-Lipschitz function
of the logits in the max norm, is held to the same 5e-2.
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model
from repro_torch.models import encdec

torch.set_num_threads(1)

TOL = {"float32": {"logits": 1e-4, "loss": 1e-5},
       "bfloat16": {"logits": 5e-2, "loss": 5e-2}}


def inputs(cfg, B, S):
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.vision_patches:
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return b


def _jax_params(jcfg):
    """The JAX package's ``init(PRNGKey(0))`` of the float32 config
    (numpy leaves). For bfloat16 the leaves that the bfloat16 config makes
    in bfloat16 are rounded to it, so both packages get the same bfloat16
    weights."""
    f32 = dataclasses.replace(jcfg, dtype="float32")
    params = jax.tree.map(np.asarray, jax.jit(jbuild_model(f32).init)(
        jax.random.PRNGKey(0)))
    if jcfg.dtype == "float32":
        return params
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, s: np.asarray(jnp.asarray(a).astype(
        s.dtype)), params, shapes)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)),
                        tree)


def _jax_reference(jcfg, params, batch, B, steps):
    """``loss`` and ``prefill`` on the full and the blockwise path (one
    jitted program), then ``steps`` jitted decode steps from an empty
    cache (encdec: over a 4-frame memory)."""
    jm = jbuild_model(jcfg, remat="none")
    jbw = jbuild_model(dataclasses.replace(jcfg, attn_chunk=4),
                       remat="none")

    @jax.jit
    def full(p, batch):
        return {"loss": jm.loss(p, batch), "prefill": jm.prefill(p, batch),
                "loss_bw": jbw.loss(p, batch),
                "prefill_bw": jbw.prefill(p, batch)}

    p = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = full(p, jb)
    if jcfg.family == "encdec":
        cache = jm.init_cache(p, B, 8, jencdec.encode(
            p, jcfg, jb["frames"][:, :4], remat="none"))
    else:
        cache = jm.init_cache(p, B, 8)
    step = jax.jit(jm.decode)
    lgs = []
    for t in range(steps):
        lg, cache = step(p, jb["tokens"][:, t:t + 1], cache)
        lgs.append(lg)
    out["decode"] = jnp.concatenate(lgs, axis=1)
    return _f32(out)


def check_against_jax(arch, dtype):
    """The port's loss, prefill (full and blockwise) and 4 decode steps
    against the JAX package's on the same weights and inputs, within
    ``TOL[dtype]``."""
    B, S, steps = 2, 12, 4
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    batch = inputs(cfg, B, S)
    jparams = _jax_params(jcfg)
    want = _jax_reference(jcfg, jparams, batch, B, steps)
    params = lm_params_from_jax(jparams, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    m = build_model(cfg, remat="none", device="cpu")
    bw = build_model(dataclasses.replace(cfg, attn_chunk=4), device="cpu")
    tol = TOL[dtype]

    def close(got, name, what="logits"):
        err = float(np.abs(got.detach().float().numpy() - want[name]).max())
        assert err <= tol[what], (name, err)

    with torch.no_grad():
        close(m.loss(params, tb), "loss", "loss")
        close(bw.loss(params, tb), "loss_bw", "loss")
    close(m.prefill(params, tb), "prefill")
    close(bw.prefill(params, tb), "prefill_bw")
    if cfg.family == "encdec":
        mem = encdec.encode(params, cfg, tb["frames"][:, :4])
        cache = m.init_cache(params, B, 8, mem)
    else:
        cache = m.init_cache(params, B, 8)
    lgs = []
    for t in range(steps):
        lg, cache = m.decode(params, tb["tokens"][:, t:t + 1].long(), cache)
        lgs.append(lg)
    close(torch.cat(lgs, dim=1), "decode")
