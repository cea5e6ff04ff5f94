"""The port's backward passes against the JAX package's, on the CPU.

``rms_norm``'s autograd Function against JAX's ``custom_vjp`` and against
autograd through the plain fp32 formulation (tests/test_property.py's
``test_rms_norm_custom_vjp_matches_autodiff``: y within 1e-5, dx and dw
within 1e-4); the blockwise attention's flash backward against
``jax.vjp`` of JAX's ``_sdpa_blockwise`` (and autograd through
``_sdpa_full``) within 2e-5, the JAX forward test's bound; and every
architecture's loss and gradients against ``jax.value_and_grad`` of the
JAX bundle's loss on the same weights (tests/_torch_train_parity.py
gives the tolerances), plus one model whose sequence exceeds
``attn_chunk`` so that the flash backward runs inside it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_train_parity import check_grads_against_jax
from repro.configs import ARCH_IDS
from repro.models import layers as JL

from repro_torch.models import layers as L

torch.set_num_threads(1)


def _vjp(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = fn(*ts)
    return y.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        y, ts, torch.from_numpy(cot))]


@pytest.mark.parametrize("seed,b,s,dmul", [(0, 1, 1, 1), (1, 2, 3, 2),
                                           (2, 4, 2, 3), (3, 3, 1, 1),
                                           (4, 1, 3, 3)])
def test_rms_norm_function_matches_jax_and_autograd(seed, b, s, dmul):
    d = 8 * dmul
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    y, g = _vjp(lambda x, w: L.rms_norm(x, w, 1e-5), (x, w), dy)
    yr, gr = _vjp(lambda x, w: L.rms_norm_fp32(x, w, 1e-5), (x, w), dy)
    yj, vjp = jax.vjp(lambda x, w: JL.rms_norm(x, w, 1e-5),
                      jnp.asarray(x), jnp.asarray(w))
    gj = vjp(jnp.asarray(dy))
    for want_y, want_g in ((yr, gr), (np.asarray(yj), gj)):
        np.testing.assert_allclose(y, want_y, atol=1e-5)
        for a, b_ in zip(g, want_g):
            np.testing.assert_allclose(a, np.asarray(b_), atol=1e-4)


def test_rms_norm_backward_stays_in_bf16():
    """The cotangent of a bf16 activation is bf16 and dw takes w's
    dtype (fp32 norm scales), as JAX's custom_vjp returns them."""
    x = torch.randn(2, 3, 16, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    dx, dw = torch.autograd.grad(L.rms_norm(x, w, 1e-5), (x, w),
                                 torch.ones(2, 3, 16, dtype=torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32


@pytest.mark.parametrize("seed,chunk,gmul", [(0, 32, 1), (1, 64, 2),
                                             (2, 32, 2), (3, 64, 1)])
def test_blockwise_attention_backward_matches_jax(seed, chunk, gmul):
    B, S, KV, hd = 2, 128, 2, 16
    H = KV * gmul
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    out, g = _vjp(lambda q, k, v: L._sdpa_blockwise(q, k, v, chunk),
                  (q, k, v), do)
    _, gfull = _vjp(lambda q, k, v: L._sdpa_full(q, k, v, causal=True),
                    (q, k, v), do)
    jout, vjp = jax.vjp(lambda q, k, v: JL._sdpa_blockwise(q, k, v, chunk),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gj = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out, np.asarray(jout), atol=2e-5)
    for a, want, full in zip(g, gj, gfull):
        np.testing.assert_allclose(a, np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(a, full, atol=2e-5)


def test_blockwise_attention_saves_no_probability_block():
    """The forward keeps q, k, v, out and the lse for the backward, not
    the (c x c) probability blocks that autograd would stash."""
    B, S, KV, G, hd, c = 1, 64, 2, 2, 8, 16
    q = torch.randn(B, S, KV * G, hd, requires_grad=True)
    k = torch.randn(B, S, KV, hd, requires_grad=True)
    v = torch.randn(B, S, KV, hd, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        L._sdpa_blockwise(q, k, v, c)
    assert sorted(saved) == sorted([(B, S, KV * G, hd), (B, S, KV, hd),
                                    (B, S, KV, hd), (B, S, KV * G, hd),
                                    (S // c, B, KV, G, c)])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_match_jax(arch):
    check_grads_against_jax(arch)


def test_blockwise_grads_match_jax_in_model():
    """qwen3 with attn_chunk 16 at S=32: the flash forward and backward
    run inside the model (two q blocks)."""
    check_grads_against_jax("qwen3_32b", S=32, attn_chunk=16)
