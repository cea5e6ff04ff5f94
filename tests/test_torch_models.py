"""The port's LM models (repro_torch.models) on the CPU.

Mirrors tests/test_models_smoke.py's forward, decode and prefill cases
over every architecture (the train step is in tests/test_torch_train.py),
and holds each architecture's port against the JAX package on the
same weights: the JAX ``init(PRNGKey(0))`` pytree, carried over by
``convert.lm_params_from_jax``, and the same seeded numpy tokens (and
frames / patch embeddings). Compared: ``loss``, ``prefill``'s logits on
the full-attention path and on the blockwise path (``attn_chunk=4``,
S=12: three q blocks), and the logits of 4 decode steps from an empty
cache. Also the forward half of tests/test_property.py's
``test_blockwise_attention_matches_full``.

Float32 here (logits within 1e-4, loss within 1e-5); bfloat16 in
tests/test_torch_models_bf16.py. tests/_torch_lm_parity.py says how the
tolerances were set.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_lm_parity import check_against_jax
from repro.configs import ARCH_IDS

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import encdec
from repro_torch.models.layers import _sdpa_blockwise, _sdpa_full

torch.set_num_threads(1)


def _batch(cfg, B=2, S=16):
    b = {"tokens": torch.ones((B, S), dtype=torch.long),
         "labels": torch.ones((B, S), dtype=torch.long)}
    if cfg.family == "encdec":
        b["frames"] = torch.ones((B, S, cfg.d_model))
    if cfg.vision_patches:
        b["vision_embeds"] = torch.ones((B, cfg.vision_patches,
                                         cfg.d_model))
    return b


def _model(arch):
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg, device="cpu")
    return cfg, m, m.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_loss(arch):
    cfg, m, params = _model(arch)
    loss = m.loss(params, _batch(cfg))
    assert loss.shape == () and bool(torch.isfinite(loss))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step(arch):
    cfg, m, params = _model(arch)
    B, S = 2, 8
    if cfg.family == "encdec":
        mem = encdec.encode(params, cfg, torch.ones((B, 4, cfg.d_model)))
        cache = m.init_cache(params, B, S, mem)
    else:
        cache = m.init_cache(params, B, S)
    lg, cache2 = m.decode(params, torch.ones((B, 1), dtype=torch.long),
                          cache)
    assert lg.shape == (B, 1, cfg.padded_vocab)
    assert bool(torch.all(torch.isfinite(lg.float())))
    # different input token -> different logits
    lg2, _ = m.decode(params, torch.full((B, 1), 2, dtype=torch.long),
                      cache2)
    assert not torch.allclose(lg.float(), lg2.float())


def test_prefill_last_logits():
    cfg, m, params = _model("qwen3_32b")
    lg = m.prefill(params, _batch(cfg))
    assert lg.shape == (2, 1, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_matches_jax_on_the_same_weights(arch):
    """float32; tests/test_torch_models_bf16.py holds bfloat16."""
    check_against_jax(arch, "float32")


@pytest.mark.parametrize("seed,chunk,gmul", [(0, 32, 1), (1, 64, 2),
                                             (2, 32, 2)])
def test_blockwise_attention_matches_full(seed, chunk, gmul):
    """The forward half of tests/test_property.py's case: the blockwise
    online-softmax forward equals full attention (2e-5, the JAX test's
    bound), and the JAX package's blockwise forward (1e-5: the same
    operations in the same order)."""
    from repro.models.layers import _sdpa_blockwise as jblockwise
    B, S, KV, hd = 2, 128, 2, 16
    H = KV * gmul
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    full = _sdpa_full(tq, tk, tv, causal=True)
    bw = _sdpa_blockwise(tq, tk, tv, chunk)
    np.testing.assert_allclose(bw.numpy(), full.numpy(), atol=2e-5)
    np.testing.assert_allclose(bw.numpy(), np.asarray(jblockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk)), atol=1e-5)


@pytest.mark.parametrize("arch", ["jamba15_large", "seamless_m4t_v2"])
def test_cache_from_jax_continues_decode(arch):
    """A JAX decode cache after 3 steps (attention k/v/idx and mamba
    conv/ssm state; encdec's cross k/v), carried over by
    ``lm_cache_from_jax``, decodes the next step as JAX does (1e-4)."""
    import dataclasses
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro_torch.convert import lm_cache_from_jax, lm_params_from_jax
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    jm = jbuild_model(jcfg, remat="none")
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 4)).astype(
        np.int32)
    cache = jm.init_cache(jp, 2, 8)
    step = jax.jit(jm.decode)
    for t in range(3):
        _, cache = step(jp, jnp.asarray(toks[:, t:t + 1]), cache)
    want, _ = step(jp, jnp.asarray(toks[:, 3:]), cache)
    m = build_model(cfg, device="cpu")
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    tcache = lm_cache_from_jax(jax.tree.map(np.asarray, cache), cfg)
    assert len(tcache) == cfg.num_layers
    got, tcache = m.decode(params, torch.from_numpy(toks[:, 3:]).long(),
                           tcache)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-4


def test_fused_qkv_attention_matches_jax():
    """``init_attention(fused=True)`` (one wqkv matrix and bias) against
    the JAX package's on the same weights, full and blockwise (1e-5)."""
    import dataclasses
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    from repro_torch.models.layers import Params
    jcfg = dataclasses.replace(jget_config("qwen15_32b", reduced=True),
                               dtype="float32", attn_chunk=4)
    cfg = dataclasses.replace(get_config("qwen15_32b", reduced=True),
                              dtype="float32", attn_chunk=4)
    jp = JL.init_attention(jax.random.PRNGKey(0), jcfg, fused=True)
    jp["bqkv"] = jax.random.normal(jax.random.PRNGKey(1),
                                   jp["bqkv"].shape) * 0.1
    p = Params(**{k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in jp.items()})
    assert "wqkv" in p and "wq" not in p
    x = np.random.default_rng(3).standard_normal((2, 12, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    for causal in (True, False):      # blockwise (S=12 > 4), full
        want = JL.attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                            causal=causal)
        got = TL.attention(p, torch.from_numpy(x), cfg,
                           torch.from_numpy(pos.copy()), causal=causal)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)


def test_batch_spec_matches_jax():
    """The same names and shapes as the JAX package's, torch dtypes."""
    from repro.configs import get_config as jget_config
    from repro.models import batch_spec as jbatch_spec
    from repro_torch.models import batch_spec
    names = {torch.int32: "int32", torch.float32: "float32"}
    for arch in ARCH_IDS:
        cfg = get_config(arch, reduced=True)
        for kind in ("train", "prefill", "decode"):
            want = jbatch_spec(jget_config(arch, reduced=True), 16, 2, kind)
            got = batch_spec(cfg, 16, 2, kind)
            assert {k: (s, names[d]) for k, (s, d) in got.items()} == {
                k: (s, np.dtype(d).name) for k, (s, d) in want.items()}
