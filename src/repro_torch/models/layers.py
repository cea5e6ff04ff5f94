"""Dense building blocks: norms, RoPE, GQA attention (full / blockwise /
decode-with-cache), gated MLP, embeddings, losses; port of
``repro.models.layers``. ``rms_norm`` and the blockwise attention are
``torch.autograd.Function``s with the JAX package's ``custom_vjp``
backwards; everything else differentiates through autograd.

Conventions:
  * a layer's parameters are a ``Params``: an ``nn.Module`` that holds
    tensors and sub-``Params`` under the JAX package's names and reads like
    its dict (``p["wq"]``, ``"wqkv" in p``, ``p.get("bq")``), so a
    state_dict is ``layers.<i>.mixer.wq`` where JAX has
    ``blocks.b<j>.mixer.wq[r]``.
  * activations follow cfg.dtype (bf16); norms/softmax/logsumexp in fp32,
    rounded where the JAX package rounds (scores are a product in the
    activation dtype, then cast to fp32; softmax weights cast back before
    the PV product).
  * attention is computed step by step, as the JAX package computes it:
    blockwise (a loop over kv chunks, online softmax) whenever seq_len >
    cfg.attn_chunk, so S x S never materializes. No fused library
    attention.
  * masked scores are filled with -1e30, not -inf.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..distributed import ctx as dctx

__all__ = ["Params", "init_normal", "ones", "zeros", "rms_norm",
           "rms_norm_fp32", "rematerialized", "rope",
           "init_attention", "attention", "attention_decode", "init_mlp",
           "mlp", "init_embed", "embed", "logits", "softmax_xent"]

NEG = -1e30


class Params(nn.Module):
    """Named tensors and sub-``Params``, read like the JAX package's param
    dicts. Tensors become parameters (state_dict, ``.to``)."""

    def __init__(self, **items):
        super().__init__()
        for name, v in items.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v))
            else:
                self.add_module(name, v)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def rematerialized(fn, remat: str):
    """``fn`` under one of the JAX package's remat policies, for the
    backward of the loss: ``"full"`` keeps only ``fn``'s inputs and runs
    it again in the backward (``jax.checkpoint``); ``"dots"`` keeps the
    outputs of its matrix products too (``checkpoint_dots``); ``"none"``
    keeps everything autograd saves. Without grad mode ``fn`` runs as
    is."""
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"remat must be full, dots or none, not {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def init_normal(gen: torch.Generator, shape, dtype, stddev: float = 0.02):
    """N(0, stddev) drawn in ``dtype`` on the generator's device (the JAX
    package's ``normal(stddev=0.02)`` initializer)."""
    return torch.empty(shape, dtype=dtype, device=gen.device).normal_(
        0.0, stddev, generator=gen)


def ones(shape, gen: torch.Generator, dtype=torch.float32):
    """Ones on the generator's device (norm scales, SSM ``D``)."""
    return torch.ones(shape, dtype=dtype, device=gen.device)


def zeros(shape, gen: torch.Generator, dtype=torch.float32):
    """Zeros on the generator's device (biases)."""
    return torch.zeros(shape, dtype=dtype, device=gen.device)


# ---------------------------------------------------------------- norms ----
class _RMSNorm(torch.autograd.Function):
    """RMSNorm with fp32 statistics but activation-dtype tensors end to
    end, forward and backward (the JAX package's ``_rms_fwd``/``_rms_bwd``):
    only the variance and the two backward reductions run in fp32, so the
    cotangents stay in x.dtype."""

    @staticmethod
    def forward(ctx, x, w, eps):
        var = x.float().square().mean(-1, keepdim=True)
        inv32 = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, w, inv32)
        return x * inv32.to(x.dtype) * w.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, inv32 = ctx.saved_tensors
        inv = inv32.to(x.dtype)
        t = dy * w.to(x.dtype)
        # d/dx of x*inv: inv*t - x * inv^3 * mean(t*x) (fp32 reduction only)
        s = (t * x).float().mean(-1, keepdim=True)
        dx = t * inv - x * ((inv32 ** 3) * s).to(x.dtype)
        dw = (dy * x * inv).float().sum(
            dim=tuple(range(dy.ndim - 1))).to(w.dtype)
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: ``inv`` is cast to x.dtype before both multiplies; the
    backward stays in x.dtype (``_RMSNorm``). On DTensors the Function's
    ops run by their sharding rules (each has one)."""
    return _RMSNorm.apply(x, w, eps)


def rms_norm_fp32(x: torch.Tensor, w: torch.Tensor, eps: float):
    """The plain formulation (everything in fp32, cast once at the end),
    differentiated by autograd: the tests' reference for ``rms_norm``."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * w).to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   fused: bool = False) -> Params:
    """fused=True stores one wqkv matrix: a single projection product
    instead of three (the JAX package's option, kept for parity)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = cfg.param_dtype
    if fused:
        p = {"wqkv": init_normal(gen, (d, (H + 2 * KV) * hd), dt),
             "wo": init_normal(gen, (H * hd, d), dt)}
        if cfg.qkv_bias:
            p["bqkv"] = zeros(((H + 2 * KV) * hd,), gen, dt)
    else:
        p = {"wq": init_normal(gen, (d, H * hd), dt),
             "wk": init_normal(gen, (d, KV * hd), dt),
             "wv": init_normal(gen, (d, KV * hd), dt),
             "wo": init_normal(gen, (H * hd, d), dt)}
        if cfg.qkv_bias:
            p["bq"] = zeros((H * hd,), gen, dt)
            p["bk"] = zeros((KV * hd,), gen, dt)
            p["bv"] = zeros((KV * hd,), gen, dt)
    if cfg.qk_norm:
        p["qn"] = ones((hd,), gen)
        p["kn"] = ones((hd,), gen)
    return Params(**p)


def _proj(x, w, b):
    """x @ w (+ b), the weight through ``ctx.weight`` (gathered over the
    data axes where a partial sum over them would cost more)."""
    w = dctx.weight(w, x)
    return x @ w if b is None else x @ w + b


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor, use_rope: bool = True):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if "wqkv" in p:
        qkv = _proj(x, p["wqkv"], p.get("bqkv"))
        q, k, v = torch.split(qkv, [H * hd, KV * hd, KV * hd], dim=-1)
        q, k, v = (dctx.unflatten(t, -1, (n, hd))
                   for t, n in ((q, H), (k, KV), (v, KV)))
    else:
        q = dctx.unflatten(_proj(x, p["wq"], p.get("bq")), -1, (H, hd))
        k = dctx.unflatten(_proj(x, p["wk"], p.get("bk")), -1, (KV, hd))
        v = dctx.unflatten(_proj(x, p["wv"], p.get("bv")), -1, (KV, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_full(q, k, v, causal: bool, q_pos=None, k_pos=None):
    """Materializing attention (small S): q (B,Sq,H,hd), k/v (B,Sk,KV,hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qh, k).float()
    scores = scores * hd ** -0.5
    if causal:
        qp = (torch.arange(Sq, device=q.device) if q_pos is None
              else q_pos)
        kp = (torch.arange(k.shape[1], device=q.device) if k_pos is None
              else k_pos)
        mask = qp[:, None] >= kp[None, :]
        scores = torch.where(mask, scores, NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def _flash_fwd_impl(q, k, v, chunk: int):
    """Blockwise attention forward: per q block, the diagonal kv block
    (masked) then the strictly lower kv blocks in order (unmasked), merged
    by online softmax. Returns (out, lse)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    nq = S // chunk
    qb = q.reshape(B, nq, chunk, KV, G, hd)
    kb = k.reshape(B, nq, chunk, KV, hd)
    vb = v.reshape(B, nq, chunk, KV, hd)
    scale = hd ** -0.5
    pos = torch.arange(chunk, device=q.device)
    diag_mask = pos[:, None] >= pos[None, :]                       # (c, c)

    def partial_softmax(qc, kc, vc, masked):
        s = torch.einsum("bqkgh,bskh->bkgqs", qc, kc).float() * scale
        if masked:
            s = torch.where(diag_mask, s, NEG)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        acc = torch.einsum("bkgqs,bskh->bkgqh", p.to(qc.dtype), vc).float()
        return m, l, acc

    def merge(a, b):
        (ma, la, xa), (mb, lb, xb) = a, b
        m = torch.maximum(ma, mb)
        ca, cb = torch.exp(ma - m), torch.exp(mb - m)
        return m, la * ca + lb * cb, xa * ca[..., None] + xb * cb[..., None]

    outs, lses = [], []
    for qi in range(nq):
        qc = qb[:, qi]
        st = partial_softmax(qc, kb[:, qi], vb[:, qi], masked=True)
        for kj in range(qi):
            st = merge(st, partial_softmax(qc, kb[:, kj], vb[:, kj], False))
        m, l, acc = st
        outs.append(torch.einsum("bkgqh->bqkgh",
                                 acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))           # (B,KV,G,c) fp32
    out = torch.stack(outs, dim=1).reshape(B, S, H, hd)
    return out, torch.stack(lses, dim=0)        # lse: (nq,B,KV,G,c)


def _flash_bwd_impl(q, k, v, out, lse, dout, chunk: int):
    """The flash backward (the JAX package's ``_sdpa_bwd``): per q block,
    the probability blocks are recomputed from (q, k, lse), the diagonal
    kv block (masked) first, then the strictly lower ones in order; dq,
    dk and dv accumulate in fp32 and are cast back at the end."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    nq = S // chunk
    scale = hd ** -0.5
    qb = q.reshape(B, nq, chunk, KV, G, hd)
    dob = dout.reshape(B, nq, chunk, KV, G, hd)
    kb = k.reshape(B, nq, chunk, KV, hd)
    vb = v.reshape(B, nq, chunk, KV, hd)
    # D_i = rowsum(dO * O) per (query, head) in fp32 -> (nq,B,KV,G,c)
    Dfull = torch.einsum("bshd,bshd->bsh", dout.float(), out.float())
    Db = Dfull.reshape(B, nq, chunk, KV, G).permute(1, 0, 3, 4, 2)
    pos = torch.arange(chunk, device=q.device)
    diag_mask = pos[:, None] >= pos[None, :]

    def block_grads(qc, doc, Lc, Dc, kc, vc, masked):
        """One (q block, kv block) pair -> (dq_c, dk_c, dv_c), fp32."""
        s = torch.einsum("bqkgh,bskh->bkgqs", qc, kc).float() * scale
        p = torch.exp(s - Lc[..., None])                 # (B,KV,G,c,c)
        if masked:
            p = torch.where(diag_mask, p, 0.0)
        dp = torch.einsum("bqkgh,bskh->bkgqs", doc, vc).float()
        ds = p * (dp - Dc[..., None]) * scale
        dsl = ds.to(qc.dtype)
        pl = p.to(qc.dtype)
        dq_c = torch.einsum("bkgqs,bskh->bqkgh", dsl, kc).float()
        dk_c = torch.einsum("bkgqs,bqkgh->bskh", dsl, qc).float()
        dv_c = torch.einsum("bkgqs,bqkgh->bskh", pl, doc).float()
        return dq_c, dk_c, dv_c

    dq = torch.zeros((B, nq, chunk, KV, G, hd), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, nq, chunk, KV, hd), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for qi in range(nq):
        qc, doc, Lc, Dc = qb[:, qi], dob[:, qi], lse[qi], Db[qi]
        dq_c, dk_c, dv_c = block_grads(qc, doc, Lc, Dc, kb[:, qi],
                                       vb[:, qi], True)
        dk[:, qi] += dk_c
        dv[:, qi] += dv_c
        for kj in range(qi):
            a, b, c = block_grads(qc, doc, Lc, Dc, kb[:, kj], vb[:, kj],
                                  False)
            dq_c = dq_c + a
            dk[:, kj] += b
            dv[:, kj] += c
        dq[:, qi] = dq_c
    return (dq.reshape(B, S, H, hd).to(q.dtype),
            dk.reshape(B, S, KV, hd).to(k.dtype),
            dv.reshape(B, S, KV, hd).to(v.dtype))


class _SdpaBlockwise(torch.autograd.Function):
    """Flash attention with a flash backward: the forward saves (q, k, v,
    out, lse) and the backward recomputes the probability blocks from
    them, instead of autograd stashing every fp32 probability block."""

    @staticmethod
    def forward(ctx, q, k, v, chunk):
        out, lse = _flash_fwd_impl(q, k, v, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd_impl(q, k, v, out, lse, dout, ctx.chunk), None)


def _sdpa_blockwise(q, k, v, chunk: int):
    """Flash-style causal attention, O(S) memory forward and backward."""
    return _SdpaBlockwise.apply(q, k, v, chunk)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, causal: bool = True,
              kv_override=None) -> torch.Tensor:
    """Self (or cross, via kv_override=(k,v)) attention over full
    sequences."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, use_rope=kv_override is None)
    if kv_override is not None:
        k, v = kv_override
        fn = functools.partial(_sdpa_full, causal=False)
    elif causal and S > cfg.attn_chunk and S % cfg.attn_chunk == 0:
        fn = functools.partial(_sdpa_blockwise, chunk=cfg.attn_chunk)
    else:
        fn = functools.partial(_sdpa_full, causal=causal)
    # local to a (batch row, head): on a mesh it runs on each rank's rows
    # and heads (heads over 'model' when the kv heads divide it)
    lay = {0: dctx.get_batch_axes(), 2: dctx.model_axes(k.shape[2])}
    out = dctx.local(fn, [(q, lay, None), (k, lay, None), (v, lay, None)],
                    [(lay, None)])
    return _proj(dctx.flatten(out, 2), p["wo"], None)


def _decode_scores(q, ck, k, at: int, write: bool):
    """Write ``k`` at cache position ``at`` (when ``write``) and score
    q (B,1,H,hd) against the cache (B,S,KV,hd): (B,KV,H/KV,S) fp32."""
    if write:
        ck[:, at] = k[:, 0].to(ck.dtype)
    B, _, H, hd = q.shape
    qh = q.reshape(B, ck.shape[2], H // ck.shape[2], hd)
    return torch.einsum("bkgh,bskh->bkgs", qh, ck).float() * hd ** -0.5


def _decode_values(w, cv, v, at: int, write: bool):
    """Write ``v`` at cache position ``at`` (when ``write``) and weight the
    cache by w (B,KV,G,S): (B,1,KV*G,hd)."""
    if write:
        cv[:, at] = v[:, 0].to(cv.dtype)
    B, KV, G, _ = w.shape
    return torch.einsum("bkgs,bskh->bkgh", w, cv).reshape(
        B, 1, KV * G, cv.shape[-1])


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     cache: dict):
    """One-token decode: x (B,1,d); cache {'k','v': (B,Smax,KV,hd),
    'idx': int}. Every batch row writes position ``idx`` (one index for
    the whole batch, as in the JAX package). The cache tensors are updated
    in place; the write position is clamped to Smax-1 as
    ``dynamic_update_slice`` clamps it.

    On a mesh the cache is laid out by ``cache_specs``: rows over the
    batch axes, and the kv heads over 'model' when they divide it (the
    scores, softmax and values are local to a rank's rows and heads), else
    the sequence over 'model' (each rank writes and scores its own
    positions; the softmax sees the whole row and the values come back as
    a partial sum over 'model')."""
    B = x.shape[0]
    idx = cache["idx"]
    q, k, v = _qkv(p, x, cfg, positions=torch.full(
        (B, 1), idx, dtype=torch.int32, device=x.device))
    ck, cv = cache["k"], cache["v"]
    Smax = ck.shape[1]
    at = min(max(idx, 0), Smax - 1)
    valid = torch.arange(Smax, device=x.device) <= idx
    b, kax = dctx.get_batch_axes(), dctx.model_axes(ck.shape[2])
    if kax is not None or dctx.shards("model") == 1 or dctx.even_axes(
            "model", Smax) is None:        # local to (rows, kv heads)
        c_lay = r_lay = {0: b, 2: kax}     # cache; the new q, k, v
        s_lay, o_lay, pos, write = {0: b, 1: kax}, (r_lay, None), at, True
    else:                              # the sequence over 'model'
        n = Smax // dctx.shards("model")
        c_lay, r_lay, s_lay = {0: b, 1: "model"}, {0: b}, {0: b, 3: "model"}
        o_lay, pos = ({0: b}, "model"), at % n
        write = dctx.get_mesh().get_local_rank("model") == at // n
    s = dctx.local(functools.partial(_decode_scores, at=pos, write=write),
                   [(q, r_lay, None), (ck, c_lay, None), (k, r_lay, None)],
                   [(s_lay, None)])
    s = torch.where(valid, s, NEG)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out = dctx.local(functools.partial(_decode_values, at=pos, write=write),
                     [(w, s_lay, None), (cv, c_lay, None), (v, r_lay, None)],
                     [o_lay])
    return _proj(dctx.flatten(out, 2), p["wo"], None), {
        "k": ck, "v": cv, "idx": idx + 1}


# ------------------------------------------------------------------ mlp ----
def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return Params(wg=init_normal(gen, (d, ff), dt),
                  wu=init_normal(gen, (d, ff), dt),
                  wd=init_normal(gen, (ff, d), dt))


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _proj(F.silu(_proj(x, p["wg"], None)) * _proj(x, p["wu"], None),
                 p["wd"], None)


# ----------------------------------------------------------- embeddings ----
def init_embed(gen: torch.Generator, cfg: ModelConfig) -> Params:
    V = cfg.padded_vocab
    p = {"tok": init_normal(gen, (V, cfg.d_model), cfg.param_dtype)}
    if not cfg.tie_embeddings:
        p["head"] = init_normal(gen, (cfg.d_model, V), cfg.param_dtype)
    return Params(**p)


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the table. On a mesh the lookup runs on each rank's
    ids in the whole table (all-gathered), and the table's gradient comes
    back as a partial sum over the batch axes."""
    b = dctx.get_batch_axes()
    return dctx.local(lambda t, i: t[i], [(p["tok"], {}, b),
                                         (tokens, {0: b}, None)],
                     [({0: b}, None)])


def _rows(x: torch.Tensor) -> dict:
    """The activation context's layout of x's leading (row) dims."""
    rows = {0: dctx.get_batch_axes()}
    if dctx.get_seq_axes() is not None and x.ndim >= 3:
        rows[1] = dctx.get_seq_axes()
    return rows


def _row_axes(rows: dict) -> tuple:
    """The mesh axes that split the rows laid out as ``rows``: those a
    weight applied to them sums its gradient over."""
    return tuple(a for axes in rows.values() if axes is not None
                 for a in (axes if isinstance(axes, tuple) else (axes,)))


def _vocab_axes(rows: dict, n: int):
    """The axes of a vocabulary dim of ``n`` beside rows laid out as
    ``rows``: 'model' where it divides n evenly (``dctx.model_axes``),
    unless the rows already take it (the sequence over 'model', fsdp's
    sequence-parallel branch): a mesh axis shards one dim of a tensor."""
    vax = dctx.model_axes(n)
    return None if vax in _row_axes(rows) else vax


def logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Over the whole padded vocabulary (padding columns included). On a
    mesh each rank's rows against its slice of the vocabulary over
    'model' (the whole vocabulary where the sequence is over 'model'),
    the weight made whole over the data axes: the rows' gradient comes
    back as a partial sum over the vocabulary's axes, the weight's over
    the rows' axes. (Left to DTensor, the product with the weight's
    data-sharded d_model can come out as a partial sum over the data axes
    with every rank holding the logits of the whole batch.)"""
    rows = _rows(x)
    vax = _vocab_axes(rows, p["tok"].shape[0])
    b = _row_axes(rows) or None
    out = [({**rows, x.ndim - 1: vax}, None)]
    if "head" not in p:
        return dctx.local(lambda x, t: x @ t.T, [(x, rows, vax),
                                               (p["tok"], {0: vax}, b)], out)
    return dctx.local(lambda x, w: x @ w, [(x, rows, vax),
                                           (p["head"], {1: vax}, b)], out)


# --------------------------------------------------------------- losses ----
def softmax_xent(lg: torch.Tensor, labels: torch.Tensor,
                 z_coef: float = 1e-4) -> torch.Tensor:
    """lg: (..., V) logits, labels: (...,) int; -1 is ignored. Mean NLL
    over the kept labels plus a z-loss on the log-partition."""
    lg = lg.float()
    rows = _rows(lg)
    vax = _vocab_axes(rows, lg.shape[-1])
    lay = {**rows, lg.ndim - 1: vax}
    # the log-partition as logsumexp computes it (max, then the log of the
    # sum of exp(lg - max)); on a mesh each rank reduces its vocabulary
    # slice and only the (rows, shards) maxima and the row sums cross it
    m = dctx.local(lambda t: t.amax(-1, keepdim=True), [(lg, lay, None)],
                   [(lay, None)]).amax(-1).detach()
    from torch.distributed.tensor import DTensor
    mesh = lg.device_mesh if isinstance(lg, DTensor) else None
    v0 = (mesh.get_local_rank("model") * (lg.shape[-1] // dctx.shards(vax))
          if mesh is not None and vax is not None else 0)

    def parts(t, mx, y):
        s = torch.exp(t - mx[..., None]).sum(-1)
        # jax.nn.one_hot: a label of -1 one-hots to zeros
        oh = (y[..., None] == torch.arange(
            v0, v0 + t.shape[-1], device=t.device)).to(t.dtype)
        return s, torch.einsum("...v,...v->...", t, oh)

    s, gold = dctx.local(parts, [(lg, lay, None), (m, rows, None),
                                 (labels, rows, None)],
                         [(rows, vax), (rows, vax)])
    lse = m + torch.log(s)
    mask = (labels >= 0).float()
    nll = (lse - gold) * mask
    z = z_coef * (lse * mask) ** 2
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll.sum() + z.sum()) / denom
