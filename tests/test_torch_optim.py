"""The port's optimizer (repro_torch.optim) on the CPU.

Mirrors tests/test_optim.py (all five tests) on the port, holds the
schedules' values to the JAX package's, and holds one AdamW update to
JAX's on identical state: the reduced qwen3's weights and gradients from
the JAX package, one JAX update to make the moments nonzero, then that
state carried over (``convert.lm_params_from_jax``,
``lm_opt_state_from_jax``) and one more update in both packages with the
same gradients. Params within 1e-6 absolute, m and v within 1e-6
relative: both do the same fp32 operations per element, and the global
norm sums the leaves in another order (the port's layers are not
stacked), which moves it by a few ulps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_train_parity import configs, jax_value_and_grad, named
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro.optim import warmup_cosine as jwarmup_cosine

from repro_torch.convert import lm_opt_state_from_jax, lm_params_from_jax
from repro_torch.models.layers import Params
from repro_torch.optim import adamw, constant, warmup_cosine
from repro_torch.optim.adamw import decays

torch.set_num_threads(1)


def _p(**t):
    return Params(**t)


def _g(params, **g):
    return {n: g[n] for n, _ in params.named_parameters()}


def test_adamw_matches_manual_reference():
    opt = adamw(constant(0.1), b1=0.9, b2=0.999, eps=1e-8,
                weight_decay=0.0, clip_norm=1e9)
    p = _p(w=torch.tensor([[1.0, 2.0]]))
    s = opt.init(p)
    p1, s1, _ = opt.update(_g(p, w=torch.tensor([[0.5, -0.25]])), s, p)
    # adam step 1: mhat = g, vhat = g^2 -> p - 0.1 * sign(g)
    np.testing.assert_allclose(p1["w"].detach().numpy(),
                               [[1.0 - 0.1, 2.0 + 0.1]], rtol=1e-5)


def test_weight_decay_only_on_matrices():
    opt = adamw(constant(0.1), weight_decay=0.1)
    p = _p(w=torch.ones((2, 2)), b=torch.ones((2,)))
    g = _g(p, w=torch.zeros((2, 2)), b=torch.zeros((2,)))
    p1, _, _ = opt.update(g, opt.init(p), p)
    assert bool((p1["w"] < 1.0).all())                  # decayed
    assert bool((p1["b"] == 1.0).all())                 # not decayed


def test_weight_decay_counts_the_layer_axis():
    """A 1-D leaf of a layer list is a 2-D stacked leaf in the JAX
    package's layout, and is decayed there."""
    assert decays("layers.0.ln1", torch.ones(4))
    assert decays("enc.3.ff.wg", torch.ones(4, 4))
    assert not decays("ln_f", torch.ones(4))
    assert decays("embed.tok", torch.ones(4, 4))


def test_clipping():
    opt = adamw(constant(0.1), clip_norm=1.0)
    p = _p(w=torch.zeros(4))
    _, _, met = opt.update(_g(p, w=torch.full((4,), 100.0)), opt.init(p), p)
    assert float(met["grad_norm"]) == 200.0             # reported pre-clip


def test_warmup_cosine_shape():
    lr = warmup_cosine(1.0, warmup=10, total=110, floor=0.1)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert float(lr(60)) < 1.0
    assert abs(float(lr(110)) - 0.1) < 1e-6


def test_bf16_params_fp32_moments():
    opt = adamw(constant(1e-2))
    p = _p(w=torch.ones((3, 3), dtype=torch.bfloat16))
    s = opt.init(p)
    assert s["m"]["w"].dtype == torch.float32
    p1, s1, _ = opt.update(_g(p, w=torch.ones((3, 3), dtype=torch.bfloat16)),
                           s, p)
    assert p1["w"].dtype == torch.bfloat16
    assert s1["v"]["w"].dtype == torch.float32


@pytest.mark.parametrize("peak,warmup,total,floor", [(1.0, 10, 110, 0.1),
                                                     (3e-3, 10, 100, 0.1),
                                                     (1e-3, 2, 6, 0.0)])
def test_schedules_equal_jax(peak, warmup, total, floor):
    lr, jlr = (f(peak, warmup, total, floor)
               for f in (warmup_cosine, jwarmup_cosine))
    steps = np.arange(total + 5, dtype=np.int32)
    got = np.array([float(lr(torch.tensor(int(s)))) for s in steps])
    want = np.array([float(jlr(jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert float(constant(peak)(3)) == float(jconstant(peak)(jnp.int32(3)))
    assert constant(peak)(3).dtype == torch.float32


def test_adamw_update_matches_jax():
    jcfg, cfg = configs("qwen3_32b")
    jparams, _, _, jgrads = jax_value_and_grad("qwen3_32b")
    jopt = jadamw(jwarmup_cosine(1e-3, 10, 100))
    p = jax.tree.map(jnp.asarray, jparams)
    p, state, _ = jax.jit(jopt.update)(jgrads, jopt.init(p), p)
    g2 = jax.tree.map(lambda g: np.asarray(-0.7 * g + 0.01 * np.sign(g),
                                           np.float32), jgrads)
    params = lm_params_from_jax(jax.tree.map(np.asarray, p), cfg)
    tstate = lm_opt_state_from_jax(jax.tree.map(np.asarray, state), cfg)
    assert int(tstate["step"]) == 1
    want_p, want_s, want_m = jax.jit(jopt.update)(g2, state, p)
    opt = adamw(warmup_cosine(1e-3, 10, 100))
    grads = {n: torch.from_numpy(g) for n, g in named(g2, cfg).items()}
    params, tstate, met = opt.update(grads, tstate, params)
    assert int(tstate["step"]) == 2
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    assert float(met["lr"]) == float(want_m["lr"])
    for n, w in named(jax.tree.map(np.asarray, want_p), cfg).items():
        np.testing.assert_allclose(params.get_parameter(n).detach().numpy(),
                                   w, atol=1e-6, err_msg=n)
    for key in ("m", "v"):
        want = named(jax.tree.map(np.asarray, want_s[key]), cfg)
        for n, w in want.items():
            np.testing.assert_allclose(tstate[key][n].numpy(), w,
                                       rtol=1e-6, atol=1e-30, err_msg=n)
