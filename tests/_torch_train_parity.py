"""Shared helpers of the training parity tests against the JAX package
(tests/test_torch_train_parity.py, test_torch_train.py,
test_torch_optim.py): the JAX package's ``value_and_grad`` of
``bundle.loss`` on its own ``init(PRNGKey(0))`` weights, one jitted
program per architecture, cached per process, and the port's gradients
on the same weights (carried over by ``convert.lm_params_from_jax``) and
the same seeded numpy batch.

Tolerances (float32). The loss within 1e-5 relative: tests/_torch_lm_parity.py
measured the forward within 1e-6. Each gradient leaf within 1e-4 of its
own largest magnitude: the backward sums over the batch and sequence in
another order in each framework (and the port's layers are not stacked),
so a leaf's error scales with its own size, and a wrong operation moves a
leaf by far more than 1e-4 of it.
"""
import dataclasses
import functools

import numpy as np
import torch

import jax
from _torch_lm_parity import inputs
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's own largest magnitude
B = 2


def configs(arch, **over):
    """(JAX config, port config): the reduced config in float32."""
    return tuple(dataclasses.replace(get(arch, reduced=True),
                                     dtype="float32", **over)
                 for get in (jget_config, get_config))


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(arch, S=16, attn_chunk=None):
    """(params, batch, loss, grads) of the JAX package, numpy leaves.
    Shared between tests: do not modify."""
    over = {} if attn_chunk is None else {"attn_chunk": attn_chunk}
    jcfg, cfg = configs(arch, **over)
    jm = jbuild_model(jcfg, remat="none")
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0)))
    batch = inputs(cfg, B, S)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
    return params, batch, float(loss), jax.tree.map(np.asarray, grads)


def port_value_and_grad(cfg, jparams, batch, remat="none"):
    """(loss, {name: grad}) of the port on the JAX weights."""
    params = lm_params_from_jax(jparams, cfg)
    m = build_model(cfg, remat=remat, device="cpu")
    loss = m.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    named = list(params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), {n: g for (n, _), g in zip(named, grads)}


def named(tree, cfg) -> dict:
    """A JAX param-shaped tree (numpy) -> {port name: numpy}."""
    return {n: t.detach().numpy()
            for n, t in lm_params_from_jax(tree, cfg).named_parameters()}


def check_grads_against_jax(arch, S=16, attn_chunk=None):
    over = {} if attn_chunk is None else {"attn_chunk": attn_chunk}
    _, cfg = configs(arch, **over)
    jparams, batch, jloss, jgrads = jax_value_and_grad(arch, S, attn_chunk)
    loss, grads = port_value_and_grad(cfg, jparams, batch)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    want = named(jgrads, cfg)
    assert sorted(want) == sorted(grads)
    for n, w in want.items():
        err = float(np.abs(grads[n].numpy() - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (n, err)
