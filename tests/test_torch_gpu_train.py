"""The port's training path on the card, at the reduced configs.

Marked ``gpu``: each test asks its fixture for a card and skips without
one. Run on the card with ``pytest -m gpu tests/test_torch_gpu_train.py``.
The card's machine has no JAX, so this file imports none: parity with the
JAX package is held on the CPU (test_torch_train_parity.py,
test_torch_train.py, test_torch_optim.py); here the card is held to the
port on the CPU, the autograd Functions to autograd through the plain
formulations, and the loop's recovery to an uninterrupted run (the
checks of chip_smoke.py's phase 11 (a)-(c), smaller).

Tolerances. Card against CPU in float32 (matmul precision "highest"):
the loss within 1e-5 relative and each gradient leaf within 1e-4 of its
own largest magnitude, the CPU parity bounds; the params after 2 AdamW
steps at lr 1e-3 within 1e-4 (lr / 10: a wrong update moves a param by
about lr, and Adam amplifies the devices' few-ulp gradient differences
only where a gradient is near eps). The Functions against the plain
formulations, relative to the largest magnitude: 1e-4 in float32, 2^-5
in bfloat16 (they round at other places; <= 1.2e-2 measured on the
CPU). The loop's losses within 1e-4: the embedding's gradient is an
atomic scatter-add on the card, not bit-deterministic.
"""
import copy
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataConfig, SyntheticLM, make_batch
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.optim import adamw, constant, warmup_cosine
from repro_torch.train import LoopConfig, make_train_step, train_loop
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import to_device

pytestmark = pytest.mark.gpu

FN_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert torch.get_float32_matmul_precision() == "highest"
    return torch.device("cuda")


def _loss_and_grads(bundle, params, batch):
    loss = bundle.loss(params, to_device(batch, bundle.device))
    return float(loss.detach()), torch.autograd.grad(
        loss, list(params.parameters()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_grads_and_adamw_match_cpu(cuda, arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg,
                                                            device=cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_card = copy.deepcopy(p_cpu).to(cuda)
    batches = [make_batch(cfg, DataConfig(2, 16, seed=0), i)
               for i in range(2)]
    loss_c, g_c = _loss_and_grads(cpu, p_cpu, batches[0])
    loss_g, g_g = _loss_and_grads(card, p_card, batches[0])
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for a, b in zip(g_c, g_g):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * float(
            a.abs().max())
    opt = adamw(constant(1e-3))
    for bundle, p in ((cpu, p_cpu), (card, p_card)):
        step, o = make_train_step(bundle, opt), opt.init(p)
        for b in batches:
            p, o, met = step(p, o, b)
            assert math.isfinite(float(met["grad_norm"]))
    for a, b in zip(p_cpu.parameters(), p_card.parameters()):
        assert float((b.detach().cpu() - a.detach()).abs().max()) <= 1e-4


def _vjp_rel(fn, ref, inputs, cot):
    out = []
    for f in (fn, ref):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        y = f(*xs)
        out.append([y.detach(), *torch.autograd.grad(y, xs, cot)])
    return max(float((a.float() - b.float()).abs().max())
               / float(b.float().abs().max()) for a, b in zip(*out))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functions_match_plain_autograd_on_card(cuda, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dt)
    H, KV, hd, S, c = 8, 2, 64, 256, 64
    attn = _vjp_rel(lambda q, k, v: L._sdpa_blockwise(q, k, v, c),
                    lambda q, k, v: L._sdpa_full(q, k, v, causal=True),
                    (rnd(2, S, H, hd), rnd(2, S, KV, hd), rnd(2, S, KV, hd)),
                    rnd(2, S, H, hd))
    w = 1.0 + 0.1 * torch.randn(512, generator=gen, device=cuda)
    rms = _vjp_rel(lambda x, w: L.rms_norm(x, w, 1e-6),
                   lambda x, w: L.rms_norm_fp32(x, w, 1e-6),
                   (rnd(2, S, 512), w), rnd(2, S, 512))
    assert attn <= FN_TOL[dtype] and rms <= FN_TOL[dtype]


def test_train_loop_recovers_on_card(cuda, tmp_path):
    cfg = dataclasses.replace(get_config("qwen3_32b", reduced=True),
                              dtype="float32")
    bundle = build_model(cfg, device=cuda)
    opt = adamw(warmup_cosine(3e-3, 10, 100))
    step = make_train_step(bundle, opt)

    def run(ckpt_dir, total, fail_at=None):
        params = bundle.init(torch.Generator(cuda).manual_seed(0))
        losses, fails = [], {fail_at}

        def step_fn(p, o, b):
            out = step(p, o, b)
            losses.append(float(out[2]["loss"]))
            return out

        def inj(s):
            if s in fails:
                fails.discard(s)
                raise RuntimeError("simulated node failure")

        stats = train_loop(step_fn, {"params": params,
                                     "opt": opt.init(params)},
                           SyntheticLM(cfg, DataConfig(4, 32,
                                                       mode="learnable")),
                           LoopConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                      ckpt_every=4), fail_injector=inj)
        return stats, losses

    stats, losses = run(str(tmp_path / "a"), 10, fail_at=7)
    clean, want = run(str(tmp_path / "b"), 10)
    assert (stats.restores, stats.steps_run, clean.steps_run) == (1, 13, 10)
    assert max(abs(x - y) for x, y in zip(losses[7:10], losses[4:7])) <= 1e-4
    assert max(abs(x - y) for x, y in zip(losses[7:], want[4:])) <= 1e-4
    assert losses[-1] < losses[0]
    resumed, _ = run(str(tmp_path / "a"), 14)
    assert resumed.steps_run == 4
    assert ckpt.latest_step(str(tmp_path / "a")) == 13


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    cfg = get_config("qwen3_32b", reduced=True)
    bundle = build_model(cfg, device=cuda)
    opt = adamw(constant(1e-3))
    p = bundle.init(torch.Generator(cuda).manual_seed(0))
    state = {"params": p, "opt": opt.init(p)}
    ckpt.save(str(tmp_path), 1, state)
    p2 = bundle.init(torch.Generator(cuda).manual_seed(1))
    fresh = ckpt.restore(str(tmp_path), 1, {"params": p2,
                                            "opt": opt.init(p2)})
    for a, b in zip(p.parameters(), fresh["params"].parameters()):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a, b)


def test_train_example_tiny_on_card(cuda, tmp_path):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_train_lm.py"
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats = mod.main(["--tiny", "--steps", "12", "--ckpt-dir",
                      str(tmp_path)])
    assert stats.steps_run == 12 and math.isfinite(stats.last_loss)
