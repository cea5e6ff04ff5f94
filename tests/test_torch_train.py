"""The port's training path (repro_torch.train, launch/train.py) on the
CPU.

Mirrors tests/test_train_infra.py (loss decreases, accumulation ==
big batch, checkpoint round trip, GC and torn writes, failure recovery
and resume, the straggler watchdog, the async checkpointer; the two
compression tests wait for the sharded path) and
tests/test_models_smoke.py's train step over every architecture, in the
JAX tests' dtype (bfloat16). Holds gradients equal across ``remat``, the
port's ``train_loop`` to JAX's on the same weights and data with an
injected failure, and ``python -m repro_torch.launch.train`` to JAX's
driver (the loss falls in both).
"""
import copy
import dataclasses
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_train_parity import configs
from repro.configs import ARCH_IDS

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import build_model
from repro_torch.optim import adamw, constant, warmup_cosine
from repro_torch.train import (LoopConfig, make_accum_train_step,
                               make_train_step, train_loop)
from repro_torch.train import checkpoint as ckpt

SRC = Path(__file__).resolve().parents[1] / "src"

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3_32b", reduced=True)
    m = build_model(cfg, device="cpu")
    opt = adamw(warmup_cosine(3e-3, 10, 100))
    return cfg, m, opt, make_train_step(m, opt)


def _init(m, seed=0):
    return m.init(torch.Generator().manual_seed(seed))


def _leaves(state):
    return list(ckpt._flatten(state).items())


def test_loss_decreases(setup):
    cfg, m, opt, step = setup
    it = SyntheticLM(cfg, DataConfig(4, 32, mode="learnable"))
    p = _init(m)
    o = opt.init(p)
    losses = []
    for _ in range(35):
        p, o, met = step(p, o, next(it))
        losses.append(float(met["loss"]))
    assert losses[-1] < 0.5 * losses[0]


def test_grad_accumulation_matches_big_batch(setup):
    cfg, m, opt, step = setup
    p = _init(m)
    o = opt.init(p)
    big = next(SyntheticLM(cfg, DataConfig(8, 32, mode="learnable")))
    micro = {k: v.reshape(4, 2, *v.shape[1:]) for k, v in big.items()}
    p2, o2 = copy.deepcopy(p), copy.deepcopy(o)
    p1, _, m1 = step(p, o, big)
    p2, _, m2 = make_accum_train_step(m, opt, 4)(p2, o2, micro)
    # losses match to bf16-accumulation tolerance
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-2
    for (n, a), (_, b) in zip(p1.named_parameters(), p2.named_parameters()):
        assert torch.allclose(a.float(), b.float(), atol=3e-2), n


def test_checkpoint_roundtrip(setup, tmp_path):
    cfg, m, opt, step = setup
    p = _init(m)
    state = {"params": p, "opt": opt.init(p)}
    state["params"], state["opt"], _ = step(
        p, state["opt"], next(SyntheticLM(cfg, DataConfig(2, 16))))
    ckpt.save(str(tmp_path), 7, state)
    assert ckpt.latest_step(str(tmp_path)) == 7
    p0 = _init(m, seed=1)
    fresh = {"params": p0, "opt": opt.init(p0)}
    restored = ckpt.restore(str(tmp_path), 7, fresh)
    assert restored["params"] is p0
    want, got = _leaves(state), _leaves(restored)
    assert [k for k, _ in want] == [k for k, _ in got]
    assert "params/layers.0.ln1" in dict(want)
    assert {"opt/m/embed.tok", "opt/v/layers.1.ff.wd",
            "opt/step"} <= set(dict(want))
    for (k, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert p0["embed"]["tok"].dtype == torch.bfloat16
    assert int(restored["opt"]["step"]) == 1


def test_checkpoint_gc_and_torn_write(tmp_path):
    state = {"x": torch.arange(4)}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(ckpt._all_steps(str(tmp_path))) == [3, 4]
    # a torn (incomplete) checkpoint is never selected
    os.makedirs(tmp_path / "step_00000009")
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_failure_recovery_and_resume(setup, tmp_path):
    cfg, m, opt, step = setup
    p = _init(m)
    state = {"params": p, "opt": opt.init(p)}
    fails = {7}

    def inj(s):
        if s in fails:
            fails.discard(s)
            raise RuntimeError("simulated node failure")

    lc = LoopConfig(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=4)
    stats = train_loop(step, state,
                       SyntheticLM(cfg, DataConfig(4, 32, mode="learnable")),
                       lc, fail_injector=inj)
    assert stats.restores == 1
    assert ckpt.latest_step(str(tmp_path)) == 11
    # a fresh loop resumes where the last one stopped
    p = _init(m)
    state2 = {"params": p, "opt": opt.init(p)}
    lc2 = LoopConfig(total_steps=16, ckpt_dir=str(tmp_path), ckpt_every=4)
    stats2 = train_loop(step, state2,
                        SyntheticLM(cfg, DataConfig(4, 32, mode="learnable")),
                        lc2)
    assert stats2.steps_run == 4


def test_straggler_watchdog(setup, tmp_path):
    cfg, m, opt, step = setup
    p = _init(m)
    state = {"params": p, "opt": opt.init(p)}
    flagged = []
    slow = {6}

    def inj(s):
        if s in slow:
            slow.discard(s)
            time.sleep(1.0)          # straggle vs ~fast EMA

    lc = LoopConfig(total_steps=8, ckpt_dir=str(tmp_path), ckpt_every=100,
                    straggler_factor=3.0)
    stats = train_loop(step, state, SyntheticLM(cfg, DataConfig(4, 32)), lc,
                       fail_injector=inj,
                       on_straggler=lambda s, r: flagged.append((s, r)))
    assert stats.stragglers >= 1 and flagged


def test_async_checkpointer(setup, tmp_path):
    cfg, m, opt, _ = setup
    p = _init(m)
    c = ckpt.Checkpointer(str(tmp_path))
    c.save_async(3, {"params": p})
    with torch.no_grad():
        p["ln_f"].add_(1.0)          # the step mutates in place meanwhile
    c.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        np.testing.assert_array_equal(z["params/ln_f"], 1.0)


def _smoke_batch(cfg, B=2, S=16):
    b = {"tokens": np.ones((B, S), np.int32),
         "labels": np.ones((B, S), np.int32)}
    if cfg.family == "encdec":
        b["frames"] = np.ones((B, S, cfg.d_model), np.float32)
    if cfg.vision_patches:
        b["vision_embeds"] = np.ones((B, cfg.vision_patches, cfg.d_model),
                                     np.float32)
    return b


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_train_step(arch):
    """tests/test_models_smoke.py's train step, on the port."""
    cfg = get_config(arch, reduced=True)
    m = build_model(cfg, device="cpu")
    params = _init(m)
    before = copy.deepcopy(params)
    opt = adamw(constant(1e-3))
    step = make_train_step(m, opt)
    batch = _smoke_batch(cfg)
    with torch.no_grad():
        loss0 = m.loss(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert loss0.shape == () and bool(torch.isfinite(loss0))
    p2, o2, metrics = step(params, opt.init(params), batch)
    assert math.isfinite(float(metrics["loss"]))
    assert math.isfinite(float(metrics["grad_norm"]))
    # params actually moved
    assert any(not torch.allclose(a.float(), b.float())
               for a, b in zip(before.parameters(), p2.parameters()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_do_not_depend_on_remat(arch):
    """Recomputation runs the same operations: the gradients of "full"
    and "dots" equal those of "none", bit for bit (float32)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in _smoke_batch(cfg).items()}
    batch["tokens"] = torch.arange(32).reshape(2, 16) % cfg.vocab
    grads = {}
    for remat in ("none", "full", "dots"):
        m = build_model(cfg, remat=remat, device="cpu")
        params = _init(m)
        grads[remat] = torch.autograd.grad(m.loss(params, batch),
                                           list(params.parameters()))
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(grads["none"], grads[remat])), remat


def test_remat_dots_keeps_the_matmuls():
    """Under "dots" the backward's recompute runs no matrix product;
    under "full" it runs them all again."""
    cfg = dataclasses.replace(get_config("qwen3_32b", reduced=True),
                              dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in _smoke_batch(cfg).items()}
    counts = {}
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    for remat in ("none", "full", "dots"):
        m = build_model(cfg, remat=remat, device="cpu")
        params = _init(m)
        with Count() as c:
            loss = m.loss(params, batch)
            fwd = c.n
            torch.autograd.grad(loss, list(params.parameters()))
        counts[remat] = (fwd, c.n - fwd)
    assert counts["dots"] == counts["none"]
    assert counts["full"][0] == counts["none"][0]
    assert counts["full"][1] > counts["none"][1]


def test_train_loop_matches_jax(tmp_path):
    """The port's train_loop and JAX's on the reduced qwen3 in float32:
    JAX's initial weights, each package's SyntheticLM (equal batches),
    10 steps, a checkpoint every 4, a failure injected at step 7. Equal
    steps run, restores and latest checkpoint; every step's loss, the
    three replayed after the restore included, within 1e-4."""
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.models import build_model as jbuild_model
    from repro.optim import adamw as jadamw
    from repro.optim import warmup_cosine as jwarmup_cosine
    from repro.train import make_train_step as jmake_train_step
    from repro.train import train_loop as jtrain_loop
    from repro.train import LoopConfig as JLoopConfig
    from repro.train import checkpoint as jckpt
    jcfg, cfg = configs("qwen3_32b")

    def injector():
        fails = {7}

        def inj(s):
            if s in fails:
                fails.discard(s)
                raise RuntimeError("simulated node failure")
        return inj

    jm = jbuild_model(jcfg)
    jopt = jadamw(jwarmup_cosine(3e-3, 10, 100))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jstep = jax.jit(jmake_train_step(jm, jopt))
    jlosses = []

    def jstep_fn(p, o, b):
        out = jstep(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(out[2]["loss"]))
        return out

    jstats = jtrain_loop(
        jstep_fn, {"params": jp, "opt": jopt.init(jp)},
        JSyntheticLM(jcfg, JDataConfig(4, 32, mode="learnable")),
        JLoopConfig(total_steps=10, ckpt_dir=str(tmp_path / "jax"),
                    ckpt_every=4), fail_injector=injector())

    m = build_model(cfg, device="cpu")
    opt = adamw(warmup_cosine(3e-3, 10, 100))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    step = make_train_step(m, opt)
    losses = []

    def step_fn(p, o, b):
        out = step(p, o, b)
        losses.append(float(out[2]["loss"]))
        return out

    stats = train_loop(
        step_fn, {"params": params, "opt": opt.init(params)},
        SyntheticLM(cfg, DataConfig(4, 32, mode="learnable")),
        LoopConfig(total_steps=10, ckpt_dir=str(tmp_path / "port"),
                   ckpt_every=4), fail_injector=injector())
    assert (stats.steps_run, stats.restores) == (
        jstats.steps_run, jstats.restores) == (13, 1)
    assert ckpt.latest_step(str(tmp_path / "port")) == jckpt.latest_step(
        str(tmp_path / "jax")) == 9
    assert len(losses) == len(jlosses) == 13
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    # the replayed steps 4-6 give the losses of their first run
    np.testing.assert_array_equal(losses[7:10], losses[4:7])


def _done_loss(out: str) -> float:
    return float(re.search(r"done: steps=30 loss=([0-9.]+) restores=0",
                           out).group(1))


def test_launch_train_loss_falls_as_jax(tmp_path, capsys):
    import repro.launch.train as jtrain
    args = ["--reduced", "--steps", "30", "--global-batch", "4", "--seq",
            "32", "--ckpt-every", "10"]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--ckpt-dir", str(tmp_path / "port")] + args,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    jtrain.main(args + ["--ckpt-dir", str(tmp_path / "jax")])
    jout = capsys.readouterr().out
    bound = 0.75 * math.log(get_config("qwen3_32b", reduced=True).vocab)
    assert _done_loss(proc.stdout) < bound and _done_loss(jout) < bound
    assert ckpt.latest_step(str(tmp_path / "port")) == 29


def test_launch_train_needs_a_card_or_cpu(monkeypatch, tmp_path):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    # one process without torchrun is a world of 1: no model axis of 2
    # (test_torch_sharded_train.py runs --model-axis 2 under torchrun)
    with pytest.raises(ValueError, match="one process a device"):
        main(["--reduced", "--model-axis", "2", "--device", "cpu"])


def test_launch_train_accum_and_resume(tmp_path, capsys):
    from repro_torch.launch.train import main
    args = ["--reduced", "--device", "cpu", "--global-batch", "4", "--seq",
            "16", "--accum", "2", "--ckpt-every", "2", "--ckpt-dir",
            str(tmp_path)]
    first = main(args + ["--steps", "4"])
    assert first.steps_run == 4 and math.isfinite(first.last_loss)
    again = main(args + ["--steps", "6"])      # resumes after step 3
    assert again.steps_run == 2
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_train_modules_import_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch.optim, repro_torch.data, "
        "repro_torch.train, repro_torch.launch.train\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
