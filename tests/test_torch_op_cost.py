"""The port's trace cost model (repro_torch.launch.op_cost) and the LM
roofline (repro_torch.launch.roofline.analyze) on the CPU, against the JAX
package's HLO cost model (repro.launch.hlo_cost).

  * Calibration, as tests/test_roofline.py's subprocess pins hlo_cost: on
    a fake (2, 4) mesh with B = 64, D = 512, ``sum((x @ w[0])**2)`` counts
    exactly 2 B D D / 8 FLOPs a card; a 3-layer ``tanh(h @ w_i)`` loop
    exactly 3x one layer's local FLOPs, and its collectives are the two
    all-gathers of h over 'model' that DTensor runs (the first layer's h
    is x, already whole over 'model').
  * The reduced qwen3_32b, qwen3_moe_235b and mamba2_2p7b train steps
    (float32, batch 4 x 16, attention chunks of 8, remat full): on a
    (1, 1) fake mesh their FLOPs equal ``FlopCounterMode``'s count of the
    plain step exactly, and JAX's ``module_cost`` of the same step within
    ``JAX_RTOL``; on (2, 2) each card does at least JAX's total / 4 and,
    under ``strategy`` tp and fsdp alike, JAX's per-chip count (a
    4-device JAX subprocess) within ``JAX_RTOL`` (PERF.md records the
    ratios).
  * Peak memory: a state-only in-place update of full-size Qwen3-32B on
    the (32, 8) mesh peaks at exactly the placed state (``bytes_per_card``
    of params and fp32 moments, and AdamW's int32 step); no remat peaks
    above remat full; ``--moe-cap`` and ``--attn-chunk`` reach the traced
    config; ``--skip-existing`` skips.

JAX_RTOL: the programs differ, not the counting. For qwen3 and the MoE
the port does 0.46 % and 0.35 % more (autograd's backward of the
cross-entropy's one-hot einsum is a batched matmul, where XLA multiplies).
For mamba2 the port does 1.62 % less: XLA's transpose of the SSD scan
computes the carried state's cotangent in every chunk, where autograd
skips the first chunk's (its state is a constant zero), 786,432 FLOPs of
dots at this size (found by listing both programs' products).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.launch.hlo_cost import module_cost
from repro.launch.roofline import Roofline as JRoofline
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro.train.step import make_train_step as jmake_train_step

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import DataConfig, make_batch
from repro_torch.distributed.sharding import param_shardings
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import HW
from repro_torch.launch.op_cost import Cost, fake_mesh, step_cost
from repro_torch.models import build_model
from repro_torch.optim import adamw, constant
from repro_torch.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3_32b", "qwen3_moe_235b", "mamba2_2p7b"]
JAX_RTOL = {"qwen3_32b": 0.01, "qwen3_moe_235b": 0.01, "mamba2_2p7b": 0.02}
SHAPE = ShapeSpec("reduced", 16, 4, "train")
B, D = 64, 512

JAX_PER_CHIP = r"""
import json, os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.distributed import ctx
from repro.distributed.sharding import batch_specs, param_shardings
from repro.launch.hlo_cost import module_cost
from repro.models import build_model
from repro.optim import adamw, constant
from repro.train.step import make_train_step
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
ctx.set_data_size(2)
out = {}
for strategy, baxes in (("tp", "data"), ("fsdp", ("data", "model"))):
    ctx.set_batch_axes(baxes)
    out[strategy] = {}
    for arch in sys.argv[1:]:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  dtype="float32", attn_chunk=8)
        bundle = build_model(cfg)
        params = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
        opt = adamw(constant(1e-3))
        ost = jax.eval_shape(opt.init, params)
        batch = {k: jax.ShapeDtypeStruct((4, 16), jnp.int32)
                 for k in ("tokens", "labels")}
        osh = param_shardings(mesh, ost["m"], strategy=strategy)
        with mesh:
            c = jax.jit(make_train_step(bundle, opt), in_shardings=(
                param_shardings(mesh, params, strategy=strategy),
                {"m": osh, "v": osh, "step": jax.NamedSharding(
                    mesh, jax.sharding.PartitionSpec())},
                batch_specs(batch, mesh, strategy=strategy))).lower(
                    params, ost, batch).compile()
        out[strategy][arch] = module_cost(c.as_text()).flops
print("PER_CHIP", json.dumps(out))
"""


def cfg32(arch):
    return dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32", attn_chunk=8)


def _jax_one_device(arch) -> float:
    cfg = dataclasses.replace(jget_config(arch, reduced=True),
                              dtype="float32", attn_chunk=8)
    bundle = jbuild_model(cfg)
    params = jax.eval_shape(bundle.init, jax.random.PRNGKey(0))
    opt = jadamw(jconstant(1e-3))
    ost = jax.eval_shape(opt.init, params)
    batch = {k: jax.ShapeDtypeStruct((4, 16), jnp.int32)
             for k in ("tokens", "labels")}
    c = jax.jit(jmake_train_step(bundle, opt)).lower(params, ost,
                                                     batch).compile()
    return module_cost(c.as_text()).flops


@pytest.fixture(scope="module")
def jax_per_chip():
    """{strategy: {arch: per-chip FLOPs on a (2, 2) mesh}} for 'tp' (the
    batch over 'data') and 'fsdp' (the batch over ('data', 'model'))."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", JAX_PER_CHIP, *ARCHS],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    line = [s for s in r.stdout.splitlines() if s.startswith("PER_CHIP")]
    assert line, r.stdout + r.stderr
    return json.loads(line[0].split(" ", 1)[1])


@pytest.fixture(scope="module")
def jax_flops(jax_per_chip):
    """{arch: (one-device FLOPs, per-chip FLOPs on a (2, 2) mesh)}."""
    return {a: (_jax_one_device(a), jax_per_chip["tp"][a]) for a in ARCHS}


# ------------------------------------------------------------ calibration --
def _calibration_inputs(mesh):
    x = distribute_tensor(torch.randn(B, D), mesh, (Shard(0), Replicate()),
                          src_data_rank=None)
    w = distribute_tensor(torch.randn(3, D, D), mesh,
                          (Replicate(), Shard(2)), src_data_rank=None)
    return x, w


def _layers(x, w):
    h = x
    for i in range(3):
        h = torch.tanh(h @ w[i])
    return torch.sum(h)


def test_calibration_on_a_fake_2x4_mesh():
    with fake_mesh({"data": 2, "model": 4}) as mesh:
        x, w = _calibration_inputs(mesh)
        one, _, _ = step_cost(lambda x, w: torch.sum((x @ w[0]) ** 2), x, w,
                              mesh=mesh)
        three, _, _ = step_cost(_layers, x, w, mesh=mesh)
    assert one.flops == 2 * B * D * D / 8
    layer = 2 * (B // 2) * D * (D // 4)           # (32, 512) @ (512, 128)
    assert three.flops == 3 * layer
    # hand count: layers 2 and 3 all-gather h (B/2, D) f32 over 'model'
    gather = (B // 2) * D * 4
    assert three.coll_count == {"all-gather": 2, "all-reduce": 0,
                                "reduce-scatter": 0, "all-to-all": 0,
                                "collective-permute": 0}
    assert three.coll_raw["all-gather"] == 2 * gather
    assert three.coll_bytes == 2 * gather
    assert three.coll_axes == {"model": 2 * gather}
    assert one.coll_bytes == 0


def test_cost_adds_and_scales():
    a = Cost(flops=1, bytes=2, coll_bytes=4, convert_bytes=1)
    a.coll_raw["all-reduce"] = 2
    a.coll_count["all-reduce"] = 1
    a.coll_axes["model"] = 4
    b = a.scaled(3)
    b += a
    assert (b.flops, b.bytes, b.coll_bytes, b.convert_bytes) == (4, 8, 16, 4)
    assert (b.coll_raw["all-reduce"], b.coll_count["all-reduce"],
            b.coll_axes) == (8, 4, {"model": 16})


def test_lm_roofline_row_has_jax_keys_and_splits_links():
    cost = Cost(flops=989e12, bytes=3.35e12, convert_bytes=0.35e12)
    cost.coll_raw["all-reduce"] = 250e9
    cost.coll_axes = {"model": 450e9, "data": 50e9}
    cost.coll_bytes = 500e9
    rl = RL.analyze(cost, 70e9, 256, model_flops=256 * 0.5 * 989e12)
    row = rl.row()
    jrow = JRoofline(chips=1, flops_per_chip=1.0, bytes_per_chip=1.0,
                     coll_bytes_per_chip=0.0, coll_breakdown={}).row()
    assert set(jrow) - set(row) == {"xla_flops_oncecounted",
                                    "xla_bytes_oncecounted"}
    assert row["t_compute_s"] == pytest.approx(1.0)
    assert row["t_memory_s"] == pytest.approx(1.0)
    assert row["t_memory_fused_s"] == pytest.approx(3.0 / 3.35)
    # 450 GB over NVLink (450 GB/s) + 50 GB over the network (50 GB/s)
    assert row["t_collective_s"] == pytest.approx(2.0)
    assert row["bottleneck"] == "collective" and row["t_bound_s"] == 2.0
    assert row["useful_ratio"] == pytest.approx(0.5)
    assert row["mfu_bound"] == pytest.approx(0.25)
    assert row["peak_memory_per_chip"] == 70e9
    assert HW.NET_BW == 50e9
    # on one node every axis rides NVLink
    assert RL.analyze(cost, 0, 4, node_axes=("data", "model")).t_collective \
        == pytest.approx(500e9 / HW.NVLINK_BW)


# ------------------------------------------------------- reduced configs --
def _plain_flops(arch) -> float:
    cfg = cfg32(arch)
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator("cpu").manual_seed(0))
    opt = adamw(constant(1e-3))
    st = opt.init(params)
    with FlopCounterMode(display=False) as fcm:
        make_train_step(m, opt)(params, st, make_batch(cfg, DataConfig(4, 16),
                                                       0))
    return fcm.get_total_flops()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_card_flops_equal_flop_counter_and_jax(jax_flops, arch):
    cost, _, _ = dryrun.trace_step(cfg32(arch), SHAPE,
                                   {"data": 1, "model": 1})
    assert cost.flops == _plain_flops(arch)
    one, _ = jax_flops[arch]
    print(f"{arch}: port {cost.flops:.0f}, JAX {one:.0f} "
          f"({cost.flops / one - 1:+.2%})")
    assert abs(cost.flops / one - 1) <= JAX_RTOL[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_per_card_flops_on_2x2_against_jax(jax_flops, arch):
    """Each card does at least a quarter of the whole step: the port's,
    and JAX's within JAX_RTOL (mamba2's whole program is 1.62 % smaller
    than JAX's, see above)."""
    cost, _, _ = dryrun.trace_step(cfg32(arch), SHAPE,
                                   {"data": 2, "model": 2})
    whole = _plain_flops(arch)
    one, per_chip = jax_flops[arch]
    print(f"{arch} on (2, 2): port {cost.flops:.0f} a card "
          f"({cost.flops / (whole / 4):.4f} x its whole step / 4), JAX "
          f"{per_chip:.0f} a chip: ratio {cost.flops / per_chip:.4f}")
    assert cost.flops >= whole / 4
    assert cost.flops >= (1 - JAX_RTOL[arch]) * one / 4
    assert abs(cost.flops / per_chip - 1) <= JAX_RTOL[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_per_card_flops_on_2x2_fsdp_against_jax(jax_per_chip, arch):
    """``strategy="fsdp"`` (weights over ('data', 'model') on their
    former data dim, the batch over both axes): each card does JAX's
    per-chip work within JAX_RTOL, as JAX's fsdp step does its tp step's.
    The weights are gathered before their products (``ctx.weight``);
    without that DTensor computed them as partial sums over the data axes,
    1.66-1.70x JAX's count."""
    cost, _, _ = dryrun.trace_step(cfg32(arch), SHAPE,
                                   {"data": 2, "model": 2}, strategy="fsdp")
    want = jax_per_chip["fsdp"][arch]
    print(f"{arch} fsdp on (2, 2): port {cost.flops:.0f} a card, JAX "
          f"{want:.0f} a chip: ratio {cost.flops / want:.4f}")
    assert abs(cost.flops / want - 1) <= JAX_RTOL[arch]


@pytest.mark.parametrize("batch,seq,rows,fsdp,want", [
    ("data", None, 64, False, "kept"),        # tp, a divided batch
    (("data", "model"), None, 64, True, "whole"),    # fsdp
    ("data", "model", 64, True, "whole"),     # fsdp, sequence over 'model'
    (None, None, 64, False, "data"),          # a whole batch, many rows
    (None, None, 8, False, "kept"),           # a whole batch, few rows
])
def test_weight_gathered_where_the_batch_misses_the_data_axes(
        batch, seq, rows, fsdp, want):
    """``ctx.weight(w, x)``: kept where DTensor chooses (the batch over
    exactly the data axes; a whole batch of fewer rows than w's
    contraction dim), else gathered over the data axes, and over 'model'
    where it shares the data dim (fsdp)."""
    from repro_torch.distributed import ctx
    pls = (Shard(0), Shard(0)) if fsdp else (Shard(0), Shard(1))
    prev = (ctx.get_batch_axes(), ctx.get_seq_axes())
    ctx.set_batch_axes(batch)
    ctx.set_seq_axes(seq)
    try:
        with fake_mesh({"data": 2, "model": 2}) as mesh:
            w = distribute_tensor(torch.randn(32, 16), mesh, pls,
                                  src_data_rank=None)
            got = tuple(ctx.weight(w, torch.zeros(rows, 32)).placements)
    finally:
        ctx.set_batch_axes(prev[0])
        ctx.set_seq_axes(prev[1])
    assert got == {"kept": pls, "whole": (Replicate(), Replicate()),
                   "data": (Replicate(), Shard(1))}[want]


# ---------------------------------------------------------------- memory --
def test_state_only_update_peaks_at_the_placed_state():
    cfg = get_config("qwen3_32b")
    axes = dryrun.MESHES["32x8"]
    with fake_mesh(axes) as mesh:
        params = param_shardings(mesh, build_model(cfg, device="cpu").init(
            torch.Generator("cpu").manual_seed(0)))
        state = adamw(constant(1e-4)).init(params)

        @torch.no_grad()
        def update(params, state):
            for p in params.parameters():
                p.mul_(0.5)
            for mom in ("m", "v"):
                for t in state[mom].values():
                    t.mul_(0.5)

        cost, peak, _ = step_cost(update, params, state, mesh=mesh)
    per = dryrun.bytes_per_card(dryrun.meta_params(cfg), axes)
    want = (sum(n * s for n, s in per.values())
            + 2 * 4 * sum(n for n, _ in per.values()) + 4)   # + int32 step
    assert peak == want
    assert cost.coll_bytes == 0 and cost.flops == 0


def test_remat_none_peaks_above_full():
    cfg = cfg32("qwen3_32b")
    shape = ShapeSpec("reduced", 32, 4, "train")
    axes = {"data": 2, "model": 2}
    _, full, _ = dryrun.trace_step(cfg, shape, axes, remat="full")
    _, none, _ = dryrun.trace_step(cfg, shape, axes, remat="none")
    assert none > full


def test_moe_cap_and_attn_chunk_reach_the_config(monkeypatch, tmp_path):
    # the cap reaches the trace: a smaller capacity moves fewer tokens
    small = cfg32("qwen3_moe_235b")
    capped = dataclasses.replace(small, moe=dataclasses.replace(
        small.moe, capacity_per_choice=0.5))
    one = {"data": 1, "model": 1}
    assert (dryrun.trace_step(capped, SHAPE, one)[0].flops
            < dryrun.trace_step(small, SHAPE, one)[0].flops)
    seen = []

    def fake_trace(cfg, shape, axes, remat="full", strategy="tp"):
        seen.append((cfg, shape, axes, remat))
        return Cost(flops=1.0), 1.0, 0.0

    monkeypatch.setattr(dryrun, "trace_step", fake_trace)
    dryrun.main(["--arch", "qwen3_moe_235b", "--shape", "prefill_32k",
                 "--moe-cap", "1.25", "--attn-chunk", "512", "--remat",
                 "dots", "--multi-pod", "--out", str(tmp_path)])
    cfg, shape, axes, remat = seen[0]
    assert cfg.moe.capacity_per_choice == 1.25 and cfg.attn_chunk == 512
    assert (shape.name, axes, remat) == ("prefill_32k",
                                         dryrun.MESHES["2x32x8"], "dots")


def test_skip_existing_skips(monkeypatch, tmp_path, capsys):
    def no_trace(*a, **k):
        raise AssertionError("traced a cell that exists")

    monkeypatch.setattr(dryrun, "trace_step", no_trace)
    (tmp_path / "qwen3_32b_train_4k_32x8.json").write_text("{}")
    assert dryrun.main(["--arch", "qwen3_32b", "--shape", "train_4k",
                        "--skip-existing", "--out", str(tmp_path)]) == []
    assert "skip qwen3_32b train_4k (exists)" in capsys.readouterr().err


def test_a_failing_cell_is_listed_and_the_rest_run(monkeypatch, tmp_path):
    calls = []

    def trace(cfg, shape, axes, remat="full", strategy="tp"):
        calls.append(shape.name)
        if shape.name == "train_4k":
            raise RuntimeError("boom")
        return Cost(flops=1.0), 1.0, 0.0

    monkeypatch.setattr(dryrun, "trace_step", trace)
    monkeypatch.setattr(dryrun, "cells", lambda: [
        ("qwen3_32b", "train_4k"), ("qwen3_32b", "decode_32k")])
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--all", "--out", str(tmp_path)])
    assert calls == ["train_4k", "decode_32k"]
    assert (tmp_path / "qwen3_32b_decode_32k_32x8.json").exists()


def test_new_modules_import_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch.launch.op_cost, repro_torch.launch.dryrun\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
