"""The port's sharded training path on CPU meshes: DTensor params over a
('data', 'model') ``DeviceMesh``, 4 ``gloo`` processes through
``torch.multiprocessing``, joined by a ``FileStore`` under a temporary
directory (no TCP port; the tests run beside other workers). Every
multi-process case runs in one spawn (tests/_torch_sharded.py, a
module-scoped fixture); the tests below read its results.

Tolerances (float32, reduced configs):
  * the loss and the grad norm of each of 2 AdamW steps within 1e-5
    relative of the single-process port step's (which tests/
    test_torch_train_parity.py holds to JAX): the same math, summed in
    another order across shards;
  * the first step's gradients, each leaf within 1e-5 of its own largest
    magnitude (measured: up to 1.3e-6; ``-s`` prints each case's maxima);
  * the params after 2 steps at lr 1e-3 within 1e-4 absolute (lr / 10,
    the bound tests/test_torch_gpu_train.py holds the card to): Adam
    divides each gradient element by its own root mean square plus eps,
    so an element near eps turns the few-ulp gradient differences of
    another summation order into a visible fraction of lr (measured: up
    to 2.6e-5 absolute, far above 1e-5 of a leaf's largest magnitude),
    while a wrong update moves a param by about lr;
  * against JAX on JAX's weights: tests/_torch_train_parity.py's bounds;
  * the elastic rescale's next loss within 1e-5 relative of the (2, 2)
    mesh's (the JAX package's test allows 5e-2; the math is the same);
  * the sharded prefill's and decode steps' logits within 1e-5 of the
    largest magnitude of the single-process port's (float32, the same
    products summed in another order across shards);
  * the fake-process-group trace's collectives (launch/op_cost.py) equal,
    by kind, in count and in result bytes, those CollectiveCounter sees
    over the real gloo step, and torch's CommDebugMode's counts: exactly
    (both are shapes);
  * ``compressed_grads`` at world 1 bit for bit against JAX's; the error
    feedback's sum over 50 steps within 2e-2 relative (as JAX's test);
  * the compressed step's loss within 1e-5 relative of JAX's on one
    device;
  * ``launch.train`` under torchrun (bfloat16, the reduced config's
    dtype) within 2e-2 of the one-process run's printed loss: bf16
    activations round differently when the model axis splits the
    products.
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_sharded as W
import jax
import jax.numpy as jnp
from _torch_train_parity import GRAD_TOL, LOSS_RTOL, jax_value_and_grad, named
from repro.configs import get_config as jget_config
from repro.distributed.compress import compressed_grads as jcompressed_grads
from repro.distributed.compress import init_ef as jinit_ef
from repro.distributed.compress import (
    make_compressed_train_step as jmake_compressed_train_step)
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM

torch.set_num_threads(1)

REL = 1e-5
PARAM_ATOL = 1e-4
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_compressed_loss(params, batch):
    """JAX's compressed step on one device, on ``params`` (numpy)."""
    jcfg = dataclasses.replace(jget_config("qwen3_32b", reduced=True),
                               dtype="float32")
    m = jbuild_model(jcfg)
    p = jax.tree.map(jnp.asarray, params)
    opt = jadamw(jconstant(1e-3))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    st = jmake_compressed_train_step(m.loss, opt, mesh)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    _, _, _, met = st(p, opt.init(p), jinit_ef(p), b)
    return float(met["loss"])


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Run every multi-process case once: {case: result}."""
    d = tmp_path_factory.mktemp("sharded")
    jparams, jbatch, _, _ = jax_value_and_grad("qwen3_32b")
    cbatch = next(SyntheticLM(get_config("qwen3_32b", reduced=True),
                              DataConfig(2, 16)))
    closs = _jax_compressed_loss(jparams, cbatch)
    out = str(d / "res.pkl")
    mp.spawn(W.run, args=(4, str(d / "store"), out, jparams, jbatch, cbatch),
             nprocs=4)
    with open(out, "rb") as f:
        res = pickle.load(f)
    res["jax_compressed_loss"] = closs
    return res


@pytest.fixture(scope="module")
def single_serve():
    """The single-process port's prefill and decode steps per arch."""
    return {arch: W.serve_steps(arch) for arch in W.ARCHS}


@pytest.fixture(scope="module")
def single():
    """The single-process port's two steps per architecture."""
    return {arch: W.two_steps(arch) for arch in W.ARCHS}


@pytest.fixture(scope="module")
def single_seq():
    """The same on the sequence-parallel case's batches of SEQ_ROWS."""
    return {arch: W.two_steps(arch, rows=W.SEQ_ROWS) for arch in W.ARCHS}


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("shape", W.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", W.ARCHS)
def test_two_sharded_steps_equal_one_device(sharded, single, arch, shape):
    grads, mets, params = sharded[("parity", arch, shape)]
    wgrads, wmets, wparams = single[arch]
    assert sorted(grads) == sorted(wgrads) == sorted(params)
    dloss = max(max(_rel(l, wl), _rel(g, wg))
                for (l, g), (wl, wg) in zip(mets, wmets))
    dgrad = max(np.abs(grads[n] - w).max() / np.abs(w).max()
                for n, w in wgrads.items())
    dparam = max(np.abs(params[n] - w).max() for n, w in wparams.items())
    print(f"{arch} {shape}: loss/grad norm {dloss:.2e}, grads {dgrad:.2e} "
          f"of each leaf's max, params {dparam:.2e}")   # -s shows maxima
    assert dloss <= REL and dgrad <= REL and dparam <= PARAM_ATOL


@pytest.mark.parametrize("arch", W.ARCHS)
def test_two_fsdp_steps_equal_one_device(sharded, single, arch):
    """``strategy="fsdp"`` on (2, 2): the weights gathered before their
    products (``ctx.weight``), the batch over ('data', 'model'); the
    tolerances of test_two_sharded_steps_equal_one_device."""
    grads, mets, params = sharded[("parity_fsdp", arch)]
    wgrads, wmets, wparams = single[arch]
    assert sorted(grads) == sorted(wgrads) == sorted(params)
    dloss = max(max(_rel(l, wl), _rel(g, wg))
                for (l, g), (wl, wg) in zip(mets, wmets))
    dgrad = max(np.abs(grads[n] - w).max() / np.abs(w).max()
                for n, w in wgrads.items())
    dparam = max(np.abs(params[n] - w).max() for n, w in wparams.items())
    print(f"{arch} fsdp (2, 2): loss/grad norm {dloss:.2e}, grads "
          f"{dgrad:.2e} of each leaf's max, params {dparam:.2e}")
    assert dloss <= REL and dgrad <= REL and dparam <= PARAM_ATOL


@pytest.mark.parametrize("arch", W.ARCHS)
def test_two_fsdp_steps_with_the_sequence_over_model_equal_one_device(
        sharded, single_seq, arch):
    """``strategy="fsdp"`` on (2, 2) with a batch of 2 rows, which divides
    'data' but not data x model: the context the dry run sets for it
    (``ctx.set_seq_axes("model")``, launch/dryrun.py ``activation_axes``),
    the sequence over 'model', the weights gathered before their products;
    the tolerances of test_two_sharded_steps_equal_one_device."""
    grads, mets, params = sharded[("parity_seq", arch)]
    wgrads, wmets, wparams = single_seq[arch]
    assert sorted(grads) == sorted(wgrads) == sorted(params)
    dloss = max(max(_rel(l, wl), _rel(g, wg))
                for (l, g), (wl, wg) in zip(mets, wmets))
    dgrad = max(np.abs(grads[n] - w).max() / np.abs(w).max()
                for n, w in wgrads.items())
    dparam = max(np.abs(params[n] - w).max() for n, w in wparams.items())
    print(f"{arch} fsdp (2, 2), sequence over 'model': loss/grad norm "
          f"{dloss:.2e}, grads {dgrad:.2e} of each leaf's max, params "
          f"{dparam:.2e}")
    assert dloss <= REL and dgrad <= REL and dparam <= PARAM_ATOL


@pytest.mark.parametrize("shape", W.SERVE_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_prefill_and_decode_equal_one_process(sharded, single_serve,
                                                      arch, shape):
    """make_prefill_step and make_decode_step on a mesh, the cache laid out
    by cache_specs: on (2, 2) the kv heads split over 'model', on (1, 4)
    (2 kv heads) the cache's sequence does."""
    got, want = sharded[("serve", arch, shape)], single_serve[arch]
    assert len(got) == len(want) == W.DECODE_STEPS + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= REL * np.abs(w).max(), (arch, i)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_fake_trace_collectives_equal_gloo(sharded, arch):
    """launch.dryrun.trace_step's count of one train step on a fake (2, 2)
    process group, against CollectiveCounter over the real 4-process gloo
    step of the same config and batch shape."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import trace_step
    counts, raw, comm = sharded[("collectives", arch)]
    cost, _, _ = trace_step(W.cfg32(arch), ShapeSpec("reduced", 16, 4,
                                                     "train"),
                            {"data": 2, "model": 2})
    assert sum(counts.values()) > 0
    assert cost.coll_count == counts
    assert cost.coll_raw == raw
    # CommDebugMode sees gloo's all-to-all fallback as the all-gather it is
    c = cost.coll_count
    assert {k: v for k, v in comm.items() if v} == {
        k: v for k, v in {
            "all_gather_into_tensor": c["all-gather"] + c["all-to-all"],
            "all_reduce": c["all-reduce"],
            "reduce_scatter_tensor": c["reduce-scatter"]}.items() if v}


def test_accumulated_step_on_a_mesh(sharded):
    """make_accum_train_step over 2 microbatches on (2, 2) equals the
    single-process accumulated step."""
    loss, gnorm, params = sharded["accum"]
    wloss, wgnorm, wparams = W.accum_step()
    assert _rel(loss, wloss) <= REL and _rel(gnorm, wgnorm) <= REL
    for n, w in wparams.items():
        assert np.abs(params[n] - w).max() <= PARAM_ATOL, n


def test_sharded_grads_equal_jax(sharded):
    """On a (2, 2) mesh, the loss and gradients on JAX's weights against
    JAX's ``value_and_grad`` (tests/_torch_train_parity.py's cache)."""
    _, _, jloss, jgrads = jax_value_and_grad("qwen3_32b")
    loss, grads = sharded["jax"]
    assert _rel(loss, jloss) <= LOSS_RTOL
    want = named(jgrads, W.cfg32("qwen3_32b", attn_chunk=1024))
    assert sorted(want) == sorted(grads)
    for n, w in want.items():
        assert np.abs(grads[n] - w).max() <= GRAD_TOL * np.abs(w).max(), n


def test_elastic_rescale_to_a_smaller_mesh(sharded):
    """A step on (2, 2), a checkpoint, then the next step on a (2, 1) mesh
    of ranks 0-1: restored from the checkpoint, and rescaled from the live
    state (itself restored in place on (2, 2), as train_loop restores)."""
    e = sharded["elastic"]
    assert _rel(e["restore"], e["ref"]) <= REL, e
    assert _rel(e["rescale"], e["ref"]) <= REL, e


def test_compression_error_feedback(sharded):
    """Quantization residual is carried: a constant gradient stream sums
    correctly over steps despite int8 rounding (world 2)."""
    total = sharded["compression"]["total"]
    np.testing.assert_allclose(total, 50 * 0.001234, rtol=2e-2)


def test_compressed_train_step_runs(sharded):
    c = sharded["compression"]
    assert np.isfinite(c["loss"]) and c["ef_nonzero"]
    assert _rel(c["loss"], sharded["jax_compressed_loss"]) <= REL


def test_compressed_grads_bit_equal_jax_at_world_1(tmp_path):
    import torch.distributed as dist
    from jax.sharding import Mesh, PartitionSpec as P

    from repro_torch.distributed.compress import compressed_grads
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((33, 7)).astype(np.float32) * 1e-2,
         "b": rng.standard_normal((5,)).astype(np.float32)}
    ef = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-4
          for k, v in g.items()}
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fm = jax.shard_map(lambda g, e: jcompressed_grads(g, e, "data"),
                       mesh=mesh, in_specs=(P(), P()),
                       out_specs=(P(), P()), check_vma=False)
    jg, je = jax.tree.map(np.asarray, fm(g, ef))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        tg, te = compressed_grads(
            {k: torch.from_numpy(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in ef.items()})
    finally:
        dist.destroy_process_group()
    for k in g:
        np.testing.assert_array_equal(tg[k].numpy(), jg[k])
        np.testing.assert_array_equal(te[k].numpy(), je[k])


def _done_loss(out: str) -> tuple:
    m = re.search(r"done: steps=(\d+) loss=([-\d.na]+)", out)
    assert m, out
    return int(m.group(1)), float(m.group(2))


def test_launch_train_under_torchrun(tmp_path):
    """``launch.train --model-axis 2`` on 4 processes prints the one-process
    run's loss; at 2 processes on the same checkpoint dir it resumes after
    the last step and runs 0 steps."""
    from repro_torch.launch import train as T
    args = ["--device", "cpu", "--reduced", "--steps", "6",
            "--global-batch", "4", "--seq", "32"]
    one = T.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)

    def torchrun(n):
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
             *args, "--model-axis", "2", "--ckpt-dir",
             str(tmp_path / "dist")],
            capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
        return _done_loss(r.stdout)

    steps, loss = torchrun(4)
    assert steps == 6
    assert abs(loss - one.last_loss) <= 2e-2, (loss, one.last_loss)
    assert torchrun(2)[0] == 0
