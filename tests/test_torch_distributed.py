"""The port's frame-sharded decode (repro_torch.distributed) against the JAX
package's, on the CPU.

Mirrors tests/test_stream.py::test_sharded_frame_decoder_single_device and
::test_sharded_stream_multi_device, and tests/test_serve.py::
test_server_sharded_mesh_single_device. The JAX side runs in this process
on its one CPU device; the port's meshes repeat the CPU device (``["cpu"]
* 4``), its counterpart of JAX's ``--xla_force_host_platform_device_count``.
The same seeded numpy inputs go through both packages. Tolerance 0
throughout.
"""
import numpy as np
import pytest
import torch

from _torch_parity import jax_decode, jcfg, rx
from repro.core import pipeline as jpipe
from repro.distributed.stream import frame_mesh as jframe_mesh
from repro.distributed.stream import (
    make_sharded_frame_decoder as jmake_sharded_frame_decoder)
from repro.serve import PlanCache as JPlanCache

from repro_torch.core.framed import FrameSpec
from repro_torch.core.pipeline import DecoderConfig
from repro_torch.core.stream import make_stream_decoder, stream_decode
from repro_torch.distributed import (FrameMesh, frame_mesh,
                                     make_sharded_frame_decoder)
from repro_torch.kernels import viterbi_fwd as vf
from repro_torch.kernels import viterbi_unified as vu
from repro_torch.kernels.autotune import plan_decode
from repro_torch.serve import DecodeServer, PlanCache

SPEC = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
SPEC34 = FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21)


def cpu_mesh(n):
    return frame_mesh(["cpu"] * n)


def test_sharded_frame_decoder_single_device():
    """A one-device mesh streams the same bits as JAX's make_decoder."""
    n = 2000
    llr = np.random.default_rng(0).standard_normal((n, 2)).astype(np.float32)
    cfg = DecoderConfig(spec=SPEC)
    got = stream_decode(cfg, llr, n, chunk_frames=8, mesh=cpu_mesh(1))
    assert np.array_equal(got, jax_decode(cfg, llr, n))


@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_sharded_stream_multi_device(rate):
    """Four shards, chunk_frames=6 (not a multiple of 4: shard padding)
    == JAX's make_decoder; at rate 3/4 from raw punctured pushes."""
    n = 4000 if rate == "1/2" else 63 * 60
    spec = SPEC if rate == "1/2" else SPEC34
    cfg = DecoderConfig(spec=spec, rate=rate)
    llr = (np.random.default_rng(0).standard_normal((n, 2)).astype(
        np.float32) if rate == "1/2" else rx(n, rate, seed=3))
    got = stream_decode(cfg, llr, n, chunk_frames=6, mesh=cpu_mesh(4),
                        push_size=777)
    assert np.array_equal(got, jax_decode(cfg, llr, n))


@pytest.fixture(scope="module")
def seven_frames():
    """Seven frames and JAX's bits for them, from its frame decoder and its
    sharded frame decoder (equal to each other)."""
    frames = np.random.default_rng(5).standard_normal(
        (7, SPEC.frame_len, 2)).astype(np.float32)
    jref = jcfg(DecoderConfig(spec=SPEC), backend="reference")
    want = np.asarray(jpipe.make_frame_decoder(jref)(frames))
    jsharded = jmake_sharded_frame_decoder(jref, jframe_mesh())
    assert np.array_equal(np.asarray(jsharded(frames)), want)
    return frames, want


@pytest.mark.parametrize("backend", ["reference", "kernel", "kernel_split"])
def test_sharded_frame_decoder_matches_jax(backend, seven_frames,
                                           monkeypatch):
    """Three shards over F=7 frames (padded to 9): equal to JAX's sharded
    and unsharded frame decoders (its kernel backends are held equal to
    its reference by its own tests), one decode per shard."""
    cfg = DecoderConfig(spec=SPEC, backend=backend)
    frames, want = seven_frames
    calls = []
    for mod, name in ((vu, "unified_decode_frames_plain"),
                      (vf, "forward_frames_plain")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    got = make_sharded_frame_decoder(cfg, cpu_mesh(3))(
        torch.from_numpy(frames))
    assert got.shape == (7, SPEC.f) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert len(calls) == (0 if backend == "reference" else 3)


def test_sharded_frame_decoder_takes_no_frames():
    out = make_sharded_frame_decoder(DecoderConfig(spec=SPEC), cpu_mesh(2))(
        torch.zeros((0, SPEC.frame_len, 2)))
    assert out.shape == (0, SPEC.f)


@pytest.mark.parametrize("shards", [1, 4])
def test_server_sharded_mesh(shards):
    """mesh= routes bucket batches through the sharded frame decoder,
    planned for the mesh's size: bits equal JAX's make_decoder."""
    cfg = DecoderConfig(spec=SPEC)
    mesh = cpu_mesh(shards)
    srv = DecodeServer(slots=2, mesh=mesh, cache=PlanCache(), device="cpu")
    assert srv.mesh == mesh and srv.device == torch.device("cpu")
    n = 1500
    llr = rx(n, seed=21)
    sid = srv.open_session(cfg, chunk_frames=6)
    assert srv.buckets()[0].plan.num_devices == shards
    srv.push(sid, llr)
    got = np.concatenate([srv.poll(sid), srv.close_session(sid)])[:n]
    assert np.array_equal(got, jax_decode(cfg, llr, n))


def test_server_restores_under_its_mesh(tmp_path):
    cfg = DecoderConfig(spec=SPEC)
    mesh = cpu_mesh(3)
    n = 6 * 64 * 2
    llr = rx(n, seed=8)
    srv = DecodeServer(slots=2, mesh=mesh, cache=PlanCache(), device="cpu")
    sid = srv.open_session(cfg, chunk_frames=6)
    srv.push(sid, llr[:n // 2])
    srv.step()
    early = srv.poll(sid)
    path = str(tmp_path / "ckpt.json")
    srv.drain(checkpoint=path)
    back = DecodeServer.restore(path, mesh=mesh, cache=PlanCache(),
                                device="cpu")
    assert back.mesh == mesh
    back.push(sid, llr[n // 2:])
    got = np.concatenate([early, back.poll(sid), back.close_session(sid)])
    assert np.array_equal(got[:n], jax_decode(cfg, llr, n))


def test_one_frames_entry_per_cfg_and_mesh():
    """The plan cache keys the sharded closure by (cfg, mesh), as JAX's:
    the same stats for the same calls."""
    cfg = DecoderConfig(spec=SPEC)
    cache, jcache = PlanCache(), JPlanCache()
    jmesh = jframe_mesh()
    a = cache.frame_decoder(cfg, mesh=cpu_mesh(2))
    assert cache.frame_decoder(cfg, mesh=FrameMesh(("cpu", "cpu"))) is a
    assert cache.frame_decoder(cfg, mesh=cpu_mesh(2)) is a
    jcfg_ = jcfg(cfg)
    ja = jcache.frame_decoder(jcfg_, jmesh)
    assert jcache.frame_decoder(jcfg_, jmesh) is ja
    assert jcache.frame_decoder(
        jcfg_, jframe_mesh(list(jmesh.devices.flat))) is ja
    stats = {k: v for k, v in cache.stats().items() if k != "build_ms"}
    jstats = {k: v for k, v in jcache.stats().items() if k != "build_ms"}
    assert stats == jstats == {"entries": 1, "hits": 2, "misses": 1,
                               "traces": 0}
    assert cache.frame_decoder(cfg, mesh=cpu_mesh(3)) is not a
    assert cache.stats()["entries"] == 2
    w = cache.window_decoder(cfg, 6, mesh=cpu_mesh(2), device="cpu")
    assert cache.window_decoder(cfg, 6, mesh=cpu_mesh(2)) is w
    b = cache.batch_decoder(cfg, 6, mesh=cpu_mesh(2))
    assert cache.batch_decoder(cfg, 6, mesh=cpu_mesh(2), device="cpu") is b
    assert cache.stats()["entries"] == 4          # + window + batch


def test_default_chunk_scales_with_the_mesh():
    for backend in ("reference", "kernel", "kernel_split"):
        cfg = DecoderConfig(spec=SPEC, backend=backend)
        one = make_stream_decoder(cfg, device="cpu").chunk_frames
        four = make_stream_decoder(cfg, mesh=cpu_mesh(4)).chunk_frames
        assert four == 4 * one
        plan = plan_decode(cfg.trellis, SPEC, num_devices=4,
                           unified=backend != "kernel_split", device="cpu")
        assert four == plan.chunk_frames


def test_frame_mesh_normalises_and_hashes(monkeypatch):
    m = FrameMesh(["cpu", torch.device("cpu")])
    assert m == cpu_mesh(2) and hash(m) == hash(cpu_mesh(2))
    assert m.devices == (torch.device("cpu"),) * 2
    assert m.size == 2 and m.home == torch.device("cpu")
    assert m != cpu_mesh(1)
    with pytest.raises(ValueError, match="at least one"):
        FrameMesh(())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    bare, indexed = FrameMesh(("cuda",)), FrameMesh(("cuda:0",))
    assert bare == indexed and hash(bare) == hash(indexed)
    assert bare.home == torch.device("cuda", 0)
    assert {bare: 1}[indexed] == 1


def test_device_and_mesh_must_agree():
    cfg = DecoderConfig(spec=SPEC)
    mesh = cpu_mesh(2)
    assert make_stream_decoder(cfg, chunk_frames=2, mesh=mesh,
                               device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="home device"):
        make_stream_decoder(cfg, chunk_frames=2, mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="home device"):
        DecodeServer(mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="home device"):
        PlanCache().frame_decoder(cfg, mesh=mesh, device="meta")
    with pytest.raises(TypeError, match="FrameMesh"):
        make_sharded_frame_decoder(cfg, ["cpu", "cpu"])


def test_frame_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frame_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_frame_decoder(DecoderConfig(spec=SPEC))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameMesh(("cuda:0",))
    assert cpu_mesh(2).size == 2                   # a named CPU mesh is fine
