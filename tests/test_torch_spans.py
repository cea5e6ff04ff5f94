"""The decode path's spans (repro_torch.obs.profiled), on the CPU.

``make_decoder`` calls run under ``decode`` with ``decode.copy_in``,
``decode.sanitize``, ``decode.frame``,
``decode.plan``, ``decode.pad`` and ``decode.kernel`` inside; a sharded
call under ``shard`` with ``shard.out``, a ``shard.decode`` a card and
``shard.gather``. ``ProfiledTracer`` puts them into a running
``torch.profiler`` beside the ring; with no tracer set they reach a
running profiler alone, and with none running they cost the shared no-op.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core.framed import FrameSpec, frame_llr
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.distributed import frame_mesh, make_sharded_frame_decoder
from repro_torch.obs.profiled import PROFILER_SPANS, span_tracer

SPEC = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
SPEC34 = FrameSpec(f=63, v1=21, v2=21, f0=21, v2s=21)
N = 5 * SPEC.f
DECODE = {"decode.copy_in", "decode.sanitize", "decode.frame",
          "decode.plan", "decode.pad", "decode.kernel"}


def _llr(n=N, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 2)).astype(np.float32))


@pytest.fixture
def tracer_set():
    """Install a tracer for one test and restore the previous one."""
    prev = obs.get_tracer()

    def install(tracer):
        obs.set_tracer(tracer)
        return tracer
    yield install
    obs.set_tracer(prev)


def _records(tracer):
    return [(r.name, r.parent, r.kind, r.attrs) for r in tracer.spans()]


def _profiled_events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _ancestors(ev):
    out = []
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
        out.append(ev.name)
    return out


@pytest.mark.parametrize("backend", ["kernel", "kernel_split"])
def test_make_decoder_spans_nest_under_decode(tracer_set, backend):
    dec = make_decoder(DecoderConfig(spec=SPEC, backend=backend), "cpu")
    t = tracer_set(obs.Tracer())
    llr = _llr()
    dec(llr, N)
    dec(llr, N)
    spans = t.spans()
    tops = [r for r in spans if r.name == "decode"]
    assert [r.attrs["call"] for r in tops] == [0, 1]
    assert all(r.parent is None for r in tops)
    inner = [r for r in spans if r.name != "decode"]
    assert {r.name for r in inner} == DECODE
    assert all(r.parent == "decode" for r in inner)
    assert len(inner) == 2 * len(DECODE)
    (kern, _) = [r for r in spans if r.name == "decode.kernel"]
    assert kern.attrs["kernel"] == ("unified" if backend == "kernel"
                                    else "split")
    assert kern.attrs["frames"] == 5 and kern.attrs["device"] == "cpu"
    assert t.counters() == {}


def test_a_punctured_call_runs_under_decode_depuncture(tracer_set):
    """The depuncture runs inside ``decode.frame``, which records the
    rate; there is no ``decode.depuncture`` span."""
    from _torch_parity import rx
    n = 63 * 4
    dec = make_decoder(DecoderConfig(spec=SPEC34, rate="3/4",
                                     backend="kernel"), "cpu")
    t = tracer_set(obs.Tracer())
    dec(rx(n, "3/4", seed=1), n)
    names = [r.name for r in t.spans()]
    assert "decode.depuncture" not in names
    assert set(names) == {"decode"} | DECODE
    (frame,) = [r for r in t.spans() if r.name == "decode.frame"]
    assert frame.attrs["rate"] == "3/4"
    assert {r.parent for r in t.spans() if r.name.startswith("decode.")} \
        == {"decode"}


@pytest.mark.parametrize("cards", [3, 4])
def test_sharded_call_spans_a_card_each(tracer_set, cards):
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    decode = make_sharded_frame_decoder(cfg, frame_mesh(["cpu"] * cards))
    t = tracer_set(obs.Tracer())
    frames = frame_llr(_llr(7 * SPEC.f), SPEC)
    decode(frames)
    spans = t.spans()
    (top,) = [r for r in spans if r.name == "shard"]
    assert top.attrs == {"call": 0} and top.parent is None
    shard = [r for r in spans if r.name.startswith("shard.")]
    assert [r.name for r in shard] == (["shard.out"] +
                                       ["shard.decode"] * cards +
                                       ["shard.gather"])
    assert all(r.parent == "shard" for r in shard)
    assert [r.attrs["card"] for r in shard[1:-1]] == list(range(cards))
    kernels = [r for r in spans if r.name == "decode.kernel"]
    assert len(kernels) == cards
    assert all(r.parent == "shard.decode" for r in kernels)


def test_a_one_card_mesh_spans_one_shard_decode(tracer_set):
    decode = make_sharded_frame_decoder(DecoderConfig(spec=SPEC),
                                        frame_mesh(["cpu"]))
    t = tracer_set(obs.Tracer())
    decode(frame_llr(_llr(), SPEC))
    assert [(r.name, r.attrs) for r in t.spans()
            if r.name.startswith("shard")] == [
        ("shard.out", {}), ("shard.decode", {"card": 0}),
        ("shard", {"call": 0})]


def test_the_ring_of_a_profiled_tracer_equals_a_tracers(tracer_set):
    llr = _llr()
    dec = make_decoder(DecoderConfig(spec=SPEC, backend="kernel"), "cpu")
    rings = []
    for tracer in (obs.Tracer(), obs.ProfiledTracer()):
        tracer_set(tracer)
        dec(llr, N)
        rings.append(_records(tracer))
    plain, profiled = rings
    assert [r[:3] for r in plain] == [r[:3] for r in profiled]
    assert [sorted(r[3]) for r in plain] == [sorted(r[3]) for r in profiled]
    assert len(plain) == 1 + len(DECODE)


def test_profiled_spans_land_in_the_profiler_around_their_ops(tracer_set):
    dec = make_decoder(DecoderConfig(spec=SPEC, backend="kernel"), "cpu")
    t = tracer_set(obs.ProfiledTracer())
    llr = _llr()
    events = _profiled_events(lambda: dec(llr, N))
    names = [e.name for e in events]
    assert {"decode"} | DECODE <= set(names)
    clip = [e for e in events if e.name in ("aten::isfinite", "aten::clamp")]
    assert len(clip) == 2 and all(
        _ancestors(e)[:2] == ["decode.sanitize", "decode"] for e in clip)
    pads = [e for e in events if e.name == "aten::constant_pad_nd"]
    assert pads and "decode.frame" in _ancestors(pads[0])
    (sanitize,) = [e for e in events if e.name == "decode.sanitize"]
    assert sanitize.cpu_parent.name == "decode"
    # the ring has the same spans
    assert {r.name for r in t.spans()} == {"decode"} | DECODE


def test_a_running_profiler_gets_the_spans_with_no_tracer_set(tracer_set):
    tracer_set(None)
    dec = make_decoder(DecoderConfig(spec=SPEC, backend="kernel"), "cpu")
    llr = _llr()
    seen = []

    def call():
        seen.append(span_tracer())
        dec(llr, N)
    events = _profiled_events(call)
    assert seen == [PROFILER_SPANS]
    assert span_tracer() is obs.NULL_TRACER
    assert {"decode"} | DECODE <= {e.name for e in events}
    assert obs.NULL_TRACER.spans() == [] and PROFILER_SPANS.spans() == []


def test_a_null_tracer_set_keeps_the_spans_out_of_the_profiler(tracer_set):
    tracer_set(obs.NullTracer())
    dec = make_decoder(DecoderConfig(spec=SPEC, backend="kernel"), "cpu")
    llr = _llr()
    events = _profiled_events(lambda: dec(llr, N))
    assert not any(e.name.startswith(("decode", "shard")) for e in events)
    assert any(e.name == "aten::where" for e in events)


@pytest.mark.parametrize("entry", ["make_decoder", "sharded"])
def test_with_no_tracer_and_no_profiler_nothing_is_recorded(tracer_set,
                                                            entry):
    tracer_set(None)
    assert span_tracer() is obs.NULL_TRACER
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    llr = _llr()
    if entry == "make_decoder":
        bits = make_decoder(cfg, "cpu")(llr, N)
    else:
        bits = make_sharded_frame_decoder(cfg, frame_mesh(["cpu"] * 3))(
            frame_llr(llr, SPEC)).reshape(-1)[:N]
    assert bits.shape == (N,)
    assert obs.get_tracer() is obs.NULL_TRACER
    assert obs.NULL_TRACER.spans() == [] and obs.NULL_TRACER.counters() == {}
    # every hook is the one shared no-op
    assert obs.NULL_TRACER.span("decode", call=0) is \
        obs.NULL_TRACER.span("decode.kernel")
