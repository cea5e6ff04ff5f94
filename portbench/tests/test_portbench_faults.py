"""A whole run, bar the look for a card, on the CPU at a tiny size: sound,
it is correct; with the timed path broken underneath, ``correct`` comes
out false, once for each fault a decode cell can have."""
import time

import pytest
import torch
from portbench_tmp import BIG_SEED, tiny_benchmark, one_thread  # noqa: F401

from portbench.harness import run_cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_benchmark(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seconds=0.2):
    chips = 4 if cell.endswith("mesh") else 1
    return run_cell(root, cell, BIG_SEED, seconds, trace, ["cpu"] * chips,
                    time.perf_counter(), log=lambda s: None)


def _wrap_decode(monkeypatch, fault):
    from repro_torch.kernels import ops
    real = ops.viterbi_decode_frames

    def broken(frames, *a, **kw):
        return fault(real, frames, *a, **kw)
    monkeypatch.setattr(ops, "viterbi_decode_frames", broken)


def altered_answer(real, frames, *a, **kw):
    bits = real(frames, *a, **kw).clone()
    bits[0, 7] ^= 1
    return bits


def half_the_batch(real, frames, *a, **kw):
    half = frames.shape[0] // 2
    bits = real(frames[:half], *a, **kw)
    rest = bits.new_zeros((frames.shape[0] - half, bits.shape[1]))
    return torch.cat([bits, rest])


@pytest.mark.parametrize("cell", ["tiny_k7", "tiny_k7_host", "tiny_k7_mesh",
                                  "tiny_galileo"])
def test_a_sound_run_is_correct(root, cell):
    result, checks = _run(root, cell)
    assert result["correct"] is True
    assert checks == {"bit_mismatches": {"value": 0, "limit": 0}}
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny_k7", "tiny_k7_host", "tiny_k7_mesh"])
@pytest.mark.parametrize("fault", [altered_answer, half_the_batch])
def test_a_broken_decode_is_not_correct(root, cell, fault, monkeypatch):
    _wrap_decode(monkeypatch, fault)
    result, checks = _run(root, cell)
    assert result["correct"] is False
    assert checks["bit_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny_k7", "tiny_k7_host"])
def test_one_altered_call_inside_the_window_is_not_correct(root, cell,
                                                           monkeypatch):
    """Only the window's sixth call (after the pool's two warm calls) is
    altered; later calls decode the same block soundly, so a check of the
    first call and the last call of each block alone would miss it."""
    calls = []

    def sixth_altered(real, frames, *a, **kw):
        calls.append(1)
        return (altered_answer if len(calls) == 2 + 6 else
                lambda r, f, *x, **y: r(f, *x, **y))(real, frames, *a, **kw)
    _wrap_decode(monkeypatch, sixth_altered)
    result, checks = _run(root, cell, seconds=1.0)
    assert result["attempted"] > 6 + 2 * 2
    assert result["correct"] is False
    assert checks["bit_mismatches"]["value"] == 1


def test_the_exchange_between_cards_left_out_is_not_correct(root,
                                                            monkeypatch):
    from repro_torch.distributed import stream as dstream
    real = dstream.make_sharded_frame_decoder

    def no_exchange(cfg, mesh):
        decode = real(cfg, mesh)

        def decode_frames(frames):
            bits = decode(frames)
            per = -(-frames.shape[0] // mesh.size)
            out = torch.zeros_like(bits)
            out[:per] = bits[:per]          # only the home card's shard
            return out
        return decode_frames
    monkeypatch.setattr(dstream, "make_sharded_frame_decoder", no_exchange)
    result, checks = _run(root, "tiny_k7_mesh")
    assert result["correct"] is False
    assert checks["bit_mismatches"]["value"] > 0


def test_a_traced_run_is_checked_and_reads_nothing_from_no_card(
        root, monkeypatch):
    from portbench import harness
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    result, checks = _run(root, "tiny_k7", trace=True)
    assert result["correct"] is True
    # on the CPU no device event exists: the device readers return nothing
    assert set(result["metrics"]) == {"host_ms_per_call"}
    assert result["device"]["window_s"] > 0
    assert list(result)[-2:] == ["breakdown", "checks"]
