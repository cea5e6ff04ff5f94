"""The 802.11 rate-3/4 configuration (``wifi_k7_r34``), its punctured
reference and the ``punctured_decoder`` client, on the CPU at a tiny size:
a run is correct, the reference equals the port's reference backend, the
client punctures as the port does, a pattern with its rows swapped on
either side is caught, and the depuncture's device metric reads nothing
without a card; the client refuses a decoder slower than the air; the
reference loads nothing of the port. On a card
(``-m gpu``) the control fails and the program passes at the cell's own
size."""
import importlib
import json
import time

import pytest
import torch
from portbench_tmp import BIG_SEED, ROOT, tiny_benchmark, one_thread  # noqa: F401

from portbench.cells import load_cell, load_module, metric_reader
from portbench.harness import Run, run_cell
from portbench.reference import channel, viterbi_punctured

pun = importlib.import_module("repro_torch.core.puncture")

CELL = "tiny_k7_r34"
CONFIG = "wifi_k7_r34"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark with a tiny cell of the rate-3/4 configuration:
    3000 bits a call, a pool of 2, on the device."""
    root = tiny_benchmark(tmp_path_factory.mktemp("bench"))
    traffic = {"entry": "punctured_decoder", "chips": 1, "bits_per_call": 3000,
               "llr_home": "device", "bits_home": "device", "pool": 2}
    (root / "portbench" / "traffic" / f"{CELL}.json").write_text(
        json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": CELL, "chips": 1,
                               "why": "a tiny cell for the CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "k7_r34_batch" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, trace=False, seconds=0.2):
    return run_cell(root, CELL, BIG_SEED, seconds, trace, ["cpu"],
                    time.perf_counter(), log=lambda s: None)


def _llr(n, ebn0=5.0, seed=BIG_SEED):
    config = load_cell(ROOT, "k7_r34_batch").config
    k, polys = 7, tuple(int(g, 8) for g in config["code"]["generators_octal"])
    gen = channel.generator(seed, "cpu")
    bits = channel.info_bits(gen, (n,))
    return config, channel.received_llr(channel.encode(bits, k, polys), ebn0,
                                        gen)


def test_the_cell_is_the_standards_code_and_puncturing():
    cell = load_cell(ROOT, "k7_r34_batch")
    assert cell.code == (7, (0o133, 0o171), 2) and cell.chips == 1
    assert cell.n == 1 << 24 and cell.traffic["pool"] == 4
    assert cell.config["code"]["rate"] == "3/4"
    assert cell.config["puncture"] == [[1, 1, 0], [1, 0, 1]]
    assert (pun.PATTERNS["3/4"] == cell.config["puncture"]).all()
    kept = viterbi_punctured.keep_mask(cell.config, cell.n)
    assert int(kept.sum()) == 22_369_622


def test_a_sound_run_is_correct(root):
    result, checks = _run(root)
    assert result["correct"] is True
    assert checks == {"bit_mismatches": {"value": 0, "limit": 0}}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"decoded_mbps", "latency_ms_p95", "setup_s"} <= set(
        result["metrics"])


@pytest.mark.parametrize("n", [3000, 3001, 1000])
@pytest.mark.parametrize("ebn0", [5.0, 1.0])
def test_the_reference_equals_the_ports_reference_backend(n, ebn0):
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.pipeline import DecoderConfig, make_decoder
    from repro_torch.core.trellis import make_trellis
    config, llr = _llr(n, ebn0)
    ours = viterbi_punctured.reference_bits(config, llr)
    cfg = DecoderConfig(trellis=make_trellis(7, (0o133, 0o171)),
                        spec=FrameSpec(**config["frame"]), rate="3/4",
                        backend="reference")
    port = make_decoder(cfg, "cpu")(pun.puncture(llr, "3/4"), n)
    assert ours.dtype == torch.int32 and ours.shape == (n,)
    assert torch.equal(ours, port)


@pytest.mark.parametrize("n", [3000, 3001, 3002, 2])
def test_the_clients_puncturing_is_the_ports(n):
    client = load_module(ROOT, "clients", "punctured_decoder")
    config, llr = _llr(n)
    got = client.puncture(llr, config)
    assert torch.equal(got, pun.puncture(llr, "3/4"))
    assert got.shape == (int(viterbi_punctured.keep_mask(config, n).sum()),)


def test_the_line_rate_is_the_54_mbps_mode():
    client = load_module(ROOT, "clients", "punctured_decoder")
    cell = load_cell(ROOT, "k7_r34_batch")
    assert cell.config["line_rate_mbps"] == 54
    assert client.airtime_s(cell.n, cell.config) == pytest.approx(
        (1 << 24) / 54e6)


def _tiny_client(root):
    from portbench.harness import make_client, make_inputs
    cell = load_cell(root, CELL)
    inputs = make_inputs(cell, BIG_SEED, torch.device("cpu"))
    return make_client(cell, inputs, ["cpu"], 3)


def test_a_decoder_that_keeps_up_with_the_air_passes(root):
    times = _tiny_client(root).keep_up(airtime=60.0)
    assert len(times) == 2 and max(times) <= 60.0


def test_a_decoder_slower_than_the_air_is_refused(root):
    client = _tiny_client(root)
    real = client.decode

    def slow(stream, n):
        time.sleep(0.02)
        return real(stream, n)
    client.decode = slow
    with pytest.raises(RuntimeError, match="falls behind the air"):
        client.keep_up(airtime=0.015)


def test_the_reference_refuses_a_pattern_that_is_not_the_stated_rate():
    config, llr = _llr(30)
    for bad in ([[1, 1], [1, 0]], [[1, 1, 0]], [[1, 2, 0], [1, 0, 1]]):
        with pytest.raises(ValueError):
            viterbi_punctured.reference_bits({**config, "puncture": bad}, llr)


def test_the_reference_loads_nothing_of_the_port():
    from test_portbench_imports import FORBIDDEN, _loaded
    names = _loaded("import portbench.reference.viterbi_punctured")
    assert "torch" in names and "portbench" in names
    assert "repro_torch" not in names and not names & FORBIDDEN


def _program_swaps_rows(monkeypatch):
    monkeypatch.setitem(pun.PATTERNS, "3/4", pun.PATTERNS["3/4"][::-1].copy())


def _client_swaps_rows(monkeypatch):
    from portbench import harness
    real = harness.load_module

    def load(root, folder, name):
        mod = real(root, folder, name)
        if folder == "clients":
            inner = mod.puncture
            mod.puncture = lambda llr, config: inner(
                llr, {**config, "puncture": config["puncture"][::-1]})
        return mod
    monkeypatch.setattr(harness, "load_module", load)


@pytest.mark.parametrize("fault", [_program_swaps_rows, _client_swaps_rows])
def test_a_pattern_with_its_rows_swapped_is_not_correct(root, fault,
                                                        monkeypatch):
    fault(monkeypatch)
    result, checks = _run(root)
    assert result["correct"] is False
    assert checks["bit_mismatches"]["value"] > 0


def test_depuncture_device_ms_reads_nothing_without_a_card(root,
                                                           monkeypatch):
    from portbench import harness
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    result, _ = _run(root, trace=True)
    assert result["correct"] is True
    assert "depuncture_device_ms" not in result["metrics"]
    assert "host_ms_per_call" in result["metrics"]
    read = metric_reader(root, "depuncture_device_ms").read
    assert read(Run(load_cell(root, CELL), 1.0, 1.0, [1.0], [1.0])) is None


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "python -m pytest -m gpu portbench/tests)")
    return "cuda:0"


@pytest.mark.gpu
def test_control_fails_and_program_passes_at_the_cells_size(card):
    from portbench.control import CONTROL, readings
    assert readings(ROOT, "k7_r34_batch", 7001, [card])["bit_mismatches"] == 0
    for seed in (7101, 7102, 7103):
        assert readings(ROOT, "k7_r34_batch", seed, [card],
                        CONTROL)["bit_mismatches"] > 0
