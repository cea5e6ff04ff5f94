"""Cells, configurations, traffic and metrics are found by name from data
files, and a cell defined only in a temporary folder runs."""
import json
import re
import time

import pytest
from portbench_tmp import BIG_SEED, ROOT, tiny_benchmark, one_thread  # noqa: F401

from portbench.cells import load_benchmark, load_cell, load_module, \
    metric_reader, metrics_of
from portbench.harness import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_loads_from_its_files():
    bench = load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = load_cell(ROOT, w["name"])
        k, polys, beta = cell.code
        assert cell.chips == w["chips"] == cell.traffic["chips"]
        assert len(polys) == beta and k == cell.config["code"]["k"]
        assert cell.config["name"] == w["config"]
        assert cell.n > 0


def test_the_cells_are_the_ones_the_issue_names():
    cells = {w["name"]: w for w in load_benchmark(ROOT)["workloads"]}
    assert load_cell(ROOT, "k7_r12_batch").code == (7, (0o171, 0o133), 2)
    assert load_cell(ROOT, "k7_r12_batch").n == 1 << 24
    if "galileo_k15_batch" in cells:
        cell = load_cell(ROOT, "galileo_k15_batch")
        assert cell.code == (15, (0o46321, 0o51271, 0o63667, 0o70535), 4)
        assert cell.n == 1 << 20
    assert [w["name"] for w in cells.values() if w["chips"] == 4] in (
        [], ["k7_r12_mesh4"])


def test_benchmark_json_keeps_to_the_contract_shape():
    bench = load_benchmark(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200
        assert metrics_of(bench, w["name"], "per_layer")


def test_every_metric_and_entry_has_its_file():
    bench = load_benchmark(ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(ROOT, m["name"]).read)
    assert metric_reader(ROOT, "decoded_mbps.host") is not None
    with pytest.raises(FileNotFoundError):
        metric_reader(ROOT, "no_such_metric.host")
    for w in bench["workloads"]:
        entry = load_cell(ROOT, w["name"]).traffic["entry"]
        assert (ROOT / "portbench" / "clients" / f"{entry}.py").is_file()


def test_metrics_of_follows_the_workloads_key():
    bench = load_benchmark(ROOT)
    batch = {m["name"] for m in metrics_of(bench, "k7_r12_batch", "per_layer")}
    assert "host_ms_per_call" in batch and "h2d_ms_per_call" not in batch
    for w in bench["workloads"]:
        e2e = {m["name"] for m in metrics_of(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in metrics_of(bench, w["name"], "per_layer"):
            assert m["moves"] in e2e, (w["name"], m["name"])
    bench["per_layer"].append({"name": "x", "moves": "decoded_mbps"})
    assert "x" in {m["name"] for m in metrics_of(bench, "k7_r12_batch",
                                                   "per_layer")}


def test_a_cell_defined_only_in_a_temporary_folder_runs(tmp_path):
    root = tiny_benchmark(tmp_path)
    extra = json.loads((root / "portbench/traffic/tiny_k7.json").read_text())
    extra["pool"] = 3
    (root / "portbench/traffic/only_here.json").write_text(json.dumps(extra))
    cfg = json.loads((root / "portbench/configs/ccsds_k7_r12.json").read_text())
    cfg["name"] = "k7_only_here"
    cfg["channel"]["ebn0_db"] = 2.0
    (root / "portbench/configs/k7_only_here.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "k7_only_here", "source": "a test",
                             "file": "portbench/configs/k7_only_here.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "only_here", "config": "k7_only_here",
                               "traffic": "only_here", "chips": 1, "why": "t"})
    for m in bench["end_to_end"]:
        if m["name"] in ("decoded_mbps", "latency_ms_p95"):
            m["workloads"].append("only_here")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(KeyError):
        load_cell(ROOT, "only_here")
    assert load_cell(root, "only_here").config["channel"]["ebn0_db"] == 2.0
    result, checks = run_cell(root, "only_here", BIG_SEED, 0.2, False,
                              ["cpu"], time.perf_counter(), log=lambda s: None)
    assert result["correct"] and checks["bit_mismatches"]["value"] == 0
    assert set(result["metrics"]) == {"decoded_mbps", "latency_ms_p95",
                                      "setup_s"}
    assert list(result)[-1] == "checks"
