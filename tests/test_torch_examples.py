"""The port's examples (examples/torch_*.py) run in-process on the CPU at a
small size; each asserts its own bit equality (kernel backend == reference
backend, streamed == one-shot over a two-shard mesh, every server session
== its solo stream_decode)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

torch.set_num_threads(1)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    ber = _example("torch_quickstart").main(["--device", "cpu", "--n",
                                             "4096"])
    assert 0.0 <= ber < 1e-2
    assert "equal to the reference backend's bits" in capsys.readouterr().out


def test_sdr_pipeline(capsys):
    out = _example("torch_sdr_pipeline").main(["--device", "cpu", "--n",
                                               "3024"])
    assert out.shape == (3024,) and out.dtype == np.int32
    text = capsys.readouterr().out
    assert "over 2 shard(s) (cpu, cpu)" in text
    assert "streamed bits equal the one-shot bits" in text


@pytest.mark.parametrize("chaos", [False, True])
def test_serve_viterbi(chaos, tmp_path, capsys):
    argv = ["--device", "cpu", "--sessions", "3", "--chunks", "2",
            "--chunk-frames", "2", "--trace-out", str(tmp_path / "t.json"),
            "--metrics-out", str(tmp_path / "m")]
    if chaos:
        argv += ["--chaos", "--kill-at-step", "3", "--checkpoint-dir",
                 str(tmp_path / "ck")]
    snap = _example("torch_serve_viterbi").main(argv)
    text = capsys.readouterr().out
    assert "every healthy session bit-identical" in text
    assert ("CRASH" in text) == chaos
    assert snap["checkpoint"]["restores"] == (1 if chaos else 0)
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert "repro_serve_bits " in (tmp_path / "m.prom").read_text()
    assert json.loads((tmp_path / "m.json").read_text())["totals"]
