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


def _recorded(mod):
    """Wraps the example's ``stream_decode`` (its verification baseline,
    which every served session must equal) to keep each session's bits."""
    bits, real = [], mod.stream_decode

    def stream_decode(*args, **kwargs):
        out = np.asarray(real(*args, **kwargs))
        bits.append(out)
        return out

    mod.stream_decode = stream_decode
    return bits


def _serve_both(argv_jax, argv_port):
    """The JAX example and the port's on the same received streams (the
    JAX example's ``make_rx``, seeded by session): each one's verified
    bits in session order."""
    from repro.core.trellis import make_trellis as jmake_trellis
    jex = _example("serve_viterbi")
    tex = _example("torch_serve_viterbi")
    tex.make_rx = lambda tr, n, rate, seed, snr=4.0: np.asarray(jex.make_rx(
        jmake_trellis(tr.k, tr.polys), n, rate, seed, snr))
    want, got = _recorded(jex), _recorded(tex)
    jex.main(argv_jax)
    tex.main(["--device", "cpu"] + argv_port)
    return want, got


SMALL = ["--sessions", "2", "--chunks", "2", "--chunk-frames", "2"]


@pytest.mark.parametrize("block", [["--block-frames", "auto"],
                                   ["--block-frames", "4", "--overlap",
                                    "40"],
                                   ["--block-frames", "1"]])
def test_serve_viterbi_block_frames_bits_equal_jax(block, capsys):
    want, got = _serve_both(SMALL + block, SMALL + block)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert w.shape == (2 * 2 * 2048,) and np.array_equal(g, w)
    text = capsys.readouterr().out
    mode = "sequential scan" if block[1] == "1" else "block-parallel"
    assert text.count(f"per-window launch latency [{mode}") == 2


def test_serve_viterbi_resume_bits_equal_jax(tmp_path, capsys):
    """A first run leaves its last checkpoint with every session still
    open; ``--resume`` restores it, closes the carried-over sessions (the
    same undelivered bits in both packages), then serves anew."""
    def argv(pkg):
        return ["--sessions", "3", "--chunks", "2", "--chunk-frames", "2",
                "--checkpoint-dir", str(tmp_path / pkg)]
    _serve_both(argv("jax"), argv("port"))
    capsys.readouterr()
    want, got = _serve_both(argv("jax") + ["--resume"],
                            argv("port") + ["--resume"])
    assert len(got) == len(want) == 3
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("resumed: closed")]
    assert len(lines) == 6 and lines[:3] == lines[3:]


def test_train_lm_tiny(tmp_path, capsys):
    """examples/torch_train_lm.py --tiny: launch/train.py's loop on the
    reduced qwen3, 12 steps with a checkpoint at the last."""
    stats = _example("torch_train_lm").main(
        ["--tiny", "--steps", "12", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)])
    assert stats.steps_run == 12 and np.isfinite(stats.last_loss)
    assert "done: steps=12" in capsys.readouterr().out
    assert (tmp_path / "step_00000011" / "manifest.json").is_file()
