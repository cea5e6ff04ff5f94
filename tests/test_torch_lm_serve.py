"""The port's LM serve loop (repro_torch.launch.serve) against the JAX
package's (repro.launch.serve), on the CPU.

Both ``main``s run with ``get_config`` patched to the architecture's
``reduced()`` config in float32, and the port serves the very weights the
JAX ``main`` initialised (``init(PRNGKey(0))``, carried over by
``convert.lm_params_from_jax``). The prompts come from the same
``np.random.default_rng(0)``, so the greedy tokens of every request must
be equal: the slot loop, the shared cache index that a slot's prefill
advances for every slot, and the argmax over the padded vocabulary are
all the JAX package's.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import get_config as jget_config

import repro_torch.launch.serve as tserve
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_jax

SRC = Path(__file__).resolve().parents[1] / "src"

torch.set_num_threads(1)


def _f32(get_config):
    def get(arch, reduced=False):
        return dataclasses.replace(get_config(arch, reduced=True),
                                   dtype="float32")
    return get


@pytest.mark.parametrize("arch", ["qwen3_32b", "qwen3_moe_235b",
                                  "mamba2_2p7b", "jamba15_large"])
def test_served_tokens_equal_jax(arch, monkeypatch, capsys):
    import jax
    monkeypatch.setattr(jserve, "get_config", _f32(jget_config))
    monkeypatch.setattr(tserve, "get_config", _f32(tget_config))
    inits = []
    jbuild = jserve.build_model

    def jax_build(cfg, *a, **k):
        b = jbuild(cfg, *a, **k)

        def init(key):
            inits.append(b.init(key))
            return inits[-1]
        return dataclasses.replace(b, init=init)

    monkeypatch.setattr(jserve, "build_model", jax_build)
    argv = ["--arch", arch, "--requests", "5", "--slots", "3", "--gen",
            "6", "--max-seq", "64"]
    want = jserve.main(argv)
    jparams = jax.tree.map(np.asarray, inits[0])
    tbuild = tserve.build_model

    def port_build(cfg, *a, **k):
        b = tbuild(cfg, *a, **k)
        return dataclasses.replace(
            b, init=lambda gen: lm_params_from_jax(jparams, cfg))

    monkeypatch.setattr(tserve, "build_model", port_build)
    got = tserve.main(argv + ["--device", "cpu"])
    assert sorted(got) == sorted(want) == list(range(5))
    assert got == {rid: list(map(int, toks)) for rid, toks in want.items()}
    out = capsys.readouterr().out
    assert "served 5 requests, 30 tokens" in out


def test_refuses_encdec_as_jax_does():
    with pytest.raises(SystemExit, match="decoder-only"):
        jserve.main(["--arch", "seamless_m4t_v2"])
    with pytest.raises(SystemExit, match="decoder-only"):
        tserve.main(["--arch", "seamless_m4t_v2", "--device", "cpu"])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3_32b"])


def test_serve_requests_stats():
    """The slot loop on the reduced config: every request gets ``gen``
    tokens in range, and one step time per batched decode step."""
    from repro_torch.models import build_model
    cfg = tget_config("qwen3_32b", reduced=True)
    bundle = build_model(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]
    done, stats = tserve.serve_requests(bundle, params, prompts, slots=2,
                                        gen=4, max_seq=32)
    assert sorted(done) == [0, 1, 2]
    assert all(len(t) == 4 and all(0 <= x < cfg.padded_vocab for x in t)
               for t in done.values())
    assert stats["steps"] == len(stats["step_ms"]) > 0
    assert stats["seconds"] > 0


def test_lm_modules_import_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch.models, repro_torch.launch.serve, "
        "repro_torch.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
