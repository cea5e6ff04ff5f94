"""The port's shape-counting dry run (repro_torch.launch.dryrun) against
the JAX package's, on the CPU, with no compile and no allocation on
either side: the JAX package's models through ``jax.eval_shape``, the
port's on the meta device.

``count_params``, ``active_params`` and ``model_flops`` equal JAX's for
every architecture at full size and every shape; the per-card bytes of
the params equal the sum over JAX's ``param_specs`` on the same mesh
shape (a dim over n shards holds ceil(dim / n)); the command writes its
row without a card.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry          # noqa: E402  sets XLA_FLAGS
if _flags is None:                               # the tests see one device
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags
from repro.configs import get_config as jget_config           # noqa: E402
from repro.distributed.sharding import param_specs as jparam_specs  # noqa
from repro.launch.roofline import count_params as jcount_params  # noqa
from repro.models import build_model as jbuild_model          # noqa: E402

from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun                         # noqa: E402
from repro_torch.launch.roofline import count_params          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _jax_shapes(arch):
    cfg = jget_config(arch)
    return cfg, jax.eval_shape(jbuild_model(cfg).init,
                               jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_jax(arch):
    jcfg, shapes = _jax_shapes(arch)
    cfg = get_config(arch)
    params = dryrun.meta_params(cfg)
    assert all(p.is_meta for p in params.parameters())
    assert count_params(params) == jcount_params(shapes)
    assert dryrun.active_params(params, cfg) == jdry.active_params(
        shapes, jcfg)
    for name, shape in SHAPES.items():
        assert dryrun.model_flops(cfg, params, shape) == jdry.model_flops(
            jcfg, shapes, jdry.SHAPES[name]), name
    assert list(dryrun.cells()) == list(jdry.cells())


def _jax_bytes(shapes, axes, strategy):
    specs = jparam_specs(shapes, strategy=strategy)
    total = 0
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for leaf, spec in zip(jax.tree.leaves(shapes),
                          jax.tree.leaves(specs, is_leaf=is_spec)):
        n = 1
        for i, dim in enumerate(leaf.shape):
            ax = spec[i] if i < len(spec) else None
            k = 1
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                k *= axes.get(a, 1)
            n *= math.ceil(dim / k)
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "jamba15_large",
                                  "starcoder2_7b", "seamless_m4t_v2"])
def test_bytes_per_card_equal_jax_specs(arch):
    _, shapes = _jax_shapes(arch)
    params = dryrun.meta_params(get_config(arch))
    for axes in dryrun.MESHES.values():
        for strategy in ("tp", "fsdp"):
            per = dryrun.bytes_per_card(params, axes, strategy)
            assert sum(n * s for n, s in per.values()) == _jax_bytes(
                shapes, axes, strategy), (axes, strategy)


def test_dryrun_writes_its_row_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3_32b", "--shape", "train_4k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    row = json.loads((tmp_path / "qwen3_32b_train_4k_32x8.json").read_text())
    assert row == json.loads(proc.stdout.strip().splitlines()[-1])
    assert (row["chips"], row["mesh"], row["params"]) == (256, "32x8",
                                                          32763433984)
    assert row["fits_hbm"] and row["state_bytes_per_chip"] == (
        2 * row["param_bytes_per_chip"] + row["moment_bytes_per_chip"])
    assert row["t_compute_s"] == row["model_flops"] / (256 * 989e12)
    for key in ("peak_memory_per_chip", "coll_bytes_per_chip",
                "t_collective_s"):
        assert row[key] is None
    assert set(row["not_counted"]) == {"activations", "collective_bytes"}
