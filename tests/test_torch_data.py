"""The port's data pipeline (repro_torch.data) on the CPU.

Mirrors tests/test_data.py (all five tests) on the port, and holds
``make_batch`` bit for bit to the JAX package's (the same numpy code, a
copy in the port) over seeds, steps, hosts, both modes and the vision
and encoder-decoder extras.
"""
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import make_batch as jmake_batch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM, make_batch


def test_determinism():
    cfg = get_config("qwen3_32b", reduced=True)
    a = make_batch(cfg, DataConfig(4, 32, seed=1), step=5)
    b = make_batch(cfg, DataConfig(4, 32, seed=1), step=5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = make_batch(cfg, DataConfig(4, 32, seed=1), step=6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_host_sharding_partitions_global_batch():
    cfg = get_config("qwen3_32b", reduced=True)
    full = make_batch(cfg, DataConfig(8, 16, seed=3), step=2)
    parts = [make_batch(cfg, DataConfig(8, 16, seed=3, host_id=h,
                                        num_hosts=4), step=2)
             for h in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]), full["tokens"])


def test_labels_are_shifted_tokens():
    cfg = get_config("qwen3_32b", reduced=True)
    b = make_batch(cfg, DataConfig(2, 16, mode="learnable"), 0)
    assert np.all((b["tokens"][:, 1:] == b["labels"][:, :-1]))


def test_iterator_resume():
    cfg = get_config("qwen3_32b", reduced=True)
    it = SyntheticLM(cfg, DataConfig(2, 8), start_step=0)
    seq = [next(it)["tokens"] for _ in range(4)]
    it2 = SyntheticLM(cfg, DataConfig(2, 8), start_step=2)
    np.testing.assert_array_equal(next(it2)["tokens"], seq[2])


def test_vlm_and_encdec_extras():
    vcfg = get_config("phi3_vision_4p2b", reduced=True)
    b = make_batch(vcfg, DataConfig(2, 16), 0)
    assert b["vision_embeds"].shape == (2, vcfg.vision_patches, vcfg.d_model)
    assert np.all(b["labels"][:, :vcfg.vision_patches] == -1)
    ecfg = get_config("seamless_m4t_v2", reduced=True)
    b = make_batch(ecfg, DataConfig(2, 16), 0)
    assert b["frames"].shape == (2, 16, ecfg.d_model)


@pytest.mark.parametrize("arch", ["qwen3_32b", "phi3_vision_4p2b",
                                  "seamless_m4t_v2"])
@pytest.mark.parametrize("mode", ["random", "learnable"])
def test_make_batch_equals_jax(arch, mode):
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch,
                                                            reduced=True)
    for seed in (0, 1, 12345):
        for step in (0, 1, 7, 1000):
            for host, hosts in ((0, 1), (1, 2), (3, 4)):
                kw = dict(global_batch=8, seq_len=24, seed=seed,
                          host_id=host, num_hosts=hosts, mode=mode)
                got = make_batch(cfg, DataConfig(**kw), step)
                want = jmake_batch(jcfg, JDataConfig(**kw), step)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k])
