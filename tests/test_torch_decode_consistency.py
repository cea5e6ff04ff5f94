"""Incremental decode must equal the parallel (teacher-forced) forward,
per family, in the port: mirrors tests/test_decode_consistency.py's five
architectures on the CPU (float32, the reduced configs, MoE capacity
lifted so that no batch-shape-dependent drop differs; < 2e-5, the JAX
test's bound)."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["qwen3_32b", "mamba2_2p7b",
                                  "jamba15_large", "starcoder2_7b",
                                  "qwen3_moe_235b"])
def test_incremental_matches_parallel(arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    if cfg.moe:   # avoid batch-shape-dependent capacity drops
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_per_choice=float(cfg.moe.num_experts)))
    m = build_model(cfg, remat="none", device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        x, _ = T.forward(params, cfg, toks, remat="none")
        lg_full = L.logits(params["embed"], x)
    cache = m.init_cache(params, B, S)
    outs = []
    for t in range(S):
        lg, cache = m.decode(params, toks[:, t:t + 1], cache)
        outs.append(lg[:, 0])
    lg_inc = torch.stack(outs, dim=1)
    assert float((lg_inc - lg_full).abs().max()) < 2e-5
