"""The port's LM models on the card, at the reduced configs.

Marked ``gpu``: each test asks its fixture for a card and skips without
one. Run on the card with ``pytest -m gpu tests/test_torch_gpu_lm.py``.
The card's machine has no JAX, so this file imports none: parity with the
JAX package is held on the CPU (test_torch_models.py,
test_torch_models_bf16.py, test_torch_lm_serve.py); here the card is held
to the port on the CPU, and incremental decode to the parallel forward.

Tolerances. Card against CPU in float32 (matmul precision "highest", no
TF32): 1e-4 on logits, the bound that holds the port to JAX on the CPU:
the two devices sum in other orders, and a wrong operation moves logits
by 1e-2 or more. Incremental against parallel on the card: 1e-4 in
float32 for the same reason (the JAX test's 2e-5 is a bound for one
CPU), and 5e-2 in bfloat16, the bound the bf16 parity tests use (the two
paths round intermediate results at different places).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

pytestmark = pytest.mark.gpu

DECODER_ONLY = [a for a in ARCH_IDS if a != "seamless_m4t_v2"]
CONSISTENCY = ["qwen3_32b", "mamba2_2p7b", "jamba15_large", "starcoder2_7b",
               "qwen3_moe_235b"]
INC_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert torch.get_float32_matmul_precision() == "highest"
    return torch.device("cuda")


def _batch(cfg, B, S, device):
    rng = np.random.default_rng(1)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.vision_patches:
        b["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in b.items()}


def _prefill_and_decode(bundle, params, batch, steps):
    lg = [bundle.prefill(params, batch)]
    cache = bundle.init_cache(params, batch["tokens"].shape[0], 16)
    for t in range(steps):
        out, cache = bundle.decode(params, batch["tokens"][:, t:t + 1],
                                   cache)
        lg.append(out)
    return torch.cat(lg, dim=1).float().cpu()


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_card_matches_cpu(cuda, arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device=cuda)
    params = cpu.init(torch.Generator().manual_seed(0))
    want = _prefill_and_decode(cpu, params, _batch(cfg, 2, 12, "cpu"), 4)
    got = _prefill_and_decode(card, copy.deepcopy(params).to(cuda),
                              _batch(cfg, 2, 12, cuda), 4)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", CONSISTENCY)
def test_incremental_matches_parallel_on_card(cuda, arch, dtype):
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    if cfg.moe:   # avoid batch-shape-dependent capacity drops
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_per_choice=float(cfg.moe.num_experts)))
    m = build_model(cfg, remat="none", device=cuda)
    params = m.init(torch.Generator(cuda).manual_seed(0))
    B, S = 2, 12
    toks = _batch(cfg, B, S, cuda)["tokens"]
    with torch.no_grad():
        x, _ = T.forward(params, cfg, toks, remat="none")
        lg_full = L.logits(params["embed"], x).float()
    cache = m.init_cache(params, B, S)
    outs = []
    for t in range(S):
        lg, cache = m.decode(params, toks[:, t:t + 1], cache)
        outs.append(lg[:, 0].float())
    lg_inc = torch.stack(outs, dim=1)
    assert bool(torch.isfinite(lg_inc).all())
    assert float((lg_inc - lg_full).abs().max()) < INC_TOL[dtype]
