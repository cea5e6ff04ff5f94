"""The port's sharded training path on the card, at the reduced configs.

Marked ``gpu``: each test asks its fixture for the cards it needs and
skips, with the reason, without them. Run on the card with ``pytest -m
gpu tests/test_torch_gpu_sharded.py``. No JAX here: parity with the JAX
package is held on the CPU (test_torch_sharded_train.py); here the
sharded step on ``nccl`` meshes is held to the plain step on one card,
the checks of chip_smoke.py's phase 12 at the reduced size.

Tolerances (float32, matmul precision "highest"): the loss and grad
norm of each of 2 AdamW steps within 1e-5 relative; the params after
them within 2e-4 (lr / 5; Adam turns few-ulp gradient differences into
a fraction of lr where a gradient is near eps).
"""

import pytest
import torch

import _torch_gpu_sharded as W

pytestmark = pytest.mark.gpu

REL, PARAM_ATOL = 1e-5, 2e-4
ARCHS = ["qwen3_32b", "qwen3_moe_235b", "mamba2_2p7b"]


def _cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, {torch.cuda.device_count()} present")
    assert torch.get_float32_matmul_precision() == "highest"


def _check(got, want):
    (mets, params), (wmets, wparams) = got, want
    for (l, g), (wl, wg) in zip(mets, wmets):
        assert abs(l - wl) <= REL * abs(wl) and abs(g - wg) <= REL * abs(wg)
    for n, w in wparams.items():
        assert float((params[n] - w).abs().max()) <= PARAM_ATOL, n


@pytest.mark.parametrize("arch", ARCHS)
def test_world1_sharded_step_equals_plain(tmp_path, arch):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    _cards(1)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        got = W.steps(arch, "cuda", mesh)
    finally:
        dist.destroy_process_group()
    _check(got, W.steps(arch, "cuda"))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (1, 4), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_multi_card_sharded_step_equals_plain(tmp_path, shape):
    import torch.multiprocessing as mp
    world = shape[0] * shape[1]
    _cards(world)
    out = str(tmp_path / "res.pt")
    mp.spawn(W.run, args=(world, str(tmp_path / "store"), shape, ARCHS, out),
             nprocs=world)
    res = torch.load(out)
    for arch in ARCHS:
        _check(res[arch], W.steps(arch, "cuda"))
