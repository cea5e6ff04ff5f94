"""On the card, at the cells' own sizes: the control (the program with its
bfloat16 branch metrics) fails the check on three seeds, and the program
passes it. Skips without a card."""
import pytest
from portbench_tmp import ROOT, one_thread  # noqa: F401

from portbench.cells import load_benchmark


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "python -m pytest -m gpu portbench/tests)")
    return "cuda:0"


def _one_chip_cells():
    return [w["name"] for w in load_benchmark(ROOT)["workloads"]
            if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["k7_r12_batch", "galileo_k15_batch"])
def test_control_fails_and_program_passes_at_the_cells_size(card, cell):
    from portbench.control import CONTROL, readings
    if cell not in _one_chip_cells():
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    assert readings(ROOT, cell, 7001, [card])["bit_mismatches"] == 0
    for seed in (7101, 7102, 7103):
        assert readings(ROOT, cell, seed, [card],
                        CONTROL)["bit_mismatches"] > 0
