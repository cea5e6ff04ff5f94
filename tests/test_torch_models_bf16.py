"""The port's LM models against the JAX package in bfloat16, on the CPU:
tests/test_torch_models.py's comparison (loss, prefill on the full and
the blockwise path, 4 decode steps) with every architecture's reduced
config in bfloat16. Logits and loss within 5e-2
(tests/_torch_lm_parity.py says why). A file of its own so that the
test workers split the two dtypes' JAX compiles.
"""
import pytest

from _torch_lm_parity import check_against_jax
from repro.configs import ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_matches_jax_on_the_same_weights_bf16(arch):
    check_against_jax(arch, "bfloat16")
