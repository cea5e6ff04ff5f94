import os
import sys

# tests must see exactly ONE device (the dry-run sets its own flags in a
# separate process); never inherit a stray device-count flag.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def std_trellis():
    from repro.core import STD_K7
    return STD_K7


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def noisy_llr(bits, trellis, snr_db, rng):
    """Encode bits, BPSK, add AWGN -> (n, beta) llr numpy."""
    import jax.numpy as jnp
    from repro.core import encode
    coded = np.asarray(encode(jnp.asarray(bits), trellis))
    tx = 1.0 - 2.0 * coded.astype(np.float32)
    sigma = 10.0 ** (-snr_db / 20.0)
    return tx + sigma * rng.standard_normal(tx.shape).astype(np.float32)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on the "
        "card with `pytest -m gpu tests/test_torch_gpu.py`)")
