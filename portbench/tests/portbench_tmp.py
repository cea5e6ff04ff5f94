"""Helpers of the benchmark's tests: the repository's root on the path, and
a copy of the benchmark in a temporary folder with tiny cells added as
data files."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: A seed above 2**32: the benchmark takes seeds wider than 32 bits.
BIG_SEED = (1 << 33) + 12345


def tiny_benchmark(tmp: Path, bits: int = 3000, pool: int = 2) -> Path:
    """A copy of BENCHMARK.json and portbench/ under ``tmp``, plus tiny
    cells of every entry defined only there: ``tiny_k7`` (device),
    ``tiny_k7_host``, ``tiny_k7_mesh`` (4 chips) and ``tiny_galileo``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for name, entry, home, chips, config in (
            ("tiny_k7", "make_decoder", "device", 1, "ccsds_k7_r12"),
            ("tiny_k7_host", "make_decoder", "host", 1, "ccsds_k7_r12"),
            ("tiny_k7_mesh", "sharded_frames", "device", 4, "ccsds_k7_r12"),
            ("tiny_galileo", "make_decoder", "device", 1, "galileo_k15_r14")):
        traffic = {"entry": entry, "chips": chips, "bits_per_call": bits,
                   "llr_home": home, "bits_home": home, "pool": pool}
        (tmp / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": name, "chips": chips,
                                   "why": "a tiny cell for the CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and not m["name"].endswith(".host"):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture(autouse=True)
def one_thread():
    """Run a test on one intra-op thread and restore the count after: the
    tests' tensors are small, and the suite runs in several processes at
    once on a few cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
