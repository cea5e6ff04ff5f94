"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
compared with the reference, each with its limit. Exits non-zero, and
prints no result, without a CUDA card (or with fewer than the cell asks
for), without the port's package beside the benchmark, or when JAX or the
JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level modules that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch beside the benchmark under {ROOT}",
              file=sys.stderr)
        return 2
    import torch
    from portbench.cells import load_cell
    from portbench.harness import run_cell

    chips = load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(chips)]
    result, checks = run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        devices, T_PROCESS, log=lambda s: print(s, file=sys.stderr))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
