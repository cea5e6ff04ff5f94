"""Readings that set a cell's limit: the program on many seeds and the
control on a few, at the cell's own size and load, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103

For each seed the cell's client decodes every block of the pool once, and
the first block once more, as a run's window does (closed loop, one
client), and each output is compared with the reference's decode of the
same LLRs. The program runs as the configuration states; the control is
the program with its own lower-precision path switched on: branch
metrics in bfloat16 (``bm_dtype``). The benchmark's runs never run this.
The last line of standard output is a JSON summary: the largest reading of
the program and the smallest of the control, for each number compared.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: The control: the configuration's decoder with this laid over it.
CONTROL = {"bm_dtype": "bfloat16"}


def readings(root, workload: str, seed: int, devices, overrides=None) -> dict:
    """One seed's counts (``harness.check_outputs``) of the program, or of
    the control with ``overrides=CONTROL``."""
    import torch
    from portbench.cells import load_cell
    from portbench.harness import check_outputs, make_client, make_inputs
    cell = load_cell(root, workload)
    inputs = make_inputs(cell, seed, torch.device(devices[0]))
    pool = len(inputs.order)
    client = make_client(cell, inputs, devices, pool + 1, overrides)
    outputs = []
    for i, p in enumerate([inputs.order[0]] + inputs.order):
        outputs.append((p, client.finish(client.issue(p),
                                         pool if i == 0 else p)))
    del client
    return check_outputs(cell, inputs, outputs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.cells import load_cell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    chips = load_cell(ROOT, args.workload).chips
    devices = [f"cuda:{i}" for i in range(chips)]
    summary = {"workload": args.workload, "program": {}, "control": {}}
    for label, seeds, over in (("program", args.seeds, None),
                               ("control", args.control_seeds, CONTROL)):
        for seed in seeds:
            r = readings(ROOT, args.workload, seed, devices, over)
            print(json.dumps({"variant": label, "seed": seed, **r}),
                  flush=True)
            summary[label][str(seed)] = r["bit_mismatches"]
    summary["program_max"] = max(summary["program"].values())
    summary["control_min"] = min(summary["control"].values())
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
