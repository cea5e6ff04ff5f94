"""Markdown table of the LM dry run's rows, both meshes side by side.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod \
        --out DIR
    python3 tools/dryrun_table.py DIR

One line per (arch, shape) cell that ``launch.dryrun.cells()`` lists: for
each mesh the traced peak a card (GB) and whether it fits 80 GB, FLOPs,
HBM bytes and link-weighted collective bytes a card, the bottleneck,
t_bound, the useful-FLOP ratio and the MFU bound. A cell without a row
prints "missing".
"""
import json
import sys
from pathlib import Path

MESHES = ("32x8", "2x32x8")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell(row) -> list:
    if row is None:
        return ["missing"] + [""] * 8
    return [f"{row['peak_memory_per_chip'] / 1e9:.1f}",
            "yes" if row["fits_hbm"] else "**no**",
            f"{row['flops_per_chip']:.3g}", f"{row['bytes_per_chip']:.3g}",
            f"{row['coll_bytes_per_chip']:.3g}", row["bottleneck"],
            f"{row['t_bound_s']:.3g}", f"{row['useful_ratio']:.3f}",
            f"{row['mfu_bound']:.3f}"]


def main(argv=None):
    out = Path((argv or sys.argv[1:])[0])
    rows = {}
    for p in sorted(out.glob("*.json")):
        r = json.loads(p.read_text())
        if "t_bound_s" in r and not r.get("tag"):
            rows[(r["arch"], r["shape"], r["mesh"])] = r
    cells = sorted({(a, s) for a, s, _ in rows},
                   key=lambda c: (c[0], SHAPES.index(c[1])))
    head = ["peak GB", "fits", "FLOPs", "HBM B", "coll B", "bound",
            "t_bound s", "useful", "MFU bound"]
    print("| arch | shape | " + " | ".join(f"{h} {m}" for m in MESHES
                                          for h in head) + " |")
    print("|" + " --- |" * (2 + len(head) * len(MESHES)))
    for a, s in cells:
        vals = [v for m in MESHES for v in cell(rows.get((a, s, m)))]
        print(f"| {a} | {s} | " + " | ".join(vals) + " |")


if __name__ == "__main__":
    main()
