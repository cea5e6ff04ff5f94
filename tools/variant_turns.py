#!/usr/bin/env python3
"""Time variant trees' wide-mapping or large-code kernels against this
tree's, in turns, on one card.

    python3 tools/variant_turns.py [--large] DIR [DIR ...]

Each DIR holds a copy of this tree's ``src/`` with edits to try (a
variant of ``csrc/acs.cuh``, say: another thread count, a knocked-out
exchange, a doubled barrier). Each DIR's ``src/repro_torch`` is imported
under another name and builds its own sources into its own
``build/kernels``, all in parallel. Then, on chip_smoke.py's main frame
(packed, radix 4):

* without ``--large``, K=16 and K=17 rate 1/2 at 132 frames: each tree's
  B1 against this tree's wide mapping off a cluster (``_cluster=1``),
  printed as equal or not (a knock-out variant need not be); B1 and B3 of
  every tree and of the wide mapping off a cluster, in turns;
* with ``--large``, chip_smoke.py's large codes (K=12, 13, 14, 15 and K=12
  beta=8) at their ``LARGE_TIME_FRAMES`` and at ``LARGE_FULL_FRAMES``
  (eight frames an SM): each tree's B1 and B3 against this tree's,
  printed as equal or not; B1 and B3 of every tree in turns.

Turns are a, b, ..., b, a over 2 rounds of 3 launches (CUDA events; the
minimum). Prints each tree's spill stores of the cluster kernels with 8
and 16 butterflies a thread (``--large``: of every one-block kernel).
Needs a card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import importlib
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

SOURCES = ("viterbi_unified.cu", "viterbi_fwd.cu")
CODES = ((16, (0o135417, 0o163251)), (17, (0o247153, 0o365715)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    large = "--large" in argv
    argv = [a for a in argv if a != "--large"]
    import torch
    if not argv or not torch.cuda.is_available():
        print("usage: variant_turns.py [--large] DIR [DIR ...] (needs a "
              "CUDA card)")
        return 2
    import chip_smoke as cs
    from parent_turns import load_other

    cs.phase_device()
    tops = {"tree": "repro_torch"}
    for d in argv:
        name = "variant_" + re.sub(r"\W", "_", Path(d).name)
        load_other(Path(d).resolve(), name)
        tops[Path(d).name] = name
    mods = {s: {m: importlib.import_module(f"{top}.{path}")
                for m, path in (("vu", "kernels.viterbi_unified"),
                                ("vf", "kernels.viterbi_fwd"),
                                ("tr", "core.trellis"),
                                ("build", "kernels.build"))}
            for s, top in tops.items()}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2 * len(mods)) as pool:
        list(pool.map(lambda a: mods[a[0]]["build"].build(a[1]),
                      [(s, src) for s in mods for src in SOURCES]))
    print(f"[variants] built {len(mods)} trees in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for s, m in mods.items():
        for src in SOURCES:
            lines = m["build"].build(src).log.splitlines()
            pat = (r"Function properties for \w*?(\w+_block_kernelILi\d+E)"
                   if large else r"Function properties for \w*?(\w+_cluster_"
                   r"kernelILi(8|16)ELb[01])")
            for i, ln in enumerate(lines[:-1]):
                hit = re.search(pat, ln)
                if hit:
                    print(f"[variants] {s} {hit.group(1)}: "
                          f"{lines[i + 1].strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    spec = cs.main_config("1/2", "kernel").spec
    kw = dict(v1=20, f=256, v2=45, f0=32, v2s=45, frames_per_tile=1,
              pack_survivors=True, radix=4)
    fkw = dict(frames_per_tile=1, pack_survivors=True, radix=4)
    tree = mods["tree"]
    if large:
        return _large(cs, mods, gen, spec, kw, fkw)
    for code in CODES:
        tr = {s: m["tr"].make_trellis(*code) for s, m in mods.items()}
        frames = cs._frames(tr["tree"], spec, 132, gen, torch.float32)
        want = tree["vu"].unified_decode_frames_cuda(
            frames, trellis=tr["tree"], _cluster=1, **kw)
        fns = {"wide B1": lambda: tree["vu"].unified_decode_frames_cuda(
            frames, trellis=tr["tree"], _cluster=1, **kw)}
        for s, m in mods.items():
            got = m["vu"].unified_decode_frames_cuda(frames, trellis=tr[s],
                                                     **kw)
            print(f"[variants] K={code[0]} {s} B1 equal to the wide mapping "
                  f"off a cluster: {bool(torch.equal(got, want))}",
                  flush=True)
            fns[f"{s} B1"] = (lambda m=m, s=s: m["vu"]
                              .unified_decode_frames_cuda(
                                  frames, trellis=tr[s], **kw))
        fns["wide B3"] = lambda: tree["vf"].forward_frames_cuda(
            frames, trellis=tr["tree"], _cluster=1, **fkw)
        for s, m in mods.items():
            fns[f"{s} B3"] = (lambda m=m, s=s: m["vf"].forward_frames_cuda(
                frames, trellis=tr[s], **fkw))
        ms = cs._interleaved(fns, 3, rounds=2)
        print(f"[variants] K={code[0]} F=132 ms per launch, in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        del frames
    return 0


def _large(cs, mods, gen, spec, kw, fkw) -> int:
    """The --large rows: every tree's B1 and B3 at each large code and
    frame count, equal to this tree's, in turns."""
    import torch
    tree = mods["tree"]
    for code in cs.CODES:
        if code[0] < cs.LARGE_K:
            continue
        for F in (cs.LARGE_TIME_FRAMES[code[0]], cs.LARGE_FULL_FRAMES):
            tr = {s: m["tr"].make_trellis(*code) for s, m in mods.items()}
            frames = cs._frames(tr["tree"], spec, F, gen, torch.float32)
            want = (tree["vu"].unified_decode_frames_cuda(
                        frames, trellis=tr["tree"], **kw),
                    tree["vf"].forward_frames_cuda(
                        frames, trellis=tr["tree"], **fkw))
            fns = {}
            for s, m in mods.items():
                got = (m["vu"].unified_decode_frames_cuda(
                           frames, trellis=tr[s], **kw),
                       m["vf"].forward_frames_cuda(
                           frames, trellis=tr[s], **fkw))
                same = torch.equal(got[0], want[0]) and all(
                    torch.equal(a, b) for a, b in zip(got[1], want[1]))
                print(f"[variants] K={code[0]} beta={len(code[1])} F={F} "
                      f"{s} B1 and B3 equal to this tree's: {same}",
                      flush=True)
                fns[f"{s} B1"] = (lambda m=m, s=s: m["vu"]
                                  .unified_decode_frames_cuda(
                                      frames, trellis=tr[s], **kw))
                fns[f"{s} B3"] = (lambda m=m, s=s: m["vf"]
                                  .forward_frames_cuda(
                                      frames, trellis=tr[s], **fkw))
            ms = cs._interleaved(fns, 3, rounds=2)
            print(f"[variants] K={code[0]} beta={len(code[1])} F={F} ms "
                  f"per launch, in turns: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
                  flush=True)
            del frames, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
