#!/usr/bin/env python3
"""Time variant trees' wide-mapping or large-code kernels against this
tree's, in turns, on one card.

    python3 tools/variant_turns.py [--large | --low-rate] DIR [DIR ...]

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
  printed as equal or not; B1 and B3 of every tree in turns;
* with ``--low-rate``, chip_smoke.py's low-rate rows of ``WIDE_TIME``
  (beta > 8 at k <= 15: K=7 beta=9 and 16, K=9 beta=10, K=11, 13, 15
  beta=9, at their frames), at 1056 frames K=12 and 14 beta=9, and at 4224
  K=5 beta=12 and K=8 beta=9: each tree's B1 and B3
  against this tree's (this tree's planned tiles), printed as equal or
  not; B1 and B3 of every tree and of this tree's wide mapping forced
  (``_wide``: the mapping these codes ran on before, its path metrics
  now in device memory), in turns.

Turns are a, b, ..., b, a over 2 rounds of 3 launches (CUDA events; the
minimum). Prints each tree's spill stores of the cluster kernels with 8
and 16 butterflies a thread (``--large``, ``--low-rate``: of every
one-block kernel; ``--low-rate`` also the SASS counts of the register
mapping's run-time-beta kernels at R = 2, 4, 8, from ``cuobjdump``).
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
    low_rate = "--low-rate" in argv
    argv = [a for a in argv if a not in ("--large", "--low-rate")]
    import torch
    if not argv or not torch.cuda.is_available():
        print("usage: variant_turns.py [--large | --low-rate] DIR [DIR ...] "
              "(needs a CUDA card)")
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
            pat = (r"Function properties for \w*?(\w+_block(_pe)?_kernel"
                   r"ILi\d+E)" if large or low_rate else
                   r"Function properties for \w*?(\w+_cluster_"
                   r"kernelILi(8|16)ELb[01])")
            for i, ln in enumerate(lines[:-1]):
                hit = re.search(pat, ln)
                if hit:
                    print(f"[variants] {s} {hit.group(1)}: "
                          f"{lines[i + 1].strip()}", flush=True)
    if low_rate:
        _sass_counts(mods)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    spec = cs.main_config("1/2", "kernel").spec
    kw = dict(v1=20, f=256, v2=45, f0=32, v2s=45, frames_per_tile=1,
              pack_survivors=True, radix=4)
    fkw = dict(frames_per_tile=1, pack_survivors=True, radix=4)
    tree = mods["tree"]
    if large:
        return _large(cs, mods, gen, spec, kw, fkw)
    if low_rate:
        return _low_rate(cs, mods, gen, spec, kw, fkw)
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


def _sass_counts(mods) -> None:
    """Each tree's register-mapping kernels at a run-time beta (R = 2, 4,
    8): their SASS instructions, and of them the divergence checks before
    a warp-collective (``BRA.DIV``, each the head of a slow path taken
    when the warp is not converged), the warp syncs and the convergence
    barriers (``cuobjdump -sass`` beside nvcc)."""
    import subprocess
    tool = Path(mods["tree"]["build"].nvcc_path()).parent / "cuobjdump"
    for s, m in mods.items():
        for src in SOURCES:
            out = subprocess.run([str(tool), "-sass",
                                  str(m["build"].build(src).path)],
                                 capture_output=True, text=True).stdout
            for blk in out.split("Function : ")[1:]:
                hit = re.search(r"(viterbi_\w+_kernel)ILi([248])ELi0E",
                                blk.split(None, 1)[0])
                if not hit:
                    continue
                ins = [ln for ln in blk.splitlines()
                       if re.match(r"\s*/\*[0-9a-f]+\*/", ln)]
                n = {op: sum(op in ln for ln in ins)
                     for op in ("BRA.DIV", "WARPSYNC", "BSYNC")}
                print(f"[variants] {s} {hit.group(1)}<{hit.group(2)}, 0> "
                      f"SASS: {len(ins)} instructions, {n['BRA.DIV']} "
                      f"BRA.DIV, {n['WARPSYNC']} WARPSYNC, {n['BSYNC']} "
                      f"BSYNC", flush=True)


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


def _low_rate(cs, mods, gen, spec, kw, fkw) -> int:
    """The --low-rate rows: every tree's B1 and B3 at each low-rate code
    and frame count, equal to this tree's, in turns with this tree's wide
    mapping forced."""
    import torch
    from repro_torch.kernels import autotune
    tree = mods["tree"]
    k14 = (14, (0o21645, 0o35661, 0o24567, 0o31235, 0o27771, 0o22223,
                0o36541, 0o20003, 0o33333))
    rows = [(code, F) for code, F in cs.WIDE_TIME if code[0] <= 15]
    k8 = (8, (0o247, 0o371, 0o275, 0o315, 0o223, 0o367, 0o301, 0o353,
              0o261))
    rows += [(cs.LOW_RATE_CODES[6], 1056), (k14, 1056),
             (cs.LOW_RATE_CODES[0], 4224), (k8, 4224)]
    for code, F in rows:
        tr = {s: m["tr"].make_trellis(*code) for s, m in mods.items()}
        tiles = [autotune.plan_tiles(tr["tree"], spec, pack_survivors=True,
                                     radix=4, unified=u, max_frames=F,
                                     device="cuda").frames_per_tile
                 for u in (True, False)]
        ukw = dict(kw, frames_per_tile=tiles[0])
        bkw = dict(fkw, frames_per_tile=tiles[1])
        frames = cs._frames(tr["tree"], spec, F, gen, torch.float32)
        want = (tree["vu"].unified_decode_frames_cuda(
                    frames, trellis=tr["tree"], **ukw),
                tree["vf"].forward_frames_cuda(
                    frames, trellis=tr["tree"], **bkw))
        fns = {"wide B1": lambda: tree["vu"].unified_decode_frames_cuda(
            frames, trellis=tr["tree"], _wide=True, **kw)}
        for s, m in mods.items():
            got = (m["vu"].unified_decode_frames_cuda(
                       frames, trellis=tr[s], **ukw),
                   m["vf"].forward_frames_cuda(
                       frames, trellis=tr[s], **bkw))
            same = torch.equal(got[0], want[0]) and all(
                torch.equal(a, b) for a, b in zip(got[1], want[1]))
            print(f"[variants] K={code[0]} beta={len(code[1])} F={F} "
                  f"{s} B1 and B3 equal to this tree's: {same}", flush=True)
            fns[f"{s} B1"] = (lambda m=m, s=s: m["vu"]
                              .unified_decode_frames_cuda(
                                  frames, trellis=tr[s], **ukw))
        fns["wide B3"] = lambda: tree["vf"].forward_frames_cuda(
            frames, trellis=tr["tree"], _wide=True, **fkw)
        for s, m in mods.items():
            fns[f"{s} B3"] = (lambda m=m, s=s: m["vf"].forward_frames_cuda(
                frames, trellis=tr[s], **bkw))
        ms = cs._interleaved(fns, 3, rounds=2)
        print(f"[variants] K={code[0]} beta={len(code[1])} F={F} tiles "
              f"{tiles} ms per launch, in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        del frames, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
