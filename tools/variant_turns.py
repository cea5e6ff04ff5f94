#!/usr/bin/env python3
"""Time variant trees' wide-mapping or large-code kernels against this
tree's, in turns, on one card.

    python3 tools/variant_turns.py [--large | --low-rate | --thread] DIR ...

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
  now in device memory), in turns;
* with ``--thread``, B1 at K=7 on the main shape (16384 frames) and at
  the K=7 cells' calls (parent_turns.py's ``K7_CELLS``): each tree's B1 at
  tiles 32 and 64 (a tree without the thread mapping takes its own planned
  tile), equal to this tree's warp mapping forced
  (``_warp``), which runs in the same turns; then this tree's thread
  mapping against its warp mapping at the other codes the thread mapping
  takes (``THREAD_OTHER``).

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
    thread = "--thread" in argv
    argv = [a for a in argv if a not in ("--large", "--low-rate",
                                         "--thread")]
    import torch
    if not argv or not torch.cuda.is_available():
        print("usage: variant_turns.py [--large | --low-rate | --thread] "
              "DIR [DIR ...] (needs a CUDA card)")
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
            pat = (r"Function properties for \w*?(\w+_thread_kernel"
                   r"ILi7ELi2E)" if thread else
                   r"Function properties for \w*?(\w+_block(_pe)?_kernel"
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
    if thread:
        return _thread(cs, mods, gen)
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


def _sass_size(m, kernel: str) -> int:
    """SASS instructions of one kernel of a tree's viterbi_unified.cu
    (``cuobjdump -sass``; -1 without the tool)."""
    import subprocess
    tool = Path(m["build"].nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return -1
    out = subprocess.run([str(tool), "-sass",
                          str(m["build"].build("viterbi_unified.cu").path)],
                         capture_output=True, text=True).stdout
    for blk in out.split("Function : ")[1:]:
        if kernel in blk.split(None, 1)[0]:
            return sum(1 for ln in blk.splitlines()
                       if re.match(r"\s*/\*[0-9a-f]+\*/", ln))
    return -1


def _thread(cs, mods, gen) -> int:
    """The --thread rows: every tree's B1 at K=7 on the main shape and at
    the K=7 cells' calls, per tile, equal to this tree's warp mapping
    forced, all in turns."""
    import torch
    from parent_turns import K7_CELLS
    from repro_torch.core.framed import FrameSpec
    tree = mods["tree"]
    rows = ((("main", (7, (0o171, 0o133)), 16384,
              dict(v1=20, f=256, v2=45, f0=32, v2s=45)),) + K7_CELLS)
    for label, code, F, geometry in rows:
        spec = FrameSpec(start="boundary", **geometry)
        tr = {s: m["tr"].make_trellis(*code) for s, m in mods.items()}
        frames = cs._frames(tr["tree"], spec, F, gen, torch.float32)
        kw = dict(geometry, pack_survivors=True, radix=4)
        want = tree["vu"].unified_decode_frames_cuda(
            frames, trellis=tr["tree"], frames_per_tile=2, _warp=True, **kw)
        fns = {"warp": lambda: tree["vu"].unified_decode_frames_cuda(
            frames, trellis=tr["tree"], frames_per_tile=2, _warp=True,
            **kw)}
        for s, m in mods.items():
            b1 = m["vu"].unified_decode_frames_cuda
            if "mapping_launches" not in vars(b1):
                fns[s] = (lambda m=m, s=s: m["vu"].unified_decode_frames_cuda(
                    frames, trellis=tr[s], frames_per_tile=2, **kw))
                continue
            for ft in (32, 64):
                if F % ft:
                    continue
                fns[f"{s} {ft}"] = (
                    lambda m=m, s=s, ft=ft: m["vu"].unified_decode_frames_cuda(
                        frames, trellis=tr[s], frames_per_tile=ft, **kw))
        if label == "main":
            import ctypes
            for s, m in mods.items():
                lib = m["vu"].kernel_library().lib
                if hasattr(lib, "viterbi_unified_thread_attrs"):
                    out = (ctypes.c_int * 3)()
                    lib.viterbi_unified_thread_attrs(7, 2, out)
                    print(f"[variants] {s} thread kernel K=7 beta=2: "
                          f"{out[0]} registers, {out[1]} local bytes, "
                          f"{_sass_size(m, 'thread_kernelILi7ELi2E')} SASS "
                          f"instructions", flush=True)
        for name, fn in fns.items():
            print(f"[variants] K=7 {label} F={F} {name} equal to the warp "
                  f"mapping: {bool(torch.equal(fn(), want))}", flush=True)
        ms = cs._interleaved(fns, 5, rounds=2)
        print(f"[variants] K=7 {label} F={F} ms per launch, in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        del frames, want
    _thread_codes(cs, tree, gen)
    return 0


#: The other codes the thread mapping takes: (code, frames).
THREAD_OTHER = [((3, (0o7, 0o5)), 65536), ((4, (0o13, 0o15, 0o17)), 65536),
                ((5, (0o23, 0o35)), 65536), ((6, (0o65, 0o57)), 65536),
                ((7, (0o171, 0o133, 0o165)), 65536),
                ((5, (0o23, 0o35, 0o25)), 65536), ((6, (0o65, 0o57)), 16384)]


def _thread_codes(cs, tree, gen) -> None:
    """This tree's B1 on the thread mapping (its planned tile) against its
    warp mapping (``_warp``, two warps of frames a block) at the other
    codes the thread mapping takes, main frame, in turns."""
    import torch
    from repro_torch.core.framed import FrameSpec
    from repro_torch.kernels import autotune
    geometry = dict(v1=20, f=256, v2=45, f0=32, v2s=45)
    spec = FrameSpec(**geometry)
    for code, F in THREAD_OTHER:
        tr = tree["tr"].make_trellis(*code)
        frames = cs._frames(tr, spec, F, gen, torch.float32)
        kw = dict(geometry, trellis=tr, pack_survivors=True, radix=4)
        ft = autotune.plan_tiles(tr, spec, pack_survivors=True, radix=4,
                                 max_frames=F, device="cuda").frames_per_tile
        wt = autotune.max_frames_per_block(tr, warp=True) // 4
        fns = {f"thread {ft}": lambda: tree["vu"].unified_decode_frames_cuda(
                   frames, frames_per_tile=ft, **kw),
               f"warp {wt}": lambda: tree["vu"].unified_decode_frames_cuda(
                   frames, frames_per_tile=wt, _warp=True, **kw)}
        outs = [fn() for fn in fns.values()]
        ms = cs._interleaved(fns, 5, rounds=2)
        print(f"[variants] K={code[0]} beta={len(code[1])} F={F}: equal "
              f"{bool(torch.equal(*outs))}; ms per launch, in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        del frames, outs


if __name__ == "__main__":
    sys.exit(main())
