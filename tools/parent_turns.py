#!/usr/bin/env python3
"""Time this tree's CUDA kernels against another checkout's, in turns, on
one card.

    python3 tools/parent_turns.py --parent DIR [--json PATH]

DIR is an unpacked checkout of the commit to compare with (for example
``git archive <parent> | tar -x -C DIR``). Its ``src/repro_torch`` is
imported under another name, so each side launches its kernels through
its own wrappers and builds its own sources with its own flags (into its
own ``build/kernels``); the two sides share only the inputs. Then:

* B1 (``unified_decode_frames_cuda``) and B3 (``forward_frames_cuda``) at
  the main path's shape (K=7, F=16384, L=321, packed, radix 4; B1 at each
  side's planned tile, B3 at this tree's), and B1 at the K=7 cells' calls
  (``K7_CELLS``: k7_r12_batch's 65,536 frames of the (171, 133) code,
  k7_r34_batch's 66,624 rows of the (133, 171) code in its frame), each
  side at its own planned tile;
* the split traceback (``traceback_frames_cuda``) at chip_smoke.py's
  ``TB_CASES``, on this tree's forward streams;
* B1 and B3 at chip_smoke.py's ``WIDE_TIME`` rows (K=16, 17, 18, 19 at
  132 frames on the wide mapping; the low rates K=7 beta=9 and 16 and
  K=9 beta=10 at 4224, K=11 beta=9 at 1056, K=13 beta=9 at 264, K=15 beta=9 at 132;
  main frame, packed, radix 4, this tree's planned tiles), each side
  planning its own mapping (since the cluster mapping, a thread-block
  cluster a frame at 16 <= k <= 19; since the run-time-beta forms, the
  register mapping and the one-block form past beta = 8 at k <= 15);
* B1 and B3 at chip_smoke.py's large codes (K=12, 13, 14, 15 and K=12
  beta=8; main frame, packed, radix 4) at their ``LARGE_TIME_FRAMES`` and
  at ``LARGE_FULL_FRAMES``, each side planning its own mapping (since the
  one-block form of the cluster mapping at 12 <= k <= 15);
* in this tree alone, B1 and B3 at K=11 (``TB_K11_FRAMES`` frames) on the
  register mapping ("other") and forced on the one-block form ("tree");
  and B1 at the large codes and frame counts where the planner keeps its
  survivors on chip (``autotune.block_survivors_on_chip``: K=12 at 132 and
  264 frames, K=13 at 132, K=12 beta=8 at 264) with them there ("tree")
  and in the device-memory scratch ("other").

Each pair runs in turns (other, tree, tree, other, ... over 4 rounds;
CUDA events; the minimum per side) and must give equal outputs. Prints one
line per kernel and shape and writes the numbers as JSON to ``--json``
(default ``build/parent_turns.json``). Needs a card, nvcc and the
other checkout; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCES = ("viterbi_unified.cu", "viterbi_fwd.cu", "traceback_frames.cu")
OTHER = "other_repro_torch"
#: B1 at the K=7 cells' calls: (cell, code, frames, frame geometry).
K7_CELLS = (("k7_r12_batch", (7, (0o171, 0o133)), 65536,
             dict(v1=20, f=256, v2=45, f0=32, v2s=45)),
            ("k7_r34_batch", (7, (0o133, 0o171)), 66624,
             dict(v1=21, f=252, v2=45, f0=42, v2s=45)))


def load_other(parent: Path, name: str = OTHER) -> None:
    """Import the other checkout's ``repro_torch`` as ``name``: its
    modules' relative imports stay inside that tree."""
    pkg = parent / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)


def side(top: str):
    """The modules one side launches through."""
    def m(name):
        return importlib.import_module(f"{top}.{name}")
    return dict(trellis=m("core.trellis"), build=m("kernels.build"),
                autotune=m("kernels.autotune"),
                vu=m("kernels.viterbi_unified"), vf=m("kernels.viterbi_fwd"),
                tbf=m("kernels.traceback_frames"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--json", type=Path,
                    default=ROOT / "build" / "parent_turns.json")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    import chip_smoke as cs
    from repro_torch.core.framed import FrameSpec
    from repro_torch.kernels import autotune

    cs.phase_device()
    load_other(args.parent.resolve())
    sides = {"other": side(OTHER), "tree": side("repro_torch")}
    with concurrent.futures.ThreadPoolExecutor(2 * len(SOURCES)) as pool:
        list(pool.map(lambda a: a[0]["build"].build(a[1]),
                      [(s, src) for s in sides.values() for src in SOURCES]))
    mine = sides["tree"]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    spec = cs.main_config("1/2", "kernel").spec
    k7 = mine["trellis"].make_trellis(*cs.CODES[4])
    frames = cs._frames(k7, spec, 16384, gen, torch.float32)
    rows = []

    def record(kernel, shape, ms, reps):
        rows.append({"kernel": kernel, "shape": shape,
                     "other_ms": ms["other"], "tree_ms": ms["tree"],
                     "tree_over_other": ms["tree"] / ms["other"]})
        print(f"[turns] {kernel} {shape}: other {ms['other'] * 1e3:.1f} us, "
              f"tree {ms['tree'] * 1e3:.1f} us "
              f"({ms['tree'] / ms['other'] - 1:+.2%}; min of 4 rounds of "
              f"{reps}, in turns)", flush=True)

    def compare(kernel, shape, fns, reps):
        outs = {s: fn() for s, fn in fns.items()}
        a, b = outs["other"], outs["tree"]
        same = (all(torch.equal(x, y) for x, y in zip(a, b))
                if isinstance(a, tuple) else torch.equal(a, b))
        if not same:
            raise AssertionError(f"{kernel} {shape}: the two trees disagree")
        record(kernel, shape, cs._interleaved(fns, reps, rounds=4), reps)

    # B1 and B3 at the main shape, each side through its own wrappers
    ut, st = (autotune.plan_tiles(k7, spec, pack_survivors=True, radix=4,
                                  unified=u, max_frames=16384,
                                  device="cuda").frames_per_tile
              for u in (True, False))
    tr = {s: d["trellis"].make_trellis(*cs.CODES[4])
          for s, d in sides.items()}

    def b1_turns(fr, code, F, geometry, label, reps):
        """B1 of both sides on ``fr``, each at its own planned tile."""
        t = {s: d["trellis"].make_trellis(*code) for s, d in sides.items()}
        fs = FrameSpec(start="boundary", **geometry)
        tiles = {s: d["autotune"].plan_tiles(
            t[s], fs, pack_survivors=True, radix=4, max_frames=F,
            device="cuda").frames_per_tile for s, d in sides.items()}
        compare("viterbi_unified", f"{label} tiles other {tiles['other']} "
                f"tree {tiles['tree']}", {
                    s: (lambda s=s: sides[s]["vu"].unified_decode_frames_cuda(
                        fr, trellis=t[s], frames_per_tile=tiles[s],
                        pack_survivors=True, radix=4, **geometry))
                    for s in sides}, reps)

    b1_turns(frames, cs.CODES[4], 16384,
             dict(v1=20, f=256, v2=45, f0=32, v2s=45), "K=7 F=16384",
             args.reps)
    for cell, code, F, geometry in K7_CELLS:
        fs = FrameSpec(start="boundary", **geometry)
        cf = cs._frames(mine["trellis"].make_trellis(*code), fs, F, gen,
                        torch.float32)
        b1_turns(cf, code, F, geometry, f"K=7 {cell} F={F}",
                 max(1, args.reps // 4))
        del cf
    compare("viterbi_fwd", f"K=7 F=16384 tile {st}", {
        s: (lambda s=s: sides[s]["vf"].forward_frames_cuda(
            frames, trellis=tr[s], frames_per_tile=st, pack_survivors=True,
            radix=4))
        for s in sides}, args.reps)

    # the split traceback at chip_smoke.py's shapes
    k11 = cs.CODES[6]
    frames11 = cs._frames(mine["trellis"].make_trellis(*k11), spec,
                          cs.TB_K11_FRAMES, gen, torch.float32)
    reps = max(1, args.reps // 2)
    for label, code, layout, pack, f0 in cs.TB_CASES:
        fr, tile = (frames, st) if code == cs.CODES[4] else (frames11, 1)
        tr = {s: d["trellis"].make_trellis(*code) for s, d in sides.items()}
        sel, amax = mine["vf"].forward_frames_cuda(
            fr, trellis=tr["tree"], frames_per_tile=tile,
            pack_survivors=pack, radix=4, layout=layout)
        compare("traceback_frames", f"{label} F={fr.shape[0]}", {
            s: (lambda s=s: sides[s]["tbf"].traceback_frames_cuda(
                sel, amax, trellis=tr[s], v1=20, f=256, f0=f0, v2s=45,
                packed=pack, layout=layout))
            for s in sides}, reps)
        del sel, amax
    del frames, frames11

    # B1 and B3 on the wide mapping, each side through its own planner
    wkw = dict(v1=20, f=256, v2=45, f0=32, v2s=45, frames_per_tile=1,
               pack_survivors=True, radix=4)
    for code, F in cs.WIDE_TIME:
        tr = {s: d["trellis"].make_trellis(*code) for s, d in sides.items()}
        wf = cs._frames(tr["tree"], spec, F, gen, torch.float32)
        shape = f"K={code[0]} beta={len(code[1])} F={F}"
        ut, st = (autotune.plan_tiles(tr["tree"], spec, pack_survivors=True,
                                      radix=4, unified=u, max_frames=F,
                                      device="cuda").frames_per_tile
                  for u in (True, False))
        compare("viterbi_unified", shape, {
            s: (lambda s=s: sides[s]["vu"].unified_decode_frames_cuda(
                wf, trellis=tr[s], **dict(wkw, frames_per_tile=ut)))
            for s in sides}, 3)
        compare("viterbi_fwd", shape, {
            s: (lambda s=s: sides[s]["vf"].forward_frames_cuda(
                wf, trellis=tr[s], frames_per_tile=st, pack_survivors=True,
                radix=4))
            for s in sides}, 3)
        del wf

    # B1 and B3 at the large codes, each side through its own planner
    for code in cs.CODES:
        if code[0] < cs.LARGE_K:
            continue
        tr = {s: d["trellis"].make_trellis(*code) for s, d in sides.items()}
        for F in sorted({cs.LARGE_TIME_FRAMES[code[0]],
                         cs.LARGE_FULL_FRAMES}):
            lf = cs._frames(tr["tree"], spec, F, gen, torch.float32)
            shape = f"K={code[0]} beta={len(code[1])} F={F}"
            compare("viterbi_unified", shape, {
                s: (lambda s=s: sides[s]["vu"].unified_decode_frames_cuda(
                    lf, trellis=tr[s], **wkw))
                for s in sides}, 3)
            compare("viterbi_fwd", shape, {
                s: (lambda s=s: sides[s]["vf"].forward_frames_cuda(
                    lf, trellis=tr[s], frames_per_tile=1,
                    pack_survivors=True, radix=4))
                for s in sides}, 3)
            del lf

    # K=11: the register mapping ("other") against the one-block form
    # forced ("tree"), both this tree's
    t11 = mine["trellis"].make_trellis(*k11)
    f11 = cs._frames(t11, spec, cs.TB_K11_FRAMES, gen, torch.float32)
    u11, s11 = (autotune.plan_tiles(t11, spec, pack_survivors=True, radix=4,
                                    unified=u, max_frames=cs.TB_K11_FRAMES,
                                    device="cuda").frames_per_tile
                for u in (True, False))
    vu, vf = mine["vu"], mine["vf"]
    for name, fn in (("viterbi_unified", lambda **o: vu
                      .unified_decode_frames_cuda(
                          f11, trellis=t11, **dict(wkw, frames_per_tile=u11),
                          **o)),
                     ("viterbi_fwd", lambda **o: vf.forward_frames_cuda(
                         f11, trellis=t11, frames_per_tile=s11,
                         pack_survivors=True, radix=4, **o))):
        compare(name, f"K=11 F={cs.TB_K11_FRAMES} register (other) vs "
                f"one-block forced (tree)",
                {"other": fn, "tree": lambda fn=fn: fn(_block=True)}, 3)
    del f11

    # B1's survivors on chip ("tree", the planner's choice) against the
    # scratch ("other"), where the planner keeps them on chip
    rule = vu.block_survivors_on_chip

    def scratch(fn):
        vu.block_survivors_on_chip = lambda *a, **k: False
        try:
            return fn()
        finally:
            vu.block_survivors_on_chip = rule

    for code, F in ((cs.CODES[7], 132), (cs.CODES[7], 264),
                    (cs.CODES[8], 132), (cs.CODES[11], 264)):
        tl = mine["trellis"].make_trellis(*code)
        if not rule(tl, spec, pack_survivors=True, frames=F, device="cuda"):
            raise AssertionError(f"K={tl.k} F={F}: the planner keeps B1's "
                                 f"survivors off chip")
        lf = cs._frames(tl, spec, F, gen, torch.float32)

        def b1(lf=lf, tl=tl):
            return vu.unified_decode_frames_cuda(lf, trellis=tl, **wkw)

        compare("viterbi_unified", f"K={tl.k} beta={tl.beta} F={F} survivors "
                f"in the scratch (other) vs on chip (tree)",
                {"other": lambda b1=b1: scratch(b1), "tree": b1}, 5)
        del lf
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
