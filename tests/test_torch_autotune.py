"""The port's tile planner and tune DB (kernels/autotune.py,
kernels/tunedb.py), on the CPU.

Mirrors tests/test_autotune.py and tests/test_tunedb.py test for test.
The TPU-specific cases (Mosaic lane padding, the sublane layout's doubled
tiles) become their Hopper counterparts: the shared-memory model is the
kernels' own carve-up, packing keeps its ratio in both layouts, and the
packed plan holds more resident frames per SM. On the CPU the planner
plans for the H100 (``H100_LIMITS``, and the main path's registers
recorded from the card, ``H100_REGISTERS``) and ``measure=True`` times the
plain versions
with the host clock. Also: a tune DB written by the JAX package
loads here and keeps its rows, and ``DecodePlan.cache_key()`` is the JAX
package's tuple for the same knobs.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.framed import FrameSpec, frame_llr
from repro_torch.core.trellis import STD_K7, make_trellis
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels.autotune import (H100_BLOCKS, H100_LIMITS,
                                          H100_REGISTERS,
                                          candidate_tiles, measure_plan,
                                          plan_decode, plan_tiles,
                                          split_smem_bytes,
                                          unified_smem_bytes)
from repro_torch.kernels.packing import Layout
from repro_torch.kernels.tunedb import (SCHEMA, TuneDB, TuneDBWarning,
                                        default_path, platform_id,
                                        platform_key)
from repro_torch.obs.tracer import Tracer, set_tracer

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
SPEC = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
CPU = dict(device="cpu")
K9 = make_trellis(9, (0o753, 0o561))
#: K=7 at rate 1/4: past the thread mapping's beta (autotune.THREAD_MAX_BETA),
#: so B1 keeps the warp mapping, whose model the K=7 cases below held
#: before the thread mapping took the rate-1/2 code (same states, same
#: registers on the CPU, no LLR staging at beta <= 8).
K7_WARP = make_trellis(7, (0o171, 0o133, 0o165, 0o117))
#: K=5 at rate 1/4 on the warp mapping, likewise (two frames a warp).
K5_WARP = make_trellis(5, (0o23, 0o35, 0o25, 0o37))


def _reg_warps(kernel):
    """Warps an SM's 64 K registers hold for one kernel (allocated per
    warp in units of 256), at the registers the CPU plans with."""
    return 65536 // (-(-H100_REGISTERS[kernel] * 32 // 256) * 256)


#: One warp's two LLR chunks at rate 1/2 on the thread mapping: 32 rows of
#: eight stages of two float32 and two words.
_LLR_CHUNKS = 2 * 32 * (8 * 2 + 2) * 4


def _thread_resident(trellis, spec, ft):
    """Frames of B1's thread mapping resident an SM at tile ``ft`` (one
    thread a frame): blocks limited by threads, block slots, shared memory
    (the ring, with the runtime's 1 KB a block) and registers (a block of
    fewer than 32 threads still takes a warp's)."""
    ring = unified_smem_bytes(trellis, spec, ft)[0]
    warps = -(-ft // 32)
    return ft * min(2048 // (32 * warps), 32, 233472 // (ring + 1024),
                    _reg_warps("unified_thread") // warps)


# ---- tests/test_autotune.py ------------------------------------------------

def test_footprint_matches_kernel_scratch():
    """The warp mapping's sel term is the kernel's survivor carve-up: one
    byte per state unpacked, one bit packed (8x less at S=64); the rest is
    knob-independent. The thread mapping (K=7 rate 1/2) keeps a ring of
    LANE words whatever pack says."""
    L, FT, S = SPEC.frame_len, 4, K7_WARP.num_states
    ring = unified_smem_bytes(STD_K7, SPEC, FT)
    assert ring == unified_smem_bytes(STD_K7, SPEC, FT, pack_survivors=True)
    assert dict(ring[1]) == {"survivor_ring": FT * 77 * 2 * 4,
                             "llr_chunks": _LLR_CHUNKS}
    _, plain = unified_smem_bytes(K7_WARP, SPEC, FT)
    _, packed = unified_smem_bytes(K7_WARP, SPEC, FT, pack_survivors=True)
    d_plain, d_packed = dict(plain), dict(packed)
    assert d_plain["sel_survivors"] == L * FT * S
    assert d_packed["sel_survivors"] == L * FT * (S // 32) * 4
    assert d_plain["sel_survivors"] == 8 * d_packed["sel_survivors"]
    for k in d_plain:
        if k != "sel_survivors":
            assert d_plain[k] == d_packed[k]


def test_footprint_scales_linearly_in_ft():
    """The unified block's shared memory grows with its frames (on the
    thread mapping its ring does, beside a warp's LLR chunks), the
    forward block's with its warps (one 256-byte run buffer each)."""
    t2, _ = unified_smem_bytes(K7_WARP, SPEC, 2)
    t8, _ = unified_smem_bytes(K7_WARP, SPEC, 8)
    assert t8 == 4 * t2
    r2 = dict(unified_smem_bytes(STD_K7, SPEC, 2)[1])
    r8 = dict(unified_smem_bytes(STD_K7, SPEC, 8)[1])
    assert r8["survivor_ring"] == 4 * r2["survivor_ring"]
    assert r8["llr_chunks"] == r2["llr_chunks"] == _LLR_CHUNKS
    s2, _ = split_smem_bytes(STD_K7, SPEC, 2)
    s8, _ = split_smem_bytes(STD_K7, SPEC, 8)
    assert s8 == 4 * s2 == 8 * 256


def test_packed_plan_is_deeper():
    """On Hopper the packed plan holds more resident frames per SM (the
    unpacked survivors fill the SM's shared memory first; the packed ones
    leave the registers to bound it)."""
    plain = plan_tiles(K7_WARP, SPEC, **CPU)
    packed = plan_tiles(K7_WARP, SPEC, pack_survivors=True, **CPU)
    assert plain.frames_per_sm == 10          # 233472 // (20576 + 1024)
    # one warp a frame; 48 registers a thread: 65536 // 1536 = 42 warps,
    # so tile 1 stops at the 32 block slots, tile 2 takes 21 blocks of 2,
    # tiles 4 and 8 only 40 frames
    assert _reg_warps("unified") == 42
    assert packed.frames_per_tile == 2 and packed.frames_per_sm == 42
    assert packed.registers == H100_REGISTERS["unified"] == 48
    assert packed.frames_per_sm > plain.frames_per_sm
    assert packed.fits and packed.budget == H100_LIMITS.smem_per_block
    # the thread mapping (K=7 rate 1/2): pack changes nothing; a warp of
    # frames a block, its ring (19,712 B) and LLR chunks (4,608 B) in
    # shared memory, as many blocks as those and the registers allow
    t_plain = plan_tiles(STD_K7, SPEC, **CPU)
    t_packed = plan_tiles(STD_K7, SPEC, pack_survivors=True, **CPU)
    assert t_plain == t_packed
    assert t_packed.frames_per_tile == 32
    assert t_packed.smem_bytes == 32 * 77 * 2 * 4 + _LLR_CHUNKS == 24320
    assert t_packed.registers == H100_REGISTERS["unified_thread"]
    assert t_packed.frames_per_sm == _thread_resident(STD_K7, SPEC, 32) \
        == 32 * min(233472 // (24320 + 1024), _reg_warps("unified_thread"))


def test_plan_search_runs_once_per_shape(monkeypatch):
    """plan_tiles weighs the tiles once per shape and card: a second call
    returns the first call's plan without weighing a tile; a changed
    input (the budget, the kernel's registers) weighs them again."""
    weighed = []
    tile_at = autotune._tile_at
    monkeypatch.setattr(autotune, "_tile_at",
                        lambda *a, **k: weighed.append(1) or tile_at(*a, **k))
    autotune._best_tile.cache_clear()
    p = plan_tiles(STD_K7, SPEC, max_frames=65536, **CPU)
    n = len(weighed)
    assert n == len(candidate_tiles(STD_K7, 65536))
    assert plan_tiles(STD_K7, SPEC, max_frames=65536, **CPU) is p
    assert len(weighed) == n
    plan_tiles(STD_K7, SPEC, max_frames=65536, smem_budget=50000, **CPU)
    assert len(weighed) > n
    n = len(weighed)
    monkeypatch.setitem(H100_REGISTERS, "unified_thread", 255)
    q = plan_tiles(STD_K7, SPEC, max_frames=65536, **CPU)
    assert len(weighed) > n and q.registers == 255
    assert q.frames_per_sm < p.frames_per_sm


def test_plan_respects_budget_and_floor():
    # a tiny budget still yields the smallest candidate (kernel must run)
    p = plan_tiles(K7_WARP, SPEC, smem_budget=1, **CPU)
    assert p.frames_per_tile == 1 and not p.fits and p.frames_per_sm == 0
    # whatever the budget, the tile stops at the thread cap
    p = plan_tiles(K7_WARP, SPEC, pack_survivors=True, smem_budget=1 << 30,
                   **CPU)
    assert p.frames_per_tile <= autotune.max_frames_per_block(K7_WARP) == 8
    assert 0 < p.utilization() < 1
    # the thread mapping under a budget of a warp's LLR chunks and four
    # frames' rings: the tile stops at four frames; under one short of a
    # single frame's ring the smallest tile, which does not fit (B1's
    # wrapper then runs the warp mapping and its scratch); its cap is 256
    ring = 77 * 2 * 4                          # f0 + v2s stages, 2 words
    p = plan_tiles(STD_K7, SPEC, smem_budget=_LLR_CHUNKS + 4 * ring, **CPU)
    assert p.fits and p.frames_per_tile == 4 and p.frames_per_sm > 0
    assert dict(p.breakdown) == {"survivor_ring": 4 * ring,
                                 "llr_chunks": _LLR_CHUNKS}
    p = plan_tiles(STD_K7, SPEC, smem_budget=_LLR_CHUNKS + ring - 16, **CPU)
    assert p.frames_per_tile == 1 and not p.fits and p.frames_per_sm == 0
    p = plan_tiles(STD_K7, SPEC, smem_budget=1, **CPU)
    assert p.frames_per_tile == 1 and not p.fits and p.frames_per_sm == 0
    p = plan_tiles(STD_K7, SPEC, smem_budget=1 << 30, **CPU)
    assert p.frames_per_tile <= autotune.max_frames_per_block(STD_K7) == 256


def test_plan_caps_at_stream_length():
    """K=5 on the warp mapping (two frames a warp) needs blocks of more
    than one frame to fill the SM beyond its 32 block slots; one frame
    caps the tile at 1. K=5 rate 1/2 takes the thread mapping only where
    the frames fill the card: one frame is planned on the warp mapping,
    like the rate-1/4 code; with no frame count, the thread mapping."""
    t5 = make_trellis(5, (0o23, 0o35))
    p = plan_tiles(t5, SPEC, pack_survivors=True, max_frames=1, **CPU)
    assert p.frames_per_tile == 1 and p.frames_per_sm == 32
    assert p.registers == H100_REGISTERS["unified"]
    p = plan_tiles(t5, SPEC, pack_survivors=True, **CPU)
    best = max(_thread_resident(t5, SPEC, ft) for ft in candidate_tiles(t5))
    assert p.frames_per_sm == best
    assert p.frames_per_tile == min(ft for ft in candidate_tiles(t5)
                                    if _thread_resident(t5, SPEC, ft) == best)
    k5 = K5_WARP
    p = plan_tiles(k5, SPEC, pack_survivors=True, **CPU)
    # 42 warps of registers (48 a thread) hold 84 frames: tile 2 (one
    # warp) stops at 32 blocks = 64 frames, tile 4 (two warps) takes
    # 21 blocks = 84, tiles 8 and 16 only 10 x 8 and 5 x 16 = 80
    assert p.frames_per_tile == 4 and p.frames_per_sm == 84
    p = plan_tiles(k5, SPEC, pack_survivors=True, max_frames=1, **CPU)
    assert p.frames_per_tile == 1 and p.frames_per_sm == 32
    assert candidate_tiles(k5, max_frames=5) == [1, 2, 4, 8]


def test_plan_scales_with_state_count():
    """K=9 (S=256) frames take 4x the packed survivors: fewer resident
    frames, bounded by shared memory before registers (on the CPU every
    code plans with the main path's registers)."""
    p7 = plan_tiles(STD_K7, SPEC, pack_survivors=True, **CPU)
    p9 = plan_tiles(K9, SPEC, pack_survivors=True, **CPU)
    assert p9.frames_per_sm < p7.frames_per_sm
    assert p9.smem_bytes == 32 + SPEC.frame_len * 32   # starts + 8 words
    by_smem = 233472 // (10304 + 1024)                  # 20 one-frame blocks
    assert p9.frames_per_tile == 1 and p9.fits
    assert p9.frames_per_sm == by_smem < _reg_warps("unified")


def test_smem_model_is_the_kernel_carve_up():
    """Hopper counterpart of test_mosaic_padding_model: the model is the
    kernels' own arithmetic (csrc/*.cu smem_layout / fwd_smem), term by
    term; tests/test_torch_gpu.py holds it to the compiled kernels."""
    L, FT = SPEC.frame_len, 3
    _, bd = unified_smem_bytes(K7_WARP, SPEC, FT, pack_survivors=True)
    assert dict(bd) == {"traceback_starts": 96,   # 3 x 8 int32, 16-aligned
                        "sel_survivors": FT * L * 2 * 4}
    fixed = dataclasses.replace(SPEC, start="fixed")
    assert dict(unified_smem_bytes(K7_WARP, fixed, FT)[1])[
        "traceback_starts"] == 0
    serial = FrameSpec(f=256, v1=20, v2=45)        # one subframe per frame
    assert dict(unified_smem_bytes(K7_WARP, serial, FT)[1])[
        "traceback_starts"] == 16                  # 3 x 1 int32, padded
    w4 = make_trellis(4, (0o13, 0o15, 0o17, 0o11))  # S=8: one padded word
    _, bd = unified_smem_bytes(w4, SPEC, FT, pack_survivors=True)
    assert dict(bd)["sel_survivors"] == FT * L * 4
    # the thread mapping's ring: a start's f0 + v2s stages (77), padded
    # to 16 bytes, then a warp's two LLR chunks; the starts stay in
    # registers, so a fixed start changes nothing; serial: f + v2 stages
    assert dict(unified_smem_bytes(STD_K7, SPEC, FT)[1]) == {
        "survivor_ring": -(-FT * 77 * 2 * 4 // 16) * 16,
        "llr_chunks": _LLR_CHUNKS}
    assert unified_smem_bytes(STD_K7, fixed, FT) == \
        unified_smem_bytes(STD_K7, SPEC, FT)
    assert dict(unified_smem_bytes(STD_K7, serial, FT)[1]) == {
        "survivor_ring": -(-FT * 301 * 2 * 4 // 16) * 16,
        "llr_chunks": _LLR_CHUNKS}
    k4 = make_trellis(4, (0o13, 0o15, 0o17))       # S=8: one padded word
    assert dict(unified_smem_bytes(k4, SPEC, FT, pack_survivors=True)[1]) \
        == {"survivor_ring": -(-FT * 77 * 4 // 16) * 16,
            "llr_chunks": 2 * 32 * (8 * 3 + 2) * 4}
    _, bd = split_smem_bytes(K9, SPEC, FT)          # a warp per frame
    assert dict(bd) == {"run_buffers": FT * 256}
    _, bd = split_smem_bytes(k4, SPEC, FT)          # 4 frames a warp
    assert dict(bd) == {"run_buffers": 256}


def test_lane_packing_evaporates_under_mosaic():
    """Hopper counterpart: nothing pads a lane on Hopper, so packing keeps
    its full ratio (one bit for a byte) in both layouts, and the layout
    changes no shared memory."""
    for layout in ("lane", "sublane"):
        _, p = unified_smem_bytes(K7_WARP, SPEC, 4, pack_survivors=True,
                                  layout=layout)
        _, u = unified_smem_bytes(K7_WARP, SPEC, 4, layout=layout)
        assert dict(u)["sel_survivors"] == 8 * dict(p)["sel_survivors"]
    for code in (K7_WARP, STD_K7):
        assert unified_smem_bytes(code, SPEC, 4, layout="lane") == \
            unified_smem_bytes(code, SPEC, 4, layout="sublane")


def test_sublane_plan_doubles_frames_at_equal_budget():
    """Hopper counterpart: at the same budget the packed plan keeps over
    2x (3.2x) the resident frames per SM of the unpacked one, in both
    layouts (on the TPU it was the sublane layout that kept packing's
    compression)."""
    for layout in ("lane", "sublane"):
        packed = plan_tiles(K7_WARP, SPEC, pack_survivors=True, radix=4,
                            layout=layout, **CPU)
        plain = plan_tiles(K7_WARP, SPEC, radix=4, layout=layout, **CPU)
        assert packed.fits and packed.frames_per_sm >= 2 * plain.frames_per_sm
        # the thread mapping keeps LANE words either way
        assert plan_tiles(STD_K7, SPEC, pack_survivors=True, radix=4,
                          layout=layout, **CPU) == plan_tiles(
            STD_K7, SPEC, radix=4, layout=layout, **CPU)


def test_split_model_is_smaller_and_plans_deeper():
    """plan_tiles(unified=False) budgets the forward kernel (no survivor
    scratch): smaller at every tile, more resident frames than unpacked
    unified survivors, and it fits a budget one unified frame exceeds."""
    for ft in (1, 4, 8):
        u, _ = unified_smem_bytes(K7_WARP, SPEC, ft, pack_survivors=True)
        s, bd = split_smem_bytes(K7_WARP, SPEC, ft, pack_survivors=True)
        assert s < u
        assert {n for n, _ in bd} == {"run_buffers"}
        # B3 keeps the warp mapping at K=7 rate 1/2
        assert split_smem_bytes(STD_K7, SPEC, ft) == \
            split_smem_bytes(K7_WARP, SPEC, ft)
    pu = plan_tiles(K7_WARP, SPEC, **CPU)
    ps = plan_tiles(K7_WARP, SPEC, unified=False, **CPU)
    assert ps.kernel == "split" and pu.kernel == "unified"
    assert ps.frames_per_sm > pu.frames_per_sm
    budget = 2048           # under one packed unified frame (2584 B)
    pu = plan_tiles(K7_WARP, SPEC, pack_survivors=True, smem_budget=budget,
                    **CPU)
    ps = plan_tiles(K7_WARP, SPEC, pack_survivors=True, smem_budget=budget,
                    unified=False, **CPU)
    assert not pu.fits and ps.fits and ps.frames_per_sm > 0


def test_bf16_halves_bm_term():
    """Hopper counterpart: branch metrics live in registers, so bf16 (and
    radix) change no shared memory; a bad bm_dtype still raises."""
    _, f32 = unified_smem_bytes(STD_K7, SPEC, 4, pack_survivors=True)
    _, bf16 = unified_smem_bytes(STD_K7, SPEC, 4, pack_survivors=True,
                                 bm_dtype="bfloat16", radix=4)
    assert bf16 == f32
    with pytest.raises(ValueError, match="bm_dtype"):
        unified_smem_bytes(STD_K7, SPEC, 4, bm_dtype="float16")
    with pytest.raises(ValueError, match="bm_dtype"):
        split_smem_bytes(STD_K7, SPEC, 4, bm_dtype="float16")


def test_plan_decode_full_plan():
    """plan_decode returns everything the front end executes: auto layout
    resolves to lane (the layout measured faster on the H100 for the split
    stream, and without effect on the unified kernel), kernel kwargs splat
    into ops, and the chunk is a multiple of tiles x devices."""
    p = plan_decode(STD_K7, SPEC, num_devices=4, **CPU)
    assert p.tile.layout is Layout.LANE
    assert p.unified and p.pack_survivors and p.radix == 4
    assert p.chunk_frames == 2 * p.frames_per_tile * 4
    kw = p.kernel_kwargs()
    assert kw["layout"] == "lane" and kw["unified"] is True
    assert kw["frames_per_tile"] == p.frames_per_tile
    ps = plan_decode(STD_K7, SPEC, unified=False, **CPU)
    assert not ps.unified and ps.tile.kernel == "split"
    assert ps.tile.layout is Layout.LANE


def test_candidates_lift_the_256_cap():
    """Hopper counterpart: candidates are the powers of two up to the
    thread cap: on the warp mapping eight warps of 32 // min(S, 32) frames
    (64 at K=3, 16 at K=5, 8 from K=6 on, K=11 too), on B1's thread
    mapping 256 (one thread a frame, K=3..7 at rate 1/2), capped at the
    smallest that covers max_frames."""
    assert candidate_tiles(make_trellis(3, (0o7, 0o5, 0o7, 0o5)))[-1] == 64
    assert candidate_tiles(K5_WARP)[-1] == 16
    assert candidate_tiles(K7_WARP) == [1, 2, 4, 8]
    assert candidate_tiles(make_trellis(3, (0o7, 0o5)))[-1] == 256
    assert candidate_tiles(make_trellis(5, (0o23, 0o35)))[-1] == 256
    assert candidate_tiles(STD_K7) == [1 << i for i in range(9)]
    assert candidate_tiles(STD_K7, unified=False) == [1, 2, 4, 8]
    assert candidate_tiles(K9)[-1] == 8
    k11 = make_trellis(11, (0o3345, 0o3613))
    assert candidate_tiles(k11) == [1, 2, 4, 8]
    assert candidate_tiles(K7_WARP, max_frames=3) == [1, 2, 4]
    assert candidate_tiles(K7_WARP, max_frames=300) == [1, 2, 4, 8]
    assert candidate_tiles(STD_K7, max_frames=3) == [1, 2, 4]
    assert candidate_tiles(STD_K7, max_frames=300) == [1 << i
                                                       for i in range(9)]


def test_kernel_runs_beyond_256_frames_per_tile():
    """A tile (padding granule) of 512 frames decodes exactly: the kernel
    wrappers run at most the thread cap's frames per block."""
    spec = FrameSpec(f=16, v1=8, v2=8)
    rng = np.random.default_rng(0)
    llr = torch.from_numpy(rng.standard_normal((330 * 16, 2))
                           .astype(np.float32))
    frames = frame_llr(llr, spec)
    want = ref.unified_decode_frames_ref(frames, STD_K7, spec)
    for unified in (True, False):
        got = ops.viterbi_decode_frames(
            frames, STD_K7, spec, unified=unified, frames_per_tile=512,
            pack_survivors=True, radix=4, layout="sublane", device="cpu")
        assert torch.equal(got, want)


def test_plan_cache_key_and_pinned_tile():
    a = plan_decode(STD_K7, SPEC, **CPU)
    b = plan_decode(STD_K7, SPEC, **CPU)
    assert a.cache_key() == b.cache_key()
    assert a.fingerprint() == b.fingerprint()
    c = plan_decode(STD_K7, SPEC, radix=2, **CPU)
    assert a.cache_key() != c.cache_key()
    d = plan_decode(STD_K7, SPEC, chunk_frames=7, **CPU)
    assert a.cache_key() != d.cache_key()
    p = plan_decode(STD_K7, SPEC, layout="lane", frames_per_tile=8, **CPU)
    assert p.frames_per_tile == 8 and p.tile.layout is Layout.LANE
    assert p.chunk_frames == 2 * 8            # chunk follows the pinned tile


def test_geometry_validation_errors():
    with pytest.raises(ValueError, match="multiple of f0"):
        plan_tiles(STD_K7, FrameSpec(f=256, v1=20, v2=45, f0=48, v2s=45),
                   **CPU)
    with pytest.raises(ValueError, match="exceeds v2"):
        plan_tiles(STD_K7, FrameSpec(f=256, v1=20, v2=20, f0=32, v2s=45),
                   **CPU)
    plan_tiles(STD_K7, SPEC, **CPU)


def test_plan_identity_differs_for_every_knob():
    base = plan_decode(STD_K7, SPEC, layout="sublane", **CPU)
    variants = [
        ("frames_per_tile",
         dataclasses.replace(base, tile=dataclasses.replace(
             base.tile, frames_per_tile=base.tile.frames_per_tile * 2))),
        ("kernel", dataclasses.replace(base, tile=dataclasses.replace(
            base.tile, kernel="split"))),
        ("layout", dataclasses.replace(base, tile=dataclasses.replace(
            base.tile, layout=Layout.LANE))),
        ("bm_dtype", dataclasses.replace(base, tile=dataclasses.replace(
            base.tile, bm_dtype="bfloat16"))),
        ("pack_survivors", dataclasses.replace(base, pack_survivors=False)),
        ("radix", dataclasses.replace(base, radix=2)),
        ("chunk_frames",
         dataclasses.replace(base, chunk_frames=base.chunk_frames + 1)),
        ("num_devices", dataclasses.replace(base, num_devices=2)),
        ("block_frames", dataclasses.replace(base, block_frames=4,
                                             overlap=16)),
        ("overlap", dataclasses.replace(base, block_frames=4, overlap=20)),
    ]
    keys = {}
    for name, plan in [("base", base)] + variants:
        key, fp = plan.cache_key(), plan.fingerprint()
        for other, (okey, ofp) in keys.items():
            assert key != okey, f"{name} aliases {other} in cache_key()"
            assert fp != ofp, f"{name} aliases {other} in fingerprint()"
        keys[name] = (key, fp)
    relabeled = dataclasses.replace(base, tile=dataclasses.replace(
        base.tile, smem_bytes=base.tile.smem_bytes + 1, frames_per_sm=1))
    assert relabeled.cache_key() == base.cache_key()
    assert relabeled.fingerprint() == base.fingerprint()


def test_fingerprint_stable_across_processes():
    prog = (
        "from repro_torch.core.framed import FrameSpec\n"
        "from repro_torch.core.trellis import STD_K7\n"
        "from repro_torch.kernels.autotune import plan_decode\n"
        "spec = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)\n"
        "p = plan_decode(STD_K7, spec, layout='sublane', block_frames=4,\n"
        "                overlap=45, device='cpu')\n"
        "print(p.fingerprint())\n")
    here = plan_decode(STD_K7, SPEC, layout="sublane", block_frames=4,
                       overlap=45, **CPU)
    assert here.block_frames == 4 and here.overlap == 45
    out = subprocess.run([sys.executable, "-c", prog], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.stdout.strip() == here.fingerprint()


def test_cache_key_is_the_jax_tuple():
    """For the same knobs (pinned tile and layout) the port's cache key is
    the JAX package's tuple, element for element, and so is its
    fingerprint."""
    from repro.core import FrameSpec as JFrameSpec
    from repro.core import STD_K7 as JSTD_K7
    from repro.kernels import autotune as jautotune
    jspec = JFrameSpec(**vars(SPEC))
    for knobs in (dict(layout="sublane", frames_per_tile=8),
                  dict(layout="lane", frames_per_tile=4, unified=False,
                       radix=2, pack_survivors=False, num_devices=2),
                  dict(layout="sublane", frames_per_tile=16,
                       block_frames=4, overlap=45, chunk_frames=9)):
        port = plan_decode(STD_K7, SPEC, **knobs, **CPU)
        jax_plan = jautotune.plan_decode(JSTD_K7, jspec, **knobs)
        assert port.cache_key() == jax_plan.cache_key()
        assert [type(x) for x in port.cache_key()] == \
            [type(x) for x in jax_plan.cache_key()]
        assert port.fingerprint() == jax_plan.fingerprint()


def test_auto_tile_in_ops_is_the_planners():
    """frames_per_tile="auto" in ops comes from plan_tiles for the kernel
    that runs, and decodes exactly: at K=5 (two frames a warp) four frames
    a block, the tile that covers the six frames with the most resident
    frames per SM."""
    from repro_torch.obs import tracer as obs
    spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
    k5 = make_trellis(5, (0o23, 0o35))
    frames = torch.zeros((6, spec.frame_len, 2))
    for unified in (True, False):
        tracer = obs.Tracer()
        prev = obs.set_tracer(tracer)
        try:
            ops.viterbi_decode_frames(frames, k5, spec, unified=unified,
                                      device="cpu")
        finally:
            obs.set_tracer(prev)
        (ev,) = [s for s in tracer.spans() if s.name == "decode.kernel"]
        # six frames do not fill the card: B1 keeps the warp mapping, as
        # B3 does, four frames a block
        assert ev.attrs["frames_per_tile"] == plan_tiles(
            k5, spec, pack_survivors=True, radix=4, unified=unified,
            max_frames=6, **CPU).frames_per_tile == 4
        assert ev.attrs["mapping"] == "plain"         # no launch off the card


def test_device_limits_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune.device_limits("cpu") == H100_LIMITS
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan_tiles(STD_K7, SPEC)


# ---- tests/test_tunedb.py --------------------------------------------------

TSPEC = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)
MEASURE_KW = dict(measure=True, measure_reps=1, chunk_frames=4,
                  frames_per_tile=8, device="cpu")


@pytest.fixture
def db_path(tmp_path, monkeypatch):
    p = str(tmp_path / "tunedb.json")
    monkeypatch.setenv("REPRO_TUNE_DB", p)
    return p


def test_default_path_env_override(db_path):
    assert default_path() == db_path
    assert TuneDB().path == db_path


def test_default_path_without_env(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_DB", raising=False)
    assert default_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_viterbi", "tunedb.json")


def test_platform_key_includes_torch_version():
    pid = platform_id("cpu")
    assert set(pid) == {"backend", "device_kind", "torch_version",
                        "cuda_version"}
    assert pid["backend"] == "cpu" and pid["device_kind"] == "cpu"
    key = platform_key(pid)
    assert key.count("/") == 2 and pid["torch_version"] in key
    other = dict(pid, device_kind="weird-accelerator")
    assert platform_key(other) != key


def test_measure_plan_record_shape(db_path):
    plan = plan_decode(STD_K7, TSPEC, frames_per_tile=8, chunk_frames=4,
                       **CPU)
    rec = measure_plan(STD_K7, TSPEC, plan, reps=1, **CPU)
    assert rec["ms"] > 0 and rec["mbps"] > 0
    assert rec["frames"] == plan.chunk_frames
    assert rec["fingerprint"] == plan.fingerprint()
    assert rec["interpret"] is True and rec["timer"] == "host_clock"


def test_round_trip_second_instance_zero_remeasure(db_path):
    db1 = TuneDB()
    p1 = plan_decode(STD_K7, TSPEC, tunedb=db1, **MEASURE_KW)
    s1 = db1.stats()
    assert s1["measures"] >= 1 and s1["entries"] >= 1
    t = Tracer()
    set_tracer(t)
    try:
        db2 = TuneDB()
        p2 = plan_decode(STD_K7, TSPEC, tunedb=db2, **MEASURE_KW)
    finally:
        set_tracer(None)
    s2 = db2.stats()
    assert s2["measures"] == 0, "second instance re-measured a cached plan"
    assert s2["hits"] >= 1 and s2["misses"] == 0
    assert p2.cache_key() == p1.cache_key()
    counters = t.counters()
    assert counters.get("tunedb_hits", 0) >= 1
    assert "tunedb_measures" not in counters
    assert "tunedb_misses" not in counters


def test_round_trip_across_real_processes(db_path):
    db = TuneDB()
    p = plan_decode(STD_K7, TSPEC, tunedb=db, **MEASURE_KW)
    assert db.stats()["measures"] >= 1
    prog = (
        "import json\n"
        "from repro_torch.core.framed import FrameSpec\n"
        "from repro_torch.core.trellis import STD_K7\n"
        "from repro_torch.kernels.autotune import plan_decode\n"
        "from repro_torch.kernels.tunedb import TuneDB\n"
        "from repro_torch.obs.tracer import Tracer, set_tracer\n"
        "t = Tracer(); set_tracer(t)\n"
        "db = TuneDB()\n"
        "spec = FrameSpec(f=64, v1=16, v2=20, f0=16, v2s=20)\n"
        "p = plan_decode(STD_K7, spec, measure=True, tunedb=db,\n"
        "                measure_reps=1, chunk_frames=4, frames_per_tile=8,\n"
        "                device='cpu')\n"
        "print(json.dumps({'stats': db.stats(), 'counters': t.counters(),\n"
        "                  'fp': p.fingerprint()}))\n")
    out = subprocess.run([sys.executable, "-c", prog], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["fp"] == p.fingerprint()
    assert got["stats"]["measures"] == 0
    assert got["stats"]["hits"] >= 1 and got["stats"]["misses"] == 0
    assert got["counters"].get("tunedb_hits", 0) >= 1
    assert "tunedb_measures" not in got["counters"]


def test_changed_fingerprint_remeasures(db_path):
    db = TuneDB()
    plan_decode(STD_K7, TSPEC, tunedb=db, **MEASURE_KW)
    before = db.stats()["measures"]
    plan_decode(STD_K7, TSPEC, tunedb=db, radix=2, **MEASURE_KW)
    assert db.stats()["measures"] > before


def test_changed_device_kind_remeasures(db_path, monkeypatch):
    db = TuneDB()
    plan_decode(STD_K7, TSPEC, tunedb=db, **MEASURE_KW)
    before = db.stats()["measures"]
    fake = dict(platform_id("cpu"), device_kind="other-cpu")
    monkeypatch.setattr(autotune, "platform_id", lambda device=None: fake)
    plan_decode(STD_K7, TSPEC, tunedb=db, **MEASURE_KW)
    stats = db.stats()
    assert stats["measures"] > before
    assert stats["platforms"] == 2


def test_corrupt_db_warns_never_crashes(db_path):
    with open(db_path, "w") as fh:
        fh.write('{"schema": "repro.tunedb/v1", "platforms": [1, 2]}')
    db = TuneDB()
    with pytest.warns(TuneDBWarning, match="unusable"):
        assert db.get("deadbeef00", platform_id("cpu")) is None
    db.put("deadbeef00", {"ms": 1.0, "mbps": 2.0}, platform_id("cpu"))
    with open(db_path) as fh:
        doc = json.load(fh)
    assert doc["schema"] == SCHEMA
    assert TuneDB().get("deadbeef00", platform_id("cpu"))["mbps"] == 2.0


@pytest.mark.parametrize("garbage", ["not json at all{{{",
                                     '["a", "list"]',
                                     '{"schema": "something/else"}'])
def test_bad_files_all_warn(db_path, garbage):
    with open(db_path, "w") as fh:
        fh.write(garbage)
    with pytest.warns(TuneDBWarning):
        assert TuneDB().get("aa", platform_id("cpu")) is None


def test_concurrent_writers_merge_rows(db_path):
    cpu = platform_id("cpu")
    a, b = TuneDB(), TuneDB()
    a.get("fp_a", cpu)
    b.get("fp_b", cpu)
    a.put("fp_a", {"ms": 1.0, "mbps": 10.0}, cpu)
    b.put("fp_b", {"ms": 2.0, "mbps": 20.0}, cpu)
    c = TuneDB()
    assert c.get("fp_a", cpu)["mbps"] == 10.0
    assert c.get("fp_b", cpu)["mbps"] == 20.0
    assert c.stats()["entries"] == 2


def test_invalidate_deletes_file(db_path):
    cpu = platform_id("cpu")
    db = TuneDB()
    db.put("fp", {"ms": 1.0, "mbps": 1.0}, cpu)
    assert os.path.exists(db_path)
    db.invalidate()
    assert not os.path.exists(db_path)
    assert db.get("fp", cpu) is None


def test_measured_span_attrs(db_path):
    t = Tracer()
    set_tracer(t)
    try:
        plan_decode(STD_K7, TSPEC, tunedb=TuneDB(), **MEASURE_KW)
    finally:
        set_tracer(None)
    (span,) = [r for r in t.spans() if r.name == "plan_decode"]
    at = span.attrs
    assert at["measured_ms"] > 0 and at["measured_mbps"] > 0
    assert at["smem_bytes"] > 0                  # predicted, still there
    assert at["measure_candidates"] == at["measure_new"] == 1
    assert at["measure_cached"] == 0
    assert at["fingerprint"] == at["analytic_fingerprint"]


def test_measured_choice_among_candidates(db_path):
    db = TuneDB()
    plan = plan_decode(STD_K7, TSPEC, tunedb=db, measure=True,
                       measure_reps=1, measure_top_k=2, chunk_frames=4,
                       **CPU)
    stats = db.stats()
    assert stats["entries"] == 2 and stats["measures"] == 2
    assert db.get(plan.fingerprint(), platform_id("cpu")) is not None


def test_jax_written_db_loads_and_keeps_its_rows(db_path):
    """A file written by the JAX package's TuneDB loads in the port: its
    rows are found under the JAX platform key, and a port write keeps
    them."""
    from repro.kernels.tunedb import TuneDB as JTuneDB
    from repro.kernels.tunedb import platform_id as jplatform_id
    jpid = jplatform_id()
    JTuneDB(db_path).put("jaxfp00001", {"ms": 3.0, "mbps": 4.0}, jpid)
    port = TuneDB(db_path)
    assert port.get("jaxfp00001", jpid)["mbps"] == 4.0
    port.put("portfp0001", {"ms": 1.0, "mbps": 2.0}, platform_id("cpu"))
    doc = json.loads(Path(db_path).read_text())
    assert doc["schema"] == SCHEMA
    assert doc["platforms"][platform_key(jpid)]["jaxfp00001"]["ms"] == 3.0
    assert JTuneDB(db_path).get("jaxfp00001", jpid)["mbps"] == 4.0
    assert port.stats()["platforms"] == 2


def test_cuda_rows_belong_to_a_kernel_build(db_path, monkeypatch):
    """A card's platform key ends with the kernel build (a hash of the
    CUDA sources and nvcc flags): a row measured on one build misses on
    another, while a JAX-written row still hits under its own key."""
    from repro.kernels.tunedb import TuneDB as JTuneDB
    from repro.kernels.tunedb import platform_id as jplatform_id
    from repro_torch.kernels import build
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    card = platform_id("cuda")
    assert card["kernel_build"] == build._digest()
    assert platform_key(card).endswith(f"-build{build._digest()}")
    jpid = jplatform_id()
    JTuneDB(db_path).put("jaxfp00002", {"ms": 5.0, "mbps": 6.0}, jpid)
    TuneDB(db_path).put("cudafp0001", {"ms": 1.0, "mbps": 2.0}, card)
    assert TuneDB(db_path).get("cudafp0001", platform_id("cuda"))["ms"] == 1.0
    monkeypatch.setattr(build, "_digest", lambda: "0123456789abcdef")
    rebuilt = platform_id("cuda")
    assert rebuilt["kernel_build"] == "0123456789abcdef"
    db = TuneDB(db_path)
    assert db.get("cudafp0001", rebuilt) is None
    assert db.get("jaxfp00002", jpid)["mbps"] == 6.0
    assert db.stats()["hits"] == 1 and db.stats()["misses"] == 1


# ---- codes 12 <= k <= 15: the cluster mapping's one-block form ------------

LARGE = [make_trellis(12, (0o4335, 0o5723)), make_trellis(13, (0o10533,
                                                                0o17661)),
         make_trellis(14, (0o21645, 0o35661)),
         make_trellis(15, (0o46321, 0o51271, 0o63667, 0o70535))]


@pytest.mark.parametrize("tr", LARGE, ids=lambda t: f"k{t.k}")
def test_large_code_block_is_one_frame(tr):
    """A large code runs one frame on a block of ``large_threads`` threads
    (256, 128, 256, 512 at k = 12..15: 4, 16, 16, 16 butterflies a
    thread): the thread cap, the candidate tiles and the block's threads
    say so, and the CPU plans with the one-block kernels' registers."""
    assert autotune.smem_mapping(tr) and not autotune.smem_mapping(K9)
    assert autotune.max_frames_per_block(tr) == 1
    assert candidate_tiles(tr) == [1]
    T = {12: 256, 13: 128, 14: 256, 15: 512}[tr.k]
    assert autotune.block_threads(tr, 1) == autotune.large_threads(tr) == T
    assert tr.num_states // 2 // T == (4 if tr.k == 12 else 16)
    for unified, name in ((True, "unified_block"), (False, "split_block")):
        assert autotune.kernel_registers(tr, unified=unified,
                                         **CPU) == H100_REGISTERS[name]
    assert autotune.kernel_registers(K9, **CPU) == H100_REGISTERS["unified"]


@pytest.mark.parametrize("tr", LARGE, ids=lambda t: f"k{t.k}")
def test_large_code_smem_models(tr):
    """The one-block form's shared memory, term for term: two path-metric
    buffers of S float32, the tables and one block's partials (9344
    bytes), then the unified block's starts and survivors when they sit
    on chip; the forward block keeps only the first two."""
    S, L = tr.num_states, SPEC.frame_len
    core = autotune.BLOCK_CORE_BYTES
    assert core == 9344
    total, bd = unified_smem_bytes(tr, SPEC, 1, pack_survivors=True)
    assert dict(bd) == {"path_metrics": 8 * S, "tables_and_partials": core,
                        "traceback_starts": 32,
                        "sel_survivors": L * S // 8}
    assert total == 8 * S + core + 32 + L * S // 8
    scratch, bd = unified_smem_bytes(tr, SPEC, 1, pack_survivors=True,
                                     scratch=True)
    assert scratch == 8 * S + core and dict(bd)["sel_survivors"] == 0
    split, bd = split_smem_bytes(tr, SPEC, 1)
    assert split == 8 * S + core and [n for n, _ in bd] == [
        "path_metrics", "tables_and_partials"]


def test_large_code_plans_fit_one_frame_per_sm():
    """plan_tiles gives every large code a plan that fits, one frame a
    block, ``H100_BLOCKS`` blocks an SM. B1 keeps its packed survivors on
    chip only where that costs none of the launch's resident frames: for
    as many frames as the card holds (no ``max_frames``) nowhere, so every
    block is the recursion's alone (8 S + 9344 bytes); K=12 at 132 and
    264 frames (two 107936-byte blocks an SM) and K=13 at 132 (one of
    206496 bytes) on chip, at 1056 not; K=14 and K=15 never (their
    survivors outgrow a block)."""
    core = autotune.BLOCK_CORE_BYTES
    for tr in LARGE:
        for unified in (True, False):
            name = "unified" if unified else "split"
            plan = plan_tiles(tr, SPEC, pack_survivors=True,
                              unified=unified, **CPU)
            assert plan.frames_per_tile == 1 and plan.fits
            assert plan.smem_bytes == 8 * tr.num_states + core
            assert plan.frames_per_sm == H100_BLOCKS[name][tr.k] >= 1
    on_chip = {12: ((132, 264), 107936, 2), 13: ((132,), 206496, 1)}
    for tr in LARGE:
        for frames in (132, 264, 1056):
            plan = plan_tiles(tr, SPEC, pack_survivors=True,
                              max_frames=frames, **CPU)
            if frames in on_chip.get(tr.k, ((),))[0]:
                _, smem, per_sm = on_chip[tr.k]
                assert (plan.smem_bytes, plan.frames_per_sm) == (smem, per_sm)
                assert dict(plan.breakdown)["sel_survivors"] > 0
            else:
                assert plan.smem_bytes == 8 * tr.num_states + core
                assert dict(plan.breakdown)["sel_survivors"] == 0
    plan = plan_decode(LARGE[1], SPEC, **CPU)
    assert plan.frames_per_tile == 1 and plan.chunk_frames == 2
    assert plan.tile.fits and plan.tile.registers == H100_REGISTERS[
        "unified_block"]


@pytest.mark.parametrize("tr", LARGE, ids=lambda t: f"k{t.k}")
def test_large_code_grid_is_the_resident_blocks(tr):
    """block_grid launches at most one block a frame and at most the
    blocks the card keeps resident (132 SMs x ``H100_BLOCKS``), each
    taking frames in turn; a block with more shared memory (B1's
    survivors on chip) holds no more than the SM's shared memory allows,
    and the survivors go on chip exactly when those blocks still hold the
    launch's frames."""
    spec = SPEC
    for unified, name in ((True, "unified"), (False, "split")):
        cap = H100_BLOCKS[name][tr.k]
        assert autotune.block_capacity(tr, "cpu", unified=unified) == cap
        for frames in (1, 7, 132, 264, 1056, 10_000):
            assert autotune.block_grid(tr, frames, "cpu",
                                       unified=unified) == \
                min(frames, autotune.H100_SMS * cap)
    on, _ = unified_smem_bytes(tr, spec, 1, pack_survivors=True)
    limits = H100_LIMITS
    held = min(H100_BLOCKS["unified"][tr.k],
               limits.smem_per_sm // (on + limits.smem_reserved_per_block))
    assert autotune.block_capacity(tr, "cpu", smem=on) == held
    for frames in (1, 132, 264, 1056):
        want = (on <= limits.smem_per_block
                and 132 * held >= min(frames,
                                      132 * H100_BLOCKS["unified"][tr.k]))
        assert autotune.block_survivors_on_chip(
            tr, spec, pack_survivors=True, frames=frames, device="cpu") == want
    assert not autotune.block_survivors_on_chip(tr, spec,
                                                pack_survivors=False,
                                                device="cpu")
