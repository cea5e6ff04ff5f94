"""The port's launch tooling (repro_torch.launch): hardware constants, the
decode roofline and the dry run, on the CPU.

The roofline's counts at the main path's shape (F = 16384 frames of
L = 321 stages, K=7, packed, f32 LLRs) must give the bounds PERF.md
records from the H100 runs: B1 0.0301 ms (operations), B3 0.0314 ms
(bytes), the split traceback 0.0172 ms (bytes), to 0.1 us. ``Roofline``
keeps the JAX package's row keys where they mean something on a card.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch.roofline import Roofline as JRoofline

from repro_torch.core.framed import FrameSpec
from repro_torch.core.trellis import STD_K7
from repro_torch.launch import roofline as RL
from repro_torch.launch import viterbi_dryrun
from repro_torch.launch.mesh import HW, make_production_mesh

MAIN = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
F = 16384


@pytest.mark.parametrize("kernel,ms,by", [
    ("viterbi_unified", 0.0301, "operations"),
    ("viterbi_fwd", 0.0314, "bytes"),
    ("traceback_frames", 0.0172, "bytes")])
def test_main_shape_bounds(kernel, ms, by):
    nbytes, nops = RL.kernel_work(kernel, STD_K7, MAIN, F)
    bound_ms, bound_by = RL.kernel_bound(nbytes, nops)
    assert bound_ms == pytest.approx(ms, abs=1e-4)
    assert bound_by == by


def test_kernel_work_counts():
    L, S = MAIN.frame_len, STD_K7.num_states
    frames, bits = F * L * 2 * 4, F * 256 * 4
    assert RL.kernel_work("viterbi_unified", STD_K7, MAIN, F) == (
        frames + bits, 6 * F * L * S)
    # unpacked survivors: a byte per state; packed: two int32 words at S=64
    assert RL.kernel_work("viterbi_fwd", STD_K7, MAIN, F,
                          pack_survivors=False)[0] == frames + F * L * (S + 4)
    assert RL.kernel_work("viterbi_fwd", STD_K7, MAIN, F)[0] == (
        frames + F * L * (8 + 4))
    # serial traceback: one cursor of f + v2 steps per frame
    serial = FrameSpec(f=256, v1=20, v2=45)
    assert RL.kernel_work("traceback_frames", STD_K7, serial, F) == (
        F * 301 * 4 + F * 4 + bits, 6 * F * 301)
    assert RL.kernel_work("viterbi_unified", STD_K7, MAIN, F,
                          llr_bytes=2)[0] == frames // 2 + bits
    with pytest.raises(ValueError, match="unknown kernel"):
        RL.kernel_work("viterbi_block", STD_K7, MAIN, F)


def test_roofline_row_keys_are_jax_keys():
    rl = RL.decode_roofline(STD_K7, MAIN, 1 << 22, 1)
    row = rl.row()
    jrow = JRoofline(chips=1, flops_per_chip=1.0, bytes_per_chip=1.0,
                     coll_bytes_per_chip=0.0, coll_breakdown={}).row()
    assert set(row) - set(jrow) == {"t_bound_s"}
    assert row["bottleneck"] == "compute" and row["t_collective_s"] == 0.0
    assert row["t_bound_s"] == max(row["t_compute_s"], row["t_memory_s"])
    # one card, n = 2^22: exactly B1's bound at the main shape
    assert rl.t_bound * 1e3 == pytest.approx(
        RL.kernel_bound(*RL.kernel_work("viterbi_unified", STD_K7, MAIN,
                                        F))[0])


def test_decode_roofline_across_cards():
    one = RL.decode_roofline(STD_K7, MAIN, 1 << 22, 1, backend="kernel_split")
    eight = RL.decode_roofline(STD_K7, MAIN, 1 << 22, 8,
                               backend="kernel_split")
    assert eight.flops_per_chip * 8 == one.flops_per_chip
    per = F // 8
    assert eight.coll_breakdown == {
        "scatter_frames": 7 * per * MAIN.frame_len * 2 * 4,
        "gather_bits": 7 * per * 256 * 4}
    assert eight.coll_bytes_per_chip == eight.coll_breakdown[
        "scatter_frames"]
    assert eight.t_collective == eight.coll_bytes_per_chip / HW.NVLINK_BW
    # the frames pad to chips x tile
    assert RL.decode_roofline(STD_K7, MAIN, 1000 * 256, 3,
                              frames_multiple=2).flops_per_chip == (
        6 * 334 * MAIN.frame_len * 64)
    with pytest.raises(ValueError, match="backend"):
        RL.decode_roofline(STD_K7, MAIN, 1 << 20, 1, backend="reference")


def test_hw_is_the_h100_data_sheet(monkeypatch):
    assert (HW.HBM_BW, HW.PEAK_F32_OPS, HW.PEAK_FLOPS_BF16, HW.HBM_BYTES,
            HW.NVLINK_BW, HW.SMS) == (3.35e12, 67e12, 989e12, 80e9, 450e9,
                                      132)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()


def test_dryrun_writes_its_row_on_the_cpu(tmp_path, capsys):
    row = viterbi_dryrun.main(["--nbits", "100000000", "--gpus", "8",
                               "--out", str(tmp_path)])
    path = tmp_path / "viterbi_decode_100Mb_8xH100.json"
    assert json.loads(path.read_text()) == row
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row
    assert row["chips"] == 8 and row["frames"] % (8 * row[
        "frames_per_tile"]) == 0
    assert row["frames_per_chip"] * 8 == row["frames"]
    assert row["throughput_bound_gbps"] == pytest.approx(
        1e8 / row["t_bound_s"] / 1e9)
    assert row["fits_hbm"] and 0 < row["hbm_fraction"] < 1
    assert "measured_gbps" not in row


def test_dryrun_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viterbi_dryrun.main(["--nbits", "4096", "--gpus", "1", "--run"])


def test_new_modules_import_no_jax_and_no_repro():
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import sys, repro_torch.distributed, repro_torch.launch.mesh, "
        "repro_torch.launch.roofline, repro_torch.launch.viterbi_dryrun\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
