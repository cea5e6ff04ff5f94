"""Dry run of the paper's workload at node scale: framed Viterbi decoding
of ``--nbits`` bits on ``--gpus`` H100s; port of
``repro.launch.viterbi_dryrun``.

The frame axis is the distribution axis (distributed/stream.py). The
projection needs no card: the decode's roofline (launch/roofline.py) over
the planner's geometry (``plan_decode(num_devices=--gpus)``: the tile each
card pads its shard to, its resident frames per SM) gives the decode
bound in Gb/s and each card's HBM footprint against ``HW``. ``--run``
also decodes ``--nbits`` bits for real on the local cards
(``frame_mesh()``), from LLRs made on the card from ``--seed``, checks the
bits against the unsharded ``make_decoder`` on the same card and prints
the measured Gb/s beside the bound for the local mesh.

  PYTHONPATH=src python -m repro_torch.launch.viterbi_dryrun \\
      --nbits 100000000 --gpus 8 [--run] [--out DIR]

The last line of the output is the row as JSON; ``--out`` also writes it
to ``DIR/viterbi_<shape>_<mesh>.json``.
"""
from __future__ import annotations

import argparse
import json
import os

from ..core.framed import FrameSpec
from ..core.trellis import STD_K7
from . import roofline as RL
from .mesh import HW

__all__ = ["project", "run", "main"]

#: The paper's frame at K=7 rate 1/2 (the main path's, chip_smoke.py).
SPEC = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
EBN0_DB = 3.0
RUN_REPS = 5


def project(nbits: int, gpus: int, *, device="cpu") -> dict:
    """The projected row of the unified-kernel decode on ``gpus`` cards;
    ``device`` is what the planner models (the CPU plans with the H100's
    limits)."""
    from ..kernels.autotune import plan_decode
    plan = plan_decode(STD_K7, SPEC, num_devices=gpus, device=device)
    tile = plan.frames_per_tile
    rl = RL.decode_roofline(STD_K7, SPEC, nbits, gpus, frames_multiple=tile)
    frames = -(-SPEC.num_frames(nbits) // (gpus * tile)) * gpus * tile
    per = frames // gpus
    tput = nbits / rl.t_bound / 1e9 if rl.t_bound else float("inf")
    return {"arch": "viterbi_k7", "shape": f"decode_{nbits // 10**6}Mb",
            "mesh": f"{gpus}xH100", "tag": "", **rl.row(),
            "decoded_bits": nbits, "frames": frames, "frames_per_chip": per,
            "frames_per_tile": tile, "frames_per_sm": plan.tile.frames_per_sm,
            "chunk_frames": plan.chunk_frames,
            "waves_per_chip": per / (plan.tile.frames_per_sm * HW.SMS),
            "hbm_fraction": rl.peak_memory_per_chip / HW.HBM_BYTES,
            "fits_hbm": rl.peak_memory_per_chip <= HW.HBM_BYTES,
            "throughput_bound_gbps": tput}


def run(nbits: int, *, seed: int = 0, mesh=None) -> dict:
    """Decode ``nbits`` bits across ``mesh`` (default: every local card):
    frames made on the home card, the sharded decode timed with CUDA
    events over RUN_REPS calls after a warm one, bits held against the
    unsharded make_decoder on the same card."""
    import torch
    from ..channel.sim import channel
    from ..core.framed import frame_llr
    from ..core.pipeline import DecoderConfig, make_decoder
    from ..distributed.stream import frame_mesh, make_sharded_frame_decoder
    mesh = frame_mesh() if mesh is None else mesh
    home = mesh.home
    cfg = DecoderConfig(spec=SPEC, backend="kernel")
    gen = torch.Generator(device=home).manual_seed(seed)
    _, rx = channel(gen, nbits, EBN0_DB)
    frames = frame_llr(rx.reshape(nbits, -1), SPEC).contiguous()
    decode = make_sharded_frame_decoder(cfg, mesh)
    got = decode(frames)                                 # warm
    want = make_decoder(cfg, home)(rx, nbits)
    if not torch.equal(got.reshape(-1)[:nbits], want):
        raise AssertionError("sharded decode != unsharded make_decoder")
    del want
    with torch.cuda.device(home):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(RUN_REPS):
            decode(frames)
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 1e3 / RUN_REPS
    return {"measured_chips": mesh.size,
            "measured_devices": [str(d) for d in mesh.devices],
            "measured_device_name": torch.cuda.get_device_name(home),
            "measured_s": sec, "measured_gbps": nbits / sec / 1e9}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nbits", type=int, default=100_000_000)
    ap.add_argument("--gpus", type=int, default=8)
    ap.add_argument("--run", action="store_true",
                    help="also decode --nbits bits on the local cards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    row = project(args.nbits, args.gpus,
                  device="cuda" if args.run else "cpu")
    print(f"viterbi {row['mesh']}: {row['frames']} frames "
          f"({row['frames_per_chip']} per card, tile "
          f"{row['frames_per_tile']}, {row['waves_per_chip']:.1f} waves), "
          f"tc={row['t_compute_s']:.3e} tm={row['t_memory_s']:.3e} "
          f"tl={row['t_collective_s']:.3e} bound={row['bottleneck']} "
          f"-> decode bound {row['throughput_bound_gbps']:.1f} Gb/s "
          f"({row['throughput_bound_gbps'] * 1000 / args.gpus:.1f} Mb/s per "
          f"card); home card HBM {row['peak_memory_per_chip'] / 1e9:.2f} GB "
          f"of {HW.HBM_BYTES / 1e9:.0f} GB", flush=True)
    if args.run:
        measured = run(args.nbits, seed=args.seed)
        local = project(args.nbits, measured["measured_chips"],
                        device="cuda")
        row.update(measured,
                   measured_bound_gbps=local["throughput_bound_gbps"],
                   measured_bottleneck=local["bottleneck"])
        print(f"measured on {measured['measured_chips']} card(s) "
              f"({measured['measured_device_name']}): "
              f"{measured['measured_s'] * 1e3:.3f} ms per decode of "
              f"{args.nbits} bits = {measured['measured_gbps']:.2f} Gb/s "
              f"against a bound of {local['throughput_bound_gbps']:.1f} Gb/s "
              f"({local['bottleneck']}) on that mesh; bits equal the "
              f"unsharded make_decoder", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out,
                            f"viterbi_{row['shape']}_{row['mesh']}.json")
        with open(path, "w") as fp:
            json.dump(row, fp, indent=1)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
