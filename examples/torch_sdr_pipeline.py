"""SDR receiver pipeline on the PyTorch port: punctured rate-3/4 stream ->
depuncture -> framed decode (parallel traceback) -> BER, plus the
streaming front end: the same raw punctured stream pushed slice by slice,
as a real receiver would, through core.stream's double-buffered decoder,
frame-sharded over every local card (the paper's tiling is also the
distribution axis). The streamed bits must equal the one-shot bits.

  PYTHONPATH=src python examples/torch_sdr_pipeline.py [--device cpu] [--n N]

``--device cpu`` runs the kernels' plain torch versions and shards over
two CPU devices instead of the cards. The noise comes from a seeded
``torch.Generator``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.channel.sim import awgn, ber, bpsk
from repro_torch.core import STD_K7, FrameSpec, encode
from repro_torch.core.pipeline import DecoderConfig, make_decoder
from repro_torch.core.puncture import puncture
from repro_torch.core.stream import make_stream_decoder
from repro_torch.distributed import frame_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=99_999, help="bits to send")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev, n, rate = torch.device(args.device), args.n, "3/4"
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bits = torch.randint(0, 2, (n,), generator=gen, device=dev,
                         dtype=torch.int32)

    tx = bpsk(puncture(encode(bits, STD_K7), rate))
    print(f"tx: {n} info bits -> {tx.shape[0]} channel symbols (rate {rate})")
    rx = awgn(tx, 6.0, gen)

    spec = FrameSpec(f=252, v1=21, v2=45, f0=42, v2s=45)
    cfg = DecoderConfig(spec=spec, rate=rate, backend="kernel")
    out = make_decoder(cfg, dev)(rx, n)
    print(f"punctured {rate} BER @ 6 dB: {ber(out, bits):.2e}")

    # ---- streaming decode, frame-sharded over every local card ----------
    # Push the raw punctured symbols in receiver-sized slices (the stream
    # depunctures in-stream; pattern alignment is stream-global); chunks
    # are dispatched without blocking (double-buffered) and each chunk's
    # frames are split across the mesh.
    mesh = frame_mesh() if dev.type == "cuda" else frame_mesh([dev] * 2)
    sym = rx.cpu().numpy()
    sdec = make_stream_decoder(cfg, mesh=mesh)
    push = 16 * spec.f * 4 // 3                          # symbols per push
    t0 = time.perf_counter()
    parts = [sdec.push(sym[i:i + push]) for i in range(0, sym.shape[0], push)]
    parts.append(sdec.flush())
    out2 = np.concatenate(parts)[:n]
    dt = time.perf_counter() - t0
    print(f"streamed decode over {mesh.size} shard(s) "
          f"({', '.join(map(str, mesh.devices))}), chunk="
          f"{sdec.chunk_frames} frames: {n / dt / 1e6:.2f} Mb/s, BER "
          f"{ber(torch.from_numpy(out2), bits.cpu()):.2e}")
    assert np.array_equal(out.cpu().numpy(), out2), "streamed != one-shot"
    print("streamed bits equal the one-shot bits")
    return out2


if __name__ == "__main__":
    main()
