"""Quickstart for the PyTorch port: encode -> AWGN channel -> Viterbi
decode with the unified CUDA kernel on the card.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--n N]

``--device cpu`` runs the kernels' plain torch versions instead. The
channel's noise comes from a seeded ``torch.Generator``. The decode is
checked against the reference backend on the same received stream: the
bits must be equal.

For unbounded inputs, use the streaming front end instead of one shot:

    from repro_torch.core import make_stream_decoder
    sdec = make_stream_decoder(cfg)           # chunk size from plan_decode
    bits_so_far = sdec.push(llr_chunk)        # double-buffered on the card
    tail = sdec.flush()                       # zero-padded tail + drain

Chunked output is bit-identical to the one-shot decode; pass ``mesh=``
(``repro_torch.distributed.frame_mesh()``) to split each chunk's frames
across the cards.
"""
import argparse
import dataclasses

import torch

from repro_torch.channel.sim import awgn, ber, bpsk
from repro_torch.core import STD_K7, FrameSpec, encode
from repro_torch.core.pipeline import DecoderConfig, make_decoder


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=20_000, help="bits to send")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev, n = torch.device(args.device), args.n
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bits = torch.randint(0, 2, (n,), generator=gen, device=dev,
                         dtype=torch.int32)

    # transmitter: standard (2,1,7) code, generators 171/133 (paper Fig. 1)
    tx = bpsk(encode(bits, STD_K7))                       # (n, 2)
    # channel: 3 dB Eb/N0
    rx = awgn(tx, 3.0, gen)

    # receiver: the paper's unified kernel (forward + parallel traceback in
    # one launch, survivor paths in shared memory only)
    cfg = DecoderConfig(spec=FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45),
                        backend="kernel")
    out = make_decoder(cfg, dev)(rx, n)
    ref = make_decoder(dataclasses.replace(cfg, backend="reference"),
                       dev)(rx, n)
    assert torch.equal(out, ref), "kernel bits != reference bits"
    rate = ber(out, bits)
    print(f"decoded {n} bits on {dev}, BER = {rate:.2e} @ 3 dB "
          f"(theory ~1e-3); equal to the reference backend's bits")
    return rate


if __name__ == "__main__":
    main()
