"""Sharded frame decode: port of ``repro.distributed.stream``.

Frames are independent (core/framed.py), so the decode spreads across
cards by splitting the frame axis: each card decodes a contiguous, equal
share of a chunk's frames with its own ordinary frame decoder (reference,
unified kernel or split kernels), and the bits come back to the mesh's
first card, the *home* device, where the caller's tensors live.

A ``FrameMesh`` is this package's counterpart of the JAX package's 1-D
``'frames'`` mesh: a tuple of devices. A device may appear more than once
(the counterpart of ``--xla_force_host_platform_device_count``): a mesh of
``["cpu"] * 4`` decodes in four shards on the host, ``["cuda:0"] * 2`` in
two shards on one card.

Nothing on the decode path waits on the host, and no card waits on
another's decode. Every shard is first copied to its card, then launched
on that card's current stream; an event recorded there makes the home
card's current stream wait before it copies the shard's bits back. The chunk size from ``kernels.autotune.plan_decode(num_devices=
mesh.size)`` is a multiple of tiles x devices, so each card gets whole
kernel tiles; the tile plan itself is per card and does not change.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from ..core.pipeline import DecoderConfig
from ..kernels.ops import resolve_device
from ..obs.profiled import span_tracer

__all__ = ["FrameMesh", "frame_mesh", "make_sharded_frame_decoder"]


def normalise_device(device) -> torch.device:
    """``resolve_device`` with the CUDA index made explicit: ``"cuda"`` is
    ``cuda:<current>``, so one card never has two names."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class FrameMesh:
    """The devices a chunk's frames are split across, in shard order.
    ``devices[0]`` is the home device: inputs are framed and outputs
    returned there. Hashable, so plan-cache entries key on it."""
    devices: tuple

    def __post_init__(self):
        devs = tuple(normalise_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a FrameMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def frame_mesh(devices=None) -> FrameMesh:
    """A mesh over the given devices, or over every local card
    (``cuda:0 ... cuda:n-1``). Without a card and without ``devices`` it
    raises: there is no CPU mesh unless the caller names one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; name the mesh's devices, "
                "e.g. frame_mesh(['cpu'] * 4)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return FrameMesh(tuple(devices))


def make_sharded_frame_decoder(cfg: DecoderConfig,
                               mesh: FrameMesh | None = None):
    """Returns decode_frames((F, L, beta)) -> (F, f) bits on the mesh's
    home device, frame-sharded.

    F is padded with zero frames to a multiple of the mesh size (the
    padding's bits are dropped). Shard i is frames [i F'/n, (i+1) F'/n) and
    runs through ``PLAN_CACHE.frame_decoder(cfg, device=devices[i])``, so
    every backend shards the same way.

    Each call runs under a ``shard`` span (attribute ``call``, the
    decoder's sequence number of the call): ``shard.out`` (the padding and
    the copies out of the home card), one ``shard.decode`` a card
    (attribute ``card``; the card's frame decoder runs inside it) and
    ``shard.gather`` (the waits on the cards' events and the copies
    back)."""
    from ..serve.plan_cache import PLAN_CACHE
    mesh = frame_mesh() if mesh is None else mesh
    if not isinstance(mesh, FrameMesh):
        raise TypeError(f"mesh must be a FrameMesh, got {type(mesh).__name__}")
    home, n = mesh.home, mesh.size
    local = [PLAN_CACHE.frame_decoder(cfg, device=d) for d in mesh.devices]

    calls = itertools.count()

    def decode_frames(frames) -> torch.Tensor:
        trace = span_tracer()
        with trace.span("shard", call=next(calls)):
            with trace.span("shard.out"):
                frames = torch.as_tensor(frames).to(home)
                F = frames.shape[0]
                if n > 1 and F > 0:
                    Fp = -(-F // n) * n
                    if Fp != F:
                        frames = torch.nn.functional.pad(
                            frames, (0, 0, 0, 0, 0, Fp - F))
                    per = Fp // n
                    # three passes, so no card waits on another's decode:
                    # every copy out of the home card is queued on its
                    # stream before the home card's own shard, and the home
                    # stream waits on the shards only after every launch
                    shards = [frames[i * per:(i + 1) * per].to(
                        dev, non_blocking=True)
                        for i, dev in enumerate(mesh.devices)]
            if n == 1 or F == 0:
                with trace.span("shard.decode", card=0):
                    return local[0](frames)
            launched = []
            for card, (dev, fn, shard) in enumerate(zip(mesh.devices, local,
                                                        shards)):
                with trace.span("shard.decode", card=card):
                    if dev.type != "cuda":
                        launched.append((fn(shard), None))
                        continue
                    with torch.cuda.device(dev):
                        bits = fn(shard)
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(dev))
                    launched.append((bits, done))
            with trace.span("shard.gather"):
                bits = launched[0][0]
                out = torch.empty((Fp,) + tuple(bits.shape[1:]),
                                  dtype=bits.dtype, device=home)
                for i, (bits, done) in enumerate(launched):
                    if done is not None:
                        torch.cuda.current_stream(home).wait_event(done)
                    out[i * per:(i + 1) * per].copy_(bits, non_blocking=True)
                return out[:F]

    return decode_frames
