"""The split path's traceback: survivor stream + argmax in device memory ->
decoded bits (the second half of the paper's Table I row b).

In the JAX package this step is an XLA scan outside Pallas
(``repro.core.traceback.*_frames``); here it is a CUDA kernel
(``csrc/traceback_frames.cu``) so that the split path's time is the
survivor round trip through device memory and not a Python loop of small
launches. Its plain version is ``core.traceback.*_frames``.

* ``traceback_frames`` dispatches by the tensor's device: a CUDA tensor to
  the kernel, a CPU tensor to the plain version, no fallback;
* ``traceback_frames_cuda`` checks, allocates the (F, f) bits, launches on
  the current stream, raises on any failure and counts ``.launches``;
* ``traceback_frames_plain`` picks the plain serial or parallel chase.

Geometry as the unified kernel takes it: ``nsub = f // f0`` cursors per
frame, cursor q starting at stage ``v1 + (q+1)*f0 - 1 + v2s``; the serial
traceback is the one cursor ``f0 = f, v2s = L - v1 - f`` starting from the
last stage's argmax.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.traceback import parallel_traceback_frames, serial_traceback_frames
from ..core.trellis import Trellis
from .build import build
from .packing import Layout, packed_width

__all__ = ["traceback_frames", "traceback_frames_cuda",
           "traceback_frames_plain", "kernel_library", "THREADS"]

SOURCE = "traceback_frames.cu"
#: Threads per block of the traceback kernel (one cursor each).
THREADS = 256


def kernel_library():
    """Build (at first use) and load the kernel; returns build.Built."""
    built = build(SOURCE)
    lib = built.lib
    if not getattr(lib, "_argtypes_set", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.traceback_frames_launch.argtypes = (
            [vp] * 3 + [ctypes.c_longlong] + [i] * 11 + [vp])
        lib.traceback_frames_launch.restype = i
        lib._argtypes_set = True
    return built


def _geometry(sel, amax, trellis, v1, f, f0, v2s, start, packed, layout):
    """Validate; returns (layout, F, L)."""
    lay = Layout(layout)
    if amax.ndim != 2:
        raise ValueError(f"amax must be (F, L), got {tuple(amax.shape)}")
    F, L = amax.shape
    S = trellis.num_states
    row = packed_width(S) if packed else S
    want = ((L * row, F) if packed else (L, S, F)) if lay is Layout.SUBLANE \
        else (F, L, row)
    if tuple(sel.shape) != want:
        raise ValueError(f"sel must be {want} for layout={lay.value} "
                         f"packed={packed}, got {tuple(sel.shape)}")
    if f0 < 1 or f % f0 or v2s < 0 or v1 < 0 or v1 + f + v2s > L:
        raise ValueError(f"need f % f0 == 0 and v1 + f + v2s <= L, got "
                         f"v1={v1} f={f} f0={f0} v2s={v2s} L={L}")
    if start not in ("boundary", "fixed"):
        raise ValueError(f"start must be 'boundary' or 'fixed', got {start!r}")
    return lay, F, L


def traceback_frames(sel: torch.Tensor, amax: torch.Tensor, *,
                     trellis: Trellis, v1: int, f: int, f0: int, v2s: int,
                     start: str = "boundary", packed: bool = False,
                     layout: str = "lane") -> torch.Tensor:
    """(sel, amax) of ``forward_frames`` -> (F, f) int32 bits."""
    kw = dict(trellis=trellis, v1=v1, f=f, f0=f0, v2s=v2s, start=start,
              packed=packed, layout=layout)
    if sel.is_cuda:
        return traceback_frames_cuda(sel, amax, **kw)
    if sel.device.type != "cpu":
        raise ValueError(f"no traceback kernel for device {sel.device}")
    return traceback_frames_plain(sel, amax, **kw)


def traceback_frames_cuda(sel: torch.Tensor, amax: torch.Tensor, *,
                          trellis: Trellis, v1: int, f: int, f0: int,
                          v2s: int, start: str = "boundary",
                          packed: bool = False,
                          layout: str = "lane") -> torch.Tensor:
    """Launch the CUDA kernel. ``sel`` may be a frame slice of a sublane
    stream (``sel[..., :F]``): its rows are read at their stride."""
    lay, F, L = _geometry(sel, amax, trellis, v1, f, f0, v2s, start, packed,
                          layout)
    if not (sel.is_cuda and amax.device == sel.device):
        raise ValueError(f"sel and amax must lie on one CUDA device, got "
                         f"{sel.device} and {amax.device}")
    if sel.dtype != (torch.int32 if packed else torch.int8) \
            or amax.dtype != torch.int32:
        raise ValueError(f"sel must be {'int32' if packed else 'int8'} and "
                         f"amax int32, got {sel.dtype} and {amax.dtype}")
    if not amax.is_contiguous():
        raise ValueError("amax must be contiguous")
    ld = 0
    if lay is Layout.SUBLANE:
        ld = sel.stride(-2)
        if sel.stride(-1) != 1 or (sel.ndim == 3
                                   and sel.stride(0) != sel.shape[1] * ld):
            raise ValueError("a sublane sel must have unit frame stride and "
                             "evenly strided rows")
    elif not sel.is_contiguous():
        raise ValueError("a lane sel must be contiguous")
    if not 2 <= trellis.k <= 11:
        raise ValueError(f"the CUDA kernel takes 2 <= k <= 11, got "
                         f"k={trellis.k}")
    dev = sel.device
    out = torch.empty((F, f), dtype=torch.int32, device=dev)
    if F == 0:
        return out
    lib = kernel_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.traceback_frames_launch(
            sel.data_ptr(), amax.data_ptr(), out.data_ptr(), ld, F, L,
            trellis.k, v1, f, f0, v2s, int(packed),
            int(lay is Layout.SUBLANE), int(start == "fixed"), THREADS,
            stream)
    if err != 0:
        raise RuntimeError(f"traceback_frames launch failed: CUDA error "
                           f"{err}")
    traceback_frames_cuda.launches += 1
    return out


traceback_frames_cuda.launches = 0


def traceback_frames_plain(sel: torch.Tensor, amax: torch.Tensor, *,
                           trellis: Trellis, v1: int, f: int, f0: int,
                           v2s: int, start: str = "boundary",
                           packed: bool = False,
                           layout: str = "lane") -> torch.Tensor:
    """``core.traceback``'s serial chase for the one cursor that starts at
    the last stage from its argmax, the parallel chase otherwise."""
    lay, _, L = _geometry(sel, amax, trellis, v1, f, f0, v2s, start, packed,
                          layout)
    if f0 == f and start == "boundary" and v1 + f + v2s == L:
        return serial_traceback_frames(sel, amax, trellis, v1, f,
                                       packed=packed, layout=lay)
    return parallel_traceback_frames(sel, amax, trellis, v1, f, f0, v2s,
                                     start, packed=packed, layout=lay)
