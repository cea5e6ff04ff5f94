"""The receiver call's clip and framing: (n, beta) LLRs -> (F, L, beta)
overlapping frames, zero-padded at the stream's edges, the LLRs clipped on
the way when a ``clip`` is given (NaN and +-Inf -> 0, the rest clamped to
+-clip, as ``core.sanitize`` states the rule).

In the JAX package these are jnp ops that XLA fuses (the clip in
``repro.core.pipeline.make_decoder``, ``repro.core.framed.frame_llr``).
Here one CUDA kernel (``csrc/frame_llr.cu``, whose head note gives the
design) reads each LLR once and writes each framed LLR once:

* ``frame_llr_cuda`` checks, allocates the frames, launches on the current
  stream, raises on any failure and counts ``.launches``;
* ``frame_llr_plain`` is the plain torch version: ``clip_llr_plain`` (ATen's
  isfinite, where and clamp) and then the edge padding and the gather.

At punctured rates a second kernel of the same source, with its own entry
point, takes the (m,) soft-symbol stream in and writes the frames out,
clipped, depunctured through the pattern's ``rank_table`` and padded with
zero rows to B1's tile, in one launch:

* ``frame_punctured_cuda`` checks, allocates, launches, raises on any
  failure and counts ``.launches``;
* ``frame_punctured_plain`` is its plain version, the same definition in
  torch ops.

``repro_torch.core.framed.frame_received``, the receiver call's one front
end, picks between each kernel and its plain version by the tensor's
device, under the ``decode.frame`` span: a CUDA tensor takes the kernel,
with no fallback. Both kernels equal their plain versions bit for bit in
float32, float64, float16 and bfloat16; the frames keep the input's dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.puncture import PATTERNS, check_alignment
from .build import build

__all__ = ["frame_llr_cuda", "frame_llr_plain", "clip_llr_plain", "windows",
           "frame_punctured_cuda", "frame_punctured_plain", "rank_table",
           "kernel_library", "DTYPES"]

SOURCE = "frame_llr.cu"
#: The dtypes the kernel takes, by the code its C interface names them.
DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
          torch.bfloat16: 3}


def kernel_library():
    """Build (at first use) and load the kernel; returns build.Built."""
    built = build(SOURCE)
    lib = built.lib
    if not getattr(lib, "_argtypes_set", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.frame_llr_launch.argtypes = [vp, vp, i, ll, i, ll, i, i, i, i,
                                         ctypes.c_double, ctypes.c_double,
                                         vp]
        lib.frame_llr_launch.restype = i
        lib.frame_punctured_launch.argtypes = [
            vp, vp, i, ll, ll, i, ll, ll, i, i, i, i, i, vp,
            ctypes.c_double, ctypes.c_double, vp]
        lib.frame_punctured_launch.restype = i
        lib._argtypes_set = True
    return built


def windows(x: torch.Tensor, starts: torch.Tensor, length: int,
            dim: int) -> torch.Tensor:
    """Gather windows ``x[starts[i] : starts[i]+length]`` along ``dim``;
    the window axis replaces ``dim`` as (len(starts), length)."""
    idx = starts[:, None] + torch.arange(length, device=x.device)[None, :]
    return x.movedim(dim, 0)[idx].movedim((0, 1), (dim, dim + 1))


def clip_llr_plain(x: torch.Tensor, clip: float) -> torch.Tensor:
    """NaN/Inf -> neutral zero, |x| > clip -> +-clip; the identity on clean
    in-range inputs. A float dtype clamps to the bounds as it holds them,
    which gives what ATen's clamp on the card gives (it compares in float
    and rounds back) and lets float16 clip on the CPU, whose clamp refuses
    a bound past the dtype's range."""
    lo, hi = (_bounds(x.dtype, float(clip)) if x.dtype.is_floating_point
              else (-clip, clip))
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x)
                       ).clamp(lo, hi)


def frame_llr_plain(llr: torch.Tensor, spec,
                    clip: float | None = None) -> torch.Tensor:
    """(n, beta) -> (F, L, beta) frames of ``spec`` (a ``FrameSpec``),
    clipped first when ``clip`` is given."""
    if clip is not None:
        llr = clip_llr_plain(llr, clip)
    n, _ = llr.shape
    F = spec.num_frames(n)
    pad_r = F * spec.f + spec.v2 - n
    padded = torch.nn.functional.pad(llr, (0, 0, spec.v1, pad_r))
    starts = torch.arange(F, device=llr.device) * spec.f
    return windows(padded, starts, spec.frame_len, 0)


@functools.lru_cache(maxsize=None)
def _bounds(dtype: torch.dtype, clip: float) -> tuple[float, float]:
    """The clip's bounds as ``dtype`` holds them (float16 rounds 1e6 to
    inf), which is what ATen's clamp compares with."""
    b = torch.tensor([-clip, clip], dtype=dtype).double()
    return float(b[0]), float(b[1])


def frame_llr_cuda(llr: torch.Tensor, spec,
                   clip: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. The kernel reads the
    stream as one run, so a non-contiguous tensor is copied contiguous
    first."""
    if not llr.is_cuda:
        raise ValueError(f"llr must lie on a CUDA device, got {llr.device}")
    if llr.ndim != 2:
        raise ValueError(f"llr must be (n, beta), got {llr.ndim}-D "
                         f"{tuple(llr.shape)}")
    if llr.dtype not in DTYPES:
        raise ValueError(f"the framing kernel takes "
                         f"{sorted(map(str, DTYPES))}, got {llr.dtype}")
    llr = llr.contiguous()
    n, beta = llr.shape
    F = spec.num_frames(n)
    L = spec.frame_len
    out = torch.empty((F, L, beta), dtype=llr.dtype, device=llr.device)
    if out.numel() == 0:
        return out
    lo, hi = (0.0, 0.0) if clip is None else _bounds(llr.dtype, float(clip))
    lib = kernel_library().lib
    with torch.cuda.device(llr.device):
        stream = torch.cuda.current_stream(llr.device).cuda_stream
        err = lib.frame_llr_launch(
            llr.data_ptr(), out.data_ptr(), DTYPES[llr.dtype], n, beta, F,
            spec.f, spec.v1, L, int(clip is not None), lo, hi, stream)
    if err != 0:
        raise RuntimeError(f"frame_llr launch failed: CUDA error {err}")
    frame_llr_cuda.launches += 1
    return out


frame_llr_cuda.launches = 0


def rank_table(name: str) -> tuple[int, tuple[int, ...]]:
    """The punctured pattern ``name``'s table: the symbols a period keeps,
    and at ``t * beta + b`` (phase t of the period, output b) the rank of
    that symbol among the period's kept ones in the order they are sent
    (stage by stage, output by output), -1 where the pattern drops it.
    Cached by the pattern's contents, so a changed ``PATTERNS`` entry is
    seen by the next call."""
    return _rank_table(tuple(map(tuple, PATTERNS[name].tolist())))


@functools.lru_cache(maxsize=None)
def _rank_table(mask: tuple) -> tuple[int, tuple[int, ...]]:
    table, kept = [], 0
    for t in range(len(mask[0])):
        for row in mask:
            table.append(kept if row[t] else -1)
            kept += int(row[t])
    return kept, tuple(table)


@functools.lru_cache(maxsize=None)
def _c_table(table: tuple):
    return (ctypes.c_byte * len(table))(*table)


def _punctured_rows(stream: torch.Tensor, name: str, n: int, spec,
                    rows: int | None) -> tuple[int, int, int, tuple]:
    """Checks the stream's length against n stages of ``name``; returns
    (F, rows, kept, table): the frames that hold stages, the rows written
    and the pattern's ``rank_table``."""
    kept, table = rank_table(name)
    beta, period = PATTERNS[name].shape
    q, r = divmod(n, period)
    want = q * kept + sum(k >= 0 for k in table[:r * beta])
    if stream.ndim != 1 or stream.shape[0] != want:
        raise ValueError(f"stream length {tuple(stream.shape)} != expected "
                         f"({want},) for {n} stages at rate {name}")
    check_alignment(spec.f, spec.v1, spec.v2, name)
    F = spec.num_frames(n)
    rows = F if rows is None else int(rows)
    if rows < F:
        raise ValueError(f"rows={rows} < the {F} frames of {n} stages")
    return F, rows, kept, table


def frame_punctured_plain(stream: torch.Tensor, name: str, n: int, spec,
                          clip: float | None = None, rows: int | None = None
                          ) -> torch.Tensor:
    """The punctured receiver call's clip, depuncture, framing and padding
    by their definition: (m,) soft symbols of n stages at rate ``name`` ->
    (rows, L, beta) frames of ``spec`` (``rows=None``: the F frames),

        s = m*f - v1 + j,  t = s mod period,
        out[m, j, b] = g(stream[(s div period)*kept + rank[t*beta + b]])
                       where 0 <= s < n, m < F and the pattern keeps (b, t),
                     = 0 otherwise,

    g the clip (``clip_llr_plain``), or the identity when ``clip`` is None;
    the frames keep the stream's dtype. The kernel's plain version, and the
    receiver call's on the CPU and in the reference backend."""
    F, rows, kept, table = _punctured_rows(stream, name, n, spec, rows)
    beta, period = PATTERNS[name].shape
    dev = stream.device
    if clip is not None:
        stream = clip_llr_plain(stream, clip)
    x = torch.cat([stream, stream.new_zeros(1)])
    m = torch.arange(rows, device=dev)[:, None, None]
    s = m * spec.f - spec.v1 + torch.arange(spec.frame_len,
                                            device=dev)[None, :, None]
    b = torch.arange(beta, device=dev)[None, None, :]
    rank = torch.tensor(table, device=dev)[s.remainder(period) * beta + b]
    src = s.div(period, rounding_mode="floor") * kept + rank
    keep = (m < F) & (s >= 0) & (s < n) & (rank >= 0)
    return x[torch.where(keep, src, stream.shape[0])]


def frame_punctured_cuda(stream: torch.Tensor, name: str, n: int, spec,
                         clip: float, rows: int | None = None
                         ) -> torch.Tensor:
    """Launch the punctured framing kernel on the current stream: one read
    of the (m,) soft symbols, one write of the (rows, L, beta) frames,
    rows F.. zero (the tile's padding). A non-contiguous stream is copied
    contiguous first."""
    if not stream.is_cuda:
        raise ValueError(f"stream must lie on a CUDA device, got "
                         f"{stream.device}")
    if stream.dtype not in DTYPES:
        raise ValueError(f"the framing kernel takes "
                         f"{sorted(map(str, DTYPES))}, got {stream.dtype}")
    F, rows, kept, table = _punctured_rows(stream, name, n, spec, rows)
    stream = stream.contiguous()
    beta, period = PATTERNS[name].shape
    L = spec.frame_len
    out = torch.empty((rows, L, beta), dtype=stream.dtype,
                      device=stream.device)
    if out.numel() == 0:
        return out
    lo, hi = _bounds(stream.dtype, float(clip))
    lib = kernel_library().lib
    with torch.cuda.device(stream.device):
        cs = torch.cuda.current_stream(stream.device).cuda_stream
        err = lib.frame_punctured_launch(
            stream.data_ptr(), out.data_ptr(), DTYPES[stream.dtype],
            stream.shape[0], n, beta, F, rows, spec.f, spec.v1, L, period,
            kept, _c_table(table), lo, hi, cs)
    if err != 0:
        raise RuntimeError(f"frame_punctured launch failed: CUDA error "
                           f"{err}")
    frame_punctured_cuda.launches += 1
    return out


frame_punctured_cuda.launches = 0
