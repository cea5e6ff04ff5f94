"""Cases shared by the framing kernels' CPU and card tests
(tests/test_torch_framing.py, tests/test_torch_gpu_framing.py and, for the
punctured receiver call, tests/test_torch_punctured_framing.py and
tests/test_torch_gpu_punctured.py); imports no JAX.

``llr_case`` makes an (n, beta) LLR stream with NaN, +-Inf, +-2e6, +-1e6
and -0.0 planted on the first and last rows of every frame's window and of
its kept stages. ``todays_frames`` is the receiver call's clip and framing
as they ran on the card before the kernel: ATen's isfinite, where and
clamp, then the frame windows written out from their definition (row
``m*f - v1 + j`` of the stream, zero past either end). ``bits`` views a
float tensor as the integers of its bits, so that -0.0 and the payload of
a NaN count.

The punctured cases: ``PUNCTURED`` names each rate's frame (the
k7_r34_batch cell's at rate 3/4), ``punctured_length`` a stream of n
stages with each tail ``n % period`` and two short ones, ``symbols_case``
the (m,) soft symbols of n stages with the same values planted, and
``todays_punctured_frames`` the receiver call's chain as it ran on the
card before the punctured kernel: ``clip_llr_plain`` (unless ``clip`` is
False), ``depuncture``, ``frame_llr_plain``, then zero rows up to
``rows``.
"""
import numpy as np
import torch

from repro_torch.core.framed import FrameSpec
from repro_torch.core.puncture import PATTERNS, depuncture
from repro_torch.core.sanitize import LLR_CLIP
from repro_torch.kernels import framing

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
_CELL = FrameSpec(f=256, v1=20, v2=45, f0=32, v2s=45)
#: The k7_r12 cells' frame at beta 2, the Galileo cell's at beta 4, and a
#: blocked frame (four blocks of 64 stages, overlap 24) at beta 3.
SPECS = {"k7_cell": (_CELL, 2), "galileo_cell": (_CELL, 4),
         "blocked_b3": (FrameSpec(f=256, v1=20, v2=45).blocked(4, 24), 3)}
#: Stream lengths: a multiple of f, a ragged last frame, n < f, n < v1.
LENGTHS = ["multiple", "ragged", "below_f", "below_v1"]
PLANTED = [np.nan, np.inf, -np.inf, 2e6, -2e6, LLR_CLIP, -LLR_CLIP, -0.0]
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def stream_length(spec: FrameSpec, kind: str) -> int:
    return {"multiple": 5 * spec.f, "ragged": 3 * spec.f + 37,
            "below_f": spec.f - 3, "below_v1": spec.v1 - 5}[kind]


def llr_case(spec: FrameSpec, beta: int, n: int, dtype: torch.dtype,
             seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = 3.0 * rng.standard_normal((n, beta))
    rows = []
    for m in range(spec.num_frames(n)):
        first = m * spec.f - spec.v1
        rows += [first, first + spec.frame_len - 1, m * spec.f,
                 m * spec.f + spec.f - 1]
    rows = [r for r in rows if 0 <= r < n]
    for i, r in enumerate(rows):
        x[r, i % beta] = PLANTED[i % len(PLANTED)]
    return torch.from_numpy(x).to(dtype)


def todays_clip(x: torch.Tensor) -> torch.Tensor:
    """The receiver call's clip before the kernel, in the arithmetic of
    ATen's clamp on the card: float for float16 and bfloat16, rounded back
    (the CPU's clamp refuses 1e6 in float16)."""
    y = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    y = torch.where(torch.isfinite(y), y, torch.zeros_like(y)
                    ).clamp(-LLR_CLIP, LLR_CLIP)
    return y.to(x.dtype)


def todays_frames(x: torch.Tensor, spec: FrameSpec,
                  clip: bool) -> torch.Tensor:
    if clip:
        x = todays_clip(x)
    n, beta = x.shape
    rows = (np.arange(spec.num_frames(n))[:, None] * spec.f - spec.v1
            + np.arange(spec.frame_len)[None, :])
    inside = torch.from_numpy((rows >= 0) & (rows < n))
    out = torch.zeros((rows.shape[0], spec.frame_len, beta), dtype=x.dtype,
                      device=x.device)
    out[inside.to(x.device)] = x[torch.from_numpy(rows).to(x.device)[
        inside.to(x.device)]]
    return out


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(_BITS[t.element_size()])


#: Each punctured rate's frame: multiples of the period, and at rate 3/4
#: the 802.11 cell's (portbench/configs/wifi_k7_r34.json).
PUNCTURED = {"2/3": FrameSpec(f=256, v1=20, v2=46, f0=32, v2s=46),
             "3/4": FrameSpec(f=252, v1=21, v2=45, f0=42, v2s=45)}
#: (rate, length): every tail n % period, then n < f and n < v1.
PUNCTURED_LENGTHS = [(rate, f"tail{t}") for rate in PUNCTURED
                     for t in range(PATTERNS[rate].shape[1])] + [
    (rate, kind) for rate in PUNCTURED for kind in ("below_f", "below_v1")]


def punctured_length(rate: str, kind: str) -> int:
    spec, period = PUNCTURED[rate], PATTERNS[rate].shape[1]
    if kind.startswith("tail"):
        return 5 * spec.f + 7 * period + int(kind[4:])
    return stream_length(spec, kind)


def symbols(rate: str, n: int) -> int:
    """The soft symbols the pattern keeps of n stages."""
    pattern = PATTERNS[rate]
    return int(np.tile(pattern, (1, -(-n // pattern.shape[1]))).T[:n].sum())


def symbols_case(rate: str, n: int, dtype: torch.dtype,
                 seed: int = 0) -> torch.Tensor:
    """(m,) soft symbols with the values of PLANTED on the first symbol of
    the first and last stages of each frame's window and kept stages, and
    on every 17th symbol."""
    spec = PUNCTURED[rate]
    rng = np.random.default_rng(seed)
    m = symbols(rate, n)
    x = 3.0 * rng.standard_normal(m)
    stages = [s for k in range(spec.num_frames(n)) for s in
              (k * spec.f - spec.v1, k * spec.f - spec.v1 + spec.frame_len - 1,
               k * spec.f, k * spec.f + spec.f - 1) if 0 <= s < n]
    at = [symbols(rate, s) for s in stages] + list(range(0, m, 17))
    for i, a in enumerate(a for a in at if a < m):
        x[a] = PLANTED[i % len(PLANTED)]
    return torch.from_numpy(x).to(dtype)


def todays_punctured_frames(x: torch.Tensor, rate: str, n: int,
                            rows: int | None = None,
                            clip: bool = True) -> torch.Tensor:
    spec = PUNCTURED[rate]
    if clip:
        x = framing.clip_llr_plain(x, LLR_CLIP)
    frames = framing.frame_llr_plain(depuncture(x, rate, n), spec)
    extra = 0 if rows is None else rows - frames.shape[0]
    return torch.nn.functional.pad(frames, (0, 0, 0, 0, 0, extra))
