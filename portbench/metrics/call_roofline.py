"""call_roofline (%, device trace), layer "kernels": the least time the
whole call's decode work needs on the card, over the device time per call
of every kernel the call launches (summed over the cards).

The least time is the larger of two terms, counted from the code and the
call's size alone, whatever tile, radix, mapping or fusion implements it:

* operations: six ACS operations (two candidate adds, compare, select, the
  maximum's compare, the normalising subtract) per state and framed stage,
  6 S F L, over the card's float32 rate outside the tensor cores;
* bytes: the stream's LLRs read once (n beta llr_bytes) and the int32 bits
  written once (4 n), over the card's memory bandwidth.
"""
from portbench.timeline import is_copy

ACS_OPS = 6
BIT_BYTES = 4
LLR_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
#: Published peaks (NVIDIA's H100 SXM data sheet, dense), which assume the
#: card's full 700 W power limit: float32 op/s outside the tensor cores,
#: and HBM bytes/s.
PEAKS = {"NVIDIA H100 80GB HBM3": {"f32_ops": 67e12, "hbm_bytes": 3.35e12,
                                   "power_limit_w": 700}}


def call_work(config: dict, n: int):
    """(operations, bytes) of decoding n bits of the configuration's code
    in its frame."""
    code, fr = config["code"], config["frame"]
    S = 1 << (int(code["k"]) - 1)
    beta = len(code["generators_octal"])
    F = -(-n // fr["f"])
    L = fr["v1"] + fr["f"] + fr["v2"]
    ops = ACS_OPS * S * F * L
    nbytes = n * beta * LLR_BYTES[config["llr_dtype"]] + n * BIT_BYTES
    return ops, nbytes


def least_seconds(config: dict, n: int, kind: str):
    """(seconds, 'operations' | 'bytes') on one card of ``kind``."""
    peak = PEAKS[kind]
    ops, nbytes = call_work(config, n)
    t_ops, t_bytes = ops / peak["f32_ops"], nbytes / peak["hbm_bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def read(run):
    tr = run.trace
    if tr is None or tr.device_kind not in PEAKS:
        return None
    kernel_us = sum(e.us for e in tr.events if not is_copy(e.name))
    if kernel_us <= 0:
        return None
    least, _ = least_seconds(run.cell.config, run.cell.n, tr.device_kind)
    return 100.0 * least / (kernel_us * 1e-6 / tr.calls)
