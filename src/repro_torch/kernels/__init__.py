"""Hand-written CUDA kernels for Hopper and their plain torch versions
(port of ``repro.kernels``).

Submodules are imported on first use, as in the JAX package:
``core.pipeline`` reaches ``kernels.block``, which imports ``core.framed``,
so an eager import here would re-enter ``repro_torch.core`` mid-import.
Importing a submodule builds nothing; a kernel is compiled at its first
launch.
"""
import importlib

_SUBMODULES = ("acs", "autotune", "block", "build", "framing", "ops",
               "packing", "ref", "tables", "traceback_frames", "tunedb",
               "viterbi_fwd", "viterbi_unified")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
