"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``csrc/`` becomes a shared library with a plain C interface,
compiled for Hopper (``sm_90a``) into ``<repo>/build/kernels/`` at first
use. The file name carries a hash of every source in ``csrc/`` and of the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is compiled when a module is imported; no ``--use_fast_math``
(it would flush denormals and approximate operations, and parity is
bit-exact). ``-Xptxas -v`` keeps the register, shared-memory and spill
report beside the library. ``-split-compile=0`` lets the device compiler
optimise a source's kernel instantiations in parallel, one thread per
core: the two ACS kernels are instantiated per registers-per-lane and
beta (42 each).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["Built", "build", "nvcc_path", "BUILD_DIR", "CSRC", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")


@dataclasses.dataclass
class Built:
    """A loaded kernel library: the ctypes handle, where it lies, how long
    nvcc took in this process (0.0 when it was already built) and nvcc's
    ``-Xptxas -v`` report."""
    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str


_built: dict[str, Built] = {}
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(source: str) -> Built:
    """Compile ``csrc/<source>`` (once per process and content hash) and
    load it. Raises RuntimeError with nvcc's output if the build fails.
    Different sources build concurrently when called from several
    threads; one source is built once."""
    with _locks_guard:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _built:
            return _built[source]
        stem = Path(source).stem
        out = BUILD_DIR / f"lib{stem}-{_digest()}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stdout}"
                                   f"{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)             # atomic against concurrent builds
        log = log_path.read_text() if log_path.exists() else ""
        built = Built(ctypes.CDLL(str(out)), out, seconds, log)
        _built[source] = built
        return built
