"""Disk-backed table of measured decode-plan timings: port of
``repro.kernels.tunedb``.

``plan_decode`` predicts the best kernel configuration from a model of the
card (kernels/autotune.py); ``plan_decode(measure=True)`` times the top
candidates on the card instead, and this table keeps those timings, keyed
by::

    DecodePlan.fingerprint()  x  platform identity

so a plan is measured once per (hardware, toolchain, code) and every later
process reuses the timing. The platform identity (``platform_id``) is the
backend (``cuda`` or ``cpu``), the device's name and the torch and CUDA
versions, in place of the JAX package's ``jax_version``; on a card also
the kernel build (``build._digest()``, a hash of the CUDA sources and the
nvcc flags), so a row measured on one build of the kernels is never
handed to another.

The file format is the JAX package's, schema ``repro.tunedb/v1``
(``{"schema": ..., "platforms": {platform_key: {fingerprint: record}}}``):
a file written by the JAX ``TuneDB`` loads here and keeps its rows, which
sit under their own platform keys. The contract is the same:

* a second process with the same fingerprint and platform reuses the
  cached timing, visible as ``tunedb_hits`` tracer counters and in
  ``TuneDB.stats()``;
* a changed fingerprint or device re-measures;
* a corrupt, truncated or foreign file is discarded with a
  ``TuneDBWarning``, never a crash, and the next ``put`` rewrites it;
* writes are atomic (tmp + fsync + ``os.replace``) and merge with what is
  on disk first, so concurrent writers keep each other's rows.

The location is ``$REPRO_TUNE_DB`` when set, else
``~/.cache/repro_viterbi/tunedb.json`` (``default_path``), the JAX
package's file: each package reads and writes its own platform rows.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import warnings

import torch

from ..obs.tracer import get_tracer

__all__ = ["TuneDB", "TUNE_DB", "TuneDBWarning", "platform_id",
           "platform_key", "default_path", "SCHEMA", "ENV_PATH"]

SCHEMA = "repro.tunedb/v1"

#: Env var overriding the DB file location.
ENV_PATH = "REPRO_TUNE_DB"


class TuneDBWarning(UserWarning):
    """A tune-DB file could not be used (corrupt / wrong schema) and was
    discarded."""


def platform_id(device=None) -> dict:
    """The identity of the device plans are measured on: the hardware half
    of every tune-DB key. ``device=None`` is the card when there is one,
    else the CPU."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    pid = {"backend": dev.type, "device_kind": dev.type,
           "torch_version": torch.__version__,
           "cuda_version": str(torch.version.cuda)}
    if dev.type == "cuda":
        from .build import _digest
        pid["device_kind"] = torch.cuda.get_device_name(dev)
        pid["kernel_build"] = _digest()
    return pid


def platform_key(platform: dict | None = None) -> str:
    """Flatten a platform identity into the string the DB is keyed by. A
    JAX platform (with ``jax_version``) gets the JAX package's own key, so
    its rows are found under the key JAX wrote them with; a card's key
    ends with its kernel build."""
    p = platform or platform_id()
    if "jax_version" in p:
        version = p["jax_version"]
    else:
        version = (f"torch{p.get('torch_version', '?')}"
                   f"-cuda{p.get('cuda_version', '?')}")
        if p.get("kernel_build"):
            version += f"-build{p['kernel_build']}"
    return f"{p['backend']}/{p['device_kind']}/{version}"


def default_path() -> str:
    env = os.environ.get(ENV_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_viterbi",
                        "tunedb.json")


class TuneDB:
    """Thread-safe, process-shared table of measured plan timings.

    Rows live under ``data[platform_key][fingerprint]`` as plain JSON
    dicts. ``get`` counts hits and misses (here and as the tracer's
    ``tunedb_hits`` / ``tunedb_misses``); ``record_measure`` counts timing
    passes (``tunedb_measures``)."""

    def __init__(self, path: str | None = None):
        self._path = path
        self._lock = threading.Lock()
        self._data: dict | None = None      # loaded at first access
        self.hits = 0
        self.misses = 0
        self.measures = 0

    @property
    def path(self) -> str:
        return self._path or default_path()

    def _read_file(self) -> dict:
        """The on-disk table; a missing file is empty, a bad file is a
        TuneDBWarning and empty."""
        path = self.path
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
                raise ValueError(
                    f"schema is {doc.get('schema')!r} (expected {SCHEMA!r})"
                    if isinstance(doc, dict) else
                    f"document is {type(doc).__name__}, expected an object")
            table = doc.get("platforms", {})
            if not isinstance(table, dict) or not all(
                    isinstance(v, dict) for v in table.values()):
                raise ValueError("'platforms' is not a table of tables")
            return table
        except (OSError, ValueError, TypeError) as e:
            warnings.warn(
                f"tune DB at {path} is unusable ({e.__class__.__name__}: "
                f"{e}); discarding it — plans will be re-measured and the "
                f"next write replaces the file", TuneDBWarning,
                stacklevel=3)
            return {}

    def _write_file(self, table: dict) -> None:
        """Atomic tmp + fsync + replace: a reader never sees a torn file."""
        path = self.path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   prefix=".tunedb-")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({"schema": SCHEMA, "platforms": table}, fh,
                          indent=1, sort_keys=True)
                fh.write("\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _table(self) -> dict:
        if self._data is None:
            self._data = self._read_file()
        return self._data

    def get(self, fingerprint: str, platform: dict | None = None) -> dict | None:
        """The measured record for (plan, platform), or None."""
        key = platform_key(platform)
        with self._lock:
            rec = self._table().get(key, {}).get(fingerprint)
            if rec is not None:
                self.hits += 1
            else:
                self.misses += 1
        get_tracer().count("tunedb_hits" if rec is not None
                           else "tunedb_misses")
        return rec

    def put(self, fingerprint: str, record: dict,
            platform: dict | None = None) -> dict:
        """Persist one record, merged with what is on disk first. Returns
        the stored record."""
        key = platform_key(platform)
        record = dict(record)
        record.setdefault("measured_at", time.time())
        with self._lock:
            table = self._read_file()       # fresh merge base
            for pk, rows in (self._data or {}).items():
                table.setdefault(pk, {}).update(
                    {fp: r for fp, r in rows.items()
                     if fp not in table.get(pk, {})})
            table.setdefault(key, {})[fingerprint] = record
            self._write_file(table)
            self._data = table
        return record

    def record_measure(self, n: int = 1) -> None:
        """Count a real timing pass (the expensive thing the DB avoids)."""
        with self._lock:
            self.measures += n
        get_tracer().count("tunedb_measures", n)

    def invalidate(self) -> None:
        """Drop the in-memory table and delete the file."""
        with self._lock:
            self._data = {}
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def stats(self) -> dict:
        with self._lock:
            table = self._table()
            return {"path": self.path,
                    "platforms": len(table),
                    "entries": sum(len(v) for v in table.values()),
                    "hits": self.hits, "misses": self.misses,
                    "measures": self.measures}


#: Process-global default instance (``plan_decode(measure=True)`` uses it
#: unless handed another). Nothing is read until the first lookup.
TUNE_DB = TuneDB()
