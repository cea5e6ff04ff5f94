"""Find a cell and everything it names, by name, from data files.

``BENCHMARK.json`` at the root lists the cells (``workloads``), the
configurations and the metrics. A cell names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, which is
``portbench/traffic/<traffic>.json``. The traffic's ``entry`` names the
client, ``portbench/clients/<entry>.py``; each metric is read by
``portbench/metrics/<name>.py``; a metric ``<base>.<group>``, one
quantity split by a group of cells whose runs spread differently, is
read by ``metrics/<base>.py`` unless it has a file of its own. So a
configuration, a mix of an existing kind or a metric is added with new
files and new entries in ``BENCHMARK.json``, and no edit here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["BENCH_DIR", "Cell", "load_benchmark", "load_cell", "load_module",
           "metric_reader", "metrics_of"]

#: The benchmark's folder under the root.
BENCH_DIR = "portbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload: its entry in ``BENCHMARK.json``, its configuration and
    its traffic, with the root they were read from."""
    name: str
    chips: int
    config: dict
    traffic: dict
    root: Path

    @property
    def code(self):
        """(k, generators as ints, beta)."""
        code = self.config["code"]
        polys = tuple(int(g, 8) for g in code["generators_octal"])
        return int(code["k"]), polys, len(polys)

    @property
    def n(self) -> int:
        return int(self.traffic["bits_per_call"])


def load_benchmark(root) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {path.parent}")
    return json.loads(path.read_text())


def load_cell(root, workload: str) -> Cell:
    """The cell ``workload`` of the benchmark at ``root``."""
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    if int(traffic["chips"]) != int(w["chips"]):
        raise ValueError(f"{workload}: the traffic asks for {traffic['chips']} "
                         f"chips, the cell for {w['chips']}")
    return Cell(workload, int(w["chips"]), config, traffic, root)


def metrics_of(bench: dict, workload: str, kind: str) -> list[dict]:
    """The ``kind`` ('end_to_end' or 'per_layer') metrics that the cell
    reports: those that list it under ``workloads``, and those without the
    key whose ``moves`` (or, end to end, themselves) the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load_module(root, folder: str, name: str):
    """Import ``portbench/<folder>/<name>.py`` under the root from its file."""
    path = Path(root) / BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} module {path}")
    mod_name = f"portbench_{folder}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(root, name: str):
    """The reader module of metric ``name``: its own file, or that of the
    quantity it splits (the name before the first dot)."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{name}.py"
    return load_module(root, "metrics", name if path.is_file()
                       else name.split(".")[0])
