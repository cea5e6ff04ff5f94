"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference loads nothing of the port."""
import json
import os
import subprocess
import sys

from portbench_tmp import ROOT, one_thread  # noqa: F401

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_jax_package():
    names = _loaded(
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('pb_run', "
        f"{str(ROOT / 'portbench' / 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "import portbench.harness, portbench.control, portbench.cells\n"
        "import portbench.reference.channel, portbench.reference.viterbi\n"
        "from portbench.cells import load_benchmark, load_cell, load_module, "
        "metric_reader\n"
        f"root = {str(ROOT)!r}\n"
        "bench = load_benchmark(root)\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    metric_reader(root, m['name'])\n"
        "for w in bench['workloads']:\n"
        "    load_module(root, 'clients', "
        "load_cell(root, w['name']).traffic['entry'])\n"
        "import repro_torch.core.pipeline, repro_torch.distributed.stream\n")
    assert "repro_torch" in names and "portbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded("import portbench.reference.channel\n"
                    "import portbench.reference.viterbi")
    assert "torch" in names
    assert "repro_torch" not in names
    assert not names & FORBIDDEN


def test_run_refuses_without_a_card_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "k7_r12_batch",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_refuses_beside_nothing_but_the_benchmark(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "k7_r12_batch",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout == ""
