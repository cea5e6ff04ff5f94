"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a harness
driven by the cells of ``BENCHMARK.json``, its plain reference and the
readers of its metrics. See README.md."""
