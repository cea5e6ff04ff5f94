"""setup_s (s, host clock): from the start of the process to the first
timed call: imports, the CUDA context, the kernels' build or load, the
inputs made on the card and one warm call on every block of the pool."""


def read(run):
    return run.setup_s
