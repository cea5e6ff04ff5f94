"""Batched LM serving example on the PyTorch port (continuous batching,
slot-based).

This is the LANGUAGE-MODEL scaffolding demo (repro_torch.launch.serve,
token-by-token decode of transformer requests). The Viterbi decode
service is ``repro_torch.serve`` / examples/torch_serve_viterbi.py.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

Extra arguments are passed on to ``repro_torch.launch.serve``.
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(["--arch", "qwen3_32b", "--requests", "6", "--slots", "4",
          "--gen", "12"] + sys.argv[1:])
