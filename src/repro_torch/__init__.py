"""PyTorch + CUDA port of the memory-efficient parallel Viterbi decoder.

Pairs module for module with the JAX package ``repro`` (``repro.X.Y`` ->
``repro_torch.X.Y``), which stays the reference. This package imports
``torch`` and ``numpy`` (``scipy`` in ``channel.sim``) and nothing of JAX
or of ``repro``. Its kernels are hand-written CUDA for Hopper (``sm_90a``),
built from ``kernels/csrc`` at first use; each has a plain torch version
beside it, which is what runs for tensors on the CPU.
"""
