"""repro_torch — the PyTorch / CUDA port of the MPKLink reproduction.

A second package beside ``repro`` (the JAX reference). It imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``. Every Pallas kernel on a
ported path is a hand-written CUDA kernel for Hopper (``sm_90a``) under
``repro_torch/kernels/csrc``, with a plain PyTorch version beside it that
runs for tensors on the CPU.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; the tests pass ``device="cpu"``.
"""

__version__ = "0.1.0"
