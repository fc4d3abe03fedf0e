"""MerCat2 k-mer counting in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (H100).

The port of the ``mercat2_tpu`` count path: the same packed transport,
fid-tagged sort keys, min-count filter and per-file tables, with the two
Pallas kernels of ``mercat2_tpu.ops.pallas_finalize`` replaced by CUDA C++
kernels (``csrc/``) that are compiled with ``nvcc`` at first use. Every
kernel has a plain PyTorch twin in the same module; the twin serves CPU
tensors only, so the CPU tests can hold the port against the JAX package.

Importing this package imports no JAX and compiles nothing. No module of
it imports ``mercat2_tpu``: the host code it shares with the JAX package
(``io/``, ``orf/``, ``metrics/``, ``version.py``) is copied here.
"""

from mercat2_tpu_torch.version import __version__

__all__ = ["__version__"]
