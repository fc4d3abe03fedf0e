"""Device ops of the count path: plain PyTorch, and the CUDA kernel
wrappers (``build_keys``, ``finalize_kernel``) with their plain twins."""
