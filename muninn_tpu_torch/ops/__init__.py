"""Distance, top-k and flat-search primitives; the CUDA kernels live in ``csrc/``."""
