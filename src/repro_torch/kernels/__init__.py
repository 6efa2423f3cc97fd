"""Hand-written CUDA kernels, built at first use by ``_build``."""
