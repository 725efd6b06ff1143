"""Device stages of the dense global path and their CUDA kernels."""
