"""Point-cloud ops and the wrappers of the CUDA kernels."""
