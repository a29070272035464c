"""Image ops and the launcher modules of the hand-written CUDA kernels."""
