"""Block kernels: plain PyTorch versions (``kernels_torch``) and the
hand-written CUDA kernels with their wrappers (``kernels_cuda``)."""
