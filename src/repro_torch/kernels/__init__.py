"""Hand-written CUDA C++ kernels of the port (``csrc/``), their wrappers,
their plain PyTorch versions and the device policy between them."""
