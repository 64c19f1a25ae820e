"""WiSparse block kernels: hand-written CUDA C++ for Hopper (``csrc/``),
their wrappers and launch counts (``sparse_matmul``), plain PyTorch
versions (``ref``) and the projection built on them (``ops``)."""
