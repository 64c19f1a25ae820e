"""WiSparse block kernels: hand-written CUDA C++ for Hopper (``csrc/``),
their wrappers and launch counts (``sparse_matmul``), plain PyTorch
versions (``ref``), the top-k order both sides share (``select``) and
the projection built on them (``ops``)."""
