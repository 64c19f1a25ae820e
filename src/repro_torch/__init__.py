"""PyTorch/CUDA port of the WiSparse serving stack.

A second package beside the JAX reference (``src/repro``), with the same
module layout (``configs``, ``models``, ``core``, ``sparsity``,
``kernels``, ``serving``, ``obs``, ``launch``).  It imports ``torch`` and
never JAX or the JAX package; the parity tests are the only code that
imports both.  The two WiSparse kernels on the serving path are
hand-written CUDA C++ for Hopper (``kernels/csrc``), built with ``nvcc``
at first use.
"""
