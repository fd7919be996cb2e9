"""Hand-written GPU kernels (CUDA C++ for sm_90a, sources in ``csrc/``),
each beside the plain PyTorch version of the same function.

Port of ``crucible_tpu/ops/pallas``: ``megakernel`` (K1 forward, K2
record), ``replay_kernel`` (K4 replay forward, K3 replay backward),
``sphere_hit`` (K10 closest hit) and ``sphere_shade`` (K9 fused hit +
fetch). ``build`` compiles and loads the sources.
"""
