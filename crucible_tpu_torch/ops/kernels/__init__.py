"""Hand-written GPU kernels (CUDA C++ for sm_90a, sources in ``csrc/``),
each beside the eager-torch version of the same function.

Port of ``crucible_tpu/ops/pallas``: ``megakernel`` replaces the Pallas
megakernel's forward mode. ``build`` compiles and loads the sources.
"""
