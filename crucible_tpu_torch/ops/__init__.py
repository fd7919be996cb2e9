"""Compute ops: closed-form samplers and the hand-written GPU kernels
(``ops/kernels``; sources under ``crucible_tpu_torch/csrc``)."""
