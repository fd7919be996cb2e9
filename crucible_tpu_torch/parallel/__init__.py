"""Sharded rendering and gradients over several devices and processes.

Port of ``crucible_tpu/parallel/``: the image's pixels (or rays) split
over a small grid of devices (:mod:`crucible_tpu_torch.parallel.mesh`),
each position rendering its share with the scene and camera on its own
device, the shares gathered, and gradients summed
(:mod:`crucible_tpu_torch.parallel.render`). Across processes the
gathers and sums are ``torch.distributed`` collectives (``nccl`` between
CUDA devices, ``gloo`` on the CPU); within one process a position is a
loop iteration. Every random number is a hash of (pixel, sample), so a
sharded image equals one device's render bit for bit.
"""
