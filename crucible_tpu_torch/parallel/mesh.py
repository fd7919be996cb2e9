"""The grid of devices that sharded renders run on, and each position's share.

Axes, as in ``crucible_tpu/parallel/mesh.py``:

- ``dp``: data parallel over pixels (the dominant axis);
- ``sp``: sample parallel, the second axis of the grid.

A :class:`DeviceMesh` lists one device per grid position, row-major over
(dp, sp). Under an initialized process group (``torch.distributed``) the
positions are spread evenly over the processes, each process owning a
contiguous run of them (:meth:`DeviceMesh.local_positions`); without one,
the one process owns them all. A device may stand at several positions,
as the JAX tests' virtual CPU devices do: one card then renders several
shares in turn.

The JAX package's ``NamedSharding`` helpers become ranges:
:func:`ray_sharding` gives each position its slice of a flat axis
(pixels or rays, over dp and sp together). ``replicated`` and
``pixel_sharding`` have no counterpart (ROADMAP, Do not port): a position
builds or receives its own copy of the scene on its device, and the
per-pixel terms of a loss shard over every position as the rays do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
SP_AXIS = "sp"


@dataclass(frozen=True)
class DeviceMesh:
    """A (dp, sp) grid of devices: ``devices`` (dp, sp) of ``torch.device``,
    spread over ``world`` processes of which this one is ``rank``;
    ``group``: whether a process group was initialized when it was made
    (its shares then meet through collectives, even in a world of one)."""

    devices: np.ndarray
    world: int = 1
    rank: int = 0
    group: bool = False

    axis_names = (DP_AXIS, SP_AXIS)

    @property
    def shape(self) -> dict:
        """{dp: rows, sp: columns}, as a JAX mesh's ``shape``."""
        return {DP_AXIS: self.devices.shape[0], SP_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        """The number of grid positions."""
        return int(self.devices.size)

    def device(self, position: int) -> torch.device:
        """The device of flat position ``position`` (row-major over dp, sp)."""
        return self.devices.reshape(-1)[position]

    def local_positions(self) -> range:
        """The flat positions this process renders: all of them without a
        process group, else its contiguous run of ``size / world``."""
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)


def _process_group() -> tuple[int, int]:
    """(world size, rank) of the initialized process group, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _rank_device(rank: int) -> torch.device:
    """The device a process of the group renders on: ``cuda:<local rank>``
    under ``nccl`` (one card a process, ranks in order over a host's
    cards), else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def make_mesh(
    n_devices: Optional[int] = None,
    sample_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """A (dp, sp) grid over ``devices`` (the first ``n_devices`` of them):
    by default, under an initialized process group, one position a
    process, each on its own device (``cuda:<local rank>`` under
    ``nccl``, else the CPU); without one, the local CUDA devices. A list
    may repeat a device. ``sample_parallel`` columns; it must divide the
    device count, and under a process group the processes must divide the
    positions."""
    world, rank = _process_group()
    group = dist.is_available() and dist.is_initialized()
    if devices is None:
        if group:
            devices = [_rank_device(r) for r in range(world)]
        else:
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError(
                    "make_mesh: no CUDA device; name the devices (e.g. devices=['cpu'] * 8)")
            devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % sample_parallel:
        raise ValueError(f"sample_parallel {sample_parallel} must divide the {n} devices")
    if n % world:
        raise ValueError(f"the {world} processes must divide the mesh's {n} positions")
    grid = np.empty((n // sample_parallel, sample_parallel), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // sample_parallel, i % sample_parallel] = dev
    return DeviceMesh(grid, world, rank, group)


def ray_sharding(mesh: DeviceMesh, n: int) -> list[tuple[int, int]]:
    """Each flat position's [lo, hi) of a flat axis of ``n`` entries
    (pixels or rays), over dp and sp together: ``ceil(n / size)`` a
    position, the last ones shorter or empty."""
    per = -(-n // mesh.size)
    return [(min(n, i * per), min(n, (i + 1) * per)) for i in range(mesh.size)]


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Start this process's membership of a process group over
    ``tcp://<coordinator>`` (``host:port``), ``num_processes`` processes of
    which this is ``process_id``: ``nccl`` where CUDA is available (the
    process then renders on ``cuda:<process_id mod cards>``), else
    ``gloo``. Does nothing for one process or fewer, as the JAX package's
    ``jax.distributed`` bring-up."""
    if num_processes is None or num_processes <= 1:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
