"""Observability: profiler traces and throughput counters (port of
``crucible_tpu/utils/profiling.py``).

:func:`trace` wraps a render in ``torch.profiler.profile`` and writes a
Chrome trace (viewable in Perfetto or ``chrome://tracing``);
:class:`RenderStats` counts rays, seconds and passes and prints them as one
JSON line with the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the body (host activity, and on a card its kernels) and
    write ``<log_dir>/trace_<pid>_<ns>.json``, a Chrome trace. Does nothing
    when ``log_dir`` is empty or None. A card's work is synchronized before
    the trace closes, so that its kernels are in it."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class RenderStats:
    """Accumulates per-pass throughput; printable as a JSON line."""

    rays: int = 0
    seconds: float = 0.0
    passes: int = 0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self, rays: int) -> None:
        self.seconds += time.time() - self._t0
        self.rays += rays
        self.passes += 1

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def json(self) -> str:
        return json.dumps(
            dict(
                rays=self.rays,
                seconds=round(self.seconds, 3),
                passes=self.passes,
                rays_per_sec=round(self.rays_per_sec, 1),
            )
        )
