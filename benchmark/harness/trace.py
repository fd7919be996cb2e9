"""The traced run: ``torch.profiler`` over the window, and what the
per-layer metrics read from its Chrome trace.

The profiler records the host's operators (and the benchmark's own spans,
``torch.profiler.record_function``) and the device's kernels, copies and
fills. :class:`Trace` keeps the device's intervals and the host's spans;
the readers in ``benchmark/metrics/`` take their numbers from it.
"""

from __future__ import annotations

import heapq
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Trace:
    """Device events (name, start us, duration us, category), host spans
    (name, start us, duration us) and the traced window's host-clock
    seconds."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window_s: float = 0.0

    def kernels(self, pattern: str | None = None) -> list:
        rx = re.compile(pattern) if pattern else None
        return [e for e in self.device
                if e[3] == "kernel" and (rx is None or rx.search(e[0]))]

    def kernel_s(self, pattern: str | None = None) -> float:
        return sum(e[2] for e in self.kernels(pattern)) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device's intervals, in time order."""
        out = []
        for _, ts, dur, _ in sorted(self.device, key=lambda e: e[1]):
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], ts + dur)
            else:
                out.append([ts, ts + dur])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        between device intervals summed by what the host was doing at each
        gap's midpoint (its innermost span there)."""
        by_op: dict = {}
        for name, _, dur, _ in self.device:
            by_op[name] = by_op.get(name, 0.0) + dur * 1e-6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:]) if b1[0] > b0[1]]
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        spans = sorted(self.host, key=lambda e: e[1])
        idle: dict = {}
        heap: list = []
        k = 0
        for mid, length in mids:
            while k < len(spans) and spans[k][1] <= mid:
                name, ts, dur = spans[k]
                heapq.heappush(heap, (dur, ts + dur, k, name))
                k += 1
            while heap and heap[0][1] <= mid:
                heapq.heappop(heap)
            name = heap[0][3] if heap else "(no host span)"
            idle[name] = idle.get(name, 0.0) + length * 1e-6
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[_short(n), s] for n, s in gaps_top]}


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def read_chrome_trace(path: Path, window_s: float) -> Trace:
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    tr = Trace(window_s=window_s)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append((e.get("name", ""), float(e["ts"]), float(e["dur"]), cat))
        elif cat in HOST_CATS:
            tr.host.append((e.get("name", ""), float(e["ts"]), float(e["dur"])))
    return tr


class Profiled:
    """``with Profiled(path) as p: ...`` profiles the block (host and
    device), writes the Chrome trace to ``path`` and leaves
    :attr:`trace` (:class:`Trace`) once ``window_s`` is set."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.prof = None
        self.window_s = 0.0
        self.trace = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
            self.trace = read_chrome_trace(self.path, self.window_s)
        return False
