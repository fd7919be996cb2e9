"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run fails (a non-zero exit, no result) without a CUDA device or with
fewer than the cell asks for, for a cell the manifest lacks, and when the
process holds JAX or the JAX package once the window has closed. With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profile of the window.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from harness import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "crucible_tpu")
TRACE_DIR = manifest.BENCH / "out"


class RunError(Exception):
    """A run that cannot give a result; the message says why."""


@dataclass
class Run:
    cell: manifest.Cell
    seed: int
    seconds: float
    traced: bool
    device: str
    fault: str | None = None
    control: bool = False
    overrides: dict = field(default_factory=dict)
    e2e: dict = field(default_factory=dict)
    facts: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    trace: object = None
    marks: list = field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note the host-clock time a step of set-up ended (printed to
        standard error before the window, to show where set-up goes)."""
        self.marks.append((name, time.perf_counter()))

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def over(self, key: str, default):
        """A size the run takes: the overrides' (tests at small sizes) or
        the cell's own."""
        return self.overrides.get(key, default)

    def build(self, scene):
        """The program's ``Scene.build`` of ``scene`` on the run's device,
        synchronized, its host-clock seconds kept for ``scene.build_s``."""
        t0 = time.perf_counter()
        sd = scene.build(device=self.device)
        self.sync()
        self.facts["scene_build_s"] = time.perf_counter() - t0
        return sd

    def sync(self) -> None:
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        """A host span of the traced run, around a call into the program."""
        if not self.traced:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def reading(self, name: str, value: float) -> None:
        limit = self.cell.limits.get(name, {}).get("limit")
        self.checks[name] = (value, limit)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card() -> dict:
    """The card's name, count and power limit (``nvidia-smi``, where it runs)."""
    import subprocess

    import torch

    out = {"kind": torch.cuda.get_device_name(0)}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30, check=True)
        out["power_limit"] = q.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "unknown"
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def program_in_checkout() -> None:
    """The program measured is the checkout's own: a directory that holds
    only the benchmark must not measure an installed copy."""
    import crucible_tpu_torch

    where = Path(crucible_tpu_torch.__file__).resolve()
    if manifest.ROOT not in where.parents:
        raise RunError(f"crucible_tpu_torch comes from {where.parent}, not from this checkout")


def execute(run: Run, t_start: float) -> dict:
    """Set up, measure, check; -> the result line (a dict)."""
    import torch

    from harness import trace as trace_mod

    cuda = torch.device(run.device).type == "cuda"
    program_in_checkout()
    run.mark("imports")
    run.scenes = manifest.load_module(manifest.scene_path(run.cfg["scene"]), "bench_scene")
    run.ref = manifest.load_module(manifest.reference_path(run.scenes.REFERENCE),
                                   "bench_reference")
    driver = manifest.load_module(manifest.driver_path(run.traffic["driver"]), "bench_driver")
    run.desc = run.scenes.describe(run.cfg, run.seed)
    if cuda:
        torch.cuda.set_device(run.device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(run.device)
        run.mark("cuda init")
    driver.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    run.mark("set-up")
    t = t_start
    steps = []
    for name, at in run.marks:
        steps.append(f"{name} {at - t:.3f}")
        t = at
    print(f"benchmark: set-up {setup_s:.3f} s: " + ", ".join(steps), file=sys.stderr)
    max_items = run.traffic.get("trace_items") if run.traced else None
    if run.traced:
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        with trace_mod.Profiled(TRACE_DIR / f"{run.cell.name}.trace.json") as prof:
            driver.window(run, run.seconds, max_items)
            run.sync()
            prof.window_s = run.facts["window_s"]
        run.trace = prof.trace
    else:
        driver.window(run, run.seconds, max_items)
    run.sync()
    memory_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    driver.release(run)
    if cuda:
        torch.cuda.empty_cache()
    driver.check(run)
    found = forbidden_modules()
    if found:
        raise RunError(f"the process holds {', '.join(found)} after the window")

    info = card() if cuda else {"kind": "cpu", "power_limit": "none"}
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end + run.cell.per_layer}
    metrics = {}
    if run.traced:
        for i, m in enumerate(run.cell.per_layer):
            reader = manifest.load_module(manifest.metric_path(m["name"]), f"bench_metric_{i}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = dict(run.e2e, setup_s=setup_s)
        for m in run.cell.end_to_end:
            if m["name"] not in values:
                raise RunError(f"the {run.traffic['driver']} traffic gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    ok = bool(run.checks) and all(
        lim is not None and math.isfinite(v) and v <= lim for v, lim in run.checks.values())
    device = {"platform": "gpu" if cuda else "cpu", "kind": info["kind"],
              "count": run.cell.chips, "memory_peak_bytes": int(memory_peak),
              "power_limit": info["power_limit"]}
    result = {"correct": ok and run.failed == 0, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return result


def main(argv=None, *, t_start: float) -> int:
    """Run the cell the arguments name on the card and print its result
    line; -> the exit code."""
    args = _parse(argv)
    try:
        cell = manifest.cell(args.workload)
    except KeyError as e:
        print(f"benchmark: {e.args[0]}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; this benchmark runs on the card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    run = Run(cell=cell, seed=args.seed % (1 << 63), seconds=args.seconds,
              traced=bool(args.trace), device="cuda:0")
    try:
        result = execute(run, t_start)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0
