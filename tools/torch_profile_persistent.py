#!/usr/bin/env python3
"""One iteration of the ``pixel`` schedule by stage, and a full render's time
attributed to them.

    python3 tools/torch_profile_persistent.py [--width 400] [--spp 32] [--device cuda]

The scene is book1 at ``--width``. Its lanes are ``LANES`` (2^20) padded as
``integrator.trace_persistent`` pads them: the pixels to a multiple of 512,
times ceil(lanes / pixels) sample groups (at most ``--spp``). At that lane
count each stage is timed by two points, n + 2 calls minus 2 calls over n,
after a warm call:

- ``raygen``: ``camera.generate_rays`` for every lane;
- ``k9``: ``sphere_shade.hit_spheres_fetch`` alone (K9);
- ``bounce``: ``integrator.bounce_step_fused`` (K9 and the shading after it).

Then ``trace_persistent`` renders the image at depth 50 (a warm render at 2
spp first), its iterations counted as the calls of ``bounce_step_fused``
(a wrapper installed here for the render); on a card they must equal K9's
launches, one an iteration. The render's time is split as ``model_ms`` =
iters x (raygen + bounce) and ``bookkeeping_ms``, the rest: the carry
updates and the end test's host sync of each iteration.

On a CUDA device the stages are timed with CUDA events
(``chip_smoke.cuda_ms``) and the render by the host clock between
synchronizations; then ``torch.profiler`` gives the device time of
``raygen`` and ``bounce`` (their kernels' times summed; K9 alone is one
kernel, its event time) and a second render's, with its busiest kernels,
the device's idle share of the timed render, and the same split in
device time (``model_device_ms``, ``bookkeeping_device_ms``). On the CPU (a
rehearsal of the plain versions) every time is the host clock's and the
profiler is not run. Prints JSON lines only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from crucible_tpu_torch.models import demo, integrator  # noqa: E402
from crucible_tpu_torch.models.camera import generate_rays  # noqa: E402
from crucible_tpu_torch.models.integrator import T_MIN  # noqa: E402
from crucible_tpu_torch.ops.kernels import sphere_shade  # noqa: E402

LANES = 1 << 20
DEPTH = 50
SEED = 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def total_ms(fn, reps: int, dev) -> float:
    """Milliseconds of ``reps`` calls of ``fn``: CUDA events on a card
    (``chip_smoke.cuda_ms``), the host clock elsewhere."""
    if dev.type == "cuda":
        from chip_smoke import cuda_ms

        return cuda_ms(fn, reps) * reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0)


def stage_ms(fn, reps: int, dev) -> float:
    """Milliseconds of one call of ``fn``: (reps + 2 calls) - (2 calls),
    over reps, after a warm call."""
    fn()
    _sync(dev)
    return (total_ms(fn, reps + 2, dev) - total_ms(fn, 2, dev)) / reps


def device_ms(fn, reps: int = 1, top: int = 8):
    """(device milliseconds of one call of ``fn``: the summed kernel times
    of ``reps`` calls under ``torch.profiler`` over reps; the ``top``
    kernels by device time, a call) on a card, after a warm call. Only the
    device is traced: a render's ~45,000 operations recorded on the host
    as well take the profiler a minute."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3 / reps
    return total, [dict(kernel=e.key[:80], ms=e.self_device_time_total / 1e3 / reps,
                        launches=e.count / reps) for e in rows[:top]]


@contextlib.contextmanager
def counting_bounces():
    """Count the calls of ``integrator.bounce_step_fused`` (one a
    ``trace_persistent`` iteration) in the block -> a one-item list."""
    inner = integrator.bounce_step_fused
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    integrator.bounce_step_fused = counted
    try:
        yield calls
    finally:
        integrator.bounce_step_fused = inner


def profile(width: int = 400, spp: int = 32, device="cuda", lanes: int = LANES,
            reps: int = 20) -> dict:
    """book1 at ``width``: the stages' ms an iteration at the schedule's lane
    count, and the ``spp`` render's iterations and split -> one dict."""
    dev = torch.device(device)
    sc = demo.book1_end_scene(width=width)
    sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    num_pixels = w * h
    groups = min(spp, max(1, (lanes + num_pixels - 1) // num_pixels))
    p_pad = ((num_pixels + 511) // 512) * 512
    r = groups * p_pad
    lane = torch.arange(r, device=dev)
    pix = torch.clamp_max(lane % p_pad, num_pixels - 1)
    smp = lane % 7
    table = integrator.make_sphere_table(sd).contiguous()
    o0, d0, _ = generate_rays(cp, w, h, pix, smp, SEED)
    w0 = torch.zeros((r,), device=dev)
    bounce = torch.zeros((r,), dtype=torch.int64, device=dev)
    if not integrator.fused_supported(sd):
        raise ValueError("book1 should take the fused bounce")

    out = dict(config=f"book1_{width}w", device=dev.type, lanes=r, groups=groups,
               pixels=num_pixels, rows=int(table.shape[0]), spp=spp, depth=DEPTH, reps=reps,
               timer="cuda events" if dev.type == "cuda" else "host clock")
    stages = {
        "raygen": lambda: generate_rays(cp, w, h, pix, smp, SEED),
        "k9": lambda: sphere_shade.hit_spheres_fetch(o0, d0, w0, table, T_MIN),
        "bounce": lambda: integrator.bounce_step_fused(sd, table, o0, d0, pix, smp, bounce,
                                                       SEED),
    }
    for name, fn in stages.items():
        out[f"{name}_ms"] = stage_ms(fn, reps, dev)

    def render(samples):
        return integrator.trace_persistent(sd, cp, w, h, samples, DEPTH, SEED, lanes=lanes)

    render(min(2, spp))
    _sync(dev)
    k9_before = sphere_shade.LAUNCHES
    with counting_bounces() as calls:
        t0 = time.perf_counter()
        fb = render(spp)
        _sync(dev)
        seconds = time.perf_counter() - t0
    iters = calls[0]
    if dev.type == "cuda":
        out["k9_launches"] = sphere_shade.LAUNCHES - k9_before
        if out["k9_launches"] != iters:
            raise AssertionError(f"{iters} iterations but {out['k9_launches']} K9 launches")
    model = iters * (out["raygen_ms"] + out["bounce_ms"])
    out.update(iters=iters, total_ms=1e3 * seconds, model_ms=model,
               bookkeeping_ms=1e3 * seconds - model,
               bookkeeping_ms_per_iter=(1e3 * seconds - model) / max(iters, 1),
               ms_per_iter=1e3 * seconds / max(iters, 1),
               mrays_per_s=num_pixels * spp / seconds / 1e6,
               image_mean=float(fb.mean()) / spp)
    if dev.type == "cuda":
        # Device time by the profiler's kernel times: how much of each stage,
        # and of the render's wall time, the card is busy. K9 alone is one
        # kernel a call, so its CUDA-event time is its device time.
        for name in ("raygen", "bounce"):
            out[f"{name}_device_ms"] = device_ms(stages[name], reps=5, top=0)[0]
        t0 = time.perf_counter()
        out["render_device_ms"], out["render_top_kernels"] = device_ms(lambda: render(spp))
        out["profiled_render_s"] = time.perf_counter() - t0
        out["device_idle_share"] = 1.0 - out["render_device_ms"] / out["total_ms"]
        # The same split in device time: the host-clock stage times above
        # include the launches' host time, which the loop overlaps.
        out["model_device_ms"] = iters * (out["raygen_device_ms"] + out["bounce_device_ms"])
        out["bookkeeping_device_ms"] = out["render_device_ms"] - out["model_device_ms"]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_profile_persistent: torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(dict(bench="profile_persistent", device_name=kind)), flush=True)
    print(json.dumps(dict(bench="profile_persistent",
                          **profile(args.width, args.spp, dev))), flush=True)


if __name__ == "__main__":
    main()
