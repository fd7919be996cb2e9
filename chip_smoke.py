#!/usr/bin/env python3
"""On-card check of crucible_tpu_torch: build, compare, render.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``crucible_tpu_torch/csrc`` with nvcc.
3. Holds the megakernel against its eager-torch version on the card, on the
   inputs the render path gives it:
   - ``smoke_scene`` 64 wide, 8 spp, depth 8 (Lambertian only): every
     lane's sum within 1e-4;
   - ``book1_end_scene`` 320 wide, 8 spp, depth 50: isclose(rtol=1e-3,
     atol=1e-3) on more than 99% of pixel values and image means within
     2e-3 (glass chains flip on last-ulp differences);
   - ``book1_end_scene`` 1920x1080, 32 spp, depth 50: the full launch,
     checked on a subset of lanes against the eager version under the same
     bounds (lanes are independent).
4. Renders book1 at 1920x1080, 32 spp, depth 50 through
   ``render.render_image(..., device="cuda")``, checks the image, counts
   the kernel's launches in that run and writes ``build/chip_smoke_book1.png``.
5. Prints a JSON line describing each kernel, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero. Without CUDA, or
without the package beside this file, it exits non-zero before printing a
result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def statistical_match(a, b, what: str) -> float:
    """Assert the cross-path bounds; return max |a - b|."""
    import torch

    close = torch.isclose(a, b, rtol=1e-3, atol=1e-3).float().mean().item()
    dmean = abs(a.mean().item() - b.mean().item())
    err = (a - b).abs().max().item()
    print(f"  {what}: isclose {close:.5f}, |mean diff| {dmean:.3g}, max|diff| {err:.3g}")
    if not close > 0.99 or not dmean <= 2e-3:
        raise AssertionError(f"{what}: kernel and eager version disagree")
    return err


def main() -> None:
    if not (REPO / "crucible_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: no crucible_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    from crucible_tpu_torch.models import demo, integrator, render
    from crucible_tpu_torch.ops.kernels import build, megakernel as mk

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # --- build --------------------------------------------------------------
    lib_path, build_s, log = build.build()
    print(f"build: {build_s:.2f} s -> {lib_path.relative_to(REPO)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    build.load()

    # --- kernel vs eager version ----------------------------------------------
    def compare(scene, spp, depth, lanes=None):
        sd = scene.build(device=dev)
        cp = scene.scene_cam.params(device=dev)
        w, h = scene.scene_cam.image_width, scene.scene_cam.image_height
        inputs, lane_of = integrator.mega_inputs(sd, cp, w, h, spp, depth, 0)
        out = mk.run_megakernel(**inputs, animated=False)
        ms = cuda_ms(lambda: mk.run_megakernel(**inputs, animated=False), 3)
        if lanes is not None:  # eager version on a subset of the lanes
            inputs = dict(inputs, pix=inputs["pix"][:, lanes],
                          sample0=inputs["sample0"][:, lanes])
            out = out[:, lanes]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = mk.run_megakernel_reference(**inputs)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        return out, ref, lane_of, ms, plain_ms

    out, ref, _, ms, plain_ms = compare(demo.smoke_scene(width=64), 8, 8)
    err = (out - ref).abs().max().item()
    print(f"smoke 64w 8spp d8: kernel {ms:.3f} ms, eager {plain_ms:.1f} ms, "
          f"max|diff| {err:.3g}")
    if not err <= 1e-4:
        raise AssertionError(f"smoke: kernel and eager version differ by {err}")

    out, ref, lane_of, ms320, plain320 = compare(demo.book1_end_scene(width=320), 8, 50)
    print(f"book1 320w 8spp d50: kernel {ms320:.3f} ms, eager {plain320:.1f} ms")
    err320 = statistical_match(out.t()[lane_of] / 8, ref.t()[lane_of] / 8, "book1 320w")

    # Full main-path launch; eager version on 64 pixel blocks spread over it.
    g = torch.Generator().manual_seed(0)
    n_blocks = (1920 // 32) * math.ceil(1080 / 16)
    blocks = torch.randperm(n_blocks, generator=g)[:64].sort().values
    lanes = (blocks[:, None] * mk.TILE + torch.arange(mk.TILE)).reshape(-1).to(dev)
    out, ref, _, ms_full, plain_sub = compare(
        demo.book1_end_scene(width=1920), 32, 50, lanes=lanes
    )
    print(f"book1 1920x1080 32spp d50: kernel {ms_full:.1f} ms "
          f"({1920 * 1080 * 32 / ms_full / 1e3:.2f} Mrays/s); eager on "
          f"{lanes.numel()} lanes {plain_sub:.1f} ms")
    statistical_match(out / 32, ref / 32, "book1 1080p lane subset")

    # --- main path ------------------------------------------------------------
    scene = demo.book1_end_scene(width=1920)
    mk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render.render_image(scene, samples=32, max_depth=50, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mk.LAUNCHES
    if tuple(img.shape) != (1080, 1920, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("image has non-finite values")
    if launches < 1:
        raise AssertionError("the render did not launch the megakernel")
    mrays = 1920 * 1080 * 32 / seconds / 1e6
    print(f"render_image book1 1920x1080 32spp d50: {seconds:.3f} s, "
          f"{mrays:.2f} Mrays/s, mean {img.mean().item():.5f}, "
          f"megakernel launches {launches}")
    from crucible_tpu_torch.io.image import write_png

    png = REPO / "build" / "chip_smoke_book1.png"
    png.parent.mkdir(parents=True, exist_ok=True)
    write_png(png, render.to_u8(img))
    print(f"wrote {png.relative_to(REPO)}")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "megakernel_forward",
        "route": "cuda",
        "source": "crucible_tpu_torch/csrc/megakernel.cu",
        "replaces": "crucible_tpu/ops/pallas/megakernel.py:1681",
        "launches": launches,
        "max_abs_err": err320,
        "ms": ms320,
        "plain_ms": plain320,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
