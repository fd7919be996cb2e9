"""The ``render`` traffic: whole renders in a closed loop.

Each render is one call of the program's ``render.render_image`` at the
configuration's own size, samples and depth, with a new sample seed drawn
from the run's seed, synchronized before the next one starts. Set-up
builds the scene (the configuration's scene module, ``program_scene``),
lowers it to the device (``Scene.build``, timed for ``scene.build_s``;
the renders find it cached) and renders until ``warm_seconds`` have
passed (at least once), so that every kernel is loaded and every shape
warm.

End to end: ``render_Mpaths_per_s``, the camera paths (pixels x samples)
of every render completed in the window over the window's seconds; the
window closes at the end of the first render that ends past ``seconds``,
so that it holds whole renders only.

The check: renders drawn from the seed among those the window completed,
and pixels drawn from the seed, each pixel's mean over the render's
samples held against the reference's (the scene module's ``REFERENCE``): ``pixel_gap``, the widest gap,
which a path that parts from the reference's by rounding can open alone,
and ``pixel_mean_gap``, the mean gap, which a small error spread over the
image moves.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _image_size(run):
    img = run.cfg["image"]
    return (run.over("width", img["width"]), run.over("height", img["height"]),
            run.over("samples_per_pixel", img["samples_per_pixel"]),
            run.over("max_depth", img["max_depth"]))


def setup(run) -> None:
    from crucible_tpu_torch.models import render as R

    run.width, run.height, run.spp, run.depth = _image_size(run)
    run.scene = run.scenes.program_scene(run.cfg, run.desc, run.width)
    if run.scene.scene_cam.image_height != run.height:
        raise ValueError(f"the program's image is {run.scene.scene_cam.image_height} high, "
                         f"the configuration's {run.height}")
    rng = np.random.default_rng([run.seed, 7])
    run.render_seeds = (int(s) for s in iter(lambda: rng.integers(0, 2**31 - 1), None))
    run.images, run.done, run.bad = [], 0, 0
    run.pick = np.random.default_rng([run.seed, 3])
    run.previous = None
    run.render = R.render_image
    run.mark("program import, scene")
    run.build(run.scene)
    run.mark("scene build")
    t0 = time.perf_counter()
    while True:
        _render(run, keep=False)
        if time.perf_counter() - t0 >= run.traffic["warm_seconds"]:
            break


def _render(run, keep: bool = True):
    seed = next(run.render_seeds)
    spp = run.spp // 2 if run.fault == "half" else run.spp
    img = run.render(run.scene, spp, run.depth, seed, device=run.device)
    if run.fault == "scaled":
        img = img * 1.01
    elif run.fault == "stale":
        img, run.previous = (img if run.previous is None else run.previous), img
    run.sync()
    if keep:
        # Every render judged for finite values on the device; the checked
        # renders kept as a reservoir drawn from the seed, so that the
        # window holds ``check_renders`` images, not all of them.
        run.bad = run.bad + (~torch.isfinite(img)).any()
        k = run.traffic["check_renders"]
        if len(run.images) < k:
            run.images.append((seed, img))
        else:
            j = int(run.pick.integers(run.done + 1))
            if j < k:
                run.images[j] = (seed, img)
        run.done += 1


def window(run, seconds: float, max_items: int | None) -> None:
    paths = run.width * run.height * run.spp
    t0 = time.perf_counter()
    n = 0
    while True:
        with run.span("render"):
            _render(run)
        n += 1
        if time.perf_counter() - t0 >= seconds or (max_items and n >= max_items):
            break
    elapsed = time.perf_counter() - t0
    run.attempted = n
    run.facts.update(window_s=elapsed, renders=n, paths_per_render=paths)
    run.e2e["render_Mpaths_per_s"] = n * paths / elapsed / 1e6


def release(run) -> None:
    """Count the renders that were not finite; draw the checked pixels
    from the seed."""
    run.failed = int(run.bad)
    run.checked = run.images
    run.pixels = run.pick.choice(run.width * run.height,
                            size=min(run.over("check_pixels", run.traffic["check_pixels"]),
                                     run.width * run.height), replace=False)
    run.images = run.scene = run.previous = None


def check(run) -> None:
    """``pixel_gap`` and ``pixel_mean_gap``: the widest and the mean gap
    between a checked pixel of the program's render (or, under
    ``control``, of the reference computed in bfloat16) and the
    reference's, over every channel of every checked pixel."""
    dev, ref = run.device, run.ref
    pixels = torch.as_tensor(run.pixels, device=dev)
    prep = ref.prepare(run.cfg, run.desc, run.width, run.height, dev)
    if run.control:
        prep16 = ref.prepare(run.cfg, run.desc, run.width, run.height, dev, torch.bfloat16)
    gap, total, counts = 0.0, 0.0, {}
    for seed, img in run.checked:
        want = ref.render_pixels(prep, pixels, run.spp, seed, run.depth, counts=counts)
        if run.control:
            got = ref.render_pixels(prep16, pixels, run.spp, seed, run.depth).float()
        else:
            got = img.reshape(-1, 3)[pixels]
        diff = (got - want).abs()
        gap = max(gap, float(diff.max()))
        total += float(diff.mean())
    run.facts["searches_per_path"] = counts.get("searches", 0) / (
        len(run.checked) * pixels.shape[0] * run.spp)
    run.reading("pixel_gap", gap)
    run.reading("pixel_mean_gap", total / len(run.checked))
