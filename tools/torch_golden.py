#!/usr/bin/env python3
"""The golden check of crucible_tpu_torch: every demo world through its
production schedule against the JAX package's goldens, and the gradient
check.

    python3 tools/torch_golden.py golden [--device cuda|cpu]
    python3 tools/torch_golden.py gradcheck [--device cuda|cpu]

``golden`` renders each world of ``tests/goldens/golden_tpu_v1.npz`` (the
JAX package's CPU renders at 64 px, 8 spp (the teapot 32), depth 8, seed 0)
through ``render.render_image_persistent`` with schedule ``auto``, and
``book1_deep50`` through the deep gradient path's forward
(:func:`deep_replay_image`), and holds each image to the JAX harness's
bounds (``tools/tpu_bench.py`` ``golden``), with ``scale = max(1, want.max())``:
max |diff| < 2 scale / spp, the share of |diff| > 0.05 scale below 2%,
mean |diff| < 3e-3 scale. ``earth`` and ``load_teapot`` are held where
their original assets resolve (``io.assets``); otherwise their rows say
``held: false``: earth is rendered all the same over a generated map in a
temporary ``ASSET_DIR`` (its numbers reported), the teapot's scene raises
``FileNotFoundError``.

``gradcheck`` follows the JAX harness's ``gradcheck``: direct AD against
the replay on smoke (camera leaves within 0.02, the rest 5e-3) and book1
(the radiometric leaves within 5e-3; camera leaves and ``mat_fuzz``
reported), central finite differences against the replay's gradient
(albedo, one texel of earth, the vertical field of view on sky pixels),
and the depth-50 gradients finite.

On a CUDA device each row also carries its kernel launches by kernel
(``chip_smoke._launch_counter``, set to 0 before each row). Each entry
point takes ``device``; the CPU runs the kernels' plain versions. Prints
JSON lines and exits non-zero naming what drifted. Writes nothing into the
repository beyond what the demo worlds write themselves (garden's
procedural sky, ``assets/garden.hdr``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from crucible_tpu_torch import grad  # noqa: E402
from crucible_tpu_torch.io import assets  # noqa: E402
from crucible_tpu_torch.io.procedural import generate_earth_texture  # noqa: E402
from crucible_tpu_torch.models import demo, render, replay  # noqa: E402

GOLDENS = REPO / "tests" / "goldens" / "golden_tpu_v1.npz"
SPP = 8
DEPTH = 8
SEED = 0

# (builder name, width, spp) of the goldens; the teapot runs 32 spp.
WORLDS = (
    ("smoke_scene", 64, SPP),
    ("book1_end_scene", 64, SPP),
    ("checkered_spheres", 64, SPP),
    ("earth", 64, SPP),
    ("load_teapot", 64, 32),
    ("garden_skybox", 64, SPP),
    ("sphere_stress", 64, SPP),
    ("nested_checkers", 64, SPP),
)
WORLD_SPP = {name: spp for name, _, spp in WORLDS}

# The depth-50 config through the deep gradient path's forward (two-level
# record and depth-bucketed replay).
DEEP_WORLD = ("book1_end_scene", 64, SPP, 50)
DEEP_KEY = "book1_deep50"

# Worlds whose golden was made from an asset file the repository lacks.
ASSET_WORLDS = {"earth": "earthmap.jpg", "load_teapot": "teapot.obj"}
ABSENT = "asset absent (C1)"
# The generated stand-in for earthmap.jpg: 1024x512, as the original.
EARTH_MAP_HEIGHT = 512


def load_goldens() -> dict:
    """The golden images by config, in the file's order."""
    with np.load(GOLDENS) as z:
        return {k: z[k] for k in z.files}


def compare(name: str, img: np.ndarray, want: np.ndarray, spp: int) -> dict:
    """Hold ``img`` to ``want`` at the JAX harness's bounds -> its row."""
    d = np.abs(img.astype(np.float64) - want.astype(np.float64))
    scale = max(1.0, float(want.max()))
    flip = float((d > 0.05 * scale).mean())
    checks = {
        "max_lt_2_over_spp": float(d.max()) < 2.0 * scale / spp,
        "fliptail_lt_2pct": flip < 0.02,
        "mean_lt_3em3": float(d.mean()) < 3e-3 * scale,
    }
    return dict(config=name, ok=all(checks.values()), spp=spp, d_max=float(d.max()),
                d_mean=float(d.mean()), flip_frac=flip, scale=scale, **checks)


def launch_counter(device):
    """``chip_smoke._launch_counter()`` on a CUDA device, else None (the
    plain versions count nothing)."""
    if torch.device(device).type != "cuda":
        return None
    from chip_smoke import _launch_counter

    return _launch_counter()


def counted(counter, fn):
    """(fn(), the kernel launches it made, or None without a counter)."""
    if counter is None:
        return fn(), None
    zero, launched = counter
    zero()
    out = fn()
    return out, launched()


@contextlib.contextmanager
def earth_map():
    """earth's map: the original where ``earthmap.jpg`` resolves, else a
    generated one in a temporary ``ASSET_DIR`` for the block. Yields whether
    the original resolved."""
    try:
        assets.build_asset_path(ASSET_WORLDS["earth"])
        original = True
    except FileNotFoundError:
        original = False
    if original:
        yield True
        return
    from PIL import Image

    old = os.environ.get("ASSET_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        Image.fromarray(generate_earth_texture(EARTH_MAP_HEIGHT)).save(
            Path(tmp) / ASSET_WORLDS["earth"])
        os.environ["ASSET_DIR"] = tmp
        try:
            yield False
        finally:
            if old is None:
                os.environ.pop("ASSET_DIR", None)
            else:
                os.environ["ASSET_DIR"] = old


def render_world(name: str, want: np.ndarray, device, counter=None) -> dict:
    """World ``name`` at the golden's size through schedule ``auto`` ->
    (image (h, w, 3) on the host, the schedule taken, launches, seconds)."""
    h, w, _ = want.shape
    sc = getattr(demo, name)(width=w)
    if sc.scene_cam.image_height != h:
        raise ValueError(f"{name}: {sc.scene_cam.image_height} rows, the golden {h}")
    sd, cp = sc.build(device=device), sc.scene_cam.params(device=device)
    schedule = render.auto_schedule(sd, cp, device)
    t0 = time.perf_counter()
    img, launches = counted(counter, lambda: render.render_image_persistent(
        sd, cp, w, h, WORLD_SPP[name], DEPTH, SEED, device=device).cpu().numpy())
    return img, schedule, launches, time.perf_counter() - t0


def _row(name, img, want, spp, schedule, launches, seconds) -> dict:
    row = dict(compare(name, img, want, spp), schedule=schedule, held=True, seconds=seconds)
    if launches is not None:
        row["launches"] = launches
    return row


def world_row(name: str, want: np.ndarray, device="cuda", counter=None) -> dict:
    """One held world of the goldens -> its row."""
    img, schedule, launches, s = render_world(name, want, device, counter)
    return _row(name, img, want, WORLD_SPP[name], schedule, launches, s)


def deep_replay_image(width=64, spp=SPP, depth=50, seed=SEED, device="cuda") -> np.ndarray:
    """Per-pixel mean radiance (h, w, 3) through the deep gradient path's
    forward: ``replay.render_rays_replay(split=True)`` (two-level record,
    depth-bucketed replay) over the pixel ids tiled ``spp`` times and the
    sample ids repeated, the estimator the depth-50 budget differentiates."""
    sc = getattr(demo, DEEP_WORLD[0])(width=width)
    sd, cp = sc.build(device=device), sc.scene_cam.params(device=device)
    h = sc.scene_cam.image_height
    p = width * h
    pix = torch.arange(p, device=device).repeat(spp)
    smp = torch.arange(spp, device=device).repeat_interleave(p)
    with torch.no_grad():
        rad = replay.render_rays_replay(sd, cp, width, h, pix, smp, seed, depth, split=True)
    return rad.reshape(spp, p, 3).mean(dim=0).reshape(h, width, 3).cpu().numpy()


def deep_row(want: np.ndarray, device="cuda", counter=None) -> dict:
    """``book1_deep50`` -> its row (schedule ``deep``: the replay path)."""
    _, width, spp, depth = DEEP_WORLD
    t0 = time.perf_counter()
    img, launches = counted(counter, lambda: deep_replay_image(width, spp, depth, SEED, device))
    return _row(DEEP_KEY, img, want, spp, "deep", launches, time.perf_counter() - t0)


def asset_row(name: str, want: np.ndarray, device="cuda", counter=None) -> dict:
    """earth or load_teapot -> its row: held where the original asset
    resolves; else not held, earth rendered over a generated map (its
    numbers reported), the teapot's ``FileNotFoundError`` reported."""
    try:
        found = assets.build_asset_path(ASSET_WORLDS[name])
    except FileNotFoundError:
        found = None
    if found is not None:
        return dict(world_row(name, want, device, counter), asset=str(found))
    row = dict(config=name, held=False, reason=ABSENT, spp=WORLD_SPP[name])
    if name == "earth":
        with earth_map():
            img, schedule, launches, s = render_world(name, want, device, counter)
        got = compare(name, img, want, WORLD_SPP[name])
        row.update(schedule=schedule, map="generated", seconds=s,
                   **{k: got[k] for k in ("d_max", "d_mean", "flip_frac", "scale")})
        if launches is not None:
            row["launches"] = launches
        return row
    try:
        getattr(demo, name)(width=want.shape[1])
        row["raises"] = None
    except FileNotFoundError as e:
        row["raises"] = f"FileNotFoundError: {e}"
    return row


def golden(device="cuda") -> dict:
    """Every config of the goldens on ``device`` -> {ok, drifted, configs}:
    one row a config, in the file's order; ``ok`` over the held rows."""
    goldens = load_goldens()
    counter = launch_counter(device)
    rows = []
    for name, want in goldens.items():
        if name == DEEP_KEY:
            rows.append(deep_row(want, device, counter))
        elif name in ASSET_WORLDS:
            rows.append(asset_row(name, want, device, counter))
        else:
            rows.append(world_row(name, want, device, counter))
    drifted = [r["config"] for r in rows if r["held"] and not r["ok"]]
    return dict(ok=not drifted, drifted=drifted, configs=rows)


# --- the gradient check -----------------------------------------------------------


def _setup(sc, device, pix_n=None):
    sd, cp = sc.build(device=device), sc.scene_cam.params(device=device)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    n = pix_n or w * h
    pix = torch.arange(n, device=device)
    target = torch.zeros((n, 3), device=device)
    return sd, cp, w, h, pix, target


def _smoke_bound(key):
    return 0.02 if key.startswith("cam_") else 5e-3


def _book1_bound(key):
    return None if key.startswith("cam_") or key == "mat_fuzz" else 5e-3


AD_VS_REPLAY = {
    "smoke": (demo.smoke_scene, _smoke_bound),
    "book1": (demo.book1_end_scene, _book1_bound),
}


def ad_vs_replay(tag: str, device="cuda", counter=None, spp=8, depth=4) -> dict:
    """Direct AD against the replay at 64 px -> {checks, failed, launches}:
    each leaf's max |ad - replay| over max |ad| (the leaves of
    ``grad.leaf_keys``; texture images are not compared, as in the JAX
    harness), failed where a bound applies and is not met."""
    make, enforce = AD_VS_REPLAY[tag]
    sd, cp, w, h, pix, target = _setup(make(width=64), device)
    params = grad.extract_params(sd, cp)
    kw = dict(width=w, height=h, spp=spp, max_depth=depth)
    (g_ad, g_rp), launches = counted(counter, lambda: (
        grad.loss_and_grad(params, sd, cp, target, pix, SEED, method="ad", **kw)[1],
        grad.loss_and_grad(params, sd, cp, target, pix, SEED, method="replay", **kw)[1]))
    checks, failed = {}, []
    for key in sorted(grad.leaf_keys(params)):
        a = g_ad[key].detach().double().cpu().numpy()
        b = g_rp[key].detach().double().cpu().numpy()
        scale = max(float(np.abs(a).max()), 1e-6)
        nd = float(np.abs(a - b).max() / scale)
        name = f"ad_vs_replay:{tag}:{key}"
        checks[name] = nd
        bound = enforce(key)
        if bound is not None and not (np.isfinite(nd) and nd < bound):
            failed.append(name)
    return dict(checks=checks, failed=failed, launches=launches)


FD_CHECKS = {
    # name: (world, width, leaf, spp, depth, eps, pixels)
    "fd:smoke:tex_color": ("smoke_scene", 32, "tex_color", 4, 4, 1e-3, None),
    "fd:earth:tex_images": ("earth", 24, "tex_images", 2, 3, 1e-3, None),
    # The camera on sky pixels only (smooth in vfov: no silhouette term).
    "fd:smoke:cam_vfov": ("smoke_scene", 32, "cam_vfov", 2, 3, 1e-4, 8),
}
FD_REL = 5e-2


def fd_check(name: str, device="cuda", counter=None) -> dict:
    """The replay's gradient of one entry of a leaf (its largest) against
    central differences of the loss -> {checks, failed, launches}; held as
    |ad| > 0 and |ad - fd| <= FD_REL |fd|. earth takes the original map
    where it resolves, else a generated one: the check holds the gradient
    to its own loss, not to an image."""
    world, width, key, spp, depth, eps, pix_n = FD_CHECKS[name]
    with earth_map() if world == "earth" else contextlib.nullcontext():
        sd, cp, w, h, pix, tgt = _setup(getattr(demo, world)(width=width), device, pix_n)
    p0 = grad.extract_params(sd, cp)
    kw = dict(width=w, height=h, spp=spp, max_depth=depth, method="replay")

    def leaf_of(p):
        return p[key][0] if key == "tex_images" else p[key]

    def loss_at(idx, delta):
        arr = leaf_of(p0).detach().double().cpu().numpy().copy()
        arr[idx] += delta
        moved = torch.tensor(arr, dtype=torch.float32, device=device)
        p2 = dict(p0)
        p2[key] = (moved,) + tuple(p0[key][1:]) if key == "tex_images" else moved
        with torch.no_grad():
            return float(grad.l2_loss(p2, sd, cp, tgt, pix, SEED, **kw))

    def run():
        _, grads = grad.loss_and_grad(p0, sd, cp, tgt, pix, SEED, **kw)
        g = leaf_of(grads).detach().cpu().numpy()
        idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
        fd = (loss_at(idx, eps) - loss_at(idx, -eps)) / (2 * eps)
        return float(g[idx]), fd

    (ad, fd), launches = counted(counter, run)
    rel = abs(ad - fd) / max(abs(fd), 1e-9)
    ok = abs(ad) > 0 and abs(ad - fd) <= FD_REL * abs(fd)
    return dict(checks={name: dict(ad=ad, fd=fd, rel=rel)}, failed=[] if ok else [name],
                launches=launches)


def deep50_finite(device="cuda", counter=None) -> dict:
    """book1 64 px, 2 spp, depth 50 through the default method (the
    two-level record, depth-bucketed replay) -> every gradient finite."""
    sd, cp, w, h, pix, target = _setup(demo.book1_end_scene(width=64), device)
    params = grad.extract_params(sd, cp)
    (_, g), launches = counted(counter, lambda: grad.loss_and_grad(
        params, sd, cp, target, pix, SEED, width=w, height=h, spp=2, max_depth=50))
    finite = all(bool(torch.isfinite(v).all()) for v in grad.leaves(g).values())
    return dict(checks={"deep50_grads_finite": finite},
                failed=[] if finite else ["deep50_grads_finite"], launches=launches)


def gradcheck(device="cuda") -> dict:
    """Every gradient check on ``device`` -> {ok, failed, checks, launches}
    (launches by check, on a CUDA device)."""
    counter = launch_counter(device)
    parts = {f"ad_vs_replay:{tag}": ad_vs_replay(tag, device, counter) for tag in AD_VS_REPLAY}
    parts.update((name, fd_check(name, device, counter)) for name in FD_CHECKS)
    parts["deep50"] = deep50_finite(device, counter)
    failed = [f for part in parts.values() for f in part["failed"]]
    out = dict(ok=not failed, failed=failed,
               checks={k: v for part in parts.values() for k, v in part["checks"].items()})
    if counter is not None:
        out["launches"] = {name: part["launches"] for name, part in parts.items()}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("golden", "gradcheck"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_golden: torch.cuda.is_available() is False")
    kind = (torch.cuda.get_device_name(torch.device(args.device))
            if torch.device(args.device).type == "cuda" else "cpu")
    if args.mode == "golden":
        verdict = golden(args.device)
        for row in verdict["configs"]:
            print(json.dumps(dict(bench=f"golden_{row['config']}", **row)), flush=True)
        print(json.dumps(dict(golden_verdict=verdict["ok"], drifted=verdict["drifted"],
                              device=kind)))
        if not verdict["ok"]:
            raise SystemExit(f"golden drift in: {verdict['drifted']}")
    else:
        verdict = gradcheck(args.device)
        print(json.dumps(dict(bench="gradcheck", device=kind, **verdict)))
        if not verdict["ok"]:
            raise SystemExit(f"gradcheck drift in: {verdict['failed']}")


if __name__ == "__main__":
    main()
