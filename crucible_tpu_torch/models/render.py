"""Render drivers: the whole-image forward render and the movie driver.

Port of ``crucible_tpu/models/render.py``'s persistent path:
``render_image`` -> ``render_image_data`` -> ``render_image_persistent``,
which runs one of three schedules:

- ``mega``: ``integrator.trace_persistent_mega``, the megakernel: the
  brute search (K1), or above ``CULL_MIN_ROWS`` rows a tree walk (K5),
  or for moving spheres the swept-tree walk (K6); for moving spheres
  or an animated camera their motion variants (K8); for a BVH mesh the
  triangle stage after the brute search (K7, K7 moving for a moving mesh,
  either seen by a static or an animated camera);
- ``pixel``: ``integrator.trace_persistent``, the staged persistent
  wavefront, with the fused hit + fetch kernel (K9) per bounce, or for a
  mesh the staged bounce (K10 for the spheres, ``hit_triangles`` or the
  BVH walk for the triangles);
- ``record``: ``replay.render_record_replay``, the record megakernel's
  decisions (K2, or K5-K8 where the scene routes there) shaded by the
  eager replay, for image textures and nested checkers, which the
  megakernel's shading does not take.

:func:`render_movie` renders ``ceil(duration * fps)`` frames of a movie
scene to ``<fname>/artifacts/imageNNN.ppm`` and assembles them with ffmpeg
where it is installed (:func:`make_mp4`); the frames persist, so
``skip_existing`` resumes a cut render.

A scene no schedule renders raises ``NotImplementedError`` naming the
missing feature. Every entry point runs on ``device="cuda"`` unless the
caller names another device; without CUDA that default raises (torch
does), it never falls back to the CPU.
"""

from __future__ import annotations

import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from crucible_tpu_torch.io.image import write_image
from crucible_tpu_torch.models import integrator
from crucible_tpu_torch.models import replay as replay_mod
from crucible_tpu_torch.models.camera import CameraParams
from crucible_tpu_torch.models.scene import Scene, SceneData
from crucible_tpu_torch.ops.kernels import megakernel as mk
from crucible_tpu_torch.utils import color as color_mod

# Above this sphere-table row count the mega schedule walks a per-lane
# tree of the spheres (K5), or for a moving table its swept tree (K6), instead of
# testing every row (K1, K8), as the JAX package does. The crossover is the
# JAX package's, measured on a TPU; chip_smoke.py times K6 beside K8 on a
# moving n1936 table (PERF.md section 7).
CULL_MIN_ROWS = 1024

# Target lane counts of the pixel schedule (sample groups replicate small
# pixel grids up to this): enough to fill the card, modest on the CPU.
LANES_CUDA = 1 << 20
LANES_CPU = 1 << 13


def _check_device(sd: SceneData, cp: CameraParams, device) -> None:
    want = torch.device(device)
    for name, t in (("scene", sd.sph_center), ("camera", cp.look_from)):
        if t.device.type != want.type or (
            want.index is not None and t.device.index != want.index
        ):
            raise ValueError(f"{name} tensors are on {t.device}, not {want}")


def auto_schedule(sd: SceneData, cp: CameraParams, device) -> str:
    """The schedule 'auto' takes on ``device``, the JAX package's choice
    (``crucible_tpu/models/render.py:162-181``) with its accelerator test
    read as "a CUDA device": 'mega' where the megakernel renders the scene,
    else 'pixel' where the fused bounce (K9) takes it, else 'record' on a
    CUDA device where the record megakernel takes it, else 'pixel'."""
    if integrator.megakernel_supported(sd, cp):
        return "mega"
    if integrator.fused_supported(sd):
        return "pixel"
    if (torch.device(device).type == "cuda" and integrator.megakernel_record_supported(sd, cp)
            and replay_mod.replay_supported(sd)):
        return "record"
    return "pixel"


def render_image_persistent(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    samples: int,
    max_depth: int,
    seed: int,
    *,
    device="cuda",
    schedule: str = "auto",
    cull: bool | None = None,
) -> torch.Tensor:
    """Whole-image render in one schedule -> linear radiance (height,
    width, 3) float32 on ``device``.

    ``schedule``: 'mega' (the megakernel), 'pixel' (the staged persistent
    wavefront: the fused bounce, K9, where ``integrator.fused_supported``
    holds, else the staged bounce, K10), 'record'
    (``replay.render_record_replay``: the record megakernel's decisions
    shaded by the eager replay) or 'auto' (:func:`auto_schedule`: 'mega'
    where ``integrator.megakernel_supported`` holds, else 'pixel' where
    ``integrator.fused_supported`` does, else 'record' on a CUDA device
    where ``integrator.megakernel_record_supported`` holds (image textures,
    nested checkers), else 'pixel': on the CPU, as the JAX package off an
    accelerator, and for what the record kernel does not take, such as a
    mesh of at most ``scene.BVH_MIN_TRIS`` triangles without a BVH). The
    'queue' schedule is not ported and raises ``NotImplementedError``. The
    pixel schedule's target lane count is ``LANES_CUDA`` on a card,
    ``LANES_CPU`` elsewhere.

    ``cull``: whether the mega schedule walks a tree instead of testing
    every row (K1, K8): that of a static scene that carries the sphere-BVH
    tables (K5: ``sph_perm`` and ``sph_swept_*``) or the swept tree of an
    animated one that carries the chunk-cull tables (K6: ``sph_cbounds``
    and ``sph_swept_*``, boxes that hold the spheres over the shutter). None
    takes the walk for 'auto' / 'mega' above ``CULL_MIN_ROWS`` rows, except
    for a moving table beside a mesh that the brute search holds
    (``integrator.brute_beside_mesh``: K7 beside K6 is not instantiated,
    and ``cull=True`` there raises). The image is
    the same bit for bit. A walk raises ``ValueError`` on a scene
    without its tables, and so does ``cull=False`` above the brute kernel's
    ``mk.MAX_ROWS`` rows (``mk.MAX_ROWS_ANIMATED`` for a moving table).
    Exact-time motion (a keyframe inside the shutter window) raises
    ``NotImplementedError``."""
    _check_device(sd, cp, device)
    if sd.motion_exact or cp.motion_exact:
        raise NotImplementedError(integrator.EXACT_MOTION)
    rows = int(sd.sph_center.shape[0])
    if cull is None:
        cull = (schedule in ("auto", "mega") and rows > CULL_MIN_ROWS
                and not integrator.brute_beside_mesh(sd))
    cap = mk.MAX_ROWS_ANIMATED if sd.animated else mk.MAX_ROWS
    if not cull and rows > cap and schedule in ("auto", "mega"):
        raise ValueError(
            f"the brute megakernel cannot take {rows} "
            f"{'moving ' if sd.animated else ''}sphere rows (its shared memory "
            f"holds {cap}); pass cull=True (the "
            f"{'swept-tree' if sd.animated else 'static tree'} walk) or schedule='pixel'"
        )
    if schedule == "auto":
        schedule = auto_schedule(sd, cp, device)
    if schedule == "record":
        fb = replay_mod.render_record_replay(sd, cp, width, height, samples, max_depth, seed)
        return fb.reshape(height, width, 3) / samples
    if schedule == "pixel":
        lanes = LANES_CUDA if torch.device(device).type == "cuda" else LANES_CPU
        fb = integrator.trace_persistent(
            sd, cp, width, height, samples, max_depth, seed, lanes=lanes
        )
        return fb.reshape(height, width, 3) / samples
    if schedule != "mega":
        raise NotImplementedError(
            f"the {schedule!r} schedule is not ported to crucible_tpu_torch yet"
        )
    missing = integrator.megakernel_unsupported_reason(sd, cp)
    if missing is not None:
        raise NotImplementedError(
            f"this scene needs {missing}, which crucible_tpu_torch's "
            f"megakernel does not render yet"
        )
    struct = {}
    if cull:
        tree = integrator.swept_tree(sd)
        if tree is None and sd.animated:
            raise ValueError(
                "cull=True on an animated scene needs its chunk-cull tables "
                "(sph_cbounds, and the swept tree whose boxes hold the spheres over "
                "the shutter), which Scene.build makes for an animated scene above "
                f"{CULL_MIN_ROWS} rows with an active sphere"
            )
        if tree is None:
            raise ValueError(
                "cull=True needs the scene's sphere-BVH tables (sph_perm, "
                "sph_nodes, sph_meta) and its tree (sph_swept_*), which Scene.build "
                f"makes for a static scene above {CULL_MIN_ROWS} rows with an active sphere"
            )
        struct = dict(zip(("perm", "sphere_nodes", "sphere_meta"), tree))
    fb = integrator.trace_persistent_mega(
        sd, cp, width, height, samples, max_depth, seed, **struct
    )
    return fb.reshape(height, width, 3) / samples


def render_image_data(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    samples: int,
    max_depth: int,
    seed: int,
    *,
    device="cuda",
) -> torch.Tensor:
    """Render driver -> linear radiance (height, width, 3) on ``device``."""
    return render_image_persistent(
        sd, cp, width, height, samples, max_depth, seed, device=device
    )


def render_image(
    scene: Scene,
    samples: int | None = None,
    max_depth: int | None = None,
    seed: int | None = None,
    *,
    device="cuda",
) -> torch.Tensor:
    """Render the scene's camera view -> linear radiance (H, W, 3) float32
    on ``device``."""
    sd = scene.build(device=device)
    cam = scene.scene_cam
    return render_image_data(
        sd,
        cam.params(device=device),
        cam.image_width,
        cam.image_height,
        samples if samples is not None else cam.samples,
        max_depth if max_depth is not None else cam.max_depth,
        seed if seed is not None else scene.seed,
        device=device,
    )


def to_u8(img_linear: torch.Tensor) -> np.ndarray:
    """Linear radiance (H, W, 3) -> uint8 film on the host."""
    return color_mod.to_bytes(torch.as_tensor(img_linear)).cpu().numpy()


def render_image_to_file(scene: Scene, fname: str, *, device="cuda") -> torch.Tensor:
    """Render and write ``fname`` (``.ppm`` as P3 text, another extension as
    PNG; a bare name gets ``.ppm``). Returns the linear image."""
    img = render_image(scene, device=device)
    path = Path(fname)
    if not path.suffix:
        path = path.with_suffix(".ppm")
    path.parent.mkdir(parents=True, exist_ok=True)
    write_image(path, to_u8(img.cpu()))
    return img


def compute_frame_count(duration: float, fps: float) -> int:
    """ceil(duration * fps)."""
    return math.ceil(duration * fps)


def render_movie(
    scene: Scene,
    fname: str,
    skip_existing: bool = False,
    verbose: bool = True,
    on_frame=None,
    *,
    device="cuda",
) -> Path:
    """Render ``ceil(duration * fps)`` frames of a movie scene to
    ``<fname>/artifacts/imageNNN.ppm`` and assemble ``<fname>/<name>.mp4``
    (:func:`make_mp4`).

    Each frame is the scene at its own shutter window: the camera's
    ``frame`` steps through 0..n-1, and ``Scene.build`` and
    ``Camera.params`` lower the timelines for that window. The loop is
    pipelined: frame i is dispatched to the device, then frame i-1 is
    fetched, quantized and written on one worker thread while the device
    renders. ``skip_existing`` skips frames whose file exists (resume);
    ``on_frame(frame_index, seconds)`` fires once per rendered frame, with
    its dispatch-to-written time (which includes the overlap).
    """
    if scene.duration is None:
        raise ValueError("render_movie needs a movie scene (Scene.duration set)")
    out_dir = Path(fname)
    artifacts = out_dir / "artifacts"
    artifacts.mkdir(parents=True, exist_ok=True)
    fps = scene.frame_rate
    n_frames = compute_frame_count(scene.duration, fps)
    pad = max(3, len(str(n_frames)))
    cam = scene.scene_cam

    def finish(path, img, t0, fi):
        write_image(path, to_u8(img.cpu()))  # .cpu() waits for the frame
        return fi, time.time() - t0

    def report(pending):
        done_fi, dt = pending.result()
        if on_frame is not None:
            on_frame(done_fi, dt)

    pending = None
    with ThreadPoolExecutor(max_workers=1) as ex:
        for fi in range(n_frames):
            cam.frame = fi
            frame_path = artifacts / f"image{fi:0{pad}d}.ppm"
            if skip_existing and frame_path.exists():
                continue
            if verbose:
                print(f"frame {fi + 1}/{n_frames}", file=sys.stderr)
            t0 = time.time()
            img = render_image(scene, device=device)
            if pending is not None:
                report(pending)
            pending = ex.submit(finish, frame_path, img, t0, fi)
        if pending is not None:
            report(pending)
    return make_mp4(artifacts, out_dir / f"{out_dir.name}.mp4", fps, pad)


def make_mp4(artifacts: Path, out_path: Path, fps: float, pad: int) -> Path:
    """Assemble ``artifacts/imageNNN.ppm`` into an H.264 mp4 with ffmpeg.
    Where ffmpeg is not on PATH the frames stay as they are, and the
    frames directory is returned."""
    if shutil.which("ffmpeg") is None:
        print("ffmpeg not found; frames left in", artifacts, file=sys.stderr)
        return artifacts
    cmd = [
        "ffmpeg", "-y", "-framerate", str(fps),
        "-i", str(artifacts / f"image%0{pad}d.ppm"),
        "-vf", "scale=trunc(iw/2)*2:trunc(ih/2)*2",
        "-c:v", "libx264", "-pix_fmt", "yuv420p", "-crf", "25",
        str(out_path),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return out_path

