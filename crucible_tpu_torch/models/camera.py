"""Camera: viewport math, defocus, batched primary-ray generation.

Port of ``crucible_tpu/models/camera.py``: :class:`Camera` is the host-side
settings object with the original renderer's setter surface, and
:class:`CameraParams` holds the tensors the integrator reads. Cameras may
be keyframed (``from_timeline`` / ``at_timeline``, filled by the scene's
``cam_translate_*`` animator): their position and target then move
linearly over the shutter, and each ray re-derives the basis at its
shutter fraction. A camera keyframe inside the shutter window gives the
camera exact-time tracks instead, evaluated at each ray's absolute time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from crucible_tpu_torch.models.timeline import TransformTimeline, eval_translate
from crucible_tpu_torch.ops import sampling
from crucible_tpu_torch.utils import rng as crng
from crucible_tpu_torch.utils import vec


@dataclass
class CameraParams:
    """Camera tensors (float32 scalars and 3-vectors on one device).

    An animated camera's position at a ray's shutter fraction w in [0, 1)
    is ``look_from + w * look_from_d`` (and its target likewise), exact for
    the timeline's tracks unless a keyframe falls inside the shutter; then
    ``motion_exact`` is set, and the rays read the exact-time tracks
    ``from_tr_*`` / ``at_tr_*`` (``timeline.lower_translate``'s segments,
    None otherwise) at their absolute times.
    """

    look_from: torch.Tensor  # (3,) at shutter open
    look_at: torch.Tensor  # (3,)
    vup: torch.Tensor  # (3,)
    vfov_rad: torch.Tensor  # ()
    defocus_angle_rad: torch.Tensor  # ()
    focus_dist: torch.Tensor  # ()
    frame_time: torch.Tensor  # () = frame / frame_rate
    shutter_length: torch.Tensor  # () = (shutter_angle/360) / frame_rate
    look_from_d: torch.Tensor  # (3,) shutter-close minus shutter-open
    look_at_d: torch.Tensor  # (3,)
    # Exact-time tracks of the position ("from") and the target ("at"),
    # set where a camera keyframe lies strictly inside the shutter window.
    from_tr_t0: Optional[torch.Tensor] = None  # (K,)
    from_tr_t1: Optional[torch.Tensor] = None  # (K,)
    from_tr_delta: Optional[torch.Tensor] = None  # (K, 3)
    from_tr_init: Optional[torch.Tensor] = None  # (3,)
    at_tr_t0: Optional[torch.Tensor] = None
    at_tr_t1: Optional[torch.Tensor] = None
    at_tr_delta: Optional[torch.Tensor] = None
    at_tr_init: Optional[torch.Tensor] = None
    animated: bool = False
    motion_exact: bool = False


def generate_rays(
    cp: CameraParams,
    width: int,
    height: int,
    pixel_ids: torch.Tensor,
    sample_ids: torch.Tensor,
    seed,
):
    """One primary ray per (pixel, sample) pair.

    [-0.5,0.5)^2 pixel jitter and the defocus disk come from ONE PCG4D hash
    (stream STREAM_PIXEL_JITTER); the shutter time from STREAM_TIME. The
    direction is pixel position minus origin, unnormalized. An animated
    camera re-derives its basis per ray at the ray's shutter fraction; one
    with exact-time tracks evaluates them at the ray's absolute time
    ``frame_time + u_t * shutter_length``.

    Args:
      pixel_ids: (R,) integer flat pixel index j*width + i.
      sample_ids: (R,) integer sample index within the pixel.
      seed: uint32 render seed.

    Returns: (origins (R,3), directions (R,3), times (R,))
    """
    i = (pixel_ids % width).to(torch.float32)
    j = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)

    ux, uy, ud1, ud2 = crng.uniform4(
        pixel_ids, sample_ids, crng.STREAM_PIXEL_JITTER, seed
    )
    u_t = crng.uniform1(pixel_ids, sample_ids, crng.STREAM_TIME, seed)
    times = cp.frame_time + u_t * cp.shutter_length

    if cp.animated and cp.motion_exact:
        if cp.from_tr_t0 is None or cp.at_tr_t0 is None:
            raise ValueError("the camera says motion_exact but carries no exact-time "
                             "tracks (from_tr_*, at_tr_*)")
        lf = eval_translate(cp.from_tr_t0, cp.from_tr_t1, cp.from_tr_delta,
                            cp.from_tr_init, times)  # (R, 3)
        la = eval_translate(cp.at_tr_t0, cp.at_tr_t1, cp.at_tr_delta, cp.at_tr_init, times)
    elif cp.animated:
        w01 = u_t[:, None]  # (R, 1)
        lf = cp.look_from[None, :] + w01 * cp.look_from_d[None, :]  # (R, 3)
        la = cp.look_at[None, :] + w01 * cp.look_at_d[None, :]
    else:
        lf = cp.look_from
        la = cp.look_at
    w = vec.unit(lf - la, eps=1e-12)
    u = vec.unit(vec.cross(torch.broadcast_to(cp.vup, w.shape), w), eps=1e-12)
    v = vec.cross(w, u)

    h = torch.tan(cp.vfov_rad / 2.0)
    viewport_h = 2.0 * h * cp.focus_dist
    viewport_w = viewport_h * (width / height)

    viewport_u = viewport_w * u  # horizontal edge
    viewport_v = viewport_h * (-v)  # vertical edge, image-down
    du = viewport_u / width
    dv = viewport_v / height
    pixel00 = lf - cp.focus_dist * w - 0.5 * (width - 1) * du - 0.5 * (height - 1) * dv

    offset = sampling.square_offset(ux, uy)  # (R, 2)
    pixel_pos = (
        pixel00
        + (i + offset[:, 0])[:, None] * du
        + (j + offset[:, 1])[:, None] * dv
    )

    defocus_radius = cp.focus_dist * torch.tan(cp.defocus_angle_rad / 2.0)
    disk = sampling.in_unit_disk(ud1, ud2)  # (R, 2)
    defocus_origin = (
        lf
        + (disk[:, 0] * defocus_radius)[:, None] * u
        + (disk[:, 1] * defocus_radius)[:, None] * v
    )
    use_defocus = cp.defocus_angle_rad > 0.0
    origins = torch.where(use_defocus, defocus_origin, lf)
    origins = torch.broadcast_to(origins, pixel_pos.shape)
    dirs = pixel_pos - origins
    return origins, dirs, times


@dataclass
class Camera:
    """Host-side camera settings, mirroring the original renderer's setters."""

    aspect_ratio: float = 16.0 / 9.0
    image_width: int = 400
    frame_rate: float = 24.0
    shutter_angle: float = 180.0

    vfov_deg: float = 90.0
    look_from_pt: tuple = (0.0, 0.0, 0.0)
    look_at_pt: tuple = (0.0, 0.0, -1.0)
    vup: tuple = (0.0, 1.0, 0.0)
    defocus_angle_deg: float = 0.0
    focus_dist: float = 10.0

    samples: int = 10
    max_depth: int = 10
    frame: int = 0

    # Filled by the scene's animator for movie scenes (keyframed from / at).
    from_timeline: Optional[object] = field(default=None, repr=False)
    at_timeline: Optional[object] = field(default=None, repr=False)

    @property
    def image_height(self) -> int:
        return max(1, int(self.image_width / self.aspect_ratio))

    # --- setter surface ----------------------------------------------------
    def set_samples(self, s: int) -> None:
        assert s > 0, "samples must be positive"
        self.samples = int(s)

    def set_max_depth(self, d: int) -> None:
        self.max_depth = int(d)

    def set_vfov(self, deg: float) -> None:
        self.vfov_deg = float(deg)

    def set_hfov(self, deg: float) -> None:
        """Convert a horizontal fov to the vertical one."""
        h = math.tan(math.radians(deg) / 2.0)
        v = h * (self.image_height / self.image_width)
        self.vfov_deg = math.degrees(2.0 * math.atan(v))

    def set_defocus_angle(self, deg: float) -> None:
        self.defocus_angle_deg = float(deg)

    def set_focus_dist(self, dist: float) -> None:
        self.focus_dist = float(dist)

    def set_threads(self, _n: int) -> None:
        """Compatibility no-op: parallelism lives on the device."""

    def look_from(self, p) -> None:
        """Set the camera position; resets any from-animation."""
        self.look_from_pt = tuple(float(x) for x in p)
        self.from_timeline = None

    def look_at(self, p) -> None:
        """Set the camera target; resets any at-animation."""
        self.look_at_pt = tuple(float(x) for x in p)
        self.at_timeline = None

    def next_frame(self) -> None:
        self.frame += 1

    def get_res(self) -> tuple:
        return (self.image_width, self.image_height)

    # --- tensors -------------------------------------------------------------
    def frame_time(self) -> float:
        return self.frame * (1.0 / self.frame_rate)

    def shutter_window(self) -> tuple:
        t_open = self.frame_time()
        return t_open, t_open + (self.shutter_angle / 360.0) / self.frame_rate

    def params(self, *, device="cuda") -> CameraParams:
        """The camera's tensors on ``device``: the shutter-open position and
        target, and for a keyframed camera their shutter-close minus
        shutter-open deltas. A timeline boundary strictly inside the
        shutter window sets ``motion_exact`` (the linear lerp would depart
        from the timeline there) and the exact-time tracks of both the
        position and the target: a static one holds one zero-delta
        segment."""

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        t_open, t_close = self.shutter_window()
        animated = self.from_timeline is not None or self.at_timeline is not None
        if self.from_timeline is not None:
            from_a = self.from_timeline.position_at(t_open)
            from_b = self.from_timeline.position_at(t_close)
        else:
            from_a = from_b = self.look_from_pt
        if self.at_timeline is not None:
            at_a = self.at_timeline.position_at(t_open)
            at_b = self.at_timeline.position_at(t_close)
        else:
            at_a = at_b = self.look_at_pt
        exact = False
        for tl in (self.from_timeline, self.at_timeline):
            if tl is not None:
                b = tl.boundary_times()
                exact |= bool(np.any((b > t_open + 1e-9) & (b < t_close - 1e-9)))
        tracks = {}
        if exact:
            for name, tl, init in (("from", self.from_timeline, self.look_from_pt),
                                   ("at", self.at_timeline, self.look_at_pt)):
                tl = tl or TransformTimeline(init_pos=tuple(init))
                a0, a1, dl = tl.lower_translate()
                if len(a0) == 0:  # a static one: one zero-delta segment
                    a0 = a1 = np.zeros((1,), np.float32)
                    dl = np.zeros((1, 3), np.float32)
                tracks.update({f"{name}_tr_t0": f32(a0), f"{name}_tr_t1": f32(a1),
                               f"{name}_tr_delta": f32(dl), f"{name}_tr_init": f32(tl.init_pos)})
        return CameraParams(
            look_from=f32(from_a),
            look_at=f32(at_a),
            vup=f32(self.vup),
            vfov_rad=f32(math.radians(self.vfov_deg)),
            defocus_angle_rad=f32(math.radians(self.defocus_angle_deg)),
            focus_dist=f32(self.focus_dist),
            frame_time=f32(t_open),
            shutter_length=f32((self.shutter_angle / 360.0) / self.frame_rate),
            look_from_d=f32(np.subtract(from_b, from_a)),
            look_at_d=f32(np.subtract(at_b, at_a)),
            **tracks,
            animated=animated,
            motion_exact=exact,
        )
