"""Path integrator: the persistent megakernel schedule and its inputs.

Port of the forward-render parts of ``crucible_tpu/models/integrator.py``:
the (N, 32) sphere attribute table, the megakernel's camera vector and
predicate, and ``trace_persistent_mega``, which lays the pixels out as
lanes, calls the megakernel and un-swizzles its per-lane sums. The staged
wavefront schedules are not ported yet; the record-mode predicate serves
``models/replay.py``.
"""

from __future__ import annotations

import torch

from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models.camera import CameraParams
from crucible_tpu_torch.models.scene import SceneData
from crucible_tpu_torch.ops.kernels import megakernel as mk
from crucible_tpu_torch.utils import vec


def make_sphere_table(sd: SceneData) -> torch.Tensor:
    """Per-sphere attribute table (N, 32) float32 in the layout of the JAX
    package (``crucible_tpu/ops/pallas/sphere_shade.py``):

      0-2 center, 3 radius, 4 |c|^2 - r^2, 5 active, 6 material type,
      7 fuzz, 8 ior, 9 scatter prob, 10-12 emission, 13 texture kind,
      14-16 solid color, 17 checker 1/scale, 18-20 even color,
      21-23 odd color, 24-26 center delta, 27 radius delta, 28-29 motion
      quadratic terms, 30 texture id, 31 row id.

    Motion columns are zeros: the port renders static scenes."""
    n = sd.sph_center.shape[0]
    mat = sd.sph_mat.long()
    tid = sd.mat_tex[mat].long()
    even_id = sd.tex.even[tid].long()
    odd_id = sd.tex.odd[tid].long()
    c = sd.sph_center
    r = sd.sph_radius
    emission = sd.mat_emission[mat]
    color = sd.tex.color[tid]
    even = sd.tex.color[even_id]
    odd = sd.tex.color[odd_id]
    zeros = torch.zeros_like(r)
    cols = [
        c[:, 0], c[:, 1], c[:, 2],
        r,
        c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r,
        sd.sph_active.to(torch.float32),
        sd.mat_type[mat].to(torch.float32),
        sd.mat_fuzz[mat],
        sd.mat_ior[mat],
        sd.mat_prob[mat],
        emission[:, 0], emission[:, 1], emission[:, 2],
        sd.tex.kind[tid].to(torch.float32),
        color[:, 0], color[:, 1], color[:, 2],
        sd.tex.inv_scale[tid],
        even[:, 0], even[:, 1], even[:, 2],
        odd[:, 0], odd[:, 1], odd[:, 2],
        zeros, zeros, zeros, zeros, zeros, zeros,
        tid.to(torch.float32),
        torch.arange(n, dtype=torch.float32, device=c.device),
    ]
    return torch.stack(cols, dim=1)


def megakernel_supported(sd: SceneData, cp: CameraParams) -> bool:
    """The port's megakernel renders sphere-only static scenes with solid /
    checker-of-solid textures under the default sky, seen by a static
    camera. :func:`megakernel_unsupported_reason` names what is missing."""
    return megakernel_unsupported_reason(sd, cp) is None


def megakernel_unsupported_reason(sd: SceneData, cp: CameraParams):
    """None if the megakernel renders this scene, else the missing feature."""
    checks = (
        (sd.num_tris == 0, "triangle meshes"),
        (len(sd.tex.images) == 0, "image textures"),
        (sd.tex.max_nest <= 1, "nested checker textures"),
        (sd.sky_kind == sky_mod.DEFAULT, "the spherical sky"),
        (not sd.animated and not sd.motion_exact, "moving spheres"),
        (not cp.animated and not cp.motion_exact, "animated cameras"),
    )
    return next((what for ok, what in checks if not ok), None)


def megakernel_record_supported(sd: SceneData, cp: CameraParams) -> bool:
    """The port's subset of the JAX record-mode predicate: sphere-only
    static scenes seen by a static camera, with at most ``mk.MAX_ROWS`` table
    rows. The record's decisions read no albedo or sky, so textures and the
    sky do not limit it."""
    return megakernel_record_unsupported_reason(sd, cp) is None


def megakernel_record_unsupported_reason(sd: SceneData, cp: CameraParams):
    """None if the record megakernel takes this scene, else what it lacks."""
    checks = (
        (sd.num_tris == 0, "triangle meshes"),
        (not sd.animated and not sd.motion_exact, "moving spheres"),
        (not cp.animated and not cp.motion_exact, "animated cameras"),
        (int(sd.sph_center.shape[0]) <= mk.MAX_ROWS, f"more than {mk.MAX_ROWS} sphere rows"),
    )
    return next((what for ok, what in checks if not ok), None)


def mega_cam_vector(cp: CameraParams, width: int, height: int) -> torch.Tensor:
    """Camera-constant vector (1, 48) for the megakernel: the static-camera
    specialization of ``camera.generate_rays`` (same formulas and eps;
    layout at ``megakernel.CAM_SIZE``)."""
    lf, la = cp.look_from, cp.look_at
    w_b = vec.unit(lf - la, eps=1e-12)
    u_b = vec.unit(vec.cross(cp.vup, w_b), eps=1e-12)
    v_b = vec.cross(w_b, u_b)
    h = torch.tan(cp.vfov_rad / 2.0)
    viewport_h = 2.0 * h * cp.focus_dist
    viewport_w = viewport_h * (width / height)
    du = viewport_w * u_b / width
    dv = viewport_h * (-v_b) / height
    pixel00 = (
        lf - cp.focus_dist * w_b - 0.5 * (width - 1) * du - 0.5 * (height - 1) * dv
    )
    defr = cp.focus_dist * torch.tan(cp.defocus_angle_rad / 2.0)
    defr = torch.where(cp.defocus_angle_rad > 0.0, defr, 0.0)
    f32 = dict(dtype=torch.float32, device=lf.device)
    return torch.cat(
        [
            pixel00, du, dv, lf, u_b, v_b, defr[None],
            # Animated-camera slots 19-37 (megakernel.py layout).
            la, cp.look_from_d, cp.look_at_d, cp.vup,
            viewport_h[None], viewport_w[None], cp.focus_dist[None],
            torch.tensor([width, height], **f32),
            torch.tensor([0.5 * (width - 1), 0.5 * (height - 1)], **f32),
            torch.zeros((10,), **f32),
        ]
    ).to(torch.float32).reshape(1, mk.CAM_SIZE)


def mega_inputs(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed: int,
):
    """The megakernel's inputs for a whole-image render, and the un-swizzle.

    Returns (inputs, lane_of): ``inputs`` holds ``smem``, ``pix``,
    ``sample0``, ``cam`` and ``table`` for ``megakernel.run_megakernel``;
    ``lane_of`` (width*height,) maps each pixel to its lane.

    Lanes are laid out in 32x16 pixel blocks of ``megakernel.TILE`` lanes,
    so that neighbouring lanes trace neighbouring pixels; lanes past the
    image edge carry ``sample0 = 2**30`` and never issue.
    """
    dev = sd.sph_center.device
    bw, bh = 32, mk.TILE // 32
    gx = (width + bw - 1) // bw
    gy = (height + bh - 1) // bh
    r = gx * gy * mk.TILE
    lane = torch.arange(r, dtype=torch.int64, device=dev)
    tile, q = lane // mk.TILE, lane % mk.TILE
    px = (tile % gx) * bw + q % bw
    py = (tile // gx) * bh + q // bw
    valid = (px < width) & (py < height)
    pix = (
        torch.clamp_max(py, height - 1) * width + torch.clamp_max(px, width - 1)
    ).to(torch.int32).reshape(1, r)
    sample0 = torch.where(valid, 0, 2**30).to(torch.int32).reshape(1, r)
    p = torch.arange(width * height, dtype=torch.int64, device=dev)
    ppx, ppy = p % width, p // width
    lane_of = ((ppy // bh) * gx + ppx // bw) * mk.TILE + (ppy % bh) * bw + ppx % bw

    smem = torch.tensor(
        [mk.as_i32(spp), mk.as_i32(seed), width, max_depth, 0, 0, 0, 0],
        dtype=torch.int32,
        device=dev,
    )
    inputs = dict(
        smem=smem,
        pix=pix,
        sample0=sample0,
        cam=mega_cam_vector(cp, width, height),
        table=make_sphere_table(sd),
    )
    return inputs, lane_of


def trace_persistent_mega(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed: int,
) -> torch.Tensor:
    """Whole render in one megakernel call -> per-pixel radiance SUM
    (width*height, 3) over samples 0..spp-1.

    Every random number is pcg4d(pixel, sample, stream, seed), so the
    per-pixel sums do not depend on the lane order (see :func:`mega_inputs`).
    """
    inputs, lane_of = mega_inputs(sd, cp, width, height, spp, max_depth, seed)
    acc = mk.run_megakernel(
        **inputs, animated=bool(sd.animated), cam_animated=bool(cp.animated)
    )
    return acc.t()[lane_of]
