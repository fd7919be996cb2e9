"""Differentiable rendering: parameter dicts, the L2 loss, gradient steps.

Port of the unsplit gradient path of ``crucible_tpu/grad.py``. The
parameters are a flat dict of the scene's and camera's differentiable
tensors (:func:`extract_params`); :func:`loss_and_grad` returns the L2
loss against target pixel radiances and its gradient with the same keys.
Two estimators compute it:

- ``method='replay'``: the record/replay path of ``models/replay.py``
  (record K2, K5, K8 or K7; replay K4 forward and K3 backward where the
  replay kernels take the scene, else the eager per-bounce replay: moving
  spheres and animated cameras, tables above 2048 rows, triangle meshes,
  static or moving, the spherical sky, whose image is then a leaf,
  ``sky_image``).
  Frozen-decision training records
  the decisions once (:func:`record_decisions`) and replays them in every
  later step (``rec=``).
- ``method='ad'``: direct reverse mode through the checkpointed bounce loop
  (``integrator.render_rays(differentiable=True)``, closest hits by K10, or
  for moving spheres ``intersect.hit_spheres_moving``; a mesh of at most
  ``scene.BVH_MIN_TRIS`` triangles through ``intersect.hit_triangles``, a
  moving one at each path's shutter fraction),
  the semantic reference. A BVH mesh raises ``NotImplementedError``: the
  JAX package's reverse mode cannot pass its BVH walk's ``lax.while_loop``
  either, and the port invents no gradient there.

``method='auto'`` takes the replay, as in the JAX package.
:func:`make_train_step` wraps a ``torch.optim`` optimizer.

Not ported yet: the depth-50 budget (lane-narrowed replay), the
capacity-overflow recovery ladder, sample-chunked accumulation and
checkpoints.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict

import torch

from crucible_tpu_torch.models import integrator
from crucible_tpu_torch.models import replay as replay_mod
from crucible_tpu_torch.models.camera import CameraParams
from crucible_tpu_torch.models.scene import SceneData

# Parameter keys whose value is always a tensor. The others: the texture
# images, a tuple (empty: image textures are not ported), and the sky
# image, a tensor leaf where the scene has a spherical sky, else None.
TENSOR_KEYS = (
    "tex_color", "mat_emission", "mat_fuzz", "cam_look_from", "cam_look_at",
    "cam_vfov", "cam_defocus", "cam_focus_dist",
)


def leaf_keys(params) -> tuple:
    """The keys of ``params`` that are differentiable tensor leaves:
    ``TENSOR_KEYS``, and ``sky_image`` where it is a tensor."""
    return TENSOR_KEYS + (("sky_image",) if params["sky_image"] is not None else ())


def extract_params(sd: SceneData, cp: CameraParams) -> Dict[str, Any]:
    """The differentiable leaves of (scene, camera) as a flat dict, keyed
    as in the JAX package."""
    return {
        "tex_color": sd.tex.color,  # solid/checker albedos
        "tex_images": sd.tex.images,  # texture texels (none are ported)
        "mat_emission": sd.mat_emission,
        "mat_fuzz": sd.mat_fuzz,
        "sky_image": sd.sky_image,  # None under the default sky
        "cam_look_from": cp.look_from,
        "cam_look_at": cp.look_at,
        "cam_vfov": cp.vfov_rad,
        "cam_defocus": cp.defocus_angle_rad,
        "cam_focus_dist": cp.focus_dist,
    }


def apply_params(sd: SceneData, cp: CameraParams, p: Dict[str, Any]):
    """Write a parameter dict back into new (scene, camera) dataclasses."""
    if len(p["tex_images"]):
        raise NotImplementedError(
            "image textures are not ported to crucible_tpu_torch yet"
        )
    sd = replace(
        sd,
        tex=replace(sd.tex, color=p["tex_color"]),
        mat_emission=p["mat_emission"],
        mat_fuzz=p["mat_fuzz"],
        sky_image=p["sky_image"],
    )
    cp = replace(
        cp,
        look_from=p["cam_look_from"],
        look_at=p["cam_look_at"],
        vfov_rad=p["cam_vfov"],
        defocus_angle_rad=p["cam_defocus"],
        focus_dist=p["cam_focus_dist"],
    )
    return sd, cp


def _lanes(pixel_ids: torch.Tensor, spp: int, sample0: int):
    """Lane ids of a pixel batch: pixels tiled spp times, sample-major."""
    p = pixel_ids.shape[0]
    pix = pixel_ids.to(torch.int64).repeat(spp)
    smp = torch.arange(
        sample0, sample0 + spp, dtype=torch.int64, device=pixel_ids.device
    ).repeat_interleave(p)
    return pix, smp


def render_pixels_mean(
    params,
    sd: SceneData,
    cp: CameraParams,
    pixel_ids: torch.Tensor,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed,
    method: str = "auto",
    sample0: int = 0,
    rec=None,
    grad_split: bool | None = None,
) -> torch.Tensor:
    """Per-pixel mean radiance (P, 3) for the given pixels, differentiable
    w.r.t. ``params``.

    ``method``: 'replay' (record, then the differentiable replay), 'ad'
    (direct reverse mode through the checkpointed bounce loop — the
    semantic reference) or 'auto' (the replay, which takes every scene).
    """
    if method not in ("auto", "replay", "ad"):
        raise ValueError(f"unknown method {method!r}")
    sd, cp = apply_params(sd, cp, params)
    if method == "auto":
        method = "replay"
    if rec is not None and method != "replay":
        raise ValueError(
            "precomputed decision records (rec=...) need the replay gradient "
            f"path, but method resolved to {method!r}"
        )
    if method == "ad" and sd.num_tris > 0 and sd.use_bvh:
        raise NotImplementedError(
            "direct AD (method='ad') through a BVH mesh: the BVH walk has no "
            "reverse mode, in the JAX package (its lax.while_loop) as here; use "
            "method='replay'"
        )
    pix, smp = _lanes(pixel_ids, spp, sample0)
    if method == "replay":
        rad = replay_mod.render_rays_replay(
            sd, cp, width, height, pix, smp, seed, max_depth, rec=rec, split=grad_split
        )
    else:
        rad = integrator.render_rays(
            sd, cp, width, height, pix, smp, seed, max_depth, differentiable=True
        )
    return rad.reshape(spp, pixel_ids.shape[0], 3).mean(dim=0)


def record_decisions(
    sd: SceneData,
    cp: CameraParams,
    pixel_ids: torch.Tensor,
    seed,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    sample0: int = 0,
) -> torch.Tensor:
    """Packed decision records (max_depth, spp * P) int32 for a pixel
    batch — the reusable half of frozen-decision training.

    Decisions (winner ids, scatter branches, termination) depend on
    geometry, material scalars and the camera, not on albedo or emission,
    so radiometric parameters can be fitted with replay-only steps
    (``loss_and_grad(..., rec=...)``), re-recording when the geometry or
    camera moves.
    """
    pix, smp = _lanes(pixel_ids, spp, sample0)
    return replay_mod.trace_record_mega(
        sd, cp, width, height, pix, smp, seed, max_depth
    )


def l2_loss(
    params, sd, cp, target, pixel_ids, seed,
    *, width, height, spp, max_depth, method="auto", sample0=0, rec=None,
    grad_split=None,
) -> torch.Tensor:
    """Mean squared error of the rendered pixels against ``target`` (P, 3)."""
    img = render_pixels_mean(
        params, sd, cp, pixel_ids, width, height, spp, max_depth, seed,
        method=method, sample0=sample0, rec=rec, grad_split=grad_split,
    )
    return torch.mean((img - target) ** 2)


def loss_and_grad(params, sd, cp, target, pixel_ids, seed, **kw):
    """(loss, grads): the :func:`l2_loss` value and its gradient, a dict
    with the keys of ``params`` (``tex_images`` (), and ``sky_image`` None
    where the scene has no spherical sky, as given). Keyword arguments are
    those of :func:`l2_loss`."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in leaf_keys(params)}
    with torch.enable_grad():
        loss = l2_loss({**params, **leaves}, sd, cp, target, pixel_ids, seed, **kw)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    out = {**params}
    for (k, leaf), g in zip(leaves.items(), grads):
        out[k] = torch.zeros_like(leaf) if g is None else g
    return loss.detach(), out


def make_train_step(
    optimizer: torch.optim.Optimizer, width: int, height: int, spp: int, max_depth: int
):
    """One optimization step over a parameter dict whose optimized leaves
    are the tensors ``optimizer`` was built on (``requires_grad`` set).

    Returns ``step(params, sd, cp, target, pixel_ids, seed, rec=None) ->
    loss``, which updates those leaves in place.
    """

    def step(params, sd, cp, target, pixel_ids, seed, rec=None):
        optimizer.zero_grad(set_to_none=True)
        loss = l2_loss(
            params, sd, cp, target, pixel_ids, seed,
            width=width, height=height, spp=spp, max_depth=max_depth, rec=rec,
        )
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
