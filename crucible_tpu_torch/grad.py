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
  ``sky_image``, image textures, whose texels are leaves, ``tex_images``,
  nested checkers, and exact-time motion, after the staged record).
  Frozen-decision training records
  the decisions once (:func:`record_decisions`) and replays them in every
  later step (``rec=``).
- ``method='ad'``: direct reverse mode through the checkpointed bounce loop
  (``integrator.render_rays(differentiable=True)``, closest hits by K10, or
  for moving spheres ``intersect.hit_spheres_moving``; a mesh of at most
  ``scene.BVH_MIN_TRIS`` triangles through ``intersect.hit_triangles``, a
  moving one at each path's shutter fraction; exact-time motion through
  the staged bounce's exact branch),
  the semantic reference. A BVH mesh raises ``NotImplementedError``: the
  JAX package's reverse mode cannot pass its BVH walk's ``lax.while_loop``
  either, and the port invents no gradient there.

``method='auto'`` takes the replay, as in the JAX package. Budgets above
``replay.GRAD_SPLIT_MIN_DEPTH`` (the depth-50 training budget) replay
depth-bucketed over a two-level record; ``grad_spec`` /
``grad_record_div`` / ``grad_split`` override its static capacities.

The training surface: :func:`loss_and_grad_recovering` retries a chunk
whose capacities overflowed (a NaN loss) up ``_RECOVERY_LADDER``;
:func:`loss_and_grad_accum` averages sample-chunked gradients, as the
500 spp budget needs; :func:`make_train_step` wraps a ``torch.optim``
optimizer; :func:`save_checkpoint` / :func:`load_checkpoint` keep a run
resumable bit for bit.
"""

from __future__ import annotations

import json
import math
import sys
from dataclasses import replace
from typing import Any, Dict

import numpy as np
import torch

from crucible_tpu_torch.models import integrator
from crucible_tpu_torch.models import replay as replay_mod
from crucible_tpu_torch.models.camera import CameraParams
from crucible_tpu_torch.models.scene import SceneData

# Parameter keys whose value is always a tensor. The others: the texture
# images, a tuple of (H, W, 3) tensors (empty without image textures), and
# the sky image, a tensor leaf where the scene has a spherical sky, else None.
TENSOR_KEYS = (
    "tex_color", "mat_emission", "mat_fuzz", "cam_look_from", "cam_look_at",
    "cam_vfov", "cam_defocus", "cam_focus_dist",
)


def leaf_keys(params) -> tuple:
    """The keys of ``params`` whose value is a tensor leaf: ``TENSOR_KEYS``,
    and ``sky_image`` where it is a tensor (``tex_images``, a tuple, is in
    :func:`leaves`)."""
    return TENSOR_KEYS + (("sky_image",) if params["sky_image"] is not None else ())


def leaves(params) -> Dict[str, torch.Tensor]:
    """Every differentiable tensor of ``params`` by a flat name: the keys of
    :func:`leaf_keys`, then ``tex_images/<i>`` for each texture image."""
    out = {k: params[k] for k in leaf_keys(params)}
    out.update((f"tex_images/{i}", img) for i, img in enumerate(params["tex_images"]))
    return out


def with_leaves(params, flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``params`` with the tensors of ``flat`` (named as by :func:`leaves`)
    in place of its own."""
    out = {**params, **{k: v for k, v in flat.items() if "/" not in k}}
    imgs = [flat.get(f"tex_images/{i}", img) for i, img in enumerate(params["tex_images"])]
    out["tex_images"] = tuple(imgs)
    return out


def extract_params(sd: SceneData, cp: CameraParams) -> Dict[str, Any]:
    """The differentiable leaves of (scene, camera) as a flat dict, keyed
    as in the JAX package."""
    return {
        "tex_color": sd.tex.color,  # solid/checker albedos
        "tex_images": sd.tex.images,  # texture texels
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
    sd = replace(
        sd,
        tex=replace(sd.tex, color=p["tex_color"], images=tuple(p["tex_images"])),
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
    grad_spec=None,
    grad_record_div: int | None = None,
) -> torch.Tensor:
    """Per-pixel mean radiance (P, 3) for the given pixels, differentiable
    w.r.t. ``params``.

    ``method``: 'replay' (record, then the differentiable replay), 'ad'
    (direct reverse mode through the checkpointed bounce loop — the
    semantic reference) or 'auto' (the replay, which takes every scene).
    ``grad_split`` / ``grad_spec`` / ``grad_record_div``: the deep replay's
    ``split`` / ``spec`` / ``record_div`` (``replay.render_rays_replay``,
    whose record pass is the record megakernel where it takes the scene,
    else the staged record).
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
            sd, cp, width, height, pix, smp, seed, max_depth, rec=rec, split=grad_split,
            spec=grad_spec, record_div=grad_record_div,
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
    batch — the reusable half of frozen-decision training. They come from
    the record megakernel where ``integrator.megakernel_record_supported``
    holds, else from the staged record (``replay.resolve_record_mode``).

    Decisions (winner ids, scatter branches, termination) depend on
    geometry, material scalars and the camera, not on albedo or emission,
    so radiometric parameters can be fitted with replay-only steps
    (``loss_and_grad(..., rec=...)``), re-recording when the geometry or
    camera moves.
    """
    pix, smp = _lanes(pixel_ids, spp, sample0)
    mode = replay_mod.resolve_record_mode("auto", sd, cp)
    return replay_mod.record_pass(mode, sd, cp, width, height, pix, smp, seed, max_depth)


def l2_loss(
    params, sd, cp, target, pixel_ids, seed,
    *, width, height, spp, max_depth, method="auto", sample0=0, rec=None,
    grad_split=None, grad_spec=None, grad_record_div=None,
) -> torch.Tensor:
    """Mean squared error of the rendered pixels against ``target`` (P, 3).
    ``sample0`` offsets the sample ids (the chunks of
    :func:`loss_and_grad_accum`); ``grad_*``: the deep replay's capacity
    overrides (:func:`render_pixels_mean`)."""
    img = render_pixels_mean(
        params, sd, cp, pixel_ids, width, height, spp, max_depth, seed,
        method=method, sample0=sample0, rec=rec, grad_split=grad_split,
        grad_spec=grad_spec, grad_record_div=grad_record_div,
    )
    return torch.mean((img - target) ** 2)


def loss_and_grad(params, sd, cp, target, pixel_ids, seed, **kw):
    """(loss, grads): the :func:`l2_loss` value and its gradient, a dict
    with the keys of ``params`` (``tex_images`` a tuple of one gradient an
    image, () without image textures; ``sky_image`` None where the scene
    has no spherical sky, as given). Keyword arguments are those of
    :func:`l2_loss`."""
    flat = {k: v.detach().requires_grad_(True) for k, v in leaves(params).items()}
    with torch.enable_grad():
        loss = l2_loss(with_leaves(params, flat), sd, cp, target, pixel_ids, seed, **kw)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return loss.detach(), with_leaves(params, {
        k: torch.zeros_like(leaf) if g is None else g
        for (k, leaf), g in zip(flat.items(), grads)})


# The capacity-overflow recovery ladder: "default" is the shipped spec;
# k divides every bucket divisor and the narrow record's by k (k times the
# capacities); "unsplit" drops the lane narrowing (always right, the most
# memory).
_RECOVERY_LADDER = ("default", 2, 4, "unsplit")


def _ladder_kwargs(rung) -> dict:
    """The :func:`l2_loss` keyword arguments of a ladder rung."""
    if rung == "default":
        return {}
    if rung == "unsplit":
        return {"grad_split": False}
    spec = tuple((lim, max(1, dv // rung)) for lim, dv in replay_mod.GRAD_BUCKET_SPEC)
    return {"grad_spec": spec,
            "grad_record_div": max(1, replay_mod.RECORD_DEEP_DIV // rung)}


def loss_and_grad_recovering(
    params, sd, cp, target, pixel_ids, seed,
    *, width, height, spp, max_depth, method="auto", sample0=0, rec=None,
    verbose=True, start=0,
):
    """:func:`loss_and_grad` with recovery from capacity overflow.

    The deep replay's static capacities poison the radiance with NaN when a
    scene's survivors exceed them. A non-finite loss sends the chunk up
    ``_RECOVERY_LADDER`` from rung ``start``: doubled capacities, quadrupled,
    then the unsplit replay; each retry is reported on stderr. A loss that
    is non-finite even unsplit is no capacity overflow, and raises
    ``FloatingPointError``. Reading the loss is one host sync per rung.
    """
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth, method=method,
              sample0=sample0, rec=rec)
    for i, rung in enumerate(_RECOVERY_LADDER[start:]):
        extra = _ladder_kwargs(rung)
        loss, grads = loss_and_grad(params, sd, cp, target, pixel_ids, seed, **kw, **extra)
        if math.isfinite(float(loss)):
            if i and verbose:
                print(
                    f"crucible_tpu_torch: recovered from deep-replay capacity overflow "
                    f"at ladder rung {rung!r} ({extra}) — consider setting "
                    f"CRUCIBLE_GRAD_BUCKETS/CRUCIBLE_RECORD_DEEP_DIV or split=False "
                    f"permanently for this scene",
                    file=sys.stderr,
                )
            return loss, grads
        if verbose:
            print(
                f"crucible_tpu_torch: WARNING: non-finite chunk loss at ladder rung "
                f"{rung!r} (sample0={sample0}) — retrying with wider deep-replay "
                f"capacities",
                file=sys.stderr,
            )
    raise FloatingPointError(
        "loss is non-finite even with the full-width (unsplit) replay — this is "
        "NOT a lane-narrowing capacity overflow. Check scene parameters for NaN "
        "sources (negative radii, zero-length camera axes); the capacity knobs "
        "(CRUCIBLE_GRAD_BUCKETS, CRUCIBLE_RECORD_DEEP_DIV, split=) cannot help here."
    )


def loss_and_grad_accum(
    params, sd, cp, target, pixel_ids, seed,
    *, width, height, spp, max_depth, chunk_spp, method="auto", recover=True,
):
    """Sample-chunked gradient accumulation -> (loss, grads): the mean of
    ``spp // chunk_spp`` chunk losses and of their gradients, chunk k on
    samples [k * chunk_spp, (k + 1) * chunk_spp). Deep budgets (500 spp at
    depth 50) train so without holding more than one chunk's records.

    The objective is the mean of chunk losses (minibatch SGD over sample
    windows), not the L2 of the all-sample mean image: E[chunk MSE] is the
    MSE of the mean image plus the chunk estimator's variance, so
    parameters that modulate variance feel an extra pull, as in any
    minibatch Monte Carlo objective.

    Gradients are summed in place into sums allocated once. ``recover``
    checks each chunk's loss for the capacity poison and sends only a
    poisoned chunk up the recovery ladder (from its second rung); the
    check lags one chunk (chunk k + 1 is launched before chunk k's loss is
    read on the host), so the card does not wait on the host between
    chunks. ``recover=False`` reads nothing on the host.
    """
    if spp % chunk_spp:
        raise ValueError(f"spp {spp} is not a multiple of chunk_spp {chunk_spp}")
    n = spp // chunk_spp
    kw = dict(width=width, height=height, spp=chunk_spp, max_depth=max_depth, method=method)
    total = {k: torch.zeros_like(v) for k, v in leaves(params).items()}
    loss_sum = torch.zeros((), dtype=torch.float32, device=params["tex_color"].device)

    def fold(loss_c, grads_c):
        loss_sum.add_(loss_c)
        for k, g in leaves(grads_c).items():
            total[k].add_(g)

    def checked(s0, loss_c, grads_c):
        if not math.isfinite(float(loss_c)):
            print(
                f"crucible_tpu_torch: WARNING: chunk sample0={s0} NaN-poisoned "
                f"(deep-replay capacity overflow) — recovering",
                file=sys.stderr,
            )
            loss_c, grads_c = loss_and_grad_recovering(
                params, sd, cp, target, pixel_ids, seed, sample0=s0, start=1, **kw
            )
        return loss_c, grads_c

    pending = None
    for s0 in range(0, spp, chunk_spp):
        loss_c, grads_c = loss_and_grad(params, sd, cp, target, pixel_ids, seed, sample0=s0,
                                        **kw)
        if not recover:
            fold(loss_c, grads_c)
            continue
        if pending is not None:
            fold(*checked(*pending))
        pending = (s0, loss_c, grads_c)
    if pending is not None:
        fold(*checked(*pending))
    inv = 1.0 / n
    return loss_sum * inv, with_leaves(params, {k: t.mul_(inv) for k, t in total.items()})


def make_train_step(
    optimizer: torch.optim.Optimizer, width: int, height: int, spp: int, max_depth: int,
    recover: bool = False,
):
    """One optimization step over a parameter dict whose optimized leaves
    are the tensors ``optimizer`` was built on (``requires_grad`` set).

    Returns ``step(params, sd, cp, target, pixel_ids, seed, rec=None) ->
    loss``, which updates those leaves in place. ``recover=True`` takes the
    gradient from :func:`loss_and_grad_recovering`, so a poisoned deep
    chunk is retried wider instead of corrupting the parameters (one host
    sync per step), then steps the optimizer.
    """
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth)

    def step(params, sd, cp, target, pixel_ids, seed, rec=None):
        optimizer.zero_grad(set_to_none=True)
        if recover:
            loss, grads = loss_and_grad_recovering(params, sd, cp, target, pixel_ids, seed,
                                                   rec=rec, **kw)
            owned = {id(t) for group in optimizer.param_groups for t in group["params"]}
            flat_grads = leaves(grads)
            for k, t in leaves(params).items():
                if id(t) in owned:
                    t.grad = flat_grads[k]
        else:
            loss = l2_loss(params, sd, cp, target, pixel_ids, seed, rec=rec, **kw)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# Checkpoints: one .npz, read back with allow_pickle=False
# ---------------------------------------------------------------------------


def _flatten_state(x, arrays: list):
    """A JSON-able form of an optimizer ``state_dict`` whose tensors are
    appended to ``arrays`` and named by their index. Dicts keep their key
    types (a state dict's keys are ints) as lists of pairs."""
    if isinstance(x, torch.Tensor):
        arrays.append(x.detach().cpu().numpy())
        return {"tensor": len(arrays) - 1}
    if isinstance(x, dict):
        return {"dict": [[_flatten_state(k, arrays), _flatten_state(v, arrays)]
                         for k, v in x.items()]}
    if isinstance(x, (list, tuple)):
        return {type(x).__name__: [_flatten_state(v, arrays) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"value": x}
    raise TypeError(f"cannot checkpoint an optimizer state value of type {type(x)}")


def _unflatten_state(x, arrays):
    (kind, v), = x.items()
    if kind == "tensor":
        return torch.from_numpy(arrays[f"opt{v}"].copy())
    if kind == "dict":
        return {_unflatten_state(k, arrays): _unflatten_state(w, arrays) for k, w in v}
    if kind == "list":
        return [_unflatten_state(w, arrays) for w in v]
    if kind == "tuple":
        return tuple(_unflatten_state(w, arrays) for w in v)
    return v


def save_checkpoint(path, params, optimizer: torch.optim.Optimizer | None = None,
                    step: int = 0) -> None:
    """Write a parameter dict (and an optimizer's state) to one ``.npz``:
    each tensor leaf as ``param/<name>`` (names as by :func:`leaves`, so
    texture image i is ``param/tex_images/<i>``), ``__step__``, and the
    optimizer's ``state_dict`` as its tensors ``opt<i>`` beside its
    structure in JSON (``__opt__``, uint8). Nothing is pickled."""
    payload = {f"param/{k}": v.detach().cpu().numpy() for k, v in leaves(params).items()}
    payload["__step__"] = np.asarray(step)
    if optimizer is not None:
        arrays = []
        tree = _flatten_state(optimizer.state_dict(), arrays)
        payload.update({f"opt{i}": a for i, a in enumerate(arrays)})
        payload["__opt__"] = np.frombuffer(json.dumps(tree).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_checkpoint(path, *, device="cuda"):
    """-> (params, optimizer state_dict or None, step) from
    :func:`save_checkpoint`'s file; the leaves on ``device``. Give the
    state to ``optimizer.load_state_dict`` of an optimizer built on the same
    leaves in the same order."""
    with np.load(path, allow_pickle=False) as z:
        params = {"tex_images": (), "sky_image": None}
        images = {}
        for name in z.files:
            if name.startswith("param/tex_images/"):
                images[int(name.rsplit("/", 1)[1])] = torch.tensor(z[name], device=device)
            elif name.startswith("param/"):
                params[name[len("param/"):]] = torch.tensor(z[name], device=device)
        params["tex_images"] = tuple(images[i] for i in range(len(images)))
        state = None
        if "__opt__" in z.files:
            state = _unflatten_state(json.loads(z["__opt__"].tobytes()), z)
        return params, state, int(z["__step__"])
