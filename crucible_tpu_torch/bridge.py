"""Carry scene and camera parameters across as numpy arrays.

The parity tests build a scene with the JAX package, turn its ``SceneData``
and ``CameraParams`` leaves into numpy arrays (on the test's side: this
package never sees JAX), and hand them to :func:`scene_data_from_arrays` /
:func:`camera_params_from_arrays`, so that both packages compute on exactly
the same inputs. :func:`scene_data_to_arrays` is the inverse for the port's
own scenes.

Array keys are the ``SceneData`` field names, with the texture table's
fields prefixed ``tex_`` (its images, ``tex_images``, a tuple of (H, W, 3)
arrays, present where the scene has image textures); static keys are
``sky_kind``, ``num_spheres``, ``num_tris``, ``animated``, ``motion_exact``,
``use_bvh``, ``bvh_leaf_size``, ``tri_exact`` and ``max_nest``. As in the
JAX package, ``sky_image`` is
a (1, 1, 3) zero placeholder under the default sky (the port's
``SceneData.sky_image`` is then None). The structure tables of the
sphere walks (``STRUCT_ARRAYS``: the sphere BVH's, or an animated scene's
cluster boxes ``sph_cbounds``), the motion fields (``MOTION_ARRAYS``: the
spheres' and a moving mesh's shutter deltas), the exact-time tracks
(``EXACT_ARRAYS``: a motion_exact scene's sphere tracks and a tri_exact
mesh's vertex tracks) and the triangle and
triangle-BVH arrays (``MESH_ARRAYS``) are optional keys (``OPTIONAL_ARRAYS``,
those a JAX ``SceneData`` has): absent, or None, where the scene has none.
A camera's exact-time tracks (``CAMERA_TRACK_ARRAYS``) are optional keys
of its arrays likewise; :func:`camera_params_to_arrays` is the inverse of
:func:`camera_params_from_arrays`.
The port's own tree (``SWEPT_ARRAYS``, which K5 and K6 walk) is optional
too; :func:`scene_data_from_arrays` builds it where the arrays carry a
sphere BVH or cluster boxes and no tree, as a JAX-lowered scene's do.
:func:`params_from_arrays` / :func:`params_to_arrays` carry the gradient
path's parameter dict (``grad.extract_params``) the same way, and
:func:`params_from_jax_checkpoint` reads it from a checkpoint file of the
JAX package. Packed decision records cross as int32 arrays.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from crucible_tpu_torch.grad import TENSOR_KEYS
from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models.camera import CameraParams
from crucible_tpu_torch.models.scene import SceneData, swept_struct
from crucible_tpu_torch.models.textures import TextureTable

SCENE_ARRAYS = (
    "sph_center", "sph_radius", "sph_mat", "sph_active",
    "mat_type", "mat_tex", "mat_fuzz", "mat_ior", "mat_prob", "mat_emission",
    "sky_image",
)
STRUCT_ARRAYS = ("sph_perm", "sph_nodes", "sph_meta", "sph_cbounds")
SWEPT_ARRAYS = ("sph_swept_perm", "sph_swept_nodes", "sph_swept_meta")
MOTION_ARRAYS = ("sph_center_d", "sph_radius_d", "motion_t0", "motion_t1",
                 "tri_v0_d", "tri_v1_d", "tri_v2_d")
MESH_ARRAYS = ("tri_v0", "tri_v1", "tri_v2", "tri_mat", "tri_active",
               "bvh_min", "bvh_max", "bvh_first", "bvh_count", "bvh_miss")
EXACT_ARRAYS = tuple(f"{p}_{track}_{part}" for p in ("sph", "tri")
                     for track, parts in (("tr", ("t0", "t1", "delta", "init")),
                                          ("sc", ("t0", "t1", "from", "to")))
                     for part in parts)
OPTIONAL_ARRAYS = STRUCT_ARRAYS + MOTION_ARRAYS + EXACT_ARRAYS + MESH_ARRAYS
TEX_ARRAYS = ("kind", "color", "inv_scale", "even", "odd", "image_id")
SCENE_STATIC = ("sky_kind", "num_spheres", "num_tris", "animated", "motion_exact",
                "use_bvh", "bvh_leaf_size", "tri_exact")
CAMERA_ARRAYS = tuple(
    f.name for f in fields(CameraParams) if f.name not in ("animated", "motion_exact")
)
CAMERA_TRACK_ARRAYS = tuple(k for k in CAMERA_ARRAYS if "_tr_" in k)
CAMERA_STATIC = ("animated", "motion_exact")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)  # a copy


def scene_data_from_arrays(
    arrays: dict[str, np.ndarray], *, device="cuda", max_nest: int = 1, **static
) -> SceneData:
    """SceneData on ``device`` from numpy arrays (keys: module docstring).
    Where they carry a static scene's sphere BVH (``sph_nodes``) or an
    animated scene's cluster boxes (``sph_cbounds``) but no swept tree, the
    tree the megakernel walks (K5's, or K6's over the shutter deltas) is
    built from the spheres, as ``Scene.build`` builds it. Unknown static
    keys raise ``TypeError``."""
    unknown = set(static) - set(SCENE_STATIC)
    if unknown:
        raise TypeError(f"unknown static scene fields {sorted(unknown)}")
    tex = TextureTable(
        **{k: _tensor(arrays[f"tex_{k}"], device) for k in TEX_ARRAYS},
        images=tuple(_tensor(np.asarray(im, np.float32), device)
                     for im in arrays.get("tex_images", ())),
        max_nest=int(max_nest),
    )
    sky = static.get("sky_kind", sky_mod.DEFAULT) == sky_mod.SPHERICAL
    optional = {k: _tensor(arrays[k], device) for k in OPTIONAL_ARRAYS + SWEPT_ARRAYS
                if arrays.get(k) is not None}
    walked = "sph_cbounds" in optional or "sph_nodes" in optional
    if walked and "sph_swept_nodes" not in optional:
        deltas = ("sph_center_d", "sph_radius_d") if "sph_cbounds" in optional else ()
        optional.update(swept_struct(*(arrays[k] for k in (
            "sph_center", "sph_radius", "sph_active", *deltas)), device=device))
    return SceneData(
        **{k: _tensor(arrays[k], device) for k in SCENE_ARRAYS if k != "sky_image"},
        tex=tex,
        sky_image=_tensor(arrays["sky_image"], device) if sky else None,
        **optional,
        **static,
    )


def scene_data_to_arrays(sd: SceneData) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, static) such that ``scene_data_from_arrays(arrays,
    device=..., **static)`` rebuilds ``sd``."""
    arrays = {k: getattr(sd, k).cpu().numpy() for k in SCENE_ARRAYS if k != "sky_image"}
    arrays.update({k: getattr(sd, k).cpu().numpy() for k in OPTIONAL_ARRAYS + SWEPT_ARRAYS
                   if getattr(sd, k) is not None})
    arrays["sky_image"] = (
        np.zeros((1, 1, 3), np.float32) if sd.sky_image is None
        else sd.sky_image.cpu().numpy()
    )
    arrays.update({f"tex_{k}": getattr(sd.tex, k).cpu().numpy() for k in TEX_ARRAYS})
    if sd.tex.images:
        arrays["tex_images"] = tuple(im.cpu().numpy() for im in sd.tex.images)
    static = {k: getattr(sd, k) for k in SCENE_STATIC}
    static["max_nest"] = sd.tex.max_nest
    return arrays, static


def camera_params_from_arrays(
    arrays: dict[str, np.ndarray], *, device="cuda", animated: bool = False,
    motion_exact: bool = False,
) -> CameraParams:
    """CameraParams on ``device`` from numpy arrays keyed by field name.
    A missing shutter delta (``look_from_d`` / ``look_at_d``) means zero; a
    missing exact-time track (``CAMERA_TRACK_ARRAYS``) None."""
    arrays = {"look_from_d": np.zeros(3), "look_at_d": np.zeros(3), **arrays}
    vals = {
        k: _tensor(np.asarray(arrays[k], np.float32), device) for k in CAMERA_ARRAYS
        if k not in CAMERA_TRACK_ARRAYS or arrays.get(k) is not None
    }
    return CameraParams(**vals, animated=animated, motion_exact=motion_exact)


def camera_params_to_arrays(cp: CameraParams) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, static) such that ``camera_params_from_arrays(arrays,
    device=..., **static)`` rebuilds ``cp``."""
    arrays = {k: getattr(cp, k).detach().cpu().numpy() for k in CAMERA_ARRAYS
              if getattr(cp, k) is not None}
    return arrays, {k: getattr(cp, k) for k in CAMERA_STATIC}


def params_from_arrays(arrays: dict, *, device="cuda") -> dict:
    """A ``grad.extract_params`` dict on ``device`` from numpy arrays with
    the same keys (``grad.TENSOR_KEYS`` hold the arrays). ``sky_image`` is
    an (H, W, 3) array or missing / None (the default sky); ``tex_images``
    a sequence of (H, W, 3) arrays, missing or empty without image
    textures."""
    params = {
        k: _tensor(np.asarray(arrays[k], np.float32), device) for k in TENSOR_KEYS
    }
    sky = arrays.get("sky_image")
    sky = None if sky is None else _tensor(np.asarray(sky, np.float32), device)
    images = tuple(_tensor(np.asarray(im, np.float32), device)
                   for im in arrays.get("tex_images", ()))
    return {**params, "tex_images": images, "sky_image": sky}


def params_to_arrays(params: dict) -> dict:
    """The inverse of :func:`params_from_arrays`."""
    out = {k: params[k].detach().cpu().numpy() for k in TENSOR_KEYS}
    sky = params["sky_image"]
    return {**out, "tex_images": tuple(im.detach().cpu().numpy()
                                       for im in params["tex_images"]),
            "sky_image": None if sky is None else sky.detach().cpu().numpy()}


# The JAX parameter dict's keys in its flatten order (sorted keys); the
# texture images, a tuple, flatten to one leaf an image, last.
JAX_LEAF_ORDER = tuple(sorted(TENSOR_KEYS + ("sky_image", "tex_images")))


def params_from_jax_checkpoint(path, *, device="cuda"):
    """-> (params, None, step) from a ``.npz`` written by the JAX package's
    ``grad.save_checkpoint``: its leaves ``p{i}`` in the flatten order of
    the parameter dict (``JAX_LEAF_ORDER``), and ``__step__``.

    The pickled tree structure (``__treedef__``) is not read (the file is
    opened with ``allow_pickle=False``), and neither is the optax state
    (``o{i}``): a ``torch.optim`` optimizer cannot take it, so its place in
    the result is None and a resumed run starts its optimizer afresh.
    ``sky_image`` is None where the file holds the JAX package's (1, 1, 3)
    zero placeholder of the default sky. The leaves past ``tex_color`` are
    the texture images, in order.
    """
    with np.load(path, allow_pickle=False) as z:
        n = sum(1 for name in z.files if name[0] == "p" and name[1:].isdigit())
        leaves = [z[f"p{i}"] for i in range(n)]
        step = int(z["__step__"])
    keys = [k for k in JAX_LEAF_ORDER if k != "tex_images"]
    if n < len(keys):
        raise ValueError(f"{path}: {n} parameter leaves, fewer than the {len(keys)} "
                         "of a JAX parameter dict")
    arrays = dict(zip(keys, leaves))
    arrays["tex_images"] = leaves[len(keys):]
    sky = arrays["sky_image"]
    if sky.shape == (1, 1, 3) and not sky.any():
        arrays["sky_image"] = None
    return params_from_arrays(arrays, device=device), None, step
