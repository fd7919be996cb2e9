"""Scene: user-facing builder API + the SoA ``SceneData`` of tensors.

Port of ``crucible_tpu/models/scene.py``. The host side keeps the original
surface (aliased elements via an id vendor, OBJ mesh assets, show/hide)
and ``Scene.build`` lowers the element list into flat arrays with numpy,
exactly as the JAX package does, converting to tensors on the requested
device only at the end. The spherical (equirect) sky loads from an image
asset. Scenes above ``render.CULL_MIN_ROWS`` sphere rows also get the JAX
lowering's sphere-BVH (static) or cluster (animated) tables and the tree
the megakernel walks (K5, K6). Triangles (``Triangle``,
``load_asset``) are lowered as the JAX package lowers meshes: up to
``BVH_MIN_TRIS`` as brute arrays padded to a multiple of 8, above it in
the leaf order of a BVH whose children are ordered near-first along the
camera's view. Spheres, triangles (one timeline per vertex) and the camera
are animated with keyframe timelines (``models/timeline.py``) through the
animator surface (``translate_*``, ``scale_*``, ``cam_translate_*``);
``Scene.build`` lowers them for one shutter window, linearly (centre and
radius, or the vertices, at shutter open plus their deltas to shutter
close). An image texture's file is decoded once per name
(``io.image.load_image``), and its rows index the table's ``images``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from crucible_tpu_torch.io.image import load_image
from crucible_tpu_torch.io.obj import load_obj
from crucible_tpu_torch.models import materials as mat_mod
from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models import textures as tex_mod
from crucible_tpu_torch.models.camera import Camera
from crucible_tpu_torch.models import timeline as tl_mod
from crucible_tpu_torch.models.timeline import TransformTimeline
from crucible_tpu_torch.ops.bvh import FlatBVH, build_bvh, reorder_front_to_back

# Brute-force triangle intersection up to this count; a BVH above it.
BVH_MIN_TRIS = 64
# Triangles a BVH leaf holds when Scene.build is not told: 32 on the CPU
# (the JAX package's CPU default, so that both packages build one tree),
# and on a CUDA card the size at which the megakernel's triangle stage (K7)
# renders torus_teapot fastest (chip_smoke.py's leaf-size sweep, PERF.md).
BVH_LEAF_CPU = 32
BVH_LEAF_CUDA = 4

# Sphere-table row padding (the JAX package's default, env override and all,
# so both packages build identical tables).
SPHERE_PAD = int(os.environ.get("CRUCIBLE_SPHERE_PAD", "8"))


# --------------------------------------------------------------------------
# Host-side texture / material specs (hashable, deduped into tables at build)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SolidColor:
    color: Tuple[float, float, float]


@dataclass(frozen=True)
class ImageTexture:
    """Nearest-neighbor lookup of an image asset (``io.image.load_image``)."""

    filename: str


@dataclass(frozen=True)
class CheckerTexture:
    """3-D checker over two sub-textures."""

    scale: float
    even: "TextureSpec"
    odd: "TextureSpec"

    @classmethod
    def from_colors(cls, scale, c1, c2):
        return cls(scale, SolidColor(tuple(c1)), SolidColor(tuple(c2)))


TextureSpec = Union[SolidColor, CheckerTexture, ImageTexture]


@dataclass(frozen=True)
class Lambertian:
    """Textured albedo + Russian-roulette scatter probability."""

    texture: TextureSpec
    scatter_prob: float = 1.0

    @classmethod
    def from_color(cls, color, prob: float = 1.0):
        return cls(SolidColor(tuple(float(c) for c in color)), prob)

    @classmethod
    def from_texture(cls, tex: TextureSpec, prob: float = 1.0):
        return cls(tex, prob)


@dataclass(frozen=True)
class Metal:
    """Fuzzy mirror; fuzz must be in [0, 1]."""

    albedo: Tuple[float, float, float]
    fuzz: float = 0.0

    def __post_init__(self):
        assert 0.0 <= self.fuzz <= 1.0, "A metal fuzz factor must be in [0, 1]"


@dataclass(frozen=True)
class Dielectric:
    """Glass/water with Schlick reflectance."""

    refraction_index: float


@dataclass(frozen=True)
class Emissive:
    """Light-emitting material."""

    emission: Tuple[float, float, float]


MaterialSpec = Union[Lambertian, Metal, Dielectric, Emissive]


# --------------------------------------------------------------------------
# Host-side geometry elements
# --------------------------------------------------------------------------


@dataclass
class Sphere:
    center: Tuple[float, float, float]
    radius: float
    material: MaterialSpec
    id: int = 0
    hide: bool = False
    timeline: Optional[object] = None  # TransformTimeline once animated

    def __post_init__(self):
        assert self.radius >= 0.0, "Cannot make a sphere with negative radius"


@dataclass
class Triangle:
    """Triangle element; ``timelines`` holds one timeline per vertex once
    it is animated."""

    v0: Tuple[float, float, float]
    v1: Tuple[float, float, float]
    v2: Tuple[float, float, float]
    material: MaterialSpec
    id: int = 0
    hide: bool = False
    timelines: Optional[tuple] = None


# --------------------------------------------------------------------------
# Id vendor
# --------------------------------------------------------------------------

CAMERA_TYPE = "camera"
SPHERE_TYPE = "sphere"
TRIANGLE_TYPE = "triangle"
MESH_TYPE = "triangle_mesh"


class IdVendor:
    """Alias -> (id, object type); id 0 is reserved for the camera."""

    def __init__(self):
        self._table: Dict[str, Tuple[int, str]] = {"cam": (0, CAMERA_TYPE)}
        self._next = 1

    def vend_id(self, alias: str, o_type: str) -> Optional[int]:
        if alias in self._table:
            return None  # collision
        oid = self._next
        self._next += 1
        self._table[alias] = (oid, o_type)
        return oid

    def alias_lookup(self, alias: str) -> Optional[Tuple[int, str]]:
        return self._table.get(alias)


# --------------------------------------------------------------------------
# Device-side scene
# --------------------------------------------------------------------------


@dataclass
class SceneData:
    """Flat SoA scene: tensors on one device + static metadata.

    Field names and layouts are those of the JAX package's ``SceneData``.
    ``sky_image`` is None under the
    default sky (where the JAX package keeps a (1, 1, 3) placeholder).
    ``Scene.build`` always fills the triangle and triangle-BVH fields, with
    the JAX package's one-row placeholders where there is no mesh; a
    scene bridged without them has None there.
    """

    # Spheres (padded to SPHERE_PAD multiples; `sph_active` masks padding+hidden)
    sph_center: torch.Tensor  # (N, 3) float32
    sph_radius: torch.Tensor  # (N,) float32
    sph_mat: torch.Tensor  # (N,) int32
    sph_active: torch.Tensor  # (N,) bool

    # Material table
    mat_type: torch.Tensor  # (L,) int32
    mat_tex: torch.Tensor  # (L,) int32 albedo texture id
    mat_fuzz: torch.Tensor  # (L,)
    mat_ior: torch.Tensor  # (L,)
    mat_prob: torch.Tensor  # (L,)
    mat_emission: torch.Tensor  # (L, 3)

    tex: tex_mod.TextureTable

    sky_image: Optional[torch.Tensor] = None  # (H, W, 3) spherical sky

    # Linear shutter-motion deltas (animated scenes, else None): a sphere at
    # the per-ray shutter fraction w has center c + w * cd and radius
    # r + w * rd (models/timeline.py).
    sph_center_d: Optional[torch.Tensor] = None  # (N, 3) float32
    sph_radius_d: Optional[torch.Tensor] = None  # (N,) float32
    # The shutter window (absolute times) of a motion_exact scene, else None.
    motion_t0: Optional[torch.Tensor] = None  # () float32
    motion_t1: Optional[torch.Tensor] = None  # () float32
    # Exact-time tracks (a motion_exact scene's, else None): every sphere's
    # translate and scale tracks (timeline.lower_translate / lower_scale,
    # padded by pad_tracks / pad_scale_tracks to the table's rows), which
    # the staged bounce evaluates at each ray's absolute time t = motion_t0
    # + w * (motion_t1 - motion_t0); the radius is scale component 0.
    sph_tr_t0: Optional[torch.Tensor] = None  # (N, Kt) float32
    sph_tr_t1: Optional[torch.Tensor] = None
    sph_tr_delta: Optional[torch.Tensor] = None  # (N, Kt, 3)
    sph_tr_init: Optional[torch.Tensor] = None  # (N, 3)
    sph_sc_t0: Optional[torch.Tensor] = None  # (N, Ks)
    sph_sc_t1: Optional[torch.Tensor] = None
    sph_sc_from: Optional[torch.Tensor] = None  # (N, Ks, 3)
    sph_sc_to: Optional[torch.Tensor] = None
    # A tri_exact mesh's vertex tracks, vertex-major (row vi * M + k is
    # vertex vi of triangle k, in the vertex arrays' order: leaf order for
    # a BVH mesh, padded for a brute one).
    tri_tr_t0: Optional[torch.Tensor] = None  # (3M, Kt)
    tri_tr_t1: Optional[torch.Tensor] = None
    tri_tr_delta: Optional[torch.Tensor] = None  # (3M, Kt, 3)
    tri_tr_init: Optional[torch.Tensor] = None  # (3M, 3)
    tri_sc_t0: Optional[torch.Tensor] = None  # (3M, Ks)
    tri_sc_t1: Optional[torch.Tensor] = None
    tri_sc_from: Optional[torch.Tensor] = None  # (3M, Ks, 3)
    tri_sc_to: Optional[torch.Tensor] = None

    sky_kind: int = sky_mod.DEFAULT
    num_spheres: int = 0
    num_tris: int = 0
    animated: bool = False
    motion_exact: bool = False

    # The structure tables of the megakernel's walks above render.CULL_MIN_ROWS
    # rows with an active sphere, else None: a static scene's sphere BVH at
    # the JAX package's leaf of 128 rows (megakernel.sphere_bvh_tables:
    # sph_perm, sph_nodes, sph_meta), kept for parity with its lowering and
    # as the route's key; an animated scene's chunk-cull tables: the JAX
    # package's clusters (megakernel.cluster_spheres over the shutter window:
    # sph_perm, sph_cbounds), kept likewise. Beside either, the tree the
    # kernel walks (megakernel.swept_tables, SWEPT_LEAF spheres a leaf:
    # sph_swept_perm, sph_swept_nodes, sph_swept_meta, in sph_perm's,
    # sph_nodes' and sph_meta's layouts): a static table's (K5), or a moving
    # one's over the shutter window (K6). A permuted table's column 31 keeps
    # original ids.
    sph_perm: Optional[torch.Tensor] = None  # (N_pad,) int32 permutation
    sph_nodes: Optional[torch.Tensor] = None  # (K, 16) float32 node boxes
    sph_meta: Optional[torch.Tensor] = None  # (3 * (K + 16),) int32 metadata
    sph_cbounds: Optional[torch.Tensor] = None  # (N_pad / 256, 8) float32 cluster boxes
    sph_swept_perm: Optional[torch.Tensor] = None  # (N_pad,) int32 permutation
    sph_swept_nodes: Optional[torch.Tensor] = None  # (K, 16) float32 node boxes
    sph_swept_meta: Optional[torch.Tensor] = None  # (3 * (K + 16),) int32 metadata

    # Triangles (leaf order when use_bvh; brute meshes padded to a multiple
    # of 8, `tri_active` masking the padding)
    tri_v0: Optional[torch.Tensor] = None  # (M, 3) float32
    tri_v1: Optional[torch.Tensor] = None
    tri_v2: Optional[torch.Tensor] = None
    tri_mat: Optional[torch.Tensor] = None  # (M,) int32
    tri_active: Optional[torch.Tensor] = None  # (M,) bool
    # Flat BVH over the triangles (one-node placeholders when unused)
    bvh_min: Optional[torch.Tensor] = None  # (K, 3) float32
    bvh_max: Optional[torch.Tensor] = None
    bvh_first: Optional[torch.Tensor] = None  # (K,) int32
    bvh_count: Optional[torch.Tensor] = None
    bvh_miss: Optional[torch.Tensor] = None
    use_bvh: bool = False
    bvh_leaf_size: int = 4
    # Linear shutter-motion deltas of every mesh in an animated scene (else
    # None), in the vertex arrays' order: vertex k of a triangle at the
    # per-ray shutter fraction w is tri_vk + w * tri_vk_d (zeros where the
    # triangle has no keyframes).
    tri_v0_d: Optional[torch.Tensor] = None  # (M, 3) float32
    tri_v1_d: Optional[torch.Tensor] = None
    tri_v2_d: Optional[torch.Tensor] = None
    # A triangle's keyframe inside the shutter window (exact-time motion).
    tri_exact: bool = False


def swept_struct(center, radius, active, center_d=None, radius_d=None, *, device) -> dict:
    """The tree the megakernel walks (``megakernel.swept_tables``): a static
    table's (K5), or with the shutter deltas a moving one's (K6), as
    SceneData fields on ``device``: ``sph_swept_perm``, ``sph_swept_nodes``,
    ``sph_swept_meta``. ``Scene.build`` and the bridge (a JAX-lowered
    scene) both build it so, from the lowered float32 arrays."""
    from crucible_tpu_torch.ops.kernels import megakernel as mk

    perm, nodes, meta = mk.swept_tables(*(None if a is None else np.asarray(a) for a in (
        center, radius, active, center_d, radius_d)))
    return dict(sph_swept_perm=torch.as_tensor(perm, device=device),
                sph_swept_nodes=torch.as_tensor(nodes, device=device),
                sph_swept_meta=torch.as_tensor(meta, device=device))


def _pad_to(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _shutter_vertices(tris, va, t_open: float, t_close: float):
    """(vertices at shutter open, at shutter close), each (m, 3, 3) float32,
    of ``tris`` whose static vertices are ``va``: the vertex timelines of
    every triangle that has them are evaluated in one numpy batch (scale
    times translate, as the JAX package evaluates them), not one by one."""
    anim = [i for i, t in enumerate(tris) if t.timelines is not None]
    if not anim:
        return va, va
    tls = [tl for i in anim for tl in tris[i].timelines]
    p0, p1, pd = tl_mod.pad_tracks([tl.lower_translate() for tl in tls])
    s0, s1, sf, sg = tl_mod.pad_scale_tracks([tl.lower_scale() for tl in tls])
    init = np.asarray([tl.init_pos for tl in tls], np.float64)
    va, vb = va.copy(), va.copy()
    for out, t in ((va, t_open), (vb, t_close)):
        pos = (tl_mod.eval_scale_np(s0, s1, sf, sg, t)
               * tl_mod.eval_translate_np(p0, p1, pd, init, t))
        out[anim] = pos.reshape(-1, 3, 3).astype(np.float32)
    return va, vb


def _exact_tracks(prefix: str, timelines: dict, init, scale0) -> dict:
    """The exact-time track fields ``<prefix>_tr_*`` / ``<prefix>_sc_*``
    (numpy, float32) of len(init) rows: row k lowers ``timelines[k]`` where
    it has one; every other row holds still at ``init[k]`` with uniform
    scale ``scale0[k]`` (one init segment), filled in one numpy batch. The
    arrays equal the JAX lowering's, which pads a still timeline's tracks
    per row."""
    n = len(init)
    rows = np.asarray(list(timelines), np.int64)
    tls = list(timelines.values())
    tr = [tl.lower_translate() for tl in tls]
    sc = [tl.lower_scale() for tl in tls]
    # A still row lowers to no translate segment and one scale segment.
    a0, a1, ad = tl_mod.pad_tracks(tr, max([len(x[0]) for x in tr] + [1]))
    b0, b1, bf, bt = tl_mod.pad_scale_tracks(sc, max([len(x[0]) for x in sc] + [1]))
    t0 = np.zeros((n, a0.shape[1]), np.float32)
    t1 = np.zeros_like(t0)
    delta = np.zeros((n, a0.shape[1], 3), np.float32)
    s0 = np.full((n, b0.shape[1]), np.inf, np.float32)
    s1 = np.full_like(s0, np.inf)
    sf = np.ones((n, b0.shape[1], 3), np.float32)
    s0[:, 0] = s1[:, 0] = np.float32(tl_mod._INIT_TIME)
    sf[:, 0] = np.asarray(scale0, np.float32)[:, None]
    st = sf.copy()
    pos = np.asarray(init, np.float32).copy()
    if len(rows):
        t0[rows], t1[rows], delta[rows] = a0, a1, ad
        s0[rows], s1[rows], sf[rows], st[rows] = b0, b1, bf, bt
        pos[rows] = np.asarray([tl.init_pos for tl in tls], np.float32)
    return {f"{prefix}_tr_t0": t0, f"{prefix}_tr_t1": t1, f"{prefix}_tr_delta": delta,
            f"{prefix}_tr_init": pos, f"{prefix}_sc_t0": s0, f"{prefix}_sc_t1": s1,
            f"{prefix}_sc_from": sf, f"{prefix}_sc_to": st}


def _union_kinks(tris, lo, hi, t_open: float, t_close: float):
    """The boxes (lo, hi) (m, 3) grown to hold every triangle at each
    timeline boundary strictly inside the shutter window, where a
    piecewise-linear trajectory has its extrema."""
    kinks = set()
    for t in tris:
        for tl in t.timelines or ():
            b = tl.boundary_times()
            kinks.update(float(x) for x in b[(b > t_open) & (b < t_close)])
    for kt in sorted(kinks):
        vt = np.asarray([[tl.scale_at(kt) * tl.position_at(kt) for tl in t.timelines]
                         if t.timelines is not None else [t.v0, t.v1, t.v2]
                         for t in tris], np.float32)
        lo, hi = np.minimum(lo, vt.min(axis=1)), np.maximum(hi, vt.max(axis=1))
    return lo, hi


class _TableBuilder:
    """Dedupes material/texture specs into SoA tables (numpy rows)."""

    def __init__(self):
        self.tex_rows: List[dict] = []
        self.tex_ids: Dict[TextureSpec, int] = {}
        self.images: List[np.ndarray] = []  # one per file name
        self.image_ids: Dict[str, int] = {}
        self.mat_rows: List[dict] = []
        self.mat_ids: Dict[MaterialSpec, int] = {}

    def texture(self, spec: TextureSpec) -> int:
        if spec in self.tex_ids:
            return self.tex_ids[spec]
        if isinstance(spec, SolidColor):
            row = dict(kind=tex_mod.SOLID, color=spec.color, inv_scale=1.0, even=0, odd=0, image=0)
        elif isinstance(spec, ImageTexture):
            if spec.filename not in self.image_ids:
                self.image_ids[spec.filename] = len(self.images)
                self.images.append(load_image(spec.filename))
            row = dict(
                kind=tex_mod.IMAGE,
                color=(1.0, 0.0, 1.0),
                inv_scale=1.0,
                even=0,
                odd=0,
                image=self.image_ids[spec.filename],
            )
        elif isinstance(spec, CheckerTexture):
            even = self.texture(spec.even)
            odd = self.texture(spec.odd)
            row = dict(
                kind=tex_mod.CHECKER,
                color=(0.0, 0.0, 0.0),
                inv_scale=1.0 / spec.scale,
                even=even,
                odd=odd,
                image=0,
            )
        else:
            raise TypeError(f"unknown texture spec {spec!r}")
        tid = len(self.tex_rows)
        self.tex_rows.append(row)
        self.tex_ids[spec] = tid
        return tid

    def material(self, spec: MaterialSpec) -> int:
        if spec in self.mat_ids:
            return self.mat_ids[spec]
        if isinstance(spec, Lambertian):
            row = dict(
                type=mat_mod.LAMBERTIAN,
                tex=self.texture(spec.texture),
                fuzz=0.0,
                ior=1.0,
                prob=spec.scatter_prob,
                emission=(0.0, 0.0, 0.0),
            )
        elif isinstance(spec, Metal):
            row = dict(
                type=mat_mod.METAL,
                tex=self.texture(SolidColor(tuple(spec.albedo))),
                fuzz=spec.fuzz,
                ior=1.0,
                prob=1.0,
                emission=(0.0, 0.0, 0.0),
            )
        elif isinstance(spec, Dielectric):
            row = dict(
                type=mat_mod.DIELECTRIC,
                tex=self.texture(SolidColor((1.0, 1.0, 1.0))),
                fuzz=0.0,
                ior=spec.refraction_index,
                prob=1.0,
                emission=(0.0, 0.0, 0.0),
            )
        elif isinstance(spec, Emissive):
            row = dict(
                type=mat_mod.EMISSIVE,
                tex=self.texture(SolidColor((0.0, 0.0, 0.0))),
                fuzz=0.0,
                ior=1.0,
                prob=1.0,
                emission=tuple(spec.emission),
            )
        else:
            raise TypeError(f"unknown material spec {spec!r}")
        mid = len(self.mat_rows)
        self.mat_rows.append(row)
        self.mat_ids[spec] = mid
        return mid

    def texture_table(self, device) -> tex_mod.TextureTable:
        rows = self.tex_rows or [
            dict(kind=tex_mod.SOLID, color=(0, 0, 0), inv_scale=1.0, even=0, odd=0, image=0)
        ]
        # Checker-nesting depth: children are created before their parent.
        depth = [0] * len(rows)
        for i, r in enumerate(rows):
            if r["kind"] == tex_mod.CHECKER:
                depth[i] = 1 + max(depth[r["even"]], depth[r["odd"]])

        def col(key, dtype):
            return torch.as_tensor(
                np.asarray([r[key] for r in rows], dtype), device=device
            )

        return tex_mod.TextureTable(
            max_nest=max(1, max(depth, default=1)),
            kind=col("kind", np.int32),
            color=col("color", np.float32),
            inv_scale=col("inv_scale", np.float32),
            even=col("even", np.int32),
            odd=col("odd", np.int32),
            image_id=col("image", np.int32),
            images=tuple(torch.as_tensor(np.asarray(im, np.float32), device=device)
                         for im in self.images),
        )


class Scene:
    """User-facing scene builder."""

    def __init__(
        self,
        aspect_ratio: float = 16.0 / 9.0,
        image_width: int = 400,
        frame_rate: float = 24.0,
        shutter_angle: float = 180.0,
        duration: Optional[float] = None,
        seed: int = 0,
    ):
        self.scene_cam = Camera(
            aspect_ratio=aspect_ratio,
            image_width=image_width,
            frame_rate=frame_rate,
            shutter_angle=shutter_angle,
        )
        self.elements: List[Union[Sphere, Triangle]] = []
        self.sky_kind: int = sky_mod.DEFAULT
        self.sky_image: Optional[np.ndarray] = None
        self.id_vendor = IdVendor()
        self.duration = duration  # seconds of a movie, None for an image
        self.frame_rate = frame_rate
        self.seed = seed
        self._cache: Optional[SceneData] = None
        self._cache_key = None

    @classmethod
    def new_image(cls, aspect_ratio, image_width, frame_rate=24.0, shutter_angle=180.0, threads=None):
        del threads  # parallelism lives on the device
        return cls(aspect_ratio, image_width, frame_rate, shutter_angle, None)

    @classmethod
    def new_movie(cls, aspect_ratio, image_width, frame_rate, shutter_angle, duration,
                  threads=None):
        del threads
        return cls(aspect_ratio, image_width, frame_rate, shutter_angle, duration)

    # --- element management -------------------------------------------------
    def add_element(self, element: Union[Sphere, Triangle], alias: str) -> int:
        """Vend a unique id for ``alias`` and add the element. Raises on
        alias collision."""
        o_type = SPHERE_TYPE if isinstance(element, Sphere) else TRIANGLE_TYPE
        oid = self.id_vendor.vend_id(alias, o_type)
        if oid is None:
            raise ValueError(f"alias {alias!r} already exists in scene")
        element.id = oid
        self.elements.append(element)
        self._cache = None
        return oid

    def load_asset(self, filename: str, alias: str, scale: float, shift,
                   material: MaterialSpec) -> int:
        """Load an OBJ mesh (``io/obj.load_obj``: scaled, then shifted)
        under one alias and one id, its triangles flattened into the
        element list."""
        oid = self.id_vendor.vend_id(alias, MESH_TYPE)
        if oid is None:
            raise ValueError(f"alias {alias!r} already exists in scene")
        verts, faces = load_obj(filename, scale=scale, shift=tuple(shift))
        for f in faces:
            self.elements.append(Triangle(tuple(verts[f[0]]), tuple(verts[f[1]]),
                                          tuple(verts[f[2]]), material, id=oid))
        self._cache = None
        return oid

    def load_spherical_skybox(self, filename: str) -> None:
        """Spherical equirect sky from an image asset (``.hdr`` as full float
        radiance, another format through PIL as bytes / 255)."""
        self.sky_image = load_image(filename)
        self.sky_kind = sky_mod.SPHERICAL
        self._cache = None

    def _set_hidden(self, alias: str, hide: bool) -> None:
        info = self.id_vendor.alias_lookup(alias)
        if info is None:
            raise KeyError(f"unknown alias {alias!r}")
        oid, _ = info
        for el in self.elements:
            if el.id == oid:
                el.hide = hide
        self._cache = None

    def hide_element(self, alias: str) -> None:
        self._set_hidden(alias, True)

    def show_element(self, alias: str) -> None:
        self._set_hidden(alias, False)

    # --- animation (the original renderer's scene-animator surface) ---------
    def _check_alias(self, alias: str, invalid_types) -> int:
        """Alias lookup and object-type check."""
        info = self.id_vendor.alias_lookup(alias)
        if info is None:
            raise KeyError(f"unknown alias {alias!r}")
        oid, o_type = info
        if o_type in invalid_types:
            raise TypeError(f"animation not valid for object type {o_type!r} ({alias!r})")
        return oid

    def _element_timelines(self, oid: int):
        """The timelines of every element with id ``oid``, created on
        demand: a sphere's starts at its center and radius, a triangle has
        one per vertex."""
        out = []
        for el in self.elements:
            if el.id != oid:
                continue
            if isinstance(el, Triangle):
                if el.timelines is None:
                    el.timelines = tuple(TransformTimeline(init_pos=tuple(v), init_scale=1.0)
                                         for v in (el.v0, el.v1, el.v2))
                out.extend(el.timelines)
                continue
            if el.timeline is None:
                el.timeline = TransformTimeline(
                    init_pos=tuple(el.center), init_scale=float(el.radius)
                )
            out.append(el.timeline)
        self._cache = None
        return out

    def translate_x(self, x, keyframe, interp, space, alias):
        for tl in self._element_timelines(self._check_alias(alias, [CAMERA_TYPE])):
            tl.translate_x(x, keyframe, interp, space)

    def translate_y(self, y, keyframe, interp, space, alias):
        for tl in self._element_timelines(self._check_alias(alias, [CAMERA_TYPE])):
            tl.translate_y(y, keyframe, interp, space)

    def translate_z(self, z, keyframe, interp, space, alias):
        for tl in self._element_timelines(self._check_alias(alias, [CAMERA_TYPE])):
            tl.translate_z(z, keyframe, interp, space)

    def translate_point(self, p, keyframe, interp, space, alias):
        for tl in self._element_timelines(self._check_alias(alias, [CAMERA_TYPE])):
            tl.translate_point(p, keyframe, interp, space)

    def scale_r(self, r, keyframe, interp, alias):
        """Sphere radius keyframe: spheres only."""
        oid = self._check_alias(alias, [CAMERA_TYPE, MESH_TYPE, TRIANGLE_TYPE])
        for tl in self._element_timelines(oid):
            tl.scale_r(r, keyframe, interp)

    def _axis_scale(self, alias: str):
        """Timelines of a per-axis scale, which spheres refuse."""
        return self._element_timelines(self._check_alias(alias, [CAMERA_TYPE, SPHERE_TYPE]))

    def scale_x(self, f, keyframe, interp, alias):
        for tl in self._axis_scale(alias):
            tl.scale_x(f, keyframe, interp)

    def scale_y(self, f, keyframe, interp, alias):
        for tl in self._axis_scale(alias):
            tl.scale_y(f, keyframe, interp)

    def scale_z(self, f, keyframe, interp, alias):
        for tl in self._axis_scale(alias):
            tl.scale_z(f, keyframe, interp)

    def scale_point(self, p, keyframe, interp, alias):
        """Vector-valued scale keyframe: one key per axis."""
        for tl in self._axis_scale(alias):
            tl.scale_x(p[0], keyframe, interp)
            tl.scale_y(p[1], keyframe, interp)
            tl.scale_z(p[2], keyframe, interp)

    def scale_all_uniform(self, f, keyframe, interp, alias):
        for tl in self._axis_scale(alias):
            tl.scale_uniform(f, keyframe, interp)

    def _cam_timeline(self, which: str) -> TransformTimeline:
        cam = self.scene_cam
        if which == "from":
            if cam.from_timeline is None:
                cam.from_timeline = TransformTimeline(init_pos=cam.look_from_pt)
            return cam.from_timeline
        if which == "at":
            if cam.at_timeline is None:
                cam.at_timeline = TransformTimeline(init_pos=cam.look_at_pt)
            return cam.at_timeline
        raise KeyError(f"camera animation target must be 'from' or 'at', got {which!r}")

    def cam_translate_x(self, x, keyframe, interp, space, which):
        self._cam_timeline(which).translate_x(x, keyframe, interp, space)

    def cam_translate_y(self, y, keyframe, interp, space, which):
        self._cam_timeline(which).translate_y(y, keyframe, interp, space)

    def cam_translate_z(self, z, keyframe, interp, space, which):
        self._cam_timeline(which).translate_z(z, keyframe, interp, space)

    def cam_translate_point(self, p, keyframe, interp, space, which):
        self._cam_timeline(which).translate_point(p, keyframe, interp, space)

    def _cam_point(self, which: str, attr: str):
        """The camera's look-from ("from") or look-at ("at") point at the
        current frame's shutter open: its timeline's where it has one."""
        cam = self.scene_cam
        tl = cam.from_timeline if which == "from" else cam.at_timeline
        return tl.position_at(cam.shutter_window()[0]) if tl is not None else getattr(cam, attr)

    @property
    def is_animated(self) -> bool:
        """Whether any element has keyframes (the camera's do not count)."""
        return any(
            any(t.animated for t in e.timelines) if isinstance(e, Triangle) and e.timelines
            else isinstance(e, Sphere) and e.timeline is not None and e.timeline.animated
            for e in self.elements
        )

    # --- lowering -----------------------------------------------------------
    def build(self, t_open: float | None = None, t_close: float | None = None, *,
              leaf_size: int | None = None, bvh_method: str = "sah",
              device="cuda") -> SceneData:
        """Lower the element list to a SceneData on ``device``, cached per
        device, shutter window (for an animated scene), leaf size and BVH
        method until the scene is mutated. Without CUDA, name
        ``device="cpu"``.

        An animated scene is lowered for the shutter window [t_open,
        t_close] (default: the camera's current frame): each sphere's
        center and radius at shutter open, and their deltas to shutter close
        (``sph_center_d`` / ``sph_radius_d``); each triangle's vertices at
        shutter open (its vertex timelines evaluated in one batch) and their
        deltas (``tri_v0_d`` ... for every mesh, zeros for a triangle
        without keyframes); the renderers lerp them per ray. A timeline
        boundary strictly inside the window sets ``motion_exact`` (and
        ``tri_exact`` for a triangle's): the linear lowering departs from
        the timeline there, so the scene also carries the shutter window
        (``motion_t0`` / ``motion_t1``) and every sphere's exact-time
        tracks (``sph_tr_*`` / ``sph_sc_*``), and with ``tri_exact`` every
        vertex's (``tri_tr_*`` / ``tri_sc_*``, vertex-major in the vertex
        arrays' order), which the staged bounce evaluates per ray.

        Visible triangles above ``BVH_MIN_TRIS`` get a BVH (``bvh_method``
        "sah" or "median", ``leaf_size`` triangles a leaf: None means
        ``BVH_LEAF_CPU`` on the CPU, ``BVH_LEAF_CUDA`` on a card) over boxes
        that hold each triangle at shutter open and close (and at every
        timeline kink inside the window), whose children are ordered
        near-first along the camera's view at shutter open; the triangles
        are stored in its leaf order.
        """
        device = torch.device(device)
        if leaf_size is None:
            leaf_size = BVH_LEAF_CUDA if device.type == "cuda" else BVH_LEAF_CPU
        animated = self.is_animated
        if animated and t_open is None:
            t_open, t_close = self.scene_cam.shutter_window()
        key = (device, (t_open, t_close) if animated else None, leaf_size, bvh_method)
        if self._cache is not None and self._cache_key == key:
            return self._cache

        def mid_shutter(timelines) -> bool:
            """Whether any of ``timelines`` has a boundary strictly inside
            the window: every boundary time tested at once."""
            times = [tl.boundary_times() for tl in timelines]
            b = np.concatenate(times) if times else np.zeros((0,))
            return bool(np.any((b > t_open + 1e-9) & (b < t_close - 1e-9)))

        spheres = [e for e in self.elements if isinstance(e, Sphere)]
        tris = [e for e in self.elements if isinstance(e, Triangle)]
        tri_mid = animated and mid_shutter(
            [tl for t in tris if t.timelines is not None for tl in t.timelines])
        motion_exact = tri_mid or animated and mid_shutter(
            [s.timeline for s in spheres if s.timeline is not None])

        tables = _TableBuilder()
        n = len(spheres)
        n_pad = _pad_to(n, SPHERE_PAD)
        sph_center = np.zeros((n_pad, 3), np.float32)
        sph_center_b = np.zeros((n_pad, 3), np.float32)
        sph_radius = np.ones((n_pad,), np.float32)
        sph_radius_b = np.ones((n_pad,), np.float32)
        sph_mat = np.zeros((n_pad,), np.int32)
        sph_active = np.zeros((n_pad,), bool)
        for k, s in enumerate(spheres):
            if animated and s.timeline is not None:
                sph_center[k] = s.timeline.position_at(t_open)
                sph_center_b[k] = s.timeline.position_at(t_close)
                sph_radius[k] = float(s.timeline.scale_at(t_open)[0])
                sph_radius_b[k] = float(s.timeline.scale_at(t_close)[0])
            else:
                sph_center[k] = sph_center_b[k] = s.center
                sph_radius[k] = sph_radius_b[k] = s.radius
            sph_mat[k] = tables.material(s.material)
            sph_active[k] = not s.hide

        # Triangles: hidden ones are filtered before the BVH build.
        vis_tris = [t for t in tris if not t.hide]
        m = len(vis_tris)
        use_bvh = m > BVH_MIN_TRIS
        bvh = None
        v_close = None
        if m:
            va = np.asarray([[t.v0, t.v1, t.v2] for t in vis_tris], np.float32)  # (m, 3, 3)
            va, vb = _shutter_vertices(vis_tris, va, t_open, t_close) if animated else (va, va)
            v0, v1, v2 = va[:, 0], va[:, 1], va[:, 2]
            v0b, v1b, v2b = vb[:, 0], vb[:, 1], vb[:, 2]
            t_mat = np.asarray([tables.material(t.material) for t in vis_tris], np.int32)
            if use_bvh:
                # Boxes hold each triangle at shutter open and close, and at
                # every kink of a trajectory inside the window.
                lo = np.minimum(va.min(axis=1), vb.min(axis=1))
                hi = np.maximum(va.max(axis=1), vb.max(axis=1))
                if tri_mid:
                    lo, hi = _union_kinks(vis_tris, lo, hi, t_open, t_close)
                bvh = build_bvh(lo, hi, leaf_size=leaf_size, method=bvh_method)
                view = np.asarray(self._cam_point("at", "look_at_pt"), np.float64) - np.asarray(
                    self._cam_point("from", "look_from_pt"), np.float64)
                if np.linalg.norm(view) > 1e-12:
                    bvh = reorder_front_to_back(bvh, view)
                perm = bvh.perm
                v0, v1, v2, t_mat = v0[perm], v1[perm], v2[perm], t_mat[perm]
                v0b, v1b, v2b = v0b[perm], v1b[perm], v2b[perm]
                t_active = np.ones((m,), bool)
            else:
                pad = _pad_to(m, 8) - m
                v0, v1, v2, v0b, v1b, v2b = (np.pad(a, ((0, pad), (0, 0)))
                                             for a in (v0, v1, v2, v0b, v1b, v2b))
                t_mat = np.pad(t_mat, (0, pad))
                t_active = np.zeros((m + pad,), bool)
                t_active[:m] = True
            v_close = (v0b, v1b, v2b)
        else:
            v0 = v1 = v2 = np.zeros((1, 3), np.float32)
            t_mat = np.zeros((1,), np.int32)
            t_active = np.zeros((1,), bool)
        if bvh is None:  # the JAX package's one-node placeholder
            bvh = FlatBVH(
                node_min=np.zeros((1, 3), np.float32), node_max=np.zeros((1, 3), np.float32),
                node_first=np.zeros((1,), np.int32), node_count=np.zeros((1,), np.int32),
                node_miss=np.ones((1,), np.int32), node_parent=np.full((1,), -1, np.int32),
                perm=np.zeros((0,), np.int32),
            )

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        motion = {}
        if animated:
            motion = dict(sph_center_d=t(sph_center_b - sph_center, np.float32),
                          sph_radius_d=t(sph_radius_b - sph_radius, np.float32))
            if v_close is not None:
                motion.update(tri_v0_d=t(v_close[0] - v0, np.float32),
                              tri_v1_d=t(v_close[1] - v1, np.float32),
                              tri_v2_d=t(v_close[2] - v2, np.float32))
        if motion_exact:
            motion.update(motion_t0=t(t_open, np.float32), motion_t1=t(t_close, np.float32))
            tracks = _exact_tracks(
                "sph", {k: s.timeline for k, s in enumerate(spheres) if s.timeline is not None},
                np.pad(np.asarray([s.center for s in spheres], np.float32).reshape(-1, 3),
                       ((0, n_pad - n), (0, 0))),
                np.pad(np.asarray([s.radius for s in spheres], np.float32), (0, n_pad - n),
                       constant_values=1.0))
            if tri_mid and m:
                m_rows = v0.shape[0]  # leaf order for a BVH mesh, padded for a brute one
                src = [vis_tris[j] for j in perm] if use_bvh else vis_tris
                tracks.update(_exact_tracks(
                    "tri", {vi * m_rows + k: tr.timelines[vi] for vi in range(3)
                            for k, tr in enumerate(src) if tr.timelines is not None},
                    np.concatenate([v0, v1, v2]), np.ones((3 * m_rows,), np.float32)))
            motion.update({k: t(a, np.float32) for k, a in tracks.items()})

        # Structure tables for the megakernel's walks, past the brute
        # search's crossover: a static scene's sphere BVH (the JAX
        # lowering's) and tree (K5), an animated scene's clusters (the JAX
        # lowering's) and swept tree (K6), whose boxes hold each sphere at
        # shutter open and close (a static tree's would go stale under
        # motion).
        from crucible_tpu_torch.models.render import CULL_MIN_ROWS
        from crucible_tpu_torch.ops.kernels import megakernel as mk

        sph_struct = {}
        if n_pad > CULL_MIN_ROWS and bool(sph_active.any()) and not animated:
            perm_s, snodes, smeta = mk.sphere_bvh_tables(sph_center, sph_radius, sph_active)
            sph_struct = dict(sph_perm=t(perm_s, np.int32), sph_nodes=t(snodes, np.float32),
                              sph_meta=t(smeta, np.int32),
                              **swept_struct(sph_center, sph_radius, sph_active, device=device))
        elif n_pad > CULL_MIN_ROWS and bool(sph_active.any()):
            deltas = dict(center_d=sph_center_b - sph_center, radius_d=sph_radius_b - sph_radius)
            perm_s, cbounds = mk.cluster_spheres(sph_center, sph_radius, sph_active, **deltas)
            sph_struct = dict(sph_perm=t(perm_s, np.int32), sph_cbounds=t(cbounds, np.float32),
                              **swept_struct(sph_center, sph_radius, sph_active, device=device,
                                             **deltas))

        mesh = dict(
            tri_v0=t(v0, np.float32), tri_v1=t(v1, np.float32), tri_v2=t(v2, np.float32),
            tri_mat=t(t_mat, np.int32), tri_active=t(t_active, bool),
            bvh_min=t(bvh.node_min, np.float32), bvh_max=t(bvh.node_max, np.float32),
            bvh_first=t(bvh.node_first, np.int32), bvh_count=t(bvh.node_count, np.int32),
            bvh_miss=t(bvh.node_miss, np.int32),
            num_tris=m, use_bvh=use_bvh, bvh_leaf_size=int(leaf_size),
            tri_exact=bool(tri_mid and m > 0),
        )

        if not tables.mat_rows:  # empty scene still needs one material row
            tables.material(Lambertian.from_color((0.5, 0.5, 0.5)))
        mat_rows = tables.mat_rows

        sd = SceneData(
            sph_center=t(sph_center, np.float32),
            sph_radius=t(sph_radius, np.float32),
            sph_mat=t(sph_mat, np.int32),
            sph_active=t(sph_active, bool),
            mat_type=t([r["type"] for r in mat_rows], np.int32),
            mat_tex=t([r["tex"] for r in mat_rows], np.int32),
            mat_fuzz=t([r["fuzz"] for r in mat_rows], np.float32),
            mat_ior=t([r["ior"] for r in mat_rows], np.float32),
            mat_prob=t([r["prob"] for r in mat_rows], np.float32),
            mat_emission=t([r["emission"] for r in mat_rows], np.float32),
            tex=tables.texture_table(device),
            sky_image=None if self.sky_image is None else t(self.sky_image, np.float32),
            sky_kind=self.sky_kind,
            num_spheres=n,
            animated=animated,
            motion_exact=motion_exact,
            **motion,
            **sph_struct,
            **mesh,
        )
        self._cache = sd
        self._cache_key = key
        return sd

    # --- rendering ----------------------------------------------------------
    def render_scene(self, fname: str, *, device="cuda"):
        """A movie if a duration is set (``render.render_movie``: frames in
        ``<fname>/artifacts/``), else one image
        (``render.render_image_to_file``: ``fname``, ``.ppm`` where it has
        no suffix), rendered on ``device``."""
        from crucible_tpu_torch.models import render as render_mod

        if self.duration is not None:
            return render_mod.render_movie(self, fname, device=device)
        return render_mod.render_image_to_file(self, fname, device=device)

