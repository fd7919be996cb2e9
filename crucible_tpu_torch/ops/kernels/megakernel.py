"""Persistent path-tracing megakernel: forward and record.

Port of ``crucible_tpu/ops/pallas/megakernel.py`` for its sphere branches
— the brute search over every table row (K1, K2), what the sphere-BVH
walk of big static scenes computes (K5: a per-lane walk over a small-leaf
tree of the spheres, :func:`swept_tables` with no deltas) and what the
chunk-cull branch of big moving scenes computes (K6: the same walk over a
tree whose boxes hold the spheres over the shutter, :func:`swept_tables`)
in both modes, and their motion variants (K8: ``animated`` spheres on the
linear shutter, brute or K6, and the ``cam_animated`` keyframed camera, on
any search), also in both modes — and for its triangle-BVH stage (K7,
beside the brute sphere search, in both modes, with K8's flags: a static
mesh's Woop rows, or with ``animated`` a moving mesh's (M, 32) rows, K7
moving):

- :func:`run_megakernel` (forward): given the lanes' pixel ids and first
  samples, the camera vector and the (N, 32) sphere table, it traces every
  lane's samples ``sample0..spp-1`` to the end and returns the per-lane
  radiance sums (3, R).
- :func:`run_megakernel_record` (record): each lane traces its one
  (pixel, sample0) path and returns its packed decision words (D, R) int32
  (``models/replay.py`` layout) and, in the fused mode, that path's
  radiance (3, R).

With ``swept_nodes`` / ``swept_meta`` (:func:`swept_tables`: a static
table's tree, K5, or a moving one's over boxes swept over the shutter, K6)
the table is the tree-permuted one (``integrator.permute_table``) and the
closest hit walks the tree instead of testing every row
(:func:`swept_inputs`). The result is the brute search's, bit for bit (see
:func:`cull_closest_reference`), and records carry the original row ids
(column 31 of the permuted row). With ``tri_nodes``, ``tris``, ``mats`` and
``tri_meta`` (``integrator.make_tri_tables``) each bounce then walks the
mesh's BVH for a triangle strictly nearer than the sphere
(:func:`tri_closest_reference`; a moving mesh's triangles at the path's
shutter fraction); records carry its leaf-order id and ``F_TRI``.

For CUDA tensors each wrapper launches the hand-written kernel of
``csrc/megakernel.cu`` (``flat_kernel``: persistent lanes in one flat
bounce loop fed by a work counter, over :func:`brute_rows`' staged rows or
a sphere tree, with K7's triangle walk after the brute search; see the
note there) or raises; for CPU tensors it runs its eager twin
(:func:`run_megakernel_reference`, :func:`run_megakernel_record_reference`):
all lanes in lockstep with per-lane sample regeneration, as the TPU kernel
runs them, the brute (lanes x N) quadratic in lane chunks or the lockstep
walks (near-first for a sphere tree, DFS for a mesh's), and shading from
the ported materials / textures /
skybox / sampling code. ``FORWARD_LAUNCHES`` and ``RECORD_LAUNCHES`` count
the kernel's launches (not twin calls) by variant, and :func:`zero_counts`
clears both; ``WALK_COUNTS``, ``CULL_COUNTS``, ``TRI_COUNTS`` and
``SEARCH_COUNTS`` count the plain versions' work (both modes).

Layouts: ``smem`` (8,) int32 ``[spp, seed, width, max_depth, accum_from,
0...]`` (spp and seed are uint32 bit patterns; accum_from is read in record
mode only); ``pix`` and ``sample0`` (1, R) int32 (padding lanes carry
``sample0 = 2**30`` and never issue); ``cam`` (1, 48) float32 (layout
below); ``table`` (N, 32) float32 in the ``integrator.make_sphere_table``
layout (the motion columns 24-29 read by the ``animated`` variant).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from crucible_tpu_torch.models import materials as mat_mod
from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models import textures as tex_mod
from crucible_tpu_torch.ops import bvh as bvh_mod
from crucible_tpu_torch.ops import sampling
from crucible_tpu_torch.ops.traverse import lockstep_walk
from crucible_tpu_torch.ops.kernels import build, sphere_hit, sphere_shade
from crucible_tpu_torch.ops.kernels.sphere_hit import BIG, T_MIN  # noqa: F401
from crucible_tpu_torch.utils import rng as crng

# Lanes per pixel block of the swizzled lane order (32 x 16 pixels). The
# GPU kernel does not need it; it keeps the lane order of the TPU kernel,
# so that a warp covers 32 neighbouring pixels.
TILE = 512
C_IN = 32  # sphere attribute table columns (make_sphere_table layout)

# Camera constant vector layout (1, 48) float32. Static-camera slots:
#  0-2 pixel00, 3-5 du, 6-8 dv, 9-11 look_from, 12-14 basis u, 15-17 basis v,
#  18 defocus_radius. Animated-camera slots: 19-21 look_at, 22-24 look_from
#  delta, 25-27 look_at delta, 28-30 vup, 31 viewport_h, 32 viewport_w,
#  33 focus_dist, 34 width, 35 height, 36 0.5 (width - 1), 37 0.5 (height -
#  1). Slots 38-47 are padding.
CAM_SIZE = 48

# A Hopper block can use 227 KB (232,448 bytes) of shared memory. The brute
# search stages 16 bytes of each active row there (center, |c|^2 - r^2:
# brute_rows), 36 with the motion columns (K8). Its row caps, on which the
# routes build, allow 20 bytes a row (40 moving), so that MAX_ROWS rows
# (MAX_ROWS_ANIMATED moving), padded to a multiple of 4, fit with room to
# spare.
SHARED_MEM_BYTES = 232448
MAX_ROWS = SHARED_MEM_BYTES // 20
MAX_ROWS_ANIMATED = SHARED_MEM_BYTES // 40

# sample0 of a padding lane: it never issues.
NO_SAMPLE = 2**30

# Record word: winner id * REC_ID_SCALE + a flag byte of these bits (the
# layout of models/replay.py, which takes them from here).
REC_ID_SCALE = 256
F_ALIVE = 1  # lane had an in-flight path entering this bounce
F_HIT = 2  # the path hit a primitive (else: sky)
F_TRI = 4  # winner is a triangle (else: sphere)
F_SCAT = 8  # path continued (hit & material scattered)
F_FRONT = 16  # front-face flag
F_REFL = 32  # dielectric chose reflection over refraction
F_DEGEN = 64  # Lambertian scatter direction was degenerate
F_ROOT1 = 128  # sphere hit used the far quadratic root

# Sphere-BVH and cluster tables (the JAX package's constants): rows per
# permutation block and per cluster, spheres per leaf, the guard rows of
# ``sph_meta``, and the box of a cluster that holds no active sphere.
CLUSTER = 256
SPH_LEAF = 128
NODE_WIN = 16
_FAR = np.float32(1.0e30)
# Spheres a leaf of K5's and K6's trees (:func:`swept_tables`): a leaf costs
# a slab test and its rows their quadratics; chosen by measurement on the
# card against 4 and 16 (PERF.md).
SWEPT_LEAF = 8

# The walk's slab test runs against each node box grown by SLAB_EPS * (1 +
# the box's largest |coordinate| + the ray origin's largest |coordinate|).
# The expanded quadratic's root puts a hit point up to ~1.7e-3 (|c| + |o|)
# off its sphere (an error of a few ulps of |c|^2 and |o|^2 in c_q, fault
# C6), and a box that missed such a point would skip a row that the brute
# search takes; 4e-3 covers that bound more than twice.
SLAB_EPS = float(np.float32(4e-3))
# A walk's node in the kernel: two 16-byte entries (box, first and count)
# and its skip link. K5 and K6 stage their tree's nodes in shared memory
# where they fit and read their rows from global memory.
NODE_BYTES = 9 * 4
# A moving row's search columns beside the static ones (0-2, 4): the
# center delta, s1 and s2.
MOVING_COLS = (24, 25, 26, 28, 29)
# Row ids travel through float32 column 31, exact below 2^24.
MAX_ID_ROWS = 1 << 24
# K5's and K6's walks take the nearer child first, deferring the far ones
# on a stack of this many entries, one at most a level: :func:`swept_tables`
# builds no deeper tree, and :func:`swept_inputs` refuses one.
TREE_STACK = 64

# K7 reads a mesh's rows (16 float32 Woop, or 32 for a moving mesh, K7
# moving, of which it reads the 18 its test needs from a packed copy,
# :func:`moving_tri_rows`), its material rows (24 float32) and its tree's
# nodes from global memory: staged in shared memory, torus_teapot's nodes
# halved the resident blocks and slowed the launch (PERF.md), so a mesh's
# tree has no node cap.
TRI_COLS = 16
TRI_MOVING_COLS = 32
MAT_COLS = 24
# The material id's column: Woop rows, moving rows.
TRI_MAT_COL = {TRI_COLS: 15, TRI_MOVING_COLS: 12}
# The moving-row columns K7 moving's test reads, in the packed order of
# five 16-byte entries (v0, e1 x | e1 y/z, e2 x/y | e2 z, v0d | e1d, e2d x |
# e2d y/z, the material id, 0).
MOVING_TRI_PACK = (0, 1, 2, 3, 4, 5, 6, 7, 8, 16, 17, 18, 19, 20, 21, 22, 23, 24, 12, 13)


# Launches of the CUDA kernel since the last zero_counts() (twin calls
# excluded), by variant: "brute" K1 / K2 (over every row), "walk" K5 (a
# static table's tree), "motion" K8 brute with animated and / or
# cam_animated, "motion_walk" K8's camera on K5's walk, "cull" K6 (a moving
# table's swept tree, with either camera), "tri" K7 (the triangle BVH),
# "tri_motion" K7 with either motion flag (K7 moving with animated).
FORWARD_LAUNCHES = {"brute": 0, "walk": 0, "motion": 0, "motion_walk": 0, "cull": 0,
                    "tri": 0, "tri_motion": 0}
RECORD_LAUNCHES = dict(FORWARD_LAUNCHES)
# The plain walks' work since the last reset: K5's (WALK_COUNTS) and K6's
# (CULL_COUNTS) slab tests of a node, rows of a leaf tested, and rows whose
# discriminant was not negative; K7's slab tests and leaf rows tested
# (TRI_COUNTS).
WALK_COUNTS = {"nodes": 0, "rows": 0, "roots": 0}
CULL_COUNTS = dict(WALK_COUNTS)
TRI_COUNTS = {"nodes": 0, "rows": 0}
# The plain loop's work since the last reset (forward and record mode):
# closest-hit searches (one per lane and bounce traced) and primary rays
# issued.
SEARCH_COUNTS = {"searches": 0, "issued": 0}


def zero_counts() -> None:
    """Set every launch count (FORWARD_LAUNCHES, RECORD_LAUNCHES) to 0."""
    for counts in (FORWARD_LAUNCHES, RECORD_LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))


def as_i32(v: int) -> int:
    """A uint32 bit pattern (spp, seed) as the int32 that ``smem`` holds."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def sphere_bvh_tables(center, radius, active, leaf_size=None, center_d=None,
                      radius_d=None, method="sah"):
    """Host-side per-lane sphere BVH over the active spheres' boxes (SAH,
    or median splits with ``method="median"``; ``leaf_size`` spheres a leaf,
    default ``SPH_LEAF``) -> (perm, snodes, smeta), in the JAX package's
    layout. With ``center_d`` / ``radius_d``
    (the shutter deltas) a sphere's box holds it at shutter open and close,
    so on the whole linear path (:func:`swept_tables`).

    - ``perm`` (N_pad,) int32: active spheres in leaf order, then the
      inactive ones, then ids >= N that address zero rows the caller
      appends; N_pad = ceil(N / CLUSTER) * CLUSTER + CLUSTER;
    - ``snodes`` (K, 16) float32: node box min (0-2) and max (3-5);
    - ``smeta`` (3 * (K + NODE_WIN),) int32: [first, count, miss] per node
      (first indexes the permuted table), then NODE_WIN guard rows [0, 0, K].
    """
    if leaf_size is None:
        leaf_size = SPH_LEAF
    center = np.asarray(center, np.float64)
    radius = np.abs(np.asarray(radius, np.float64))
    active = np.asarray(active).astype(bool)
    n = center.shape[0]
    ids = np.nonzero(active)[0]
    if ids.size == 0:
        raise ValueError("a sphere BVH needs at least one active sphere")
    lo, hi = center - radius[:, None], center + radius[:, None]
    if center_d is not None:
        c1 = center + np.asarray(center_d, np.float64)
        r1 = np.abs(radius + np.asarray(radius_d, np.float64))
        lo, hi = np.minimum(lo, c1 - r1[:, None]), np.maximum(hi, c1 + r1[:, None])
    bbmin, bbmax = lo[ids].astype(np.float32), hi[ids].astype(np.float32)
    fb = bvh_mod.build_bvh(bbmin, bbmax, leaf_size=leaf_size, method=method)
    inact = np.nonzero(~active)[0]
    assert leaf_size <= CLUSTER
    n_pad = ((n + CLUSTER - 1) // CLUSTER) * CLUSTER + CLUSTER
    perm = np.concatenate([ids[fb.perm], inact, np.arange(n, n_pad)]).astype(np.int32)
    assert perm.shape[0] == n_pad
    k = fb.num_nodes
    snodes = np.zeros((k, 16), np.float32)
    snodes[:, 0:3] = fb.node_min
    snodes[:, 3:6] = fb.node_max
    meta = np.stack([fb.node_first, fb.node_count, fb.node_miss], axis=1).astype(np.int32)
    guard = np.broadcast_to(np.asarray([0, 0, k], np.int32), (NODE_WIN, 3))
    smeta = np.concatenate([meta, guard]).reshape(-1)
    return perm, snodes, smeta


def swept_tables(center, radius, active, center_d=None, radius_d=None, leaf_size=None):
    """The tree a walk takes over a sphere table -> (perm, snodes, smeta) in
    :func:`sphere_bvh_tables`' layout: an SAH tree of ``leaf_size`` spheres
    a leaf (default ``SWEPT_LEAF``) over each active sphere's box: K5's of a
    static table (no deltas), K6's of a moving one, whose boxes hold each
    sphere at shutter open (center, |radius|) and close (center + center_d,
    |radius + radius_d|), so at every shutter fraction between. Where the
    chunk-cull branch's 256-row clusters (:func:`cluster_spheres`) give a
    ray about 1,300-1,700 rows to test on bouncing stress n7744, this tree
    gives it about 30 nodes and 25 rows (PERF.md). Where the SAH tree is
    deeper than the walk's stack (``TREE_STACK``), it is built with median
    splits instead, about log2(active rows / leaf_size) deep: 21 at
    ``MAX_ID_ROWS``."""
    leaf_size = leaf_size or SWEPT_LEAF
    tables = sphere_bvh_tables(center, radius, active, leaf_size, center_d, radius_d)
    k = tables[1].shape[0]
    if int(tree_depth(torch.from_numpy(tables[2][: 3 * k].reshape(k, 3)))) > TREE_STACK:
        tables = sphere_bvh_tables(center, radius, active, leaf_size, center_d, radius_d,
                                   method="median")
    return tables


def cluster_spheres(center, radius, active, center_d=None, radius_d=None):
    """Host-side spatial clustering of the chunk-cull branch, the JAX
    package's ``megakernel.cluster_spheres``, bit for bit. The port keeps
    these tables for parity with the JAX lowering (``sph_perm``,
    ``sph_cbounds``); K6 walks :func:`swept_tables`' tree instead.

    Recursive median split on the longest centroid axis with split points
    aligned to CLUSTER, so that every 256-row slice of the permuted table
    is a spatially tight cluster. Returns (perm, bounds):

    - ``perm`` (N_pad,) int32: active spheres in split order, then the
      inactive ones, then ids >= N that address zero rows the caller
      appends; N_pad = ceil(N / CLUSTER) * CLUSTER;
    - ``bounds`` (N_pad / CLUSTER, 8) float32: each cluster's box min (0-2)
      and max (3-5), padded by 1e-5 (1 + its largest |coordinate|). With
      ``center_d`` / ``radius_d`` (the shutter deltas) a box holds each
      sphere at shutter open and close, so the whole linear path. A cluster
      with no active sphere gets the far point box ``_FAR``.
    """
    center = np.asarray(center, np.float64)
    radius = np.abs(np.asarray(radius, np.float64))
    active = np.asarray(active).astype(bool)
    n = center.shape[0]

    order = []

    def split(ids):
        if len(ids) <= CLUSTER:
            order.extend(ids.tolist())
            return
        c = center[ids]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        ids = ids[np.argsort(c[:, ax], kind="stable")]
        half = max(CLUSTER, (len(ids) // 2 // CLUSTER) * CLUSTER)
        split(ids[:half])
        split(ids[half:])

    split(np.nonzero(active)[0])
    inact = np.nonzero(~active)[0]
    n_pad = ((n + CLUSTER - 1) // CLUSTER) * CLUSTER
    perm = np.concatenate(
        [np.asarray(order, np.int64), inact, np.arange(n, n_pad)]
    ).astype(np.int32)
    assert perm.shape[0] == n_pad

    lo_all = center - radius[:, None]
    hi_all = center + radius[:, None]
    if center_d is not None:
        c1 = center + np.asarray(center_d, np.float64)
        r1 = np.abs(radius + np.asarray(radius_d, np.float64))
        lo_all = np.minimum(lo_all, c1 - r1[:, None])
        hi_all = np.maximum(hi_all, c1 + r1[:, None])

    k = n_pad // CLUSTER
    bounds = np.zeros((k, 8), np.float32)
    for ci in range(k):
        rows = perm[ci * CLUSTER: (ci + 1) * CLUSTER]
        rows = rows[rows < n]
        rows = rows[active[rows]]
        if rows.size == 0:
            bounds[ci, 0:6] = _FAR
        else:
            lo = lo_all[rows].min(axis=0)
            hi = hi_all[rows].max(axis=0)
            pad = 1e-5 * (1.0 + np.maximum(np.abs(lo), np.abs(hi)))
            bounds[ci, 0:3] = (lo - pad).astype(np.float32)
            bounds[ci, 3:6] = (hi + pad).astype(np.float32)
    return perm, bounds


def _grown(lo, hi):
    """Boxes (K, 6) grown by SLAB_EPS * (1 + each box's largest
    |coordinate|); the walk adds the per-ray part of the margin."""
    pad = SLAB_EPS * (1.0 + torch.maximum(lo.abs(), hi.abs()).amax(dim=1, keepdim=True))
    return torch.cat([lo - pad, hi + pad], dim=1).contiguous()


def swept_inputs(swept_nodes, swept_meta, table):
    """What K5's and K6's walk reads from a tree of :func:`swept_tables` ->
    (nodes (K, 6) float32, each box grown by SLAB_EPS * (1 + its largest
    |coordinate|), the per-ray part of the margin being added in the walk;
    meta (K, 3) int32 [first, count, miss]), over ``table`` in the tree's
    order (``integrator.permute_table``). The guard rows of ``swept_meta``
    are not read.

    Raises where the tree does not hold the table's spheres as the walk
    needs: where [first, count, miss] address rows outside the table or a
    skip link does not point past its node, where the leaves do not cover
    every active row exactly once and no inactive one, where an active
    row's sphere at shutter open (columns 0-2, |3|) or close (+ columns
    24-26, |3 + 27|) leaves its leaf's grown box, where an inner node's
    grown box does not hold its two children's (the left child i + 1, the
    right one its skip link, which ends where its parent's does), or where
    the tree is deeper than the walk's stack (``TREE_STACK``). Else the walk
    would skip rows that the brute search takes, or overrun its stack. A
    static table's motion columns are zero: its spheres at open and close
    are one. The checks run on the table's device and are read back in one
    host sync."""
    if swept_nodes is None or swept_meta is None:
        raise ValueError("the tree walk needs both swept_nodes and swept_meta")
    k = swept_nodes.shape[0] if swept_nodes.dim() == 2 else -1
    build.check_tensors(table.device, (
        ("swept_nodes", swept_nodes, torch.float32, (k, 16)),
        ("swept_meta", swept_meta, torch.int32, (3 * (k + NODE_WIN),)),
    ))
    nodes = _grown(swept_nodes[:, 0:3], swept_nodes[:, 3:6])
    meta = swept_meta[: 3 * k].reshape(k, 3).contiguous()
    dev, n = table.device, table.shape[0]
    if k == 0:
        raise ValueError("the swept tree has no nodes")
    first, count, miss = meta[:, 0].long(), meta[:, 1].long(), meta[:, 2].long()
    node = torch.arange(k, device=dev)
    links = ((first >= 0) & (count >= 0) & (first + count <= n) & (miss > node)).all()
    # Coverage: +1 at each leaf's first row and -1 past its last.
    leaf = count > 0
    at_first = torch.where(leaf, first, n).clamp(0, n)
    cover = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    cover.index_add_(0, at_first, leaf.long())
    cover.index_add_(0, torch.where(leaf, first + count, n).clamp(0, n), -leaf.long())
    act = table[:, 5] > 0.0
    covered = cover.cumsum(0)[:n]
    once = (covered == act.long()).all()
    # Each covered row's leaf: the last leaf that starts at or before it.
    starts = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    starts[at_first] = torch.where(leaf, node, -1)
    row = torch.arange(n, device=dev)
    of_row = starts[torch.where(starts[:n] >= 0, row, 0).cummax(0).values]
    box = nodes[of_row.clamp_min(0)]
    c0, r0 = table[:, 0:3], table[:, 3:4].abs()
    c1, r1 = c0 + table[:, 24:27], (table[:, 3:4] + table[:, 27:28]).abs()
    inside = ((c0 - r0 >= box[:, 0:3]) & (c0 + r0 <= box[:, 3:6])
              & (c1 - r1 >= box[:, 0:3]) & (c1 + r1 <= box[:, 3:6])).all(dim=1)
    held = (inside | ~act).all()
    # An inner node's children: i + 1 and its skip link.
    left = node + 1
    right = miss[left.clamp_max(k - 1)]
    pair = (left < k) & (right < k)
    right_c = right.clamp(0, k - 1)
    pair = pair & (miss[right_c] == miss)
    for child in (left.clamp_max(k - 1), right_c):
        pair = pair & ((nodes[:, 0:3] <= nodes[child, 0:3]).all(dim=1)
                       & (nodes[:, 3:6] >= nodes[child, 3:6]).all(dim=1))
    parents = (pair | leaf).all()
    shallow = (_ancestors(meta) <= TREE_STACK).all()
    links, once, held, parents, shallow = torch.stack(
        [links, once, held, parents, shallow]).tolist()
    if not links:
        raise ValueError("swept_meta addresses rows outside the table, or has a skip "
                         "link that does not point past its node")
    if not once:
        raise ValueError("the swept tree's leaves do not hold every active row of the "
                         "table exactly once (and no inactive one)")
    if not (held and parents):
        raise ValueError(
            "the swept tree does not hold this table's spheres over the shutter: a "
            "sphere at shutter open or close leaves its leaf's box, or a node's box its "
            "children's; build it with swept_tables from the table's spheres and deltas"
        )
    if not shallow:
        raise ValueError(f"the swept tree is deeper than K6's stack of {TREE_STACK} "
                         "entries, which K5's walk shares; build it with swept_tables")
    return nodes, meta


def run_megakernel(
    smem,
    pix,
    sample0,
    cam,
    table,
    swept_nodes=None,
    swept_meta=None,
    tri_nodes=None,
    tris=None,
    mats=None,
    tri_meta=None,
    *,
    animated: bool,
    cam_animated: bool = False,
):
    """Dispatch the persistent megakernel -> per-lane radiance sums (3, R).

    With ``swept_nodes`` / ``swept_meta`` (:func:`swept_tables`) the
    closest hit walks that tree over ``table`` in the tree's order: a
    static table's (K5) or, with ``animated``, a moving one's whose boxes
    hold the spheres over the whole shutter (K6); else it tests every row
    (K1). ``animated`` moves the spheres on the linear shutter (table
    columns 24-29) and ``cam_animated`` re-derives the camera per path at
    its shutter fraction (cam slots 19-37): K8, the kernel's motion
    variants, on any search. A mesh's ``tri_nodes`` (K, 6), ``tris``,
    ``mats`` (NM, 24) and ``tri_meta`` (K, 3) (``integrator.make_tri_tables``)
    add the triangle stage (K7) after the brute search: ``tris`` (M, 16)
    Woop rows of a static mesh, or with ``animated`` (M, 32) rows of a
    moving one (K7 moving, at each path's shutter fraction). CUDA tensors
    launch the CUDA kernel; CPU tensors run the eager reference. The
    triangle stage beside a tree walk raises ``NotImplementedError``.
    """
    _check_inputs(smem, pix, sample0, cam, table)
    motion = dict(animated=bool(animated), cam_animated=bool(cam_animated))
    _check_combination(swept_nodes, swept_meta, tris, **motion)
    cull = _cull(swept_nodes, swept_meta, table)
    tri = _tri(tri_nodes, tris, mats, tri_meta, table)
    if table.device.type == "cpu":
        return _reference_loop(smem, pix, sample0, cam, table, rec_depth=0, radiance=True,
                               cull=cull, tri=tri, **motion)[0]
    return _launch(smem, pix, sample0, cam, table, None, True, cull, tri, **motion)[0]


def _check_combination(swept_nodes, swept_meta, tris, animated, cam_animated=False):
    """Raise for the triangle stage beside a tree walk, which the kernel
    does not instantiate, and for a triangle table whose layout is not the
    one ``animated`` reads."""
    if tris is None:
        return
    if swept_nodes is not None or swept_meta is not None:
        raise NotImplementedError(
            "the megakernel's triangle stage (K7) runs beside the brute sphere "
            "search only: a mesh beside a tree walk (K5's or K6's) is a template "
            "combination not instantiated yet (ROADMAP A11)"
        )
    if tris.dim() == 2 and (tris.shape[1] == TRI_MOVING_COLS) != animated:
        raise ValueError(
            f"an animated launch takes a moving mesh's (M, {TRI_MOVING_COLS}) rows and a "
            f"static one a static mesh's (M, {TRI_COLS}) Woop rows "
            f"(integrator.make_tri_tables gives every mesh of an animated scene the "
            f"moving layout), got {tuple(tris.shape)} with animated={animated}"
        )


def _cull(swept_nodes, swept_meta, table):
    """:func:`swept_inputs`, or None without a tree."""
    if swept_nodes is None and swept_meta is None:
        return None
    return swept_inputs(swept_nodes, swept_meta, table)


def _tri(tri_nodes, tris, mats, tri_meta, table):
    """The triangle stage's tables, checked, or None without a mesh ->
    (tri_nodes (K, 6), tri_meta (K, 3) int32, tris (M, 16) or (M, 32),
    mats (NM, 24)).

    Raises where [first, count, miss] address rows outside ``tris`` or a
    skip link does not point past its node, or where a row's material id is
    outside ``mats``. The checks run on the table's device and are read back
    in one host sync."""
    given = (tri_nodes, tris, mats, tri_meta)
    if all(x is None for x in given):
        return None
    if any(x is None for x in given):
        raise ValueError("the triangle stage needs tri_nodes, tris, mats and tri_meta")
    k = tri_nodes.shape[0] if tri_nodes.dim() == 2 else -1
    build.check_tensors(table.device, (
        ("tri_nodes", tri_nodes, torch.float32, (k, 6)),
        ("tri_meta", tri_meta, torch.int32, (k, 3)),
        ("tris", tris, torch.float32, None),
        ("mats", mats, torch.float32, None),
    ))
    if (tris.dim() != 2 or tris.shape[1] not in TRI_MAT_COL or mats.dim() != 2
            or mats.shape[1] != MAT_COLS):
        raise ValueError(f"tris must be (M, {TRI_COLS}) or (M, {TRI_MOVING_COLS}) and mats "
                         f"(NM, {MAT_COLS}), got {tuple(tris.shape)} and {tuple(mats.shape)}")
    first, count, miss = (tri_meta[:, j].long() for j in range(3))
    node = torch.arange(k, device=tri_meta.device)
    links = ((first >= 0) & (count >= 0) & (first + count <= tris.shape[0])
             & (miss > node)).all()
    mid = tris[:, TRI_MAT_COL[tris.shape[1]]]
    ids = ((mid >= 0) & (mid < mats.shape[0]) & (mid == mid.floor())).all()
    links, ids = torch.stack([links, ids]).tolist()
    if not links:
        raise ValueError("tri_meta addresses rows outside the tris, or has a skip link that "
                         "does not point past its node")
    if not ids:
        raise ValueError("tris holds a material id outside mats")
    return tri_nodes, tri_meta, tris, mats


def _check_inputs(smem, pix, sample0, cam, table):
    build.check_tensors(table.device, (
        ("smem", smem, torch.int32, (8,)),
        ("pix", pix, torch.int32, None),
        ("sample0", sample0, torch.int32, None),
        ("cam", cam, torch.float32, (1, CAM_SIZE)),
        ("table", table, torch.float32, None),
    ))
    if pix.dim() != 2 or pix.shape[0] != 1 or sample0.shape != pix.shape:
        raise ValueError(
            f"pix and sample0 must both be (1, R), got {tuple(pix.shape)} "
            f"and {tuple(sample0.shape)}"
        )
    if table.dim() != 2 or table.shape[1] != C_IN:
        raise ValueError(f"table must be (N, {C_IN}), got {tuple(table.shape)}")


def check_rows(n: int, animated: bool = False, cull=None) -> None:
    """Raise where the kernel's search cannot take an ``n``-row table: the
    brute search above its row cap (``MAX_ROWS``, with the motion columns
    when ``animated`` ``MAX_ROWS_ANIMATED``), a tree walk (``cull``, K5 or
    K6, whose records carry row ids in float32) at ``MAX_ID_ROWS`` rows or
    more. A walk reads its rows from global memory, and its nodes too where
    they do not fit in shared memory, as K7 reads its mesh."""
    if cull is not None:
        if n > MAX_ID_ROWS:
            raise ValueError(
                f"the tree walk carries row ids in float32, exact below "
                f"{MAX_ID_ROWS} rows; got {n}"
            )
        return
    cap = MAX_ROWS_ANIMATED if animated else MAX_ROWS
    if n > cap:
        raise ValueError(
            f"{n} sphere rows exceed the {cap} rows whose intersection "
            f"columns fit in a block's {SHARED_MEM_BYTES} bytes of shared "
            f"memory; bigger scenes need a tree walk (K5 for a static table, K6 for "
            f"a moving one)"
        )


def _variant(cull, tri, animated, cam_animated) -> str:
    """The launch-count key of a launch."""
    if cull is not None:
        return "cull" if animated else "motion_walk" if cam_animated else "walk"
    if tri is not None:
        return "tri_motion" if animated or cam_animated else "tri"
    return "motion" if animated or cam_animated else "brute"


def _row_entries(table, animated: bool):
    """The flat loop's row entries of ``table``'s rows, in its order:
    (N, 4) float32 (center, |c|^2 - r^2: columns 0-2, 4), or with
    ``animated`` (N, 12): that, then (center delta, s1: columns 24-26, 28)
    and (s2, original id: columns 29, 31, then two zeros), three 16-byte
    entries a row. Slices, not a list of columns, which would copy the list
    to the device."""
    parts = [table[:, 0:3], table[:, 4:5]]
    if animated:
        parts += [table[:, 24:27], table[:, 28:30], table[:, 31:32],
                  torch.zeros((table.shape[0], 2), dtype=table.dtype, device=table.device)]
    return torch.cat(parts, dim=1)


def brute_rows(table, animated: bool = False):
    """The brute search's staged row list (K1, K2, K8), built on the
    table's device with no host sync -> (rows: :func:`_row_entries`, the
    active rows first in table order, then the inactive ones; ids (N,)
    int32: each entry's table row; live (1,) int32: the number of active
    rows). The kernel stages entries [0, live) only, as 16-byte (36 with
    ``animated``) shared-memory rows, and a tie still goes to the lowest
    table row."""
    act = table[:, 5] > 0.0
    ids = torch.sort((~act).to(torch.int32), stable=True).indices
    rows = _row_entries(table, animated).index_select(0, ids)
    return rows, ids.to(torch.int32), act.sum(dtype=torch.int32).reshape(1)


def moving_tri_rows(tris):
    """K7 moving's packed copy of a moving mesh's (M, 32) rows -> (M, 20)
    float32, five 16-byte entries a row: the 18 columns its test reads
    (v0, e1, e2, v0d, e1d, e2d) in ``MOVING_TRI_PACK``'s order, then the
    material id and a zero."""
    return tris[:, list(MOVING_TRI_PACK)].contiguous()


@functools.cache
def _flat_shape(record: bool, radiance: bool, animated: bool, cam_animated: bool, n: int,
                k: int, kt: int, device: int) -> tuple:
    """The C library's flat-loop launch shape, queried once per
    (instantiation, n, k, kt, card); the query also lets the kernel take
    its dynamic shared memory, so each launch is sized from here and itself
    queries nothing."""
    lib = build.load("megakernel")
    shape = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        build.check(lib, lib.crucible_megakernel_flat_shape(
            int(record), int(radiance), int(animated), int(cam_animated), n, k, kt, shape),
            "flat shape")
    return tuple(shape)


def flat_launch_shape(record: bool, radiance: bool, n: int, r: int, *,
                      animated: bool = False, cam_animated: bool = False, nodes: int = 0,
                      tri_nodes: int = 0, device=None) -> dict:
    """The flat loop's launch on the current card (or ``device``) for an
    n-row table and R lanes, in forward (``record`` False, ``radiance``
    True) or record mode, with K8's flags, over the brute search, a sphere
    tree of ``nodes`` nodes (K5, K6) or the brute search with a mesh's tree
    of ``tri_nodes`` nodes (K7): grid (as many blocks as stay resident,
    none more than the lanes need), resident blocks per SM, SMs, threads
    per block, registers and local (stack and spill) bytes per thread, and
    dynamic shared memory per block."""
    index = None if device is None else torch.device(device).index
    dev = torch.cuda.current_device() if index is None else index
    per_sm, sms, threads, regs, local, smem = _flat_shape(
        bool(record), bool(radiance), bool(animated), bool(cam_animated), n, nodes, tri_nodes,
        dev)
    return dict(grid=min(per_sm * sms, -(-r // threads)), blocks_per_sm=per_sm, sms=sms,
                threads=threads, registers=regs, spill_bytes=local, smem_bytes=smem)


def _flat_args(cull, tri, table, animated):
    """The C entry points' (frows, fids, flive, fnodes, fmiss, trows, tris,
    mats, tnodes, tmiss, next) pointers, the sphere tree's and the mesh
    tree's node counts, and the tensors they point into: the brute
    search's staged rows (:func:`brute_rows`) or a tree's (its rows'
    entries in table order, its nodes as (K, 8): grown box, then first and
    count as int bits, and its skip links); a mesh's rows as the walk reads
    them (the Woop rows, or :func:`moving_tri_rows`), its rows and material
    rows, its nodes in the same (K, 8) layout and skip links; and a work
    counter."""
    def node_entries(nodes, meta):
        return (torch.cat([nodes, meta[:, 0:2].contiguous().view(torch.float32)], dim=1),
                meta[:, 2].contiguous())

    if cull is None:
        held = (*brute_rows(table, animated), None, None)
    else:
        held = (_row_entries(table, animated), None, None, *node_entries(*cull))
    if tri is None:
        held += (None,) * 5
    else:
        t_nodes, t_meta, tris, mats = tri
        trows = moving_tri_rows(tris) if animated else tris
        if trows.data_ptr() % 16:  # read as 16-byte entries
            trows = trows.clone()
        held += (trows, tris, mats, *node_entries(t_nodes, t_meta))
    held += (torch.empty(1, dtype=torch.int32, device=table.device),)
    fk = 0 if cull is None else cull[0].shape[0]
    kt = 0 if tri is None else tri[0].shape[0]
    return [None if t is None else t.data_ptr() for t in held], fk, kt, held


def _launch(smem, pix, sample0, cam, table, max_depth, radiance, cull, tri, animated,
            cam_animated):
    """One launch of the kernel -> (acc (3, R), rec (max_depth, R) or None):
    forward mode when ``max_depth`` is None, else record mode."""
    record = max_depth is not None
    n, r = table.shape[0], pix.shape[1]
    check_rows(n, animated, cull)
    lib = build.load("megakernel")
    acc = torch.empty((3, r), dtype=torch.float32, device=table.device)
    rec = (torch.empty((max_depth, r), dtype=torch.int32, device=table.device)
           if record else None)
    ptrs, fk, kt, _held = _flat_args(cull, tri, table, animated)
    shape = flat_launch_shape(record, radiance, n, r, animated=animated,
                              cam_animated=cam_animated, nodes=fk, tri_nodes=kt,
                              device=table.device)
    flags = (ctypes.c_float(T_MIN), int(animated), int(cam_animated))
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = (smem.data_ptr(), pix.data_ptr(), sample0.data_ptr(), cam.data_ptr(),
                table.data_ptr(), *ptrs, n, fk, kt, shape["grid"], r)
        if record:
            err = lib.crucible_megakernel_record(*head, max_depth, flags[0], int(bool(radiance)),
                                                 *flags[1:], acc.data_ptr(), rec.data_ptr(),
                                                 stream)
        else:
            err = lib.crucible_megakernel_forward(*head, *flags, acc.data_ptr(), stream)
    build.check(lib, err, "record megakernel" if record else "megakernel")
    (RECORD_LAUNCHES if record else FORWARD_LAUNCHES)[
        _variant(cull, tri, animated, cam_animated)] += 1
    return acc, rec


def run_megakernel_record(
    smem,
    pix,
    sample0,
    cam,
    table,
    swept_nodes=None,
    swept_meta=None,
    tri_nodes=None,
    tris=None,
    mats=None,
    tri_meta=None,
    *,
    max_depth: int,
    radiance: bool = False,
    animated: bool = False,
    cam_animated: bool = False,
):
    """Record-mode megakernel -> (acc (3, R) float32, rec (max_depth, R) int32).

    Each lane traces the one path (pixel, sample0); row ``it`` of ``rec`` is
    its packed decision word at bounce ``it`` (zero after the path ends).
    ``acc`` is that path's radiance from bounce ``smem[4]`` on when
    ``radiance`` (the fused mode), else zeros; the records are the same in
    both modes. ``smem[3]`` is overridden by ``max_depth``, which sizes the
    records. With ``swept_nodes`` / ``swept_meta`` the closest hit walks
    that tree over the table in its order (K5, or K6 with ``animated``), and
    the records hold the winners' original ids; else it tests every row
    (K2). ``animated`` and ``cam_animated`` are K8's, as in
    :func:`run_megakernel`: each path's words are those of the moving
    spheres and the camera at its shutter fraction. The triangle tables add
    K7's stage (K7 moving with ``animated``), as in :func:`run_megakernel`;
    a triangle winner's word holds its leaf-order id and ``F_TRI``. CUDA
    tensors launch the kernel; CPU tensors run the twin. The triangle stage
    beside a tree walk raises ``NotImplementedError``.
    """
    _check_inputs(smem, pix, sample0, cam, table)
    if max_depth < 1:
        raise ValueError(f"max_depth must be positive, got {max_depth}")
    motion = dict(animated=bool(animated), cam_animated=bool(cam_animated))
    tables = dict(swept_nodes=swept_nodes, swept_meta=swept_meta, tri_nodes=tri_nodes,
                  tris=tris, mats=mats, tri_meta=tri_meta)
    if table.device.type == "cpu":
        return run_megakernel_record_reference(
            smem, pix, sample0, cam, table, **tables, max_depth=max_depth,
            radiance=radiance, **motion,
        )
    _check_combination(swept_nodes, swept_meta, tris, **motion)
    cull = _cull(swept_nodes, swept_meta, table)
    tri = _tri(tri_nodes, tris, mats, tri_meta, table)
    smem = smem.clone()
    smem[3] = int(max_depth)
    return _launch(smem, pix, sample0, cam, table, int(max_depth), radiance, cull, tri,
                   **motion)


def run_megakernel_record_reference(
    smem, pix, sample0, cam, table, swept_nodes=None, swept_meta=None, tri_nodes=None,
    tris=None, mats=None, tri_meta=None, *, max_depth: int, radiance: bool = False,
    animated: bool = False, cam_animated: bool = False,
):
    """Eager-torch version of the record kernel: same inputs and outputs
    as :func:`run_megakernel_record`."""
    _check_combination(swept_nodes, swept_meta, tris, animated, cam_animated)
    cull = _cull(swept_nodes, swept_meta, table)
    tri = _tri(tri_nodes, tris, mats, tri_meta, table)
    smem = smem.clone()
    smem[3] = int(max_depth)
    return _reference_loop(
        smem, pix, sample0, cam, table, rec_depth=int(max_depth), radiance=radiance,
        cull=cull, tri=tri, animated=animated, cam_animated=cam_animated,
    )


# ---------------------------------------------------------------------------
# Eager reference
# ---------------------------------------------------------------------------


def run_megakernel_reference(smem, pix, sample0, cam, table, swept_nodes=None,
                             swept_meta=None, tri_nodes=None, tris=None, mats=None,
                             tri_meta=None, *, animated: bool = False,
                             cam_animated: bool = False, by_sample: bool = False):
    """Eager-torch version of the kernel: same inputs, same (3, R) output.

    Lanes advance in lockstep, as on the TPU: each step issues a new sample
    to every idle lane that has samples left, then traces one bounce of
    every live lane. Per lane this is the kernel's flat loop, in its order
    of operations, so each lane's sum is the kernel's.

    ``by_sample`` traces each of a lane's samples as a lane of its own, all
    in one lockstep loop (a step for each bounce instead of one for each
    bounce of each sample), keeps every bounce's addend, and then sums each
    lane's addends in the kernel's order (sample by sample, bounce by
    bounce; an addend past a path's end is 0.0, which leaves the sum's bits
    as they are): the same sums, in far fewer steps, holding
    ``max_depth * spp * R * 3`` floats.
    """
    _check_combination(swept_nodes, swept_meta, tris, animated, cam_animated)
    cull = _cull(swept_nodes, swept_meta, table)
    tri = _tri(tri_nodes, tris, mats, tri_meta, table)
    kw = dict(rec_depth=0, radiance=True, cull=cull, tri=tri, animated=animated,
              cam_animated=cam_animated)
    if not by_sample:
        return _reference_loop(smem, pix, sample0, cam, table, **kw)[0]
    spp, depth, r = int(smem[0]), int(smem[3]), pix.shape[1]
    s0 = sample0[0].to(torch.int64)
    smp = s0[None, :] + torch.arange(spp, device=s0.device)[:, None]  # (spp, R)
    smp = torch.where((s0 < NO_SAMPLE)[None, :] & (smp < spp), smp, NO_SAMPLE)
    adds = torch.zeros((depth, spp * r, 3), dtype=torch.float32, device=table.device)
    _reference_loop(smem, pix.repeat(1, spp), smp.reshape(1, -1).to(sample0.dtype), cam,
                    table, adds=adds, **kw)
    acc = torch.zeros((r, 3), dtype=torch.float32, device=table.device)
    for per_sample in adds.view(depth, spp, r, 3).unbind(1):
        for add in per_sample:
            acc = acc + add
    return acc.t().contiguous()


def _safe_inv(v):
    """1 / v with |v| raised to at least 1e-30 (keeping its sign)."""
    tiny = float(np.float32(1e-30))
    return 1.0 / torch.where(v.abs() < tiny, torch.where(v >= 0.0, tiny, -tiny), v)


def cull_closest_reference(o, d, table, nodes, meta, w=None, t_min: float = T_MIN,
                           counts=None):
    """Plain version of K5's and K6's closest hit: the lockstep walk of a
    tree of :func:`swept_inputs`, in the kernel's order, nearer child first
    (:func:`_near_first`) -> (t (R,), BIG on a miss; idx (R,) int64, the
    winner's row of the permuted ``table``, 0 on a miss; hit (R,) bool).

    At a node a ray slab-tests the box (``swept_inputs``' grown box, grown
    again by SLAB_EPS * the origin's largest |coordinate|) against
    [t_min, best]. Each leaf row's root is that of the spheres moving on the
    linear shutter at each ray's fraction ``w`` (R,), in the moving search's
    operations (``sphere_shade.moving_closest_reference``, K8's brute
    search, K6); ``w`` None takes the static search's (K1's, K5). A root
    replaces the best where it is nearer or, at an exact tie, where its
    original row id (column 31) is lower, so the result is the brute
    search's over the original table, bit for bit, in any order, wherever
    no leaf holding a winning root is skipped: a leaf's box holds its
    spheres over the whole shutter, each parent's its children's, and the
    margin covers the quadratic's error at the moving center c + w cd as it
    does at c. Adds the work done to ``counts`` (default ``CULL_COUNTS``):
    the slab tests (the root's, then both children's at each inner node the
    walk enters), rows and roots.
    """
    counts = CULL_COUNTS if counts is None else counts
    dev = o.device
    m = o.shape[0]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    a_q = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o_sq = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a_q
    ivx, ivy, ivz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    pr = SLAB_EPS * torch.maximum(torch.maximum(ox.abs(), oy.abs()), oz.abs())
    first, count = meta[:, 0].long(), meta[:, 1].long()
    cx, cy, cz, csr, act, orig = (table[:, c] for c in (0, 1, 2, 4, 5, 31))
    cdx, cdy, cdz, s1, s2 = (table[:, c] for c in MOVING_COLS)
    width = torch.arange(max(int(count.max()), 1), device=dev)
    rows_done = torch.zeros((), dtype=torch.int64, device=dev)
    roots_done = torch.zeros((), dtype=torch.int64, device=dev)

    best = torch.full((m,), BIG, dtype=torch.float32, device=dev)
    win = torch.zeros((m,), dtype=torch.int64, device=dev)

    def entered(lanes, c):
        """Slab tests of nodes ``c`` by rays ``lanes`` against [t_min, best]
        -> (entered, entry distance)."""
        b, p = nodes[c], pr[lanes]
        lox, loy, loz = ox[lanes], oy[lanes], oz[lanes]
        t0x = ((b[:, 0] - p) - lox) * ivx[lanes]
        t1x = ((b[:, 3] + p) - lox) * ivx[lanes]
        t0y = ((b[:, 1] - p) - loy) * ivy[lanes]
        t1y = ((b[:, 4] + p) - loy) * ivy[lanes]
        t0z = ((b[:, 2] - p) - loz) * ivz[lanes]
        t1z = ((b[:, 5] + p) - loz) * ivz[lanes]
        return _slab(t0x, t1x, t0y, t1y, t0z, t1z, t_min, best[lanes])

    def leaf(ln, c):
        """Rays ``ln`` test the rows of nodes ``c`` (none at an inner node):
        the best root, ties to the lower original id."""
        nonlocal rows_done, roots_done
        cnt = count[c]
        inside = width < cnt[:, None]
        rows = torch.where(inside, first[c][:, None] + width, 0)
        rx, ry, rz = cx[rows], cy[rows], cz[rows]

        def ex(v):  # a per-ray value against the leaf's rows
            return v[ln][:, None]

        dc = rx * ex(dx) + ry * ex(dy) + rz * ex(dz)
        oc = rx * ex(ox) + ry * ex(oy) + rz * ex(oz)
        c_sr = csr[rows]
        if w is not None:  # the rows at the rays' shutter fractions
            wr = ex(w)
            ux, uy, uz = cdx[rows], cdy[rows], cdz[rows]
            dc = dc + wr * (ux * ex(dx) + uy * ex(dy) + uz * ex(dz))
            oc = oc + wr * (ux * ex(ox) + uy * ex(oy) + uz * ex(oz))
            c_sr = c_sr + (2.0 * wr) * s1[rows] + (wr * wr) * s2[rows]
        t_all, disc = sphere_hit.accepted_roots(
            dc - ex(d_dot_o), c_sr - 2.0 * oc + ex(o_sq), ex(a_q), ex(inv_a),
            inside & (act[rows] > 0.0), t_min,
        )
        rows_done = rows_done + inside.sum()
        roots_done = roots_done + (inside & (disc >= 0.0)).sum()
        t_leaf = t_all.min(dim=1).values
        ids = orig[rows]
        at_min = t_all == t_leaf[:, None]
        id_leaf = torch.where(at_min, ids, float("inf")).min(dim=1).values
        row_leaf = rows.gather(1, (at_min & (ids == id_leaf[:, None])).int().argmax(1, keepdim=True))[:, 0]
        b_best = best[ln]
        better = (t_leaf < b_best) | (
            (t_leaf == b_best) & (t_leaf < BIG) & (id_leaf < orig[win[ln]])
        )
        best[ln] = torch.where(better, t_leaf, b_best)
        win[ln] = torch.where(better, row_leaf, win[ln])

    counts["nodes"] += _near_first(m, meta, entered, leaf, best)
    counts["rows"] += int(rows_done)
    counts["roots"] += int(roots_done)
    hit = best < BIG
    return best, torch.where(hit, win, 0), hit


def _slab(t0x, t1x, t0y, t1y, t0z, t1z, t_min, bound):
    """A slab test's (entered, entry distance) from its six plane distances,
    against [t_min, bound], in the kernels' order of min / max."""
    enter = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.clamp_min(torch.minimum(t0z, t1z), t_min),
    )
    exitv = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.minimum(torch.maximum(t0z, t1z), bound),
    )
    return enter <= exitv, enter


def tree_depth(meta) -> int:
    """The most inner-node ancestors of a node of a skip-link tree (``meta``
    (K, 3) [first, count, miss]), the most far children a near-first walk
    defers (:func:`_ancestors`)."""
    return int(_ancestors(meta).max()) if meta.shape[0] else 0


def _ancestors(meta):
    """Each node's inner-node ancestors (K,) int64, without a host sync:
    node j's descendants are j + 1 .. miss[j] - 1, so a prefix sum over the
    inner nodes counts them."""
    k = meta.shape[0]
    inner = meta[:, 1] == 0
    diff = torch.zeros(k + 1, dtype=torch.int64, device=meta.device)
    diff.index_add_(0, torch.where(inner, torch.arange(1, k + 1, device=meta.device), k),
                    inner.long())
    diff.index_add_(0, torch.where(inner, meta[:, 2].long(), k).clamp(0, k), -inner.long())
    return diff.cumsum(0)[:k]


def _near_first(m, meta, entered, leaf, bound) -> int:
    """The lockstep near-first walk of the plain sphere walks (K5, K6) over a
    skip-link tree ``meta`` (K, 3) for ``m`` rays, in the kernels' order:
    each live ray takes one step an iteration, masked rather than
    compacted: a leaf's rows (``leaf(lanes, nodes)``, which has none to test
    at an inner node and lowers the rays' ``bound`` in place), else both
    children's slab tests (``entered(lanes, nodes)`` -> (entered, entry)
    against [t_min, bound]), going on to the nearer child it enters and
    deferring the other with its entry distance; a ray that enters neither
    child, or has left a leaf, resumes at its last deferred child still
    entered before its bound, or is done. Returns the slab tests made."""
    k, dev = meta.shape[0], bound.device
    count, miss = meta[:, 1].long(), meta[:, 2].long()
    depth = tree_depth(meta) + 1
    stack_n = torch.zeros((m, depth), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((m, depth), dtype=torch.float32, device=dev)
    sp = torch.zeros((m,), dtype=torch.int64, device=dev)
    slot = torch.arange(depth, device=dev)
    cur = torch.zeros((m,), dtype=torch.int64, device=dev)
    nodes_done = torch.zeros((), dtype=torch.int64, device=dev)
    active = torch.zeros((m,), dtype=torch.bool, device=dev)
    if k:
        active, _ = entered(torch.arange(m, device=dev), cur)
        nodes_done = nodes_done + m
    while True:
        lanes = torch.nonzero(active).squeeze(1)
        if lanes.numel() == 0:
            break
        c = cur[lanes]
        leaf(lanes, c)
        inner = count[c] == 0
        left = torch.where(inner, c + 1, 0)
        right = torch.where(inner, miss[left], 0)
        # Both children's slab tests in one batch (a lane's bound is the same
        # for both).
        hit2, enter2 = entered(lanes.repeat(2), torch.cat([left, right]))
        (hl, hr), (el, er) = hit2.view(2, -1), enter2.view(2, -1)
        hl, hr = hl & inner, hr & inner
        nodes_done = nodes_done + 2 * inner.sum()
        both, near_l = hl & hr, el <= er
        s = sp[lanes]
        pos = s.clamp_max(depth - 1)
        stack_n[lanes, pos] = torch.where(both, torch.where(near_l, right, left),
                                          stack_n[lanes, pos])
        stack_t[lanes, pos] = torch.where(both, torch.where(near_l, er, el),
                                          stack_t[lanes, pos])
        s = s + both.long()
        go = hl | hr
        nxt = torch.where(both, torch.where(near_l, left, right), torch.where(hl, left, right))
        ok = (slot < s[:, None]) & (stack_t[lanes] <= bound[lanes][:, None])
        top = torch.where(ok, slot, -1).max(dim=1).values
        found = top >= 0
        cur[lanes] = torch.where(go, nxt, stack_n[lanes, top.clamp_min(0)])
        sp[lanes] = torch.where(go, s, top.clamp_min(0))
        active[lanes] = go | found
    return int(nodes_done)


def tri_closest_reference(o, d, t_init, tri_nodes, tri_meta, tris, t_min: float = T_MIN,
                          w=None):
    """Plain version of K7's walk: each ray walks the triangle BVH's skip
    links on its own, all rays in lockstep (``ops/traverse.lockstep_walk``)
    -> (t (R,), idx (R,) int64: the winner's row of ``tris``, leaf order).

    The slab test is the kernel's, without a margin. On Woop rows (M, 16)
    a leaf's rows get the unit-triangle test in the kernel's association:
    with the row's affine map (columns 0-11), d'_z = a2 . d, t = -(a2 . o +
    b_z) / d'_z (d'_z guarded at |d'_z| > 1e-12), u = (a0 . o + b_x) + t
    (a0 . d) and v likewise from a1. On moving rows (M, 32) (K7 moving) the
    rows are first lerped to each ray's shutter fraction ``w`` (R,): e1 +
    w e1d, e2 + w e2d and o - (v0 + w v0d), then Möller–Trumbore in the
    kernel's association (:func:`_moving_mt`, |det| > 1e-8). A hit needs u,
    v >= 0, u + v <= 1 and t in (t_min, the bound so far). A triangle
    replaces the bound ``t_init`` (the sphere stage's t) only where strictly
    nearer; ``idx`` is 0 where none did. Adds the work done to
    ``TRI_COUNTS``.
    """
    moving = tris.shape[1] == TRI_MOVING_COLS
    if moving and w is None:
        raise ValueError("a moving mesh's rows need the rays' shutter fractions w")

    def woop_test(lanes, rows):
        wr = tris[rows]  # (L, W, 16)
        a = wr[..., 0:9].reshape(*rows.shape, 3, 3)  # rows a0, a1, a2 of the map

        def affine(v):  # (a_i . v) for i = 0, 1, 2, summed left to right
            p = a * v[lanes][:, None, None, :]
            return (p[..., 0] + p[..., 1]) + p[..., 2]

        dp = affine(d)
        op = affine(o) + wr[..., 9:12]
        dpz = dp[..., 2]
        dz_ok = torch.abs(dpz) > 1e-12
        invdz = torch.where(dz_ok, 1.0 / torch.where(dpz == 0.0, 1.0, dpz), 0.0)
        th = -op[..., 2] * invdz
        uv = op[..., 0:2] + th[..., None] * dp[..., 0:2]
        uu, vv = uv[..., 0], uv[..., 1]
        return th, dz_ok & (uv >= 0.0).all(dim=-1) & (uu + vv <= 1.0) & (th > t_min)

    def moving_test(lanes, rows):
        th, ok = _moving_mt(tris[rows], o[lanes][:, None], d[lanes][:, None],
                            w[lanes][:, None])
        return th, ok & (th > t_min)

    return lockstep_walk(o, d, t_init, tri_nodes[:, 0:3], tri_nodes[:, 3:6], tri_meta[:, 0],
                         tri_meta[:, 1], tri_meta[:, 2], t_min,
                         moving_test if moving else woop_test, TRI_COUNTS)


def _moving_edges(r, w):
    """The edges e1 + w e1d and e2 + w e2d of moving rows ``r`` (..., 32) at
    shutter fractions ``w`` (...), each a list of three components."""
    return ([r[..., 3 + k] + w * r[..., 19 + k] for k in range(3)],
            [r[..., 6 + k] + w * r[..., 22 + k] for k in range(3)])


def _moving_mt(r, o, d, w):
    """K7 moving's leaf test of moving rows ``r`` (..., 32) against rays
    (o, d) (..., 3) at shutter fractions ``w`` (...) broadcast against them,
    term by term in the kernel's association -> (t, ok before the t
    bounds)."""
    e1, e2 = _moving_edges(r, w)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    pv = (dy * e2[2] - dz * e2[1], dz * e2[0] - dx * e2[2], dx * e2[1] - dy * e2[0])
    det = (e1[0] * pv[0] + e1[1] * pv[1]) + e1[2] * pv[2]
    det_ok = torch.abs(det) > 1e-8
    invd = torch.where(det_ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tv = [o[..., k] - (r[..., k] + w * r[..., 16 + k]) for k in range(3)]
    uu = ((tv[0] * pv[0] + tv[1] * pv[1]) + tv[2] * pv[2]) * invd
    qv = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
          tv[0] * e1[1] - tv[1] * e1[0])
    vv = ((dx * qv[0] + dy * qv[1]) + dz * qv[2]) * invd
    th = ((e2[0] * qv[0] + e2[1] * qv[1]) + e2[2] * qv[2]) * invd
    return th, det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)


def moving_tri_normal(rows, w):
    """The unit normal of moving rows ``rows`` (R, 32) at shutter fractions
    ``w`` (R,), as K7 moving makes its winner's: the cross of the lerped
    edges over max(|n|, 1e-20), the squares summed left to right."""
    e1, e2 = _moving_edges(rows, w)
    n = torch.stack([e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                     e1[0] * e2[1] - e1[1] * e2[0]], dim=1)
    nlen = torch.sqrt((n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]) + n[:, 2] * n[:, 2])
    return n * (1.0 / torch.clamp_min(nlen, 1e-20))[:, None]


def camera_at(c, w):
    """K8's camera at the paths' shutter fractions w (L,), from the camera
    vector ``c`` (48,), in the kernel's order of operations -> (pixel00,
    du, dv, look_from, basis u, basis v), each (L, 3): look_from and
    look_at lerped by w, then the basis as ``camera.generate_rays`` builds
    it (true divisions, lengths floored at 1e-12)."""
    wv = w[:, None]
    lf = c[9:12] + wv * c[22:25]
    w0 = lf - (c[19:22] + wv * c[25:28])

    def unit(v):
        n = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
        return v / torch.clamp_min(n, 1e-12)[:, None]

    def cross(a, b):
        return torch.stack([a[..., 1] * b[:, 2] - a[..., 2] * b[:, 1],
                            a[..., 2] * b[:, 0] - a[..., 0] * b[:, 2],
                            a[..., 0] * b[:, 1] - a[..., 1] * b[:, 0]], dim=1)

    wb = unit(w0)
    ub = unit(cross(c[28:31], wb))
    vb = cross(wb, ub)
    du = c[32] * ub / c[34]
    dv = -c[31] * vb / c[35]
    p00 = lf - c[33] * wb - c[36] * du - c[37] * dv
    return p00, du, dv, lf, ub, vb


def _reference_loop(smem, pix, sample0, cam, table, *, rec_depth: int, radiance: bool,
                    cull=None, tri=None, animated: bool = False, cam_animated: bool = False,
                    adds=None):
    """The lockstep loop of both eager versions -> (acc (3, R), rec).

    ``rec_depth`` 0 is forward mode (``rec`` is None). Otherwise record
    mode: each lane issues its ``sample0`` only, and row ``it`` of ``rec``
    (rec_depth, R) holds the lane's decision word at bounce ``it``;
    ``radiance`` then says whether to accumulate it, from bounce smem[4] on.
    ``adds`` (max_depth, R, 3), forward mode only: each lane issues its
    ``sample0`` only, and bounce b's addend goes to ``adds[b]`` in place of
    the sum (``acc`` stays 0).
    ``cull`` (``swept_inputs``' nodes and meta) takes the closest hit from
    the tree walk over the permuted table (:func:`cull_closest_reference`:
    K5's, counted in ``WALK_COUNTS``, or with ``animated`` K6's, its rows
    moving at each path's shutter fraction, counted in ``CULL_COUNTS``), the
    records' winner ids from its column 31. ``tri`` (``_tri``'s tables) adds
    K7's stage: a triangle strictly nearer than the sphere
    (:func:`tri_closest_reference`) takes the hit, with its table normal (a moving mesh's: its lerped
    normal at the path's shutter fraction, :func:`moving_tri_normal`) and
    its material's row of ``mats`` in the table's columns 6-23, and records
    its leaf-order id with ``F_TRI``. ``animated`` and ``cam_animated`` (both modes) are K8's: the
    moving-sphere search and winner lerp (which the record's root choice
    reads too), and the camera at each path's shutter fraction
    (:func:`camera_at`).
    """
    spp, seed, width, max_depth = (int(v) for v in smem[:4].tolist())
    accum_from = int(smem[4]) if rec_depth else 0
    dev = table.device
    pix = pix[0].to(torch.int64)
    r = pix.shape[0]
    fi = (pix % width).to(torch.float32)
    fj = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    c = cam[0]
    p00, du, dv = c[0:3], c[3:6], c[6:9]
    lf, ub, vb, defr = c[9:12], c[12:15], c[15:18], c[18]

    sample_i = sample0[0].to(torch.int64).clone()
    # Forward mode issues samples up to spp; record mode sample0 alone
    # (padding lanes carry 2**30 and never issue).
    one = rec_depth or adds is not None
    limit = torch.clamp_max(sample_i + 1, NO_SAMPLE) if one else spp
    alive = torch.zeros(r, dtype=torch.bool, device=dev)
    bounce = torch.zeros(r, dtype=torch.int64, device=dev)
    o = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    d = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    thr = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    rec = torch.zeros((rec_depth, r), dtype=torch.int32, device=dev) if rec_depth else None
    it = 0

    while True:
        issue = ~alive & (sample_i < limit)
        live = torch.nonzero(alive | issue).squeeze(1)
        if live.numel() == 0:
            break
        iss = issue[live]
        # An issued lane traces sample_i; a continuing lane sample_i - 1.
        smp = sample_i[live] - (~iss).to(torch.int64)
        p = pix[live]

        # --- the paths' shutter fractions (K8) ---------------------------
        if animated or cam_animated:
            w = crng.uniform1(p, smp, crng.STREAM_TIME, seed)
        l_p00, l_du, l_dv, l_lf, l_ub, l_vb = (
            camera_at(c, w) if cam_animated else (p00, du, dv, lf, ub, vb)
        )

        # --- primary rays for the issued lanes --------------------------
        ux, uy, ud1, ud2 = crng.uniform4(p, smp, crng.STREAM_PIXEL_JITTER, seed)
        off = sampling.square_offset(ux, uy)
        pos = (
            l_p00
            + (fi[live] + off[:, 0])[:, None] * l_du
            + (fj[live] + off[:, 1])[:, None] * l_dv
        )
        disk = sampling.in_unit_disk(ud1, ud2)
        new_o = (l_lf + (disk[:, 0] * defr)[:, None] * l_ub
                 + (disk[:, 1] * defr)[:, None] * l_vb)
        o_l = torch.where(iss[:, None], new_o, o[live])
        d_l = torch.where(iss[:, None], pos - new_o, d[live])
        thr_l = torch.where(iss[:, None], 1.0, thr[live])
        b_l = torch.where(iss, 0, bounce[live])

        # --- closest hit; the winner's row only where there is one --------
        # The brute search is K10's (the kernel shares its search routine),
        # or for moving spheres K9's.
        SEARCH_COUNTS["searches"] += int(live.numel())
        SEARCH_COUNTS["issued"] += int(iss.sum())
        if cull is not None:
            t, idx, hit = cull_closest_reference(
                o_l, d_l, table, *cull, w=w if animated else None,
                counts=CULL_COUNTS if animated else WALK_COUNTS)
        elif animated:
            t, idx = sphere_shade.moving_closest_reference(o_l, d_l, w, table, T_MIN)
            hit = t < BIG
        else:
            t, idx, hit = sphere_hit.hit_spheres_reference(
                o_l, d_l, table[:, 0:3], table[:, 4], table[:, 5], T_MIN
            )
        idx = idx.long()
        row = torch.zeros((live.numel(), C_IN), dtype=torch.float32, device=dev)
        on = torch.nonzero(hit).squeeze(1)
        row[on] = table[idx[on]]
        if tri is not None:  # K7: a triangle strictly nearer than the sphere
            t_nodes, t_meta, tris, mats = tri
            moving = tris.shape[1] == TRI_MOVING_COLS  # K7 moving, at w
            tb, tid = tri_closest_reference(o_l, d_l, torch.where(hit, t, BIG), t_nodes,
                                            t_meta, tris, w=w if moving else None)
            is_tri = tb < torch.where(hit, t, BIG)
            t = torch.where(is_tri, tb, t)
            hit = hit | is_tri
            twin = tris[tid]
            mid = twin[:, TRI_MAT_COL[tris.shape[1]]].long()
            row[:, 6:24] = torch.where(is_tri[:, None], mats[mid, 0:18], row[:, 6:24])
            t_nrm = moving_tri_normal(twin, w) if moving else twin[:, 12:15]

        t_sh = torch.where(hit, t, 1.0)
        hp = o_l + t_sh[:, None] * d_l
        w_c, w_r = row[:, 0:3], row[:, 3]
        if animated:  # the winner at the path's shutter fraction
            w_c = w_c + w[:, None] * row[:, 24:27]
            w_r = w_r + w * row[:, 27]
        inv_r = 1.0 / torch.clamp_min(w_r, 1e-20)
        nrm = (hp - w_c) * inv_r[:, None]
        if tri is not None:
            nrm = torch.where(is_tri[:, None], t_nrm, nrm)
        front = d_l[:, 0] * nrm[:, 0] + d_l[:, 1] * nrm[:, 1] + d_l[:, 2] * nrm[:, 2] < 0.0
        nrm = nrm * torch.where(front, 1.0, -1.0)[:, None]

        # --- sky on a miss, emission on a hit ------------------------------
        if radiance:
            sky = sky_mod.default_gradient(d_l)
            add = thr_l * torch.where(hit[:, None], row[:, 10:13], sky)
            if accum_from > 0:  # adding 0.0 rounds like the kernel's skip
                add = torch.where((b_l >= accum_from)[:, None], add, 0.0)
            if adds is not None:
                adds[b_l, live] = add
            else:
                acc[live] = acc[live] + add

        # --- albedo: solid or checker of solids ----------------------------
        is_even = tex_mod.checker_is_even(row[:, 17], hp)
        is_checker = (row[:, 13] == tex_mod.CHECKER)[:, None]
        albedo = torch.where(
            is_checker,
            torch.where(is_even[:, None], row[:, 18:21], row[:, 21:24]),
            row[:, 14:17],
        )

        # --- scatter -------------------------------------------------------
        u1, u2, u_dec, _ = crng.uniform4(p, smp, crng.STREAM_BOUNCE_BASE + b_l, seed)
        new_d, atten, scattered, refl, degen = mat_mod.scatter(
            row[:, 6], row[:, 7], row[:, 8], row[:, 9], albedo, d_l, nrm, front,
            u1, u2, u_dec,
        )
        cont = hit & scattered & (b_l + 1 < max_depth)
        if rec_depth:
            # Per-winner quadratic, as the replay re-solves it: which root.
            # A moving winner's at the path's shutter fraction.
            a_q = d_l[:, 0] * d_l[:, 0] + d_l[:, 1] * d_l[:, 1] + d_l[:, 2] * d_l[:, 2]
            oc = w_c - o_l
            r_h = d_l[:, 0] * oc[:, 0] + d_l[:, 1] * oc[:, 1] + d_l[:, 2] * oc[:, 2]
            r_c = oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2] - w_r * w_r
            r_disc = torch.clamp_min(r_h * r_h - a_q * r_c, 0.0)
            root1 = ~((r_h - torch.sqrt(r_disc)) * (1.0 / a_q) > T_MIN)
            if tri is not None:  # a triangle has no second root
                root1 = root1 & ~is_tri
            flags = (
                F_ALIVE | F_HIT
                | torch.where(scattered, F_SCAT, 0) | torch.where(front, F_FRONT, 0)
                | torch.where(refl, F_REFL, 0) | torch.where(degen, F_DEGEN, 0)
                | torch.where(root1, F_ROOT1, 0)
            )
            # A miss keeps the alive bit alone (megakernel.py l.1498). A
            # walk's winner is a permuted row: record its original id; a
            # triangle its leaf-order id.
            win_id = idx if cull is None else row[:, 31].long()
            if tri is not None:
                flags = flags | torch.where(is_tri, F_TRI, 0)
                win_id = torch.where(is_tri, tid, win_id)
            rec[it, live] = torch.where(hit, win_id * REC_ID_SCALE + flags, F_ALIVE).to(torch.int32)
        cont3 = cont[:, None]
        if radiance:
            thr[live] = torch.where(cont3, thr_l * atten, thr_l)
        o[live] = torch.where(cont3, hp, o_l)
        d[live] = torch.where(cont3, new_d, d_l)
        bounce[live] = b_l + 1
        alive[live] = cont
        sample_i[live] = sample_i[live] + iss.to(torch.int64)
        it += 1
    return acc.t().contiguous(), rec
