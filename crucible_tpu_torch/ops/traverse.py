"""Stackless lockstep BVH traversal for a wavefront of rays.

Port of ``crucible_tpu/ops/traverse.py``. Every ray carries a DFS cursor
into the flat skip-link BVH (``ops/bvh.py``): on a box hit at an inner
node the cursor advances to the left child (``i + 1``), otherwise it
follows the ``miss`` link; a leaf's rows are tested, then the walk goes on
at ``miss``. The closest distance so far is the slab test's upper bound.
Each step runs the rays whose cursor is still inside the tree (eagerly,
with ``torch.nonzero``); the cursor only moves forward, so the walk takes
at most as many steps as there are nodes.

:func:`lockstep_walk` is the walk with a pluggable leaf test: the staged
path's :func:`bvh_hit_triangles` (Möller–Trumbore, ``intersect.mt_hit``, the
one form of the JAX package's ``_mt_components`` / ``_mt_single``, on the
leaf rows' vertices, lerped for a moving mesh, or from the exact-time
vertex hook ``vertex_fn``) and the
plain version of the megakernel's triangle stage (K7, the Woop
unit-triangle test, ``ops/kernels/megakernel.py``) both run it.
"""

from __future__ import annotations

import math

import torch

from crucible_tpu_torch.ops.intersect import BIG, mt_hit


def safe_inv(v: torch.Tensor) -> torch.Tensor:
    """1 / v with |v| raised to at least 1e-30, keeping its sign."""
    return 1.0 / torch.where(torch.abs(v) < 1e-30, torch.where(v >= 0, 1e-30, -1e-30), v)


def lockstep_walk(o, d, t_init, node_min, node_max, first, count, miss, t_min, leaf_test,
                  counts=None):
    """Closest hit through a flat skip-link BVH -> (t (R,), idx (R,) int64).

    ``t_init`` (R,) is each ray's starting bound; a row wins only if its t
    is strictly below the ray's bound so far. ``leaf_test(lanes, rows)``
    gets the walking rays' ids (L,) and their leaf's row ids (L, W) and
    returns (t (L, W), ok (L, W) bool) before the bound. At node i the box
    is slab-tested against [t_min, bound]: (box - o) / d per axis, entry the
    largest near slab, exit the smallest far one. Within a leaf the lowest
    row wins an exact tie, and across leaves the first in DFS order, as a
    sequential test with a strict '<' gives them. ``idx`` is the winning
    row (0 where nothing beat ``t_init``). ``counts``, a dict, gains the
    slab tests made ("nodes") and the leaf rows tested ("rows").
    """
    dev = o.device
    m, k = o.shape[0], node_min.shape[0]
    # Each step gathers a node's box and metadata in one row each, and
    # slab-tests all six planes at once: (box - o) * (1 / d), per element.
    boxes = torch.cat([node_min, node_max], dim=1)
    meta = torch.stack([first.long(), count.long(), miss.long()], dim=1)
    o6 = torch.cat([o, o], dim=1)
    inv6 = torch.cat([safe_inv(d)] * 2, dim=1)
    width = torch.arange(max(int(count.max()), 1), device=dev)
    best = t_init.clone()
    win = torch.zeros((m,), dtype=torch.int64, device=dev)
    cur = torch.zeros((m,), dtype=torch.int64, device=dev)
    rows_tested = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        lanes = torch.nonzero(cur < k).squeeze(1)
        if lanes.numel() == 0:
            break
        c = cur[lanes]
        t = (boxes[c] - o6[lanes]) * inv6[lanes]
        enter = torch.clamp_min(torch.minimum(t[:, :3], t[:, 3:]).amax(dim=1), t_min)
        exitv = torch.minimum(torch.maximum(t[:, :3], t[:, 3:]).amin(dim=1), best[lanes])
        hit_node = enter <= exitv
        mc = meta[c]
        cnt = mc[:, 1]
        sel = torch.nonzero(hit_node & (cnt > 0)).squeeze(1)
        if sel.numel():
            ln = lanes[sel]
            inside = width < cnt[sel][:, None]
            rows = torch.where(inside, mc[sel, 0:1] + width, 0)
            t_row, ok = leaf_test(ln, rows)
            b_ln = best[ln]
            ok = ok & inside & (t_row < b_ln[:, None])
            t_leaf, at = torch.where(ok, t_row, math.inf).min(dim=1)  # first of equal t
            better = t_leaf < b_ln
            best[ln] = torch.where(better, t_leaf, b_ln)
            win[ln] = torch.where(better, rows.gather(1, at[:, None])[:, 0], win[ln])
            rows_tested += inside.sum()
        cur[lanes] = torch.where(hit_node & (cnt == 0), c + 1, mc[:, 2])
        if counts is not None:
            counts["nodes"] += int(lanes.numel())
    if counts is not None:
        counts["rows"] += int(rows_tested)
    return best, win


def bvh_hit_triangles(o, d, v0, v1, v2, node_min, node_max, node_first, node_count,
                      node_miss, t_min, t_max, leaf_size: int, v0d=None, v1d=None, v2d=None,
                      w=None, vertex_fn=None):
    """Closest triangle hit through the flat BVH, the staged path's walk.

    Args:
      o, d: (R, 3) rays.
      v0, v1, v2: (M, 3) triangle vertices in LEAF ORDER.
      node_*: the flat BVH (K nodes); for a moving mesh the boxes enclose
        the shutter-open and shutter-close vertices.
      t_min, t_max: the open interval of accepted t.
      leaf_size: the tree's largest leaf (the walk reads each leaf's count).
      v0d, v1d, v2d, w: optional linear shutter motion, vertex(w) = v + w
        vd with per-ray w, lerped per leaf row.
      vertex_fn: the exact per-ray-time vertex hook: ``vertex_fn(lanes,
        rows) -> (a, b, c)``, each (L, W, 3), the vertices of the leaf rows
        ``rows`` (L, W) at the times of the rays ``lanes`` (L,) (their ids
        in this batch), in place of v0 / v1 / v2 (which then only give the
        row count). The node boxes must hold each triangle over the whole
        shutter window (``Scene.build`` grows them at every kink).

    Returns (t (R,), BIG on a miss; idx (R,) int32, the winner in leaf
    order; hit (R,)). The walk carries no gradient, as the JAX package's
    ``lax.while_loop`` does not in reverse mode: with autograd recording,
    inputs that need a gradient raise ``NotImplementedError``.
    """
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (o, d, v0, v1, v2, v0d, v1d, v2d)):
        raise NotImplementedError(
            "reverse mode through the triangle-BVH walk: the JAX package's "
            "while_loop has no transpose either"
        )
    del leaf_size  # each leaf's own count bounds its rows
    moving = v0d is not None

    def leaf_test(lanes, rows):
        if vertex_fn is not None:
            a, b, c = vertex_fn(lanes, rows)
            return mt_hit(o[lanes][:, None, :], d[lanes][:, None, :], a, b, c, t_min,
                          math.inf)

        def vert(v, vd):
            x = v[rows]
            return x if not moving else x + w[lanes][:, None, None] * vd[rows]

        return mt_hit(o[lanes][:, None, :], d[lanes][:, None, :], vert(v0, v0d),
                      vert(v1, v1d), vert(v2, v2d), t_min, math.inf)

    r = o.shape[0]
    t_init = torch.full((r,), float(t_max), dtype=torch.float32, device=o.device)
    with torch.no_grad():
        t, idx = lockstep_walk(o, d, t_init, node_min, node_max, node_first, node_count,
                               node_miss, t_min, leaf_test)
    hit = t < min(float(t_max), BIG)
    return torch.where(hit, t, BIG), idx.to(torch.int32), hit
