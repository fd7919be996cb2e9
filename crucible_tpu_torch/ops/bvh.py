"""Host-side BVH construction into flat, stackless-traversal-ready arrays.

Port of ``crucible_tpu/ops/bvh.py``. :func:`build_bvh` runs the port's C++
builder (:mod:`crucible_tpu_torch.native`) by default; its Python builder,
here, is the plain version, and both give the same trees bit for bit.
Topology follows the reference builder:
recursive top-down, median split of the span sorted by bbox-min along the
longest axis (``method="median"``) or a binned surface-area-heuristic split
(``method="sah"``). Nodes are emitted in DFS order with *skip links*:

  - on a box hit at an inner node, go on to ``i + 1`` (its left child);
  - on a miss, or after testing a leaf, jump to ``miss[i]``;
  - the walk ends when the cursor reaches ``num_nodes``.

Primitives are permuted into leaf order (``perm``), so that a leaf
addresses a contiguous range.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatBVH:
    """Flat DFS-ordered BVH; all arrays numpy."""

    node_min: np.ndarray  # (K, 3) f32
    node_max: np.ndarray  # (K, 3) f32
    node_first: np.ndarray  # (K,) i32 — first primitive (leaf), else 0
    node_count: np.ndarray  # (K,) i32 — primitive count (0 for inner nodes)
    node_miss: np.ndarray  # (K,) i32 — skip link
    node_parent: np.ndarray  # (K,) i32 — parent index (-1 for root)
    perm: np.ndarray  # (M,) i32 — primitive permutation into leaf order

    @property
    def num_nodes(self) -> int:
        return len(self.node_min)


_SAH_BINS = 16


def _sah_split(span, centers, bb_min, bb_max, leaf_size=0):
    """Binned SAH split of ``span``: the (axis, plane) minimizing
    N_L*Area_L + N_R*Area_R over 16 centroid bins per axis -> (left, right)
    index arrays; a longest-axis median where every candidate is degenerate
    (all centroids coincident).

    With ``leaf_size > 0`` the split count is snapped to the nearest
    multiple of leaf_size (ordering by centroid along the SAH axis), so
    that every leaf is full but one ragged tail per subtree."""
    c = centers[span]
    clo, chi = c.min(axis=0), c.max(axis=0)
    best = None  # (cost, axis, bin_id, bin_of)
    for axis in range(3):
        extent = chi[axis] - clo[axis]
        if extent <= 0:
            continue
        t = (c[:, axis] - clo[axis]) * (_SAH_BINS / extent)
        bin_of = np.minimum(t.astype(np.int64), _SAH_BINS - 1)
        counts = np.bincount(bin_of, minlength=_SAH_BINS)
        blo = np.full((_SAH_BINS, 3), np.inf)
        bhi = np.full((_SAH_BINS, 3), -np.inf)
        np.minimum.at(blo, bin_of, bb_min[span])
        np.maximum.at(bhi, bin_of, bb_max[span])
        # prefix (left-of-plane) and suffix (right-of-plane) sweeps
        l_lo = np.minimum.accumulate(blo, axis=0)
        l_hi = np.maximum.accumulate(bhi, axis=0)
        r_lo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        r_hi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        n_l = np.cumsum(counts)[:-1]
        n_r = len(span) - n_l

        def area(lo, hi):
            d = np.maximum(hi - lo, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        cost = n_l * area(l_lo, l_hi)[:-1] + n_r * area(r_lo, r_hi)[1:]
        cost = np.where((n_l == 0) | (n_r == 0), np.inf, cost)
        b = int(np.argmin(cost))
        if np.isfinite(cost[b]) and (best is None or cost[b] < best[0]):
            best = (float(cost[b]), axis, b, bin_of)
    if best is None:
        axis = int(np.argmax(bb_max[span].max(0) - bb_min[span].min(0)))
        order = span[np.argsort(bb_min[span, axis], kind="stable")]
        k = len(order) // 2
        if leaf_size:
            k = _snap_count(k, len(order), leaf_size)
        return order[:k], order[k:]
    _, axis, b, bin_of = best
    if not leaf_size:
        mask = bin_of <= b
        return span[mask], span[~mask]
    order = span[np.argsort(c[:, axis], kind="stable")]
    k = _snap_count(int(np.count_nonzero(bin_of <= b)), len(order), leaf_size)
    return order[:k], order[k:]


def _snap_count(k, n, leaf_size):
    """Round split count k to the nearest multiple of leaf_size in (0, n),
    halves up (as the JAX package's C++ builder, which its scenes use)."""
    k = int(k / leaf_size + 0.5) * leaf_size
    return max(leaf_size, min(k, ((n - 1) // leaf_size) * leaf_size))


def build_bvh(
    bb_min: np.ndarray,
    bb_max: np.ndarray,
    leaf_size: int = 4,
    method: str = "median",
    use_native: bool = True,
) -> FlatBVH:
    """Build a flat BVH over M primitive AABBs (``bb_min``, ``bb_max``
    (M, 3)), at most ``leaf_size`` primitives a leaf, split by ``method``:
    "median" (the reference's sort + median-count split) or "sah".

    ``use_native`` builds it with the C++ builder (compiled with g++ at
    first use; a missing compiler or a failed build raises), ``False`` with
    the Python builder below; the trees are the same bit for bit."""
    if method not in ("median", "sah"):
        raise ValueError(f"unknown BVH split method {method!r}")
    m = len(bb_min)
    if m == 0:
        raise ValueError("a BVH needs at least one primitive")
    if use_native:
        from crucible_tpu_torch import native

        return FlatBVH(**native.build_bvh(bb_min, bb_max, leaf_size, method))
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    centers = 0.5 * (bb_min + bb_max)

    node_min, node_max, node_first, node_count, node_parent = [], [], [], [], []
    perm: list[int] = []

    def emit(parent: int) -> int:
        idx = len(node_min)
        node_min.append(None)
        node_max.append(None)
        node_first.append(0)
        node_count.append(0)
        node_parent.append(parent)
        return idx

    # Explicit-stack pre-order build: pushing the right child first keeps
    # DFS emission order (left == idx + 1) without recursion.
    stack: list[tuple[np.ndarray, int]] = [(np.arange(m), -1)]
    while stack:
        span, parent = stack.pop()
        idx = emit(parent)
        lo = bb_min[span].min(axis=0)
        hi = bb_max[span].max(axis=0)
        node_min[idx] = lo
        node_max[idx] = hi
        if len(span) <= leaf_size:
            node_first[idx] = len(perm)
            node_count[idx] = len(span)
            perm.extend(span.tolist())
            continue
        if method == "sah":
            left, right = _sah_split(span, centers, bb_min, bb_max, leaf_size)
        else:
            axis = int(np.argmax(hi - lo))  # longest axis
            order = span[np.argsort(bb_min[span, axis], kind="stable")]
            mid = len(order) // 2
            left, right = order[:mid], order[mid:]
        stack.append((right, idx))
        stack.append((left, idx))

    k = len(node_min)
    parents = np.asarray(node_parent, np.int32)
    counts = np.asarray(node_count, np.int32)

    # Miss links: a node's miss target is the first node after its subtree
    # (DFS subtrees are contiguous index ranges). Leaves end at i + 1, an
    # inner node where its right (last emitted) child ends.
    subtree_end = np.zeros(k, np.int32)
    children: list[list[int]] = [[] for _ in range(k)]
    for i in range(1, k):
        children[parents[i]].append(i)
    for i in range(k - 1, -1, -1):
        if counts[i] > 0:
            subtree_end[i] = i + 1
        else:
            subtree_end[i] = subtree_end[children[i][-1]]

    return FlatBVH(
        node_min=np.stack(node_min).astype(np.float32),
        node_max=np.stack(node_max).astype(np.float32),
        node_first=np.asarray(node_first, np.int32),
        node_count=counts,
        node_miss=subtree_end.astype(np.int32),
        node_parent=parents,
        perm=np.asarray(perm, np.int32),
    )


def reorder_front_to_back(b: FlatBVH, order_dir) -> FlatBVH:
    """Re-emit the flat BVH with each inner node's children ordered
    near-first along ``order_dir`` (by the projection of the child box
    centers). The skip-link walk then meets leaves roughly front to back
    for rays along that direction (the camera's view axis), so the best t
    tightens earlier and later subtrees are culled. It fixes the leaf
    order, hence the leaf-order triangle ids that records carry."""
    d = np.asarray(order_dir, np.float64)
    k = b.num_nodes
    proj = (0.5 * (b.node_min + b.node_max) @ d).astype(np.float64)
    out_min, out_max, out_first, out_count, out_parent = [], [], [], [], []
    perm_runs = []
    perm_len = 0

    # Explicit-stack pre-order re-emission (no recursion on deep trees).
    stack: list[tuple[int, int]] = [(0, -1)]
    while stack:
        i, parent = stack.pop()
        idx = len(out_min)
        out_min.append(b.node_min[i])
        out_max.append(b.node_max[i])
        out_parent.append(parent)
        c = int(b.node_count[i])
        if c > 0:
            out_first.append(perm_len)
            out_count.append(c)
            f = int(b.node_first[i])
            perm_runs.append(b.perm[f : f + c])
            perm_len += c
            continue
        out_first.append(0)
        out_count.append(0)
        left = i + 1
        right = int(b.node_miss[left])
        first, second = (left, right) if proj[left] <= proj[right] else (right, left)
        stack.append((second, idx))
        stack.append((first, idx))

    counts = np.asarray(out_count, np.int32)
    parents = np.asarray(out_parent, np.int32)
    children: list[list[int]] = [[] for _ in range(k)]
    for i in range(1, k):
        children[parents[i]].append(i)
    subtree_end = np.zeros(k, np.int32)
    for i in range(k - 1, -1, -1):
        subtree_end[i] = i + 1 if counts[i] > 0 else subtree_end[children[i][-1]]

    return FlatBVH(
        node_min=np.stack(out_min).astype(np.float32),
        node_max=np.stack(out_max).astype(np.float32),
        node_first=np.asarray(out_first, np.int32),
        node_count=counts,
        node_miss=subtree_end,
        node_parent=parents,
        perm=np.concatenate(perm_runs).astype(np.int32),
    )


def refit_bounds(bvh: FlatBVH, prim_min: np.ndarray, prim_max: np.ndarray):
    """Node boxes recomputed bottom-up for moved primitives, the topology
    kept -> (node_min, node_max) (K, 3) float32. ``prim_min`` / ``prim_max``
    (M, 3) are in the original primitive order; ``perm`` maps leaf slots to
    them."""
    k = bvh.num_nodes
    node_min = np.full((k, 3), np.inf, np.float32)
    node_max = np.full((k, 3), -np.inf, np.float32)
    for i in range(k - 1, -1, -1):
        c = bvh.node_count[i]
        if c > 0:
            prims = bvh.perm[bvh.node_first[i]: bvh.node_first[i] + c]
            node_min[i] = prim_min[prims].min(axis=0)
            node_max[i] = prim_max[prims].max(axis=0)
        p = bvh.node_parent[i]
        if p >= 0:
            node_min[p] = np.minimum(node_min[p], node_min[i])
            node_max[p] = np.maximum(node_max[p], node_max[i])
    return node_min, node_max
