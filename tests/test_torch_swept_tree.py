"""K6's swept tree (``megakernel.swept_tables``): an SAH tree over boxes
that hold each active sphere at shutter open and close, built beside the
JAX package's clusters by ``Scene.build`` and by the bridge. Its layout
(every active row once, boxes that hold their rows over the shutter and
parents that hold their children, original ids in column 31), the wrapper's
checks of it (``swept_inputs``), its plain walk against the plain moving
brute search (``sphere_shade.moving_closest_reference``) bit for bit on
bouncing stress n1936 and n7744, ties across leaves, the moving rows the
flat loop stages, and the gradient step through it against the brute
search. The card's tests are in ``tests/test_torch_cull_card.py``."""

import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import camera as tcam
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from crucible_tpu_torch.ops.kernels import sphere_shade
from tests.torch_motion_scenes import bouncing_stress
from tests.torch_threads import one_torch_thread  # noqa: F401

SWEPT = ("sph_swept_perm", "sph_swept_nodes", "sph_swept_meta")
NO_WALK = dict(sph_perm=None, sph_cbounds=None, sph_swept_perm=None, sph_swept_nodes=None,
               sph_swept_meta=None)


@functools.cache
def _scene(copies=4, width=16):
    sc = bouncing_stress(tdemo, width, copies)
    return sc, sc.build(device="cpu"), sc.scene_cam.params(device="cpu")


def _tree(sd):
    """(perm, nodes (K, 6), meta (K, 3)) as numpy, the ungrown boxes."""
    k = sd.sph_swept_nodes.shape[0]
    meta = sd.sph_swept_meta.numpy()[: 3 * k].reshape(k, 3)
    return sd.sph_swept_perm.numpy(), sd.sph_swept_nodes.numpy()[:, 0:6], meta


def _permuted(sd):
    return tint.permute_table(tint.make_sphere_table(sd), sd.sph_swept_perm)


@pytest.mark.parametrize("copies", [4, 16])
def test_swept_tree_covers_every_active_row_once(copies):
    _, sd, _ = _scene(copies)
    perm, _, meta = _tree(sd)
    n = sd.sph_center.shape[0]
    active = np.nonzero(sd.sph_active.numpy())[0]
    assert sorted(perm.tolist()) == list(range(perm.shape[0])) and perm.shape[0] > n
    leaves = meta[meta[:, 1] > 0]
    assert (leaves[:, 1] <= tmk.SWEPT_LEAF).all()
    rows = np.concatenate([np.arange(f, f + c) for f, c, _ in leaves])
    assert sorted(perm[rows].tolist()) == active.tolist()  # each active row once


@pytest.mark.parametrize("copies", [4, 16])
def test_swept_boxes_hold_their_rows_over_the_shutter_and_parents_their_children(copies):
    _, sd, _ = _scene(copies)
    perm, nodes, meta = _tree(sd)
    c, r = sd.sph_center.numpy(), sd.sph_radius.numpy()
    cd, rd = sd.sph_center_d.numpy(), sd.sph_radius_d.numpy()
    moved = 0
    for i, (first, count, miss) in enumerate(meta):
        if count == 0:  # an inner node: its children i + 1 and miss[i + 1]
            right = meta[i + 1, 2]
            assert meta[right, 2] == miss
            for child in (i + 1, right):
                assert (nodes[i, 0:3] <= nodes[child, 0:3]).all()
                assert (nodes[i, 3:6] >= nodes[child, 3:6]).all()
            continue
        ids = perm[first:first + count]
        for w in (0.0, 0.25, 0.5, 1.0):
            cw = c[ids] + np.float32(w) * cd[ids]
            rw = np.abs(r[ids] + np.float32(w) * rd[ids])[:, None]
            assert (cw - rw >= nodes[i, 0:3]).all() and (cw + rw <= nodes[i, 3:6]).all()
        moved += int((cd[ids] != 0).any())
    assert moved > 0  # the boxes are swept, not the spheres at one time


def test_column_31_carries_the_original_ids():
    _, sd, _ = _scene()
    table = _permuted(sd)
    perm = sd.sph_swept_perm.long()
    n = sd.sph_center.shape[0]
    real = perm < n
    assert torch.equal(table[real, 31].long(), perm[real])
    assert torch.equal(table[real][:, 0:3], sd.sph_center[perm[real]])


def _rays(sd, cp, width, height, moving_camera):
    """The primary rays of every pixel (one sample) and second-bounce rays
    from their hits in random upward directions (numpy seed 3), with their
    shutter fractions."""
    cp = cp if moving_camera else replace(cp, animated=False)
    p = width * height
    o, d, w = tcam.generate_rays(cp, width, height, torch.arange(p), torch.zeros(p,
                                 dtype=torch.int64), 5)
    t, _ = sphere_shade.moving_closest_reference(o, d, w, tint.make_sphere_table(sd))
    hit = t < tmk.BIG
    rng = np.random.default_rng(3)
    up = torch.from_numpy(rng.normal(size=(int(hit.sum()), 3)).astype(np.float32))
    up[:, 1] = up[:, 1].abs()
    o2 = o[hit] + t[hit, None] * d[hit]
    return torch.cat([o, o2]), torch.cat([d, up]), torch.cat([w, w[hit]])


@pytest.mark.parametrize("moving_camera", [False, True], ids=["camera", "moving_camera"])
@pytest.mark.parametrize("copies", [4, 16])
def test_plain_walk_is_the_moving_brute_search(copies, moving_camera):
    """(t, original id) of the plain K6 walk over the swept tree equal the
    moving brute search's on the original table, bit for bit; the walk
    tests far fewer rows than a 256-row cluster a search."""
    _, sd, cp = _scene(copies)
    o, d, w = _rays(sd, cp, 16, 9, moving_camera)
    table = tint.make_sphere_table(sd)
    want_t, want_id = sphere_shade.moving_closest_reference(o, d, w, table)
    permuted = _permuted(sd)
    nodes, meta = tmk.swept_inputs(sd.sph_swept_nodes, sd.sph_swept_meta, permuted)
    tmk.CULL_COUNTS.update(nodes=0, rows=0, roots=0)
    t, idx, hit = tmk.cull_closest_reference(o, d, permuted, nodes, meta, w=w)
    assert torch.equal(t, want_t) and torch.equal(hit, want_t < tmk.BIG)
    assert torch.equal(permuted[idx, 31].long()[hit], want_id[hit])
    assert hit.float().mean() > 0.5
    assert tmk.CULL_COUNTS["rows"] < tmk.CLUSTER * o.shape[0]


def chain_tree(sd, leaf=8):
    """The scene's active rows in the swept tree's order as a chain: leaf j
    holds rows [leaf j, leaf (j + 1)), inner node j's children are leaf j
    and the rest -> (perm, snodes, smeta) in swept_tables' layout, as deep
    as it has leaves less one (deeper than ``TREE_STACK``, K6's stack)."""
    perm = sd.sph_swept_perm.cpu().numpy()
    c, r = sd.sph_center.cpu().numpy().astype(np.float64), sd.sph_radius.cpu().numpy()
    cd, rd = sd.sph_center_d.cpu().numpy(), sd.sph_radius_d.cpu().numpy()
    r = np.abs(r.astype(np.float64))[:, None]
    r1 = np.abs(r[:, 0] + rd)[:, None]
    lo = np.minimum(c - r, c + cd - r1).astype(np.float32)
    hi = np.maximum(c + r, c + cd + r1).astype(np.float32)
    n_act = int(sd.sph_active.sum())
    n_leaves = -(-n_act // leaf)
    k = 2 * n_leaves - 1
    snodes = np.zeros((k, 16), np.float32)
    meta = np.zeros((k, 3), np.int32)
    box_lo, box_hi = np.full(3, np.inf, np.float32), np.full(3, -np.inf, np.float32)
    for j in reversed(range(n_leaves)):
        rows = perm[j * leaf:min((j + 1) * leaf, n_act)]
        at = 2 * j if j == n_leaves - 1 else 2 * j + 1
        snodes[at, 0:3], snodes[at, 3:6] = lo[rows].min(0), hi[rows].max(0)
        meta[at] = (j * leaf, len(rows), k if j == n_leaves - 1 else 2 * j + 2)
        box_lo, box_hi = np.minimum(box_lo, snodes[at, 0:3]), np.maximum(box_hi, snodes[at, 3:6])
        if j < n_leaves - 1:  # inner node j: leaf j and the chain after it
            snodes[2 * j, 0:3], snodes[2 * j, 3:6] = box_lo, box_hi
            meta[2 * j] = (0, 0, k)
    guard = np.tile(np.asarray([0, 0, k], np.int32), tmk.NODE_WIN)
    return perm, snodes, np.concatenate([meta.reshape(-1), guard])


def test_tree_depth_picks_the_walk_order():
    """The swept trees of n1936 and n7744 are at most TREE_STACK deep, so K6
    walks them nearer child first; a deeper tree (a chain) is refused. The
    near-first plain walk gives the brute search's bits, and tests fewer
    rows than a walk that did not prune by its best hit would: every row of
    every leaf its ray enters."""
    _, sd, cp = _scene()
    for copies in (4, 16):
        meta = _scene(copies)[1].sph_swept_meta
        k = _scene(copies)[1].sph_swept_nodes.shape[0]
        depth = tmk.tree_depth(meta[: 3 * k].reshape(k, 3))
        assert 8 <= depth <= tmk.TREE_STACK
    table = _permuted(sd)
    perm, snodes, smeta = chain_tree(sd)
    k = snodes.shape[0]
    chain_meta = torch.from_numpy(smeta[: 3 * k].reshape(k, 3))
    assert tmk.tree_depth(chain_meta) == (k - 1) // 2 > tmk.TREE_STACK
    with pytest.raises(ValueError, match="deeper than K6's stack"):
        tmk.swept_inputs(torch.from_numpy(snodes), torch.from_numpy(smeta), table)
    o, d, w = _rays(sd, cp, 16, 9, True)
    want_t, want_id = sphere_shade.moving_closest_reference(o, d, w, tint.make_sphere_table(sd))
    nodes, meta = tmk.swept_inputs(sd.sph_swept_nodes, sd.sph_swept_meta, table)
    counts = dict(nodes=0, rows=0, roots=0)
    t, idx, hit = tmk.cull_closest_reference(o, d, table, nodes, meta, w=w, counts=counts)
    assert torch.equal(t, want_t) and torch.equal(table[idx, 31].long()[hit], want_id[hit])
    leaves = meta[:, 1] > 0
    b = nodes[leaves][None]
    pr = tmk.SLAB_EPS * o.abs().amax(dim=1)[:, None]
    inv = [tmk._safe_inv(d[:, j])[:, None] for j in range(3)]
    planes = [((b[..., j + 3 * hi] + (pr if hi else -pr)) - o[:, j, None]) * inv[j]
              for j in range(3) for hi in (0, 1)]
    entered, _ = tmk._slab(*planes, tmk.T_MIN, torch.full_like(pr, tmk.BIG))
    unpruned = int((entered * meta[leaves, 1][None]).sum())
    assert counts["rows"] < unpruned


def test_swept_tables_cap_the_depth_at_the_stack(monkeypatch):
    """Where the SAH tree is deeper than K6's stack, swept_tables builds the
    tree with median splits: 64 spheres at x = 2^i peel off a leaf a level
    under SAH (7 deep), and the median tree is 3 deep. Either holds every
    row over the shutter."""
    n = 64
    center = np.zeros((n, 3), np.float32)
    center[:, 0] = 2.0 ** np.arange(n)
    radius = np.full(n, 0.25, np.float32)
    center_d = np.zeros((n, 3), np.float32)
    center_d[:, 1] = 0.5
    args = (center, radius, np.ones(n, bool), center_d, np.zeros(n, np.float32))

    def depth(tables):
        k = tables[1].shape[0]
        return tmk.tree_depth(torch.from_numpy(tables[2][: 3 * k].reshape(k, 3)))

    assert depth(tmk.swept_tables(*args)) == 7
    monkeypatch.setattr(tmk, "TREE_STACK", 4)
    perm, snodes, smeta = tmk.swept_tables(*args)
    assert depth((perm, snodes, smeta)) == 3
    table = torch.zeros((perm.shape[0], tmk.C_IN))
    table[:n, 0:3] = torch.from_numpy(center)
    table[:n, 3] = torch.from_numpy(radius)
    table[:n, 5] = 1.0
    table[:n, 24:27] = torch.from_numpy(center_d)
    table = table[torch.from_numpy(perm).long()]
    tmk.swept_inputs(torch.from_numpy(snodes), torch.from_numpy(smeta), table)


@pytest.mark.parametrize("order", [(1, 0), (0, 1)], ids=["higher_first", "lower_first"])
def test_a_tie_goes_to_the_lower_original_id_across_leaves(order):
    """Two coincident emitters, each in a leaf of its own, in either leaf
    order: every hit takes original id 0, at w = 0 and at w = 1."""
    table = torch.zeros((tmk.CLUSTER, tmk.C_IN))
    table[:2, 3] = 1.0  # radius
    table[:2, 4] = -1.0  # |c|^2 - r^2
    table[:2, 5] = 1.0  # active
    table[:2, 25] = 0.5  # center delta y
    table[:2, 29] = 0.25  # s2 = |cd|^2 - rd^2
    table[:, 31] = torch.arange(tmk.CLUSTER, dtype=torch.float32)
    table[0, 31], table[1, 31] = map(float, order)
    box = [-1.0, -1.0, -1.0, 1.0, 1.5, 1.0]
    snodes = torch.zeros((3, 16))
    snodes[:, 0:6] = torch.tensor(box)
    smeta = torch.tensor([0, 0, 3, 0, 1, 2, 1, 1, 3] + [0, 0, 3] * tmk.NODE_WIN,
                         dtype=torch.int32)
    nodes, meta = tmk.swept_inputs(snodes, smeta, table)
    o = torch.tensor([[0.0, 0.0, 3.0], [0.2, 0.1, -3.0], [5.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    for wv in (0.0, 1.0):
        t, idx, hit = tmk.cull_closest_reference(o, d, table, nodes, meta,
                                                 w=torch.full((3,), wv))
        assert hit.tolist() == [True, True, False]
        assert table[idx[:2], 31].tolist() == [0.0, 0.0] and t[2].item() == tmk.BIG


def _spoiled(change):
    _, sd, _ = _scene()
    table = _permuted(sd)
    nodes, meta = sd.sph_swept_nodes.clone(), sd.sph_swept_meta.clone()
    k = nodes.shape[0]
    m = meta[: 3 * k].reshape(k, 3)
    leaf = int(torch.nonzero(m[:, 1] > 0)[0])
    if change == "wrong_boxes":
        nodes[leaf, 0:3] = nodes[leaf, 3:6]
    elif change == "missing_row":
        m[leaf, 1] -= 1
    elif change == "inactive_row":
        table[int(m[leaf, 0]), 5] = 0.0
    elif change == "parent_box":
        nodes[0, 3:6] = nodes[0, 0:3] + 1.0
    elif change == "nodes_dtype":
        nodes = nodes.double()
    return nodes, meta, table


@pytest.mark.parametrize("change", ["wrong_boxes", "missing_row", "inactive_row",
                                    "parent_box", "nodes_dtype"])
def test_swept_inputs_refuse_a_tree_of_other_spheres(change):
    nodes, meta, table = _spoiled(change)
    with pytest.raises((ValueError, TypeError)):
        tmk.swept_inputs(nodes, meta, table)


def test_swept_inputs_need_both_tables():
    _, sd, _ = _scene()
    with pytest.raises(ValueError, match="both"):
        tmk.swept_inputs(sd.sph_swept_nodes, None, _permuted(sd))


def test_moving_rows_carry_the_motion_columns():
    """The flat loop's moving row entries: (center, |c|^2 - r^2), (center
    delta, s1), (s2, original id, 0, 0), the active rows first."""
    _, sd, _ = _scene()
    table = tint.make_sphere_table(sd)
    table[3, 5] = 0.0
    rows, ids, live = tmk.brute_rows(table, animated=True)
    n = table.shape[0]
    assert rows.shape == (n, 12) and live.tolist() == [n - 1] and 3 not in ids[: n - 1].tolist()
    t = table[ids.long()]
    cols = [0, 1, 2, 4, 24, 25, 26, 28, 29, 31]
    assert torch.equal(rows[:, :10], t[:, cols]) and not rows[:, 10:].any()


def test_bridge_builds_the_tree_that_scene_build_builds():
    """A JAX-lowered animated scene carries the clusters and no swept tree;
    the bridge builds the tree from its spheres and shutter deltas, and it
    is Scene.build's, bit for bit."""
    from crucible_tpu_torch import bridge

    _, sd, _ = _scene()
    arrays, static = bridge.scene_data_to_arrays(sd)
    jax_like = {k: v for k, v in arrays.items() if k not in bridge.SWEPT_ARRAYS}
    assert all(k not in bridge.OPTIONAL_ARRAYS for k in SWEPT)
    got = bridge.scene_data_from_arrays(jax_like, device="cpu", **static)
    for k in SWEPT:
        assert torch.equal(getattr(got, k), getattr(sd, k)), k
    # A static scene's tree (K5's) crosses as it is, and a scene with
    # neither walk's tables has none.
    static_sd = tdemo.sphere_stress(width=16, copies=4).build(device="cpu")
    arrays, static = bridge.scene_data_to_arrays(static_sd)
    back = bridge.scene_data_from_arrays(arrays, device="cpu", **static)
    assert all(torch.equal(getattr(back, k), getattr(static_sd, k)) for k in SWEPT)
    small = tdemo.book1_end_scene(width=16).build(device="cpu")
    arrays, static = bridge.scene_data_to_arrays(small)
    back = bridge.scene_data_from_arrays(arrays, device="cpu", **static)
    assert all(getattr(back, k) is None for k in SWEPT)


def test_scene_build_and_the_route_need_the_tree_beside_the_clusters():
    _, sd, cp = _scene()
    assert all(getattr(sd, k) is not None for k in SWEPT)
    assert tint.swept_tree(sd)[1] is sd.sph_swept_nodes
    assert tint.swept_tree(replace(sd, sph_cbounds=None)) is None
    with pytest.raises(ValueError, match="swept tree"):
        tint.swept_tree(replace(sd, sph_swept_nodes=None))


def test_loss_and_grad_through_the_tree_equals_the_brute_search():
    """The gradient step's record pass walks the swept tree (K6's plain
    version) and gives the loss and gradients of the brute search (K8's
    plain version) on the same scene without its walk tables."""
    _, sd, cp = _scene()
    w, h = 16, 9
    kw = dict(width=w, height=h, spp=2, max_depth=4)
    args = (torch.zeros((w * h, 3)), torch.arange(w * h), 3)
    params = G.extract_params(sd, cp)
    tmk.CULL_COUNTS.update(nodes=0, rows=0, roots=0)
    loss, grads = G.loss_and_grad(params, sd, cp, *args, **kw)
    assert tmk.CULL_COUNTS["nodes"] > 0
    brute = replace(sd, **NO_WALK)
    tmk.CULL_COUNTS.update(nodes=0, rows=0, roots=0)
    b_loss, b_grads = G.loss_and_grad(G.extract_params(brute, cp), brute, cp, *args, **kw)
    assert tmk.CULL_COUNTS["nodes"] == 0
    assert torch.isfinite(loss) and torch.equal(loss, b_loss)
    for key in G.TENSOR_KEYS:
        assert torch.equal(grads[key], b_grads[key]), key
