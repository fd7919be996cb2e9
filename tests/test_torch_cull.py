"""Animated big scenes (K6, what the megakernel's chunk-cull branch
computes): the port's cluster tables against the JAX package's, bit for
bit; the plain walk of K6's swept tree against the plain brute searches
(K8's moving one, K1's static one), bit for bit, in the forward and record
modes; the port against the JAX package's chunk-cull kernel (Pallas in
interpret mode) on bouncing stress (``tests/torch_motion_scenes.py``), its
image, records and gradient; and the routing of animated big scenes. The
swept tree's own tests are in ``tests/test_torch_swept_tree.py``, the
card's in ``tests/test_torch_cull_card.py``."""

import functools
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import render as jrender
from crucible_tpu.models import replay as jrep
from crucible_tpu.ops.pallas import megakernel as jmk
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.test_torch_scene import bridged
from tests.torch_motion_scenes import bouncing_stress
from tests.torch_threads import one_torch_thread  # noqa: F401

CULL = ("sph_perm", "sph_cbounds")
BVH = ("sph_perm", "sph_nodes", "sph_meta")
FLAGS = {"spheres": dict(animated=True, cam_animated=False),
         "both": dict(animated=True, cam_animated=True)}


@functools.cache
def _jax_scene(width=24, copies=4):
    return bouncing_stress(jdemo, width, copies)


@functools.cache
def _port_scene(width=24, copies=4):
    sc = bouncing_stress(tdemo, width, copies)
    return sc, sc.build(device="cpu"), sc.scene_cam.params(device="cpu")


def _clear(counts):
    counts.update(dict.fromkeys(counts, 0))


# --- the cluster tables --------------------------------------------------------------


def _book1_arrays():
    sd = jdemo.book1_end_scene(width=24).build()
    return (np.asarray(sd.sph_center), np.asarray(sd.sph_radius),
            np.asarray(sd.sph_active)), {}


def _bouncing_arrays():
    sd = _jax_scene().build()
    return (np.asarray(sd.sph_center), np.asarray(sd.sph_radius),
            np.asarray(sd.sph_active)), dict(center_d=np.asarray(sd.sph_center_d),
                                             radius_d=np.asarray(sd.sph_radius_d))


def _hidden_arrays():
    """Bouncing stress with all but 700 rows hidden: clusters 3-7 of 8 are
    empty and cluster 2 holds inactive rows after its active ones."""
    (c, r, active), deltas = _bouncing_arrays()
    active = active.copy()
    active[np.nonzero(active)[0][700:]] = False
    return (c, r, active), deltas


@pytest.mark.parametrize("make,k", [(_book1_arrays, 2), (_bouncing_arrays, 8),
                                    (_hidden_arrays, 8)],
                         ids=["book1", "bouncing_stress", "hidden"])
def test_cluster_spheres_matches_jax(make, k):
    arrays, deltas = make()
    got = tmk.cluster_spheres(*arrays, **deltas)
    want = jmk.cluster_spheres(*arrays, **deltas)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    perm, bounds = got
    n_pad = k * tmk.CLUSTER
    assert perm.shape == (n_pad,) and sorted(perm.tolist()) == list(range(n_pad))
    assert bounds.shape == (k, 8)
    n_act = int(arrays[2].sum())
    empty = (bounds[:, 0:6] == tmk._FAR).all(axis=1)
    assert empty.sum() == k - -(-n_act // tmk.CLUSTER)


def test_cluster_boxes_hold_the_spheres_over_the_shutter():
    (c, r, active), deltas = _bouncing_arrays()
    perm, bounds = tmk.cluster_spheres(c, r, active, **deltas)
    for ci in range(bounds.shape[0]):
        rows = perm[ci * tmk.CLUSTER:(ci + 1) * tmk.CLUSTER]
        rows = rows[rows < c.shape[0]]
        rows = rows[active[rows]]
        for w in (0.0, 0.5, 1.0):
            cw = c[rows] + w * deltas["center_d"][rows]
            rw = np.abs(r[rows] + w * deltas["radius_d"][rows])[:, None]
            assert (cw - rw >= bounds[ci, 0:3]).all() and (cw + rw <= bounds[ci, 3:6]).all()


def test_scene_build_matches_jax():
    jsd = _jax_scene().build()
    _, sd, cp = _port_scene()
    assert sd.animated and cp.animated and sd.sph_center.shape == (1936, 3)
    assert int((sd.sph_center_d != 0).any(dim=1).sum()) == 1558
    arrays, _ = bridge.scene_data_to_arrays(sd)
    for k in bridge.SCENE_ARRAYS[:-1] + ("sph_center_d", "sph_radius_d") + CULL:
        np.testing.assert_array_equal(arrays[k], np.asarray(getattr(jsd, k)), err_msg=k)
    assert sd.sph_perm.shape == (2048,) and sd.sph_cbounds.shape == (8, 8)
    assert sd.sph_nodes is None and jsd.sph_nodes is None
    # A static n1936 keeps the sphere-BVH tables, in both packages.
    static = tdemo.sphere_stress(width=24, copies=4).build(device="cpu")
    jstatic = jdemo.sphere_stress(width=24, copies=4).build()
    assert static.sph_cbounds is None and jstatic.sph_cbounds is None
    assert all(getattr(static, k) is not None for k in BVH)


def test_bridge_carries_the_cluster_tables_both_ways():
    sd, cp = bridged(_jax_scene())
    jsd = _jax_scene().build()
    assert sd.animated and cp.animated
    for k in CULL:
        np.testing.assert_array_equal(getattr(sd, k).numpy(), np.asarray(getattr(jsd, k)))
    arrays, static = bridge.scene_data_to_arrays(sd)
    back = bridge.scene_data_from_arrays(arrays, device="cpu", **static)
    assert all(torch.equal(getattr(back, k), getattr(sd, k)) for k in CULL)
    assert back.sph_nodes is None


# --- K6's inputs ------------------------------------------------------------------


def _cull_args(sd, cp, spp=1, depth=2):
    """(brute inputs on the original table for bouncing stress at 24 x 13,
    the same with the table in the swept tree's order and the tree)."""
    inputs, _ = tint.mega_inputs(sd, cp, 24, 13, spp, depth, 0)
    cull = dict(inputs, table=tint.permute_table(inputs["table"], sd.sph_swept_perm),
                swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
    return inputs, cull


def test_cull_ties_go_to_the_lowest_original_row():
    """Two coincident emitters in one leaf, the higher id first: every hit
    takes the lower original id, as the brute search does, at w = 0 and at
    w = 1 (where the spheres have moved together)."""
    table = torch.zeros((tmk.CLUSTER, tmk.C_IN))
    table[:2, 3] = 1.0  # radius
    table[:2, 4] = -1.0  # |c|^2 - r^2
    table[:2, 5] = 1.0  # active
    table[:2, 25] = 0.5  # center delta y
    table[:2, 28] = 0.0  # s1 = c.cd - r rd
    table[:2, 29] = 0.25  # s2 = |cd|^2 - rd^2
    table[:, 31] = torch.arange(tmk.CLUSTER, dtype=torch.float32)
    table[0, 31], table[1, 31] = 1.0, 0.0  # row 0 holds original id 1
    snodes = torch.zeros((1, 16))
    snodes[0, :6] = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.5, 1.0])
    smeta = torch.tensor([0, 2, 1] + [0, 0, 1] * tmk.NODE_WIN, dtype=torch.int32)
    nodes, meta = tmk.swept_inputs(snodes, smeta, table)
    o = torch.tensor([[0.0, 0.0, 3.0], [0.2, 0.1, -3.0], [5.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    for wv in (0.0, 1.0):
        t, idx, hit = tmk.cull_closest_reference(o, d, table, nodes, meta,
                                                 w=torch.full((3,), wv))
        assert hit.tolist() == [True, True, False]
        assert idx.tolist() == [1, 1, 0] and t[2].item() == tmk.BIG


# --- plain K6 against the plain brute searches -----------------------------------------


@pytest.mark.parametrize("flags", FLAGS.values(), ids=FLAGS.keys())
def test_plain_cull_forward_equals_the_moving_brute_search(flags):
    _, sd, cp = _port_scene()
    brute, cull = _cull_args(sd, cp, spp=2, depth=4)
    _clear(tmk.CULL_COUNTS)
    got = tmk.run_megakernel(**cull, **flags)
    assert tmk.CULL_COUNTS["nodes"] > 0
    assert torch.isfinite(got).all() and got.abs().sum() > 0
    assert torch.equal(got, tmk.run_megakernel(**brute, **flags))


@pytest.mark.parametrize("flags", FLAGS.values(), ids=FLAGS.keys())
def test_plain_cull_records_equal_the_moving_brute_search(flags):
    _, sd, cp = _port_scene()
    brute, cull = _cull_args(sd, cp)
    p = brute["pix"].shape[1]
    for x in (brute, cull):  # two samples a pixel, sample-major
        x["pix"] = x["pix"].repeat(1, 2)
        x["sample0"] = torch.cat([torch.zeros((1, p), dtype=torch.int32),
                                  torch.ones((1, p), dtype=torch.int32)], dim=1)
    acc, rec = tmk.run_megakernel_record(**cull, max_depth=6, radiance=True, **flags)
    b_acc, b_rec = tmk.run_megakernel_record(**brute, max_depth=6, radiance=True, **flags)
    assert torch.equal(rec, b_rec) and torch.equal(acc, b_acc)
    assert torch.equal(tmk.run_megakernel_record(**cull, max_depth=6, **flags)[1], rec)
    # Winners span the tiles: ids past book1's own 488 rows occur.
    assert int(trep.rec_winner_id(rec).max()) >= 488


def test_static_cluster_walk_equals_plain_k1():
    """The same walk over a static table's tree (no deltas) is a pure skip
    over K1's search: book1's swept tree gives K1's sums."""
    sc = tdemo.book1_end_scene(width=24)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    zero = np.zeros_like(sd.sph_center.numpy())
    perm, snodes, smeta = tmk.swept_tables(sd.sph_center.numpy(), sd.sph_radius.numpy(),
                                           sd.sph_active.numpy(), zero, zero[:, 0])
    inputs, _ = tint.mega_inputs(sd, cp, 24, 13, 2, 6, 0)
    cull = dict(inputs, table=tint.permute_table(inputs["table"], torch.from_numpy(perm)),
                swept_nodes=torch.from_numpy(snodes), swept_meta=torch.from_numpy(smeta))
    assert torch.equal(tmk.run_megakernel(**cull, animated=False),
                       tmk.run_megakernel(**inputs, animated=False))


def test_cull_refuses_what_is_not_instantiated():
    """A moving table on a static table's tree (K5's, whose boxes hold the
    spheres at one time) is refused. A mesh beside a tree walk, refused
    until ROADMAP A11, runs: K6's walk then K7 moving's stage, in both
    modes, gives the brute search's sums and words."""
    _, sd, cp = _port_scene()
    brute, cull = _cull_args(sd, cp)
    static = tdemo.sphere_stress(width=24, copies=4).build(device="cpu")
    k5_tree = dict(cull, table=tint.permute_table(tint.make_sphere_table(sd),
                                                  static.sph_swept_perm),
                   swept_nodes=static.sph_swept_nodes, swept_meta=static.sph_swept_meta)
    with pytest.raises(ValueError, match="over the shutter"):
        tmk.run_megakernel(**k5_tree, animated=True)
    tri = dict(tri_nodes=torch.zeros((1, 6)), tri_meta=torch.tensor([[0, 1, 1]], dtype=torch.int32),
               tris=torch.zeros((1, 32)), mats=torch.zeros((1, 24)))
    assert torch.equal(tmk.run_megakernel(**cull, **tri, animated=True),
                       tmk.run_megakernel(**brute, **tri, animated=True))
    got = tmk.run_megakernel_record(**cull, **tri, max_depth=2, animated=True)
    want = tmk.run_megakernel_record(**brute, **tri, max_depth=2, animated=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("mode,flags", [
    ("forward", dict(animated=False, cam_animated=True)),
    ("record", dict(animated=False, cam_animated=False)),
    ("record", dict(animated=False, cam_animated=True)),
], ids=["forward-camera", "record-static", "record-camera"])
def test_cull_refuses_a_static_table_but_in_forward_with_a_static_camera(mode, flags):
    """The tree walk without ``animated`` is K5, instantiated in both modes
    with either camera: these launches, once refused, run, and the wrapper
    and its plain version give the static brute search's sums and words
    over the original table (a moving table's tree holds its spheres at
    shutter open too)."""
    _, sd, cp = _port_scene()
    brute, cull = _cull_args(sd, cp)
    if mode == "forward":
        want = tmk.run_megakernel(**brute, **flags)
        got = (tmk.run_megakernel(**cull, **flags), tmk.run_megakernel_reference(**cull, **flags))
    else:
        want = tmk.run_megakernel_record(**brute, max_depth=2, **flags)[1]
        got = (tmk.run_megakernel_record(**cull, max_depth=2, **flags)[1],
               tmk.run_megakernel_record_reference(**cull, max_depth=2, **flags)[1])
    for x in got:
        assert torch.equal(x, want)


# --- against the JAX package's chunk-cull kernel -------------------------------------


@functools.cache
def _forward(seed=0):
    """(port image, port brute image, JAX chunk-cull image) of bouncing
    stress n1936, 24 wide, 2 spp, depth 4."""
    js = _jax_scene()
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    want = np.asarray(jrender.render_image_persistent(
        js.build(), js.scene_cam.params(), w, h, 2, 4, seed, schedule="mega", cull=True))
    _, sd, cp = _port_scene()
    _clear(tmk.CULL_COUNTS)
    got = trender.render_image_persistent(sd, cp, w, h, 2, 4, seed, device="cpu")
    assert tmk.CULL_COUNTS["nodes"] > 0  # auto took the swept-tree walk
    brute = trender.render_image_persistent(sd, cp, w, h, 2, 4, seed, device="cpu",
                                            cull=False)
    return got, brute, want


def test_cull_render_equals_brute_bit_for_bit():
    got, brute, _ = _forward()
    assert got.shape == (13, 24, 3) and torch.isfinite(got).all()
    assert torch.equal(got, brute)


def test_cull_render_matches_jax():
    got, _, want = _forward()
    got = got.numpy()
    # Fault C6's statistical bounds (tests/test_torch_render.py).
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(got.mean() - want.mean()) <= 2e-3


@functools.cache
def _records(depth=4, seed=7):
    """The port's fused records (plain K6) and the JAX package's chunk-cull
    record kernel's (interpret mode) on every pixel of bouncing stress
    n1936, 24 wide, 2 spp."""
    js = _jax_scene()
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    p = w * h
    pix, smp = np.tile(np.arange(p), 2), np.repeat(np.arange(2), p)
    jsd = js.build()
    assert jsd.sph_cbounds is not None
    jrec, jrad = jrep.trace_record_mega(
        jsd, js.scene_cam.params(), w, h, jnp.asarray(pix, jnp.uint32),
        jnp.asarray(smp, jnp.uint32), jnp.uint32(seed), depth, interpret=True, radiance=True,
    )
    sd, cp = bridged(js)
    rec, rad = trep.trace_record_mega(sd, cp, w, h, torch.from_numpy(pix),
                                      torch.from_numpy(smp), seed, depth, radiance=True)
    return (rec.numpy(), rad.numpy()), (np.asarray(jrec), np.asarray(jrad))


def test_cull_records_match_jax():
    (rec, rad), (jrec, jrad) = _records()
    assert (rec == jrec).all(axis=0).mean() > 0.97
    assert np.isclose(rad, jrad, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(rad.mean() - jrad.mean()) <= 2e-3


@pytest.mark.parametrize("seed", range(4))
def test_loss_and_grad_matches_jax_on_bouncing_stress(seed):
    """The JAX package records through its chunk-cull record kernel
    (interpret mode), as its ``loss_and_grad`` does on an accelerator; on
    those records both packages' replays give the loss within rel 2e-3 and
    the radiometric gradients within normalized 5e-3. The port's own step
    (its records from the plain cluster walk) equals its brute search's bit
    for bit, and its records equal the JAX package's on > 0.97 of the
    lanes: at 24 x 13 pixels the 5-9 lanes that decide otherwise (fault C6)
    move the loss by rel 8.9e-4 to 3.0e-3, so the bounds are held on the
    shared records."""
    js = _jax_scene()
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    jsd, jcp = js.build(), js.scene_cam.params()
    kw = dict(width=w, height=h, spp=2, max_depth=4)
    p = w * h
    jrec = jrep.trace_record_mega(
        jsd, jcp, w, h, jnp.tile(jnp.arange(p, dtype=jnp.int32), 2),
        jnp.repeat(jnp.arange(2, dtype=jnp.int32), p), jnp.uint32(seed), 4, interpret=True)
    jl, jg = JG.loss_and_grad(
        JG.extract_params(jsd, jcp), jsd, jcp, jnp.zeros((p, 3)),
        jnp.arange(p, dtype=jnp.uint32), jnp.uint32(seed), rec=jrec, **kw,
    )
    _, sd, cp = _port_scene()
    params = bridge.params_from_arrays(
        {k: np.asarray(v) for k, v in JG.extract_params(jsd, jcp).items()
         if k in G.TENSOR_KEYS}, device="cpu")
    args = (torch.zeros((p, 3)), torch.arange(p), seed)
    tl, tg = G.loss_and_grad(params, sd, cp, *args, rec=torch.from_numpy(np.array(jrec)),
                             **kw)
    assert abs(float(tl) - float(jl)) <= 2e-3 * abs(float(jl)), (float(tl), float(jl))
    for key in ("mat_emission", "tex_color"):  # the radiometric leaves (fault C4)
        want = np.asarray(jg[key])
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(tg[key].numpy() / scale, want / scale, rtol=0, atol=5e-3,
                                   err_msg=key)
    _clear(tmk.CULL_COUNTS)
    own_l, own_g = G.loss_and_grad(params, sd, cp, *args, **kw)
    assert tmk.CULL_COUNTS["nodes"] > 0  # the record pass walked the clusters
    brute_l, brute_g = G.loss_and_grad(params, replace(sd, sph_perm=None, sph_cbounds=None),
                                       cp, *args, **kw)
    assert torch.equal(own_l, brute_l)
    for key in ("mat_emission", "tex_color"):
        assert torch.equal(own_g[key], brute_g[key])
    own_rec = G.record_decisions(sd, cp, torch.arange(p), seed, **kw)
    assert (own_rec.numpy() == np.asarray(jrec)).all(axis=0).mean() > 0.97


# --- routing ------------------------------------------------------------------------


def test_auto_routes_bouncing_stress_to_the_cluster_walk(monkeypatch):
    """K6 walks the swept tree that Scene.build makes beside the clusters."""
    seen = []
    real = tmk.run_megakernel

    def spy(*args, **kwargs):
        seen.append((kwargs.get("swept_nodes"), kwargs.get("sph_nodes")))
        return real(*args, **kwargs)

    monkeypatch.setattr(tmk, "run_megakernel", spy)
    sc, sd, cp = _port_scene(16)
    assert tint.megakernel_supported(sd, cp)
    assert tint.megakernel_record_supported(sd, cp)
    img = trender.render_image(sc, samples=1, max_depth=2, device="cpu")
    assert img.shape == (9, 16, 3) and torch.isfinite(img).all()
    assert len(seen) == 1 and seen[0][0] is sc.build(device="cpu").sph_swept_nodes
    assert seen[0][1] is None


def _fan_beside_bouncing_stress(width=16):
    """bouncing stress n1936 with the fan's 80 triangles
    (tests/torch_mesh_scenes.py) beside its glass sphere, each moving by 0.5
    along x over frame 0's shutter: a moving BVH mesh beside a moving table
    that K8's brute search holds."""
    from crucible_tpu_torch.models import scene as tscene
    from tests.torch_mesh_scenes import add_fan

    sc = add_fan(tscene, bouncing_stress(tdemo, width, 4))
    for i in range(80):
        sc.translate_x(0.5, 1.0 / 48.0, "lerp", "world", f"tri{i}")
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    assert sd.animated and sd.use_bvh and sd.num_tris == 80 and sd.sph_cbounds is not None
    return sc, sd, cp


def test_mesh_beside_a_moving_table_renders_through_the_brute_search():
    """A moving mesh beside a moving table above CULL_MIN_ROWS takes K6's
    swept-tree walk and then K7 moving's stage (ROADMAP A11; until then
    K8's brute search took such a table beside a mesh), and its image is
    the brute search's bit for bit (cull=False, or the scene stripped of
    its cluster tables); a table grown past the brute search's rows is
    taken as well, by the walk."""
    sc, sd, cp = _fan_beside_bouncing_stress()
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    assert tint.megakernel_supported(sd, cp)
    _clear(tmk.CULL_COUNTS)
    img = trender.render_image_persistent(sd, cp, w, h, 1, 3, 0, device="cpu")
    assert tmk.CULL_COUNTS["nodes"] > 0 and torch.isfinite(img).all()
    brute = replace(sd, sph_perm=None, sph_cbounds=None)
    assert torch.equal(img, trender.render_image_persistent(brute, cp, w, h, 1, 3, 0,
                                                            device="cpu", cull=False))
    assert torch.equal(img, trender.render_image_persistent(sd, cp, w, h, 1, 3, 0,
                                                            device="cpu", cull=False))
    assert torch.equal(img, trender.render_image_persistent(sd, cp, w, h, 1, 3, 0,
                                                            device="cpu", cull=True))
    big = replace(sd, sph_center=torch.zeros((tmk.MAX_ROWS_ANIMATED + 1, 3)))
    assert tint.megakernel_unsupported_reason(big, cp) is None
    assert tint.megakernel_record_unsupported_reason(big, cp) is None


def test_mesh_beside_a_moving_table_records_and_differentiates():
    """The record pass of the same scene walks K6's swept tree, then K7
    moving's stage, and records the brute search's words; the gradient step
    runs on them and equals the brute search's."""
    sc, sd, cp = _fan_beside_bouncing_stress()
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    assert tint.megakernel_record_supported(sd, cp)
    brute = replace(sd, sph_perm=None, sph_cbounds=None)
    kw = dict(width=w, height=h, spp=2, max_depth=3)
    pix = torch.arange(w * h)
    _clear(tmk.CULL_COUNTS)
    rec = G.record_decisions(sd, cp, pix, 0, **kw)
    assert tmk.CULL_COUNTS["nodes"] > 0 and ((rec & tmk.F_TRI) > 0).any()
    assert torch.equal(rec, G.record_decisions(brute, cp, pix, 0, **kw))
    args = (torch.zeros((w * h, 3)), pix, 0)
    loss, g = G.loss_and_grad(G.extract_params(sd, cp), sd, cp, *args, **kw)
    b_loss, _ = G.loss_and_grad(G.extract_params(brute, cp), brute, cp, *args, **kw)
    assert torch.isfinite(loss) and torch.equal(loss, b_loss)
    assert all(torch.isfinite(g[k]).all() for k in G.TENSOR_KEYS)


def test_brute_above_max_rows_animated_raises():
    _, sd, cp = _port_scene()
    big = replace(sd, sph_center=torch.zeros((tmk.MAX_ROWS_ANIMATED + 1, 3)))
    with pytest.raises(ValueError, match="swept-tree"):
        trender.render_image_persistent(big, cp, 16, 9, 1, 1, 0, device="cpu", cull=False)


def test_render_movie_of_bouncing_stress(tmp_path):
    """Two frames: frame 0 moves (K6 with its deltas); frame 1 lies past
    the keyframe, so its deltas are zero, and the scene is still animated."""
    sc = bouncing_stress(tdemo, 16, 4)
    sc.duration = 2 / 24
    sc.scene_cam.set_samples(1)
    sc.scene_cam.set_max_depth(2)
    _clear(tmk.CULL_COUNTS)
    frames = []
    trender.render_movie(sc, str(tmp_path / "bounce"), device="cpu", verbose=False,
                         on_frame=lambda fi, dt: frames.append(fi))
    assert sorted(frames) == [0, 1] and tmk.CULL_COUNTS["nodes"] > 0
    assert len(list((tmp_path / "bounce" / "artifacts").iterdir())) == 2
