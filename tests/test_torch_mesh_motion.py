"""Moving triangle meshes (K7 moving, the megakernel's moving-triangle
stage): the scene's per-vertex motion lowering, the (M, 32) triangle
tables, the staged moving intersection, K7 moving's plain version (forward
and record), the eager replay's moving-triangle branch and the gradient,
each against the JAX package on the same inputs (its Pallas kernels in
interpret mode); the port's megakernel against its own staged path; the
shared-memory cap of an animated table; and what still raises. The card's
own tests are in ``tests/test_torch_mesh_motion_card.py``."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import integrator as jint
from crucible_tpu.models import replay as jrep
from crucible_tpu.models import scene as jscene
from crucible_tpu.models.camera import generate_rays as jgenerate_rays
from crucible_tpu.ops import intersect as jintersect
from crucible_tpu.ops import traverse as jtraverse
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.io import assets as tassets
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops import intersect as tintersect
from crucible_tpu_torch.ops import traverse as ttraverse
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests import torch_mesh_scenes as meshes
from tests.test_torch_mesh import tobj_text_grid
from tests.test_torch_scene import jax_camera_arrays, jax_scene_arrays
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 3
SCENES = {
    "moving_fan": lambda s: meshes.moving_fan(s, 48),
    "moving_fan_camera": lambda s: meshes.moving_fan(s, 48, camera=True),
    "fan_moving_sphere": lambda s: meshes.fan_beside_moving_sphere(s, 48),
    "fan_rising_camera": lambda s: meshes.fan_rising_camera(s, 48),
    "moving_box": lambda s: meshes.moving_box(s, 32),
    "moving_torus_teapot": lambda s: meshes.moving_torus_teapot(s, 48),
    "mid_shutter_fan": lambda s: meshes.moving_fan(s, 48, mid_shutter=True),
}


@functools.cache
def _scene(pkg, name):
    return SCENES[name](jscene if pkg == "jax" else tscene)


@functools.cache
def _jax_sd(name, leaf_size=8):
    return _scene("jax", name).build(leaf_size=leaf_size)


@functools.cache
def _bridged(name, leaf_size=8):
    """The port's (SceneData, CameraParams, width, height) on the CPU from
    the JAX-built scene."""
    js = _scene("jax", name)
    arrays, static = jax_scene_arrays(_jax_sd(name, leaf_size))
    jcp = js.scene_cam.params()
    sd = bridge.scene_data_from_arrays(arrays, device="cpu", **static)
    cp = bridge.camera_params_from_arrays(jax_camera_arrays(jcp), device="cpu",
                                          animated=jcp.animated, motion_exact=jcp.motion_exact)
    return sd, cp, js.scene_cam.image_width, js.scene_cam.image_height


# --- the lowering --------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("leaf", [8, 32])
def test_moving_mesh_lowering_matches_jax(name, leaf):
    """Vertices at shutter open, their deltas, the boxes (unioned over the
    shutter ends, and over the kinks inside the window of the mid-shutter
    fan), the leaf order and the flags equal the JAX package's exactly."""
    want, want_static = jax_scene_arrays(_jax_sd(name, leaf))
    got, got_static = bridge.scene_data_to_arrays(
        _scene("torch", name).build(leaf_size=leaf, device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_static == want_static
    moving_mesh = name not in ("fan_rising_camera",)
    assert ("tri_v0_d" in got) == moving_mesh
    assert got_static["tri_exact"] == (name == "mid_shutter_fan")
    assert got_static["use_bvh"] == (name != "moving_box")
    if name in ("moving_fan", "moving_torus_teapot"):
        assert np.abs(got["tri_v0_d"]).max() > 1e-3


def test_one_alias_mesh_animation_lowers_like_jax(tmp_path, monkeypatch):
    """``moving_teapot``'s animation (translate, then uniform scale) of a
    mesh loaded under one alias, as ``load_asset`` gives it."""
    (tmp_path / "mesh.obj").write_text(tobj_text_grid(9))
    monkeypatch.setattr(tassets, "ASSETS_DIR", tmp_path)
    monkeypatch.setenv("ASSET_DIR", str(tmp_path))
    out = []
    for s in (jscene, tscene):
        sc = s.Scene.new_movie(16.0 / 9.0, 32, 24.0, 180.0, 5.0)
        sc.load_asset("mesh.obj", "mesh", 0.5, (0.0, 0.0, 0.0), s.Metal((0.8, 0.3, 0.5), 0.05))
        sc.add_element(s.Sphere((0.0, -1000.0, 0.0), 1000.0,
                                s.Lambertian.from_color((0.5, 0.5, 0.5))), "ground")
        sc.translate_point((0.0, 5.0, 0.0), 2.5, "lerp", "local", "mesh")
        sc.scale_all_uniform(0.5, 3.0, "lerp", "mesh")
        sc.scene_cam.frame = 30
        if s is jscene:
            out.append(jax_scene_arrays(sc.build(leaf_size=8)))
        else:
            out.append(bridge.scene_data_to_arrays(sc.build(leaf_size=8, device="cpu")))
    (want, want_static), (got, got_static) = out
    assert got_static == want_static and got_static["num_tris"] == 162
    assert got.keys() == want.keys() and np.abs(got["tri_v1_d"]).max() > 0
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_moving_teapot_needs_the_asset():
    # Neither package ships teapot.obj (fault C1).
    with pytest.raises(FileNotFoundError):
        jdemo.moving_teapot()
    with pytest.raises(FileNotFoundError, match="teapot.obj"):
        tdemo.moving_teapot()
    assert tdemo.MOVIE_WORLDS[2] is tdemo.moving_teapot


def test_movie_relowers_each_frame():
    sc = meshes.moving_fan(tscene, 16)
    sds = []
    for frame in (6, 6, 7):
        sc.scene_cam.frame = frame
        sds.append(sc.build(device="cpu"))
    assert sds[1] is sds[0] and sds[2] is not sds[0]  # cached by shutter window
    assert not torch.equal(sds[0].tri_v0, sds[2].tri_v0)
    # One linear segment: the same deltas, to the rounding of v_close - v_open.
    torch.testing.assert_close(sds[0].tri_v0_d, sds[2].tri_v0_d, rtol=0, atol=1e-6)


# --- the (M, 32) triangle tables ------------------------------------------------------


@pytest.mark.parametrize("name", ["moving_fan", "fan_moving_sphere", "moving_torus_teapot"])
def test_make_tri_tables_moving_layout_matches_jax(name):
    jn, jt, jm, jmeta = (np.asarray(x) for x in jint.make_tri_tables(_jax_sd(name)))
    sd = _bridged(name)[0]
    nodes, tris, mats, meta = (x.numpy() for x in tint.make_tri_tables(sd))
    k, m = nodes.shape[0], sd.num_tris
    np.testing.assert_array_equal(nodes, jn[:, 0:6])
    np.testing.assert_array_equal(meta, jmeta[: 3 * k].reshape(k, 3))
    assert tris.shape == (m, 32) and jt.shape[1] == 32 and not jt[m:].any()
    np.testing.assert_allclose(tris, jt[:m], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mats, jm, rtol=1e-6, atol=1e-7)


def test_the_moving_layout_follows_mesh_moves():
    """One rule, ``integrator.mesh_moves``, picks the moving rows: a scene
    that carries deltas but is not animated keeps K7's Woop rows, the
    layout its launch without motion flags takes."""
    sd = _bridged("moving_fan")[0]
    still = dataclasses.replace(sd, animated=False)
    assert tint.mesh_moves(sd) and not tint.mesh_moves(still)
    assert tint.make_tri_tables(sd)[1].shape[1] == tmk.TRI_MOVING_COLS
    assert tint.make_tri_tables(still)[1].shape[1] == tmk.TRI_COLS
    assert not tint.mesh_moves(_bridged("fan_rising_camera")[0])


# --- the staged moving intersection ---------------------------------------------------


@functools.cache
def _rays(name, n=4096):
    """Seeded rays from around the mesh's bounds toward it, and seeded
    shutter fractions."""
    sd = _jax_sd(name)
    v = np.concatenate([np.asarray(sd.tri_v0), np.asarray(sd.tri_v1), np.asarray(sd.tri_v2)])
    lo, hi = v.min(axis=0), v.max(axis=0)
    rng = np.random.default_rng(17)
    c, span = 0.5 * (lo + hi), hi - lo
    o = (c + span * rng.uniform(-1.5, 1.5, (n, 3))).astype(np.float32)
    target = (c + 0.5 * span * rng.uniform(-1.0, 1.0, (n, 3))).astype(np.float32)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return o, (target - o).astype(np.float32), w


def _agree_hits(got, want, what):
    (t, i, h), (jt, ji, jh) = got, want
    t, i, h = t.numpy(), i.numpy(), h.numpy()
    jt, ji, jh = np.asarray(jt), np.asarray(ji), np.asarray(jh)
    same = (h == jh) & (~h | (i == ji))
    assert same.mean() > 0.999, (what, same.mean())
    assert h.sum() > 100, what
    both = h & jh & (i == ji)
    # XLA contracts multiply-adds (fault C6): a t near t_min = 1e-3 keeps
    # an absolute error of a few 1e-8 from the cancellation in e2 . q.
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-5, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("name", ["moving_fan", "moving_box", "moving_torus_teapot"])
def test_moving_intersection_matches_jax(name):
    """``bvh_hit_triangles`` (a BVH mesh) or ``hit_triangles`` (the brute
    box) with motion against the JAX package's, and the BVH walk against
    the brute test on the same rays."""
    sd = _bridged(name)[0]
    jsd = _jax_sd(name)
    o, d, w = _rays(name)
    to, td, tw = (torch.from_numpy(x) for x in (o, d, w))
    jo, jd, jw = (jnp.asarray(x) for x in (o, d, w))
    motion = dict(v0d=sd.tri_v0_d, v1d=sd.tri_v1_d, v2d=sd.tri_v2_d, w=tw)
    jmotion = dict(v0d=jsd.tri_v0_d, v1d=jsd.tri_v1_d, v2d=jsd.tri_v2_d, w=jw)
    brute = tintersect.hit_triangles(to, td, sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.tri_active,
                                     tmk.T_MIN, **motion)
    if not sd.use_bvh:
        want = jintersect.hit_triangles(jo, jd, jsd.tri_v0, jsd.tri_v1, jsd.tri_v2,
                                        jsd.tri_active, tmk.T_MIN, jnp.inf, **jmotion)
        _agree_hits(brute, want, f"hit_triangles {name}")
        return
    args = (sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.bvh_min, sd.bvh_max, sd.bvh_first,
            sd.bvh_count, sd.bvh_miss, tmk.T_MIN, tmk.BIG, sd.bvh_leaf_size)
    got = ttraverse.bvh_hit_triangles(to, td, *args, **motion)
    want = jtraverse.bvh_hit_triangles(
        jo, jd, jsd.tri_v0, jsd.tri_v1, jsd.tri_v2, jsd.bvh_min, jsd.bvh_max, jsd.bvh_first,
        jsd.bvh_count, jsd.bvh_miss, tmk.T_MIN, tmk.BIG, jsd.bvh_leaf_size, **jmotion)
    _agree_hits(got, want, f"bvh_hit_triangles {name}")
    assert torch.equal(got[2], brute[2]) and torch.equal(got[0], brute[0])


def test_k7_moving_walk_against_the_brute_test():
    """K7 moving's plain walk (Möller–Trumbore on lerped edges) against the
    brute staged test over every row at the same w: winners equal on >
    0.999 of the rays; the two lerp in another order (edges against
    vertices), so t agrees to rounding."""
    sd = _bridged("moving_torus_teapot")[0]
    o, d, w = (torch.from_numpy(x) for x in _rays("moving_torus_teapot"))
    nodes, tris, _, meta = tint.make_tri_tables(sd)
    tmk.TRI_COUNTS.update(nodes=0, rows=0)
    t, idx = tmk.tri_closest_reference(o, d, torch.full((o.shape[0],), tmk.BIG), nodes, meta,
                                       tris, w=w)
    assert tmk.TRI_COUNTS["nodes"] > 0 and tmk.TRI_COUNTS["rows"] > 0
    hit = t < tmk.BIG
    bt, bi, bh = tintersect.hit_triangles(o, d, sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.tri_active,
                                          tmk.T_MIN, v0d=sd.tri_v0_d, v1d=sd.tri_v1_d,
                                          v2d=sd.tri_v2_d, w=w)
    same = (hit == bh) & (~hit | (idx == bi.long()))
    assert same.float().mean() > 0.999 and hit.sum() > 1000
    np.testing.assert_allclose(t[hit & bh].numpy(), bt[hit & bh].numpy(), rtol=1e-4)
    with pytest.raises(ValueError, match="shutter fractions"):
        tmk.tri_closest_reference(o, d, t, nodes, meta, tris)


# --- K7 moving's plain version against the JAX kernel (interpret mode) --------------

KERNEL_CASES = ["moving_fan", "moving_fan_camera", "fan_rising_camera"]


@functools.cache
def _jax_mega(name):
    js = _scene("jax", name)
    return np.asarray(jint.trace_persistent_mega(
        _jax_sd(name), js.scene_cam.params(), 48, 48, jnp.uint32(4), 5, jnp.uint32(SEED),
        interpret=True))


@functools.cache
def _port_mega(name):
    sd, cp, w, h = _bridged(name)
    return tint.trace_persistent_mega(sd, cp, w, h, 4, 5, SEED).numpy()


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_k7_moving_forward_plain_matches_jax_kernel(name):
    sd, cp = _bridged(name)[:2]
    assert tint.megakernel_supported(sd, cp) and (sd.animated or cp.animated)
    got, want = _port_mega(name) / 4, _jax_mega(name) / 4  # per-pixel means of 4 samples
    close = np.isclose(got, want, rtol=1e-3, atol=1e-3).mean()
    assert close > 0.97, close
    assert abs(got.mean() - want.mean()) < 2e-3


def _lanes(spp):
    p = 48 * 48
    return (np.tile(np.arange(p, dtype=np.int32), spp),
            np.repeat(np.arange(spp, dtype=np.int32), p))


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_k7_moving_record_plain_matches_jax_kernel(name):
    pix, smp = _lanes(4)
    sd, cp, w, h = _bridged(name)
    js = _scene("jax", name)
    want = np.asarray(jrep.trace_record_mega(_jax_sd(name), js.scene_cam.params(), w, h,
                                             jnp.asarray(pix), jnp.asarray(smp),
                                             jnp.uint32(SEED), 5, interpret=True))
    tp, ts = torch.from_numpy(pix), torch.from_numpy(smp)
    got = trep.trace_record_mega(sd, cp, w, h, tp, ts, SEED, 5).numpy()
    tri = (got & tmk.F_TRI) > 0
    assert tri.any() and not (got[tri] & tmk.F_ROOT1).any()
    same = (got == want).all(axis=0).mean()
    assert same > 0.97, same
    rec_fused, rad = trep.trace_record_mega(sd, cp, w, h, tp, ts, SEED, 5, radiance=True)
    assert np.array_equal(rec_fused.numpy(), got) and bool(torch.isfinite(rad).all())


# --- the port's megakernel against its own staged path ------------------------------


@functools.cache
def _torus_case():
    sd, cp, _, _ = _bridged("moving_torus_teapot")
    w, h = 48, 27
    p = w * h
    pix = torch.arange(p).repeat(2)
    smp = torch.arange(2).repeat_interleave(p)
    staged = tint.render_rays(sd, cp, w, h, pix, smp, 0, 4)
    return sd, cp, w, h, pix, smp, staged


def test_moving_mesh_mega_matches_the_staged_path():
    """moving torus_teapot through the mega schedule (K7 moving's plain
    version) against the staged bounce loop at the JAX package's bounds
    (tests/test_integrator.py:287)."""
    sd, cp, w, h, _, _, staged = _torus_case()
    assert tint.megakernel_supported(sd, cp)
    img = tint.trace_persistent_mega(sd, cp, w, h, 2, 4, 0).reshape(h, w, 3).numpy() / 2.0
    ref = staged.reshape(2, h, w, 3).mean(dim=0).numpy()
    d = np.abs(img - ref)
    assert d.mean() < 3e-3 and (d > 1e-3).mean() < 0.03, d.max()


def test_moving_mesh_mega_records_replay_like_the_staged_path():
    """The port's mega records of moving torus_teapot, replayed eagerly,
    against the staged forward (tests/test_replay.py:405's bounds)."""
    sd, cp, w, h, pix, smp, staged = _torus_case()
    rec = trep.trace_record_mega(sd, cp, w, h, pix, smp, 0, 4)
    assert bool(((rec & tmk.F_TRI) > 0).any())
    o, d, _ = tint.generate_rays(cp, w, h, pix, smp, 0)
    rad = trep.trace_replay(sd, o, d, pix, smp, 0, 4, rec).numpy()
    d_ = np.abs(rad - staged.numpy())
    assert d_.mean() < 3e-3 and (d_ > 1e-3).mean() < 0.03, d_.max()


# --- the eager replay's moving-triangle branch and the gradient ----------------------


def test_eager_replay_moving_triangles_match_jax():
    """The eager replay (per-winner vertex lerp, then Möller–Trumbore and
    the normal) against the JAX package's non-kernel ``trace_replay`` on
    the same records: radiance at rtol 1e-4 / atol 1e-5."""
    pix, smp = _lanes(2)
    js = _scene("jax", "moving_fan")
    jsd, jcp = _jax_sd("moving_fan"), js.scene_cam.params()
    jp, jsm = jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32)
    o, d, _ = jgenerate_rays(jcp, 48, 48, jp, jsm, jnp.uint32(SEED))
    rec = jrep.trace_record(jsd, o, d, jp, jsm, jnp.uint32(SEED), 5)
    want = np.asarray(jrep.trace_replay(jsd, o, d, jp, jsm, jnp.uint32(SEED), 5, rec))
    rec = np.array(rec)
    assert ((rec & tmk.F_TRI) > 0).any()
    sd = _bridged("moving_fan")[0]
    got = trep.trace_replay(sd, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
                            torch.from_numpy(pix), torch.from_numpy(smp), SEED, 5,
                            torch.from_numpy(rec))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def _loss_and_grad(pkg, name, **kw):
    if pkg == "jax":
        jsd, jcp = _jax_sd(name), _scene("jax", name).scene_cam.params()
        p = 32 * 18
        if kw["method"] == "auto":
            # The JAX package's auto route on an accelerator: the record
            # megakernel (here in interpret mode), then the replay. Its CPU
            # default records through the staged path, which lerps the
            # vertices before the edges, so a grazing lane may decide
            # otherwise (one of 1152 lanes here, at a bounce off the ground).
            pix = jnp.tile(jnp.arange(p, dtype=jnp.int32), 2)
            smp = jnp.repeat(jnp.arange(2, dtype=jnp.int32), p)
            kw = dict(kw, rec=jrep.trace_record_mega(jsd, jcp, 32, 18, pix, smp,
                                                     jnp.uint32(SEED), 4, interpret=True))
        loss, g = JG.loss_and_grad(JG.extract_params(jsd, jcp), jsd, jcp, jnp.zeros((p, 3)),
                                   jnp.arange(p, dtype=jnp.int32), jnp.uint32(SEED),
                                   width=32, height=18, spp=2, max_depth=4, **kw)
        return float(loss), {k: np.asarray(v) for k, v in g.items() if k in G.TENSOR_KEYS}
    sd, cp, _, _ = _bridged(name)
    loss, g = G.loss_and_grad(G.extract_params(sd, cp), sd, cp, torch.zeros((32 * 18, 3)),
                              torch.arange(32 * 18), SEED, width=32, height=18, spp=2,
                              max_depth=4, **kw)
    return float(loss), {k: g[k].numpy() for k in G.TENSOR_KEYS}


@pytest.mark.parametrize("name,method", [("moving_fan", "auto"), ("moving_box", "ad")])
def test_loss_and_grad_matches_jax(name, method):
    """The moving fan's replay (K7 moving's plain record, the eager replay)
    and the moving box's direct AD (``hit_triangles`` with motion) against
    the JAX package's: loss within rel 2e-3, the radiometric leaves within
    normalized 5e-3."""
    jl, jg = _loss_and_grad("jax", name, method=method)
    tl, tg = _loss_and_grad("torch", name, method=method)
    assert abs(tl - jl) <= 2e-3 * abs(jl), (tl, jl)
    for key in ("tex_color", "mat_fuzz", "mat_emission"):
        scale = max(float(np.abs(jg[key]).max()), 1e-6)
        np.testing.assert_allclose(tg[key] / scale, jg[key] / scale, rtol=0, atol=5e-3,
                                   err_msg=key)


def test_moving_mesh_albedo_finite_difference():
    """The replay gradient of the largest ``tex_color`` entry against a
    central difference of the loss (the JAX package's
    test_moving_mesh_albedo bound, rel 5e-2)."""
    sd, cp, _, _ = _bridged("moving_fan")
    params = G.extract_params(sd, cp)
    kw = dict(width=32, height=18, spp=2, max_depth=4, method="replay")
    args = (sd, cp, torch.zeros((32 * 18, 3)), torch.arange(32 * 18), 0)
    _, g = G.loss_and_grad(params, *args, **kw)
    gt = g["tex_color"]
    idx = np.unravel_index(int(gt.abs().argmax()), tuple(gt.shape))
    assert abs(float(gt[idx])) > 0

    def loss_at(delta):
        arr = params["tex_color"].detach().double().clone()
        arr[idx] += delta
        return float(G.l2_loss(dict(params, tex_color=arr.float()), *args, **kw))

    eps = 1e-3
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert float(gt[idx]) == pytest.approx(fd, rel=5e-2)


# --- the shared-memory cap and what still raises ----------------------------------------


def test_k7_node_cap_counts_the_motion_columns():
    """Beside moving sphere rows (three 16-byte entries staged each, against
    one) K7 moving reads its tree's nodes from global memory as K7 does,
    with no cap, and its (M, 32) rows as the 20 columns its test reads
    (moving_tri_rows); moving torus_teapot at leaf 4, the card's default,
    goes so."""
    n, k = 8, 6449
    table = torch.zeros((n, tmk.C_IN))
    tmk.check_rows(n, animated=True)
    rows = torch.arange(2 * tmk.TRI_MOVING_COLS, dtype=torch.float32).reshape(2, -1)
    tri = (torch.zeros((k, 6)), torch.zeros((k, 3), dtype=torch.int32), rows,
           torch.zeros((1, tmk.MAT_COLS)))
    _, fk, kt, held = tmk._flat_args(None, tri, table, True)
    assert (fk, kt) == (0, k) and held[0].shape == (n, 12) and held[8].shape == (k, 8)
    assert torch.equal(held[5], rows[:, list(tmk.MOVING_TRI_PACK)])
    assert held[5].shape == (2, 20) and held[6] is rows
    sd = _scene("torch", "moving_torus_teapot").build(leaf_size=4, device="cpu")
    assert sd.bvh_min.shape[0] == 3159


def test_what_moving_meshes_still_refuse():
    # Exact time, a keyframe inside the shutter (ROADMAP A7): the
    # megakernel refuses it; it renders through the staged bounce, and its
    # records replay (dead words replay to nothing).
    sc = _scene("torch", "mid_shutter_fan")
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    assert sd.tri_exact and sd.motion_exact and not tint.megakernel_supported(sd, cp)
    assert bool(torch.isfinite(trender.render_image(sc, 1, 2, device="cpu")).all())
    rad = trep.trace_replay(sd, torch.zeros(4, 3), torch.ones(4, 3), torch.arange(4),
                            torch.zeros(4), 0, 2, torch.zeros((2, 4), dtype=torch.int32))
    assert not rad.any()
    # A mesh beside the sphere walk, refused until ROADMAP A11, runs in both
    # modes: the fan seen by the rising camera, its table walked in a tree
    # (K5 with K8's camera, then K7), records the brute search's words.
    # (Moving spheres with structure tables but without the cluster tables
    # are refused, naming K6's chunk-cull tables.)
    from dataclasses import replace

    sd, cp, w, h = _bridged("fan_rising_camera")
    walk = replace(sd, sph_perm=torch.zeros(8, dtype=torch.int32))
    assert tint.megakernel_unsupported_reason(walk, cp) is None
    assert tint.megakernel_record_unsupported_reason(walk, cp) is None
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 1, 2, 0)
    tri = dict(zip(("tri_nodes", "tris", "mats", "tri_meta"), tint.make_tri_tables(sd)))
    perm, nodes, meta = (torch.from_numpy(x) for x in tmk.swept_tables(
        sd.sph_center.numpy(), sd.sph_radius.numpy(), sd.sph_active.numpy()))
    tree = dict(inputs, table=tint.permute_table(inputs["table"], perm), swept_nodes=nodes,
                swept_meta=meta)
    got = tmk.run_megakernel_record(**tree, **tri, max_depth=2, cam_animated=True)
    want = tmk.run_megakernel_record(**inputs, **tri, max_depth=2, cam_animated=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    reason = tint.megakernel_record_unsupported_reason(
        replace(_bridged("moving_fan")[0], sph_perm=walk.sph_perm), cp)
    assert "K6" in reason and "sph_cbounds" in reason
    # A table whose layout is not the one the launch's motion flag reads.
    sd, cp, w, h = _bridged("moving_fan")
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 1, 2, 0)
    tri = dict(zip(("tri_nodes", "tris", "mats", "tri_meta"), tint.make_tri_tables(sd)))
    with pytest.raises(ValueError, match="moving layout"):
        tmk.run_megakernel(**inputs, **tri, animated=False)
    static = dict(tri, tris=tri["tris"][:, :16].contiguous())
    with pytest.raises(ValueError, match="moving layout"):
        tmk.run_megakernel(**inputs, **static, animated=True)
