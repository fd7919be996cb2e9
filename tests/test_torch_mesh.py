"""Static triangle meshes (K7, the megakernel's triangle-BVH stage): the
OBJ loader, the scene's triangle lowering and BVH, the triangle tables, the
staged intersection and BVH walk, K7's plain version (forward and record),
the eager replay's triangle branch and the gradient, each against the JAX
package on the same inputs (its Pallas kernels in interpret mode); the
port's megakernel against its own staged path and against the scalar
oracle; and what still raises. The card's own tests are in
``tests/test_torch_mesh_card.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.io import obj as jobj
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import integrator as jint
from crucible_tpu.models import replay as jrep
from crucible_tpu.models import scene as jscene
from crucible_tpu.models.camera import generate_rays as jgenerate_rays
from crucible_tpu.ops import bvh as jbvh
from crucible_tpu.ops import intersect as jintersect
from crucible_tpu.ops import traverse as jtraverse
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.io import assets as tassets
from crucible_tpu_torch.io import obj as tobj
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops import bvh as tbvh
from crucible_tpu_torch.ops import intersect as tintersect
from crucible_tpu_torch.ops import traverse as ttraverse
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests import oracle
from tests import torch_mesh_scenes as meshes
from tests.test_torch_replay import _assert_k3_scheme
from tests.test_torch_scene import jax_scene_arrays
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 3
MESH_ARRAYS = bridge.MESH_ARRAYS
SCENES = {
    "fan": lambda s: meshes.fan(s, 48),
    "floor": lambda s: meshes.floor_ball(s, 12)[0],
    "box": lambda s: meshes.box(s, 32),
    "torus_teapot": lambda s: meshes.torus_teapot(s, 32),
}


@functools.cache
def _jax_scene(name):
    return SCENES[name](jscene)


@functools.cache
def _jax_sd(name, leaf_size=32):
    return _jax_scene(name).build(leaf_size=leaf_size)


@functools.cache
def _bridged(name):
    """The port's (SceneData, CameraParams) on the CPU from the JAX-built
    scene (leaf 32, the CPU default of both packages)."""
    js = _jax_scene(name)
    arrays, static = jax_scene_arrays(_jax_sd(name))
    jcp = js.scene_cam.params()
    sd = bridge.scene_data_from_arrays(arrays, device="cpu", **static)
    cp = bridge.camera_params_from_arrays(
        {k: np.asarray(getattr(jcp, k)) for k in bridge.CAMERA_ARRAYS
         if getattr(jcp, k) is not None}, device="cpu")
    return sd, cp, js.scene_cam.image_width, js.scene_cam.image_height


# --- the OBJ loader and load_asset ------------------------------------------------

OBJ_TEXT = """# a quad and a triangle
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0.5
f 1 2 3
f 1/1/1 3/2/2 4/3/3
f -4 -3 -1
"""


def test_parse_obj_text_matches_jax():
    for kw in (dict(), dict(scale=0.5, shift=(1.0, -2.0, 0.25))):
        got = tobj.parse_obj_text(OBJ_TEXT, strict=False, **kw)
        want = jobj.parse_obj_text(OBJ_TEXT, strict=False, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="Unsupported"):
        tobj.parse_obj_text(OBJ_TEXT)
    with pytest.raises(ValueError, match="triangulated"):
        tobj.parse_obj_text("v 0 0 0\nf 1 1 1 1\n")


def test_load_asset_lowers_like_jax(tmp_path, monkeypatch):
    (tmp_path / "mesh.obj").write_text(tobj_text_grid(9))
    monkeypatch.setattr(tassets, "ASSETS_DIR", tmp_path)
    monkeypatch.setenv("ASSET_DIR", str(tmp_path))
    got_sd = None
    for s in (jscene, tscene):
        pkg, sc = ("jax" if s is jscene else "torch"), s.Scene.new_image(1.0, 16)
        oid = sc.load_asset("mesh.obj", "mesh", 0.5, (0.0, 0.1, 0.0), s.Metal((0.5, 0.4, 0.3)))
        ground = s.Lambertian.from_color((0.5, 0.5, 0.5))
        sc.add_element(s.Sphere((0.0, -100.0, 0.0), 100.0, ground), "ground")
        ids = {e.id for e in sc.elements if isinstance(e, s.Triangle)}
        assert ids == {oid} and sc.id_vendor.alias_lookup("mesh")[1] == "triangle_mesh"
        if pkg == "jax":
            want, want_static = jax_scene_arrays(sc.build(leaf_size=4))
        else:
            got_sd = sc.build(leaf_size=4, device="cpu")
            sc.hide_element("mesh")
            assert sc.build(leaf_size=4, device="cpu").num_tris == 0
    got, got_static = bridge.scene_data_to_arrays(got_sd)
    assert got_static == want_static and got_static["num_tris"] == 162
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def tobj_text_grid(n):
    """An n x n grid of quads, two triangles each, as OBJ text."""
    lines = [f"v {i} {0.1 * ((i * j) % 3)} {j}" for i in range(n + 1) for j in range(n + 1)]
    for i in range(n):
        for j in range(n):
            a, b, c, d = (1 + i * (n + 1) + j, 1 + (i + 1) * (n + 1) + j,
                          2 + (i + 1) * (n + 1) + j, 2 + i * (n + 1) + j)
            lines += [f"f {a} {b} {c}", f"f {a} {c} {d}"]
    return "\n".join(lines) + "\n"


def test_load_teapot_needs_the_asset():
    # Neither package ships teapot.obj (fault C1).
    with pytest.raises(FileNotFoundError):
        jdemo.load_teapot(width=16)
    with pytest.raises(FileNotFoundError, match="teapot.obj"):
        tdemo.load_teapot(width=16)
    assert tdemo.WORLDS[3] is tdemo.load_teapot


# --- scene lowering and the BVH -----------------------------------------------------


@pytest.mark.parametrize("name,leaf", [("fan", 32), ("fan", 4), ("floor", 32), ("floor", 4),
                                       ("box", 32), ("box", 4), ("torus_teapot", 32)])
def test_mesh_lowering_matches_jax(name, leaf):
    want, want_static = jax_scene_arrays(_jax_sd(name, leaf))
    got, got_static = bridge.scene_data_to_arrays(
        SCENES[name](tscene).build(leaf_size=leaf, device="cpu"))
    assert got.keys() == want.keys() and set(MESH_ARRAYS) <= set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_static == want_static
    assert got_static["use_bvh"] == (name != "box")


def test_reorder_front_to_back_matches_jax():
    sd = _jax_sd("torus_teapot")
    v = np.stack([np.asarray(sd.tri_v0), np.asarray(sd.tri_v1), np.asarray(sd.tri_v2)], 1)
    lo, hi = v.min(axis=1), v.max(axis=1)
    for view in ((1.0, 0.0, 0.0), (-13.0, -10.0, -3.0)):
        got = tbvh.reorder_front_to_back(tbvh.build_bvh(lo, hi, 8, "sah"), view)
        want = jbvh.reorder_front_to_back(
            jbvh.build_bvh(lo, hi, leaf_size=8, method="sah", use_native=True), view)
        for f in ("node_min", "node_max", "node_first", "node_count", "node_miss",
                  "node_parent", "perm"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_scene_build_keys_and_defaults():
    sc = meshes.fan(tscene, 16)
    a = sc.build(device="cpu")
    assert a.bvh_leaf_size == tscene.BVH_LEAF_CPU == 32
    assert sc.build(device="cpu") is a  # cached
    b = sc.build(leaf_size=4, device="cpu")
    assert b is not a and b.bvh_min.shape[0] > a.bvh_min.shape[0]
    assert sc.build(leaf_size=4, bvh_method="median", device="cpu") is not b
    sc.hide_element("tri3")
    assert sc.build(device="cpu").num_tris == 79
    sc.show_element("tri3")
    assert sc.build(device="cpu").num_tris == 80
    assert tscene.BVH_MIN_TRIS == jscene.BVH_MIN_TRIS


# --- the triangle tables -------------------------------------------------------------


@pytest.mark.parametrize("name", ["fan", "torus_teapot"])
def test_make_tri_tables_matches_jax(name):
    jn, jt, jm, jmeta = (np.asarray(x) for x in jint.make_tri_tables(_jax_sd(name)))
    sd = _bridged(name)[0]
    nodes, tris, mats, meta = (x.numpy() for x in tint.make_tri_tables(sd))
    k, m = nodes.shape[0], sd.num_tris
    np.testing.assert_array_equal(nodes, jn[:, 0:6])
    np.testing.assert_array_equal(meta, jmeta[: 3 * k].reshape(k, 3))
    assert tris.shape == (m, 16) and not jt[m:].any()  # JAX's padding rows are zero
    jt = jt[:m]
    # The affine map (columns 0-11) is a ratio of cross products that cancel
    # (b cancels again): XLA's contracted multiply-adds (fault C6) move an
    # entry by up to 3e-7 of its row's largest, so each row is held to 1e-6
    # of that, as is a float64 evaluation of the same formula. The normal,
    # material id and mats hold to rtol 1e-6 / atol 1e-7.
    v0, v1, v2 = (getattr(sd, k).numpy().astype(np.float64) for k in ("tri_v0", "tri_v1", "tri_v2"))
    nu = np.cross(v1 - v0, v2 - v0)
    det = (nu * nu).sum(1, keepdims=True)
    a = [np.cross(v2 - v0, nu) / det, np.cross(nu, v1 - v0) / det, nu / det]
    f64 = np.concatenate(a + [-np.stack([(x * v0).sum(1) for x in a], 1)], 1)
    row = np.abs(jt[:, :12]).max(axis=1, keepdims=True)
    for want in (jt[:, :12], f64):
        assert (np.abs(tris[:, :12] - want) <= 1e-6 * row).all()
    np.testing.assert_allclose(tris[:, 12:], jt[:, 12:], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mats, jm, rtol=1e-6, atol=1e-7)


# --- the staged intersection and BVH walk -------------------------------------------


@functools.cache
def _rays(name, n=4096):
    """Seeded rays from around the mesh's bounds toward it."""
    sd = _jax_sd(name)
    v = np.concatenate([np.asarray(sd.tri_v0), np.asarray(sd.tri_v1), np.asarray(sd.tri_v2)])
    lo, hi = v.min(axis=0), v.max(axis=0)
    rng = np.random.default_rng(7)
    c, span = 0.5 * (lo + hi), hi - lo
    o = (c + span * rng.uniform(-1.5, 1.5, (n, 3))).astype(np.float32)
    target = (c + 0.5 * span * rng.uniform(-1.0, 1.0, (n, 3))).astype(np.float32)
    return o, (target - o).astype(np.float32)


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


@pytest.mark.parametrize("name", ["box", "fan"])
def test_hit_triangles_and_normals_match_jax(name):
    sd, _, _, _ = _bridged(name)
    jsd = _jax_sd(name)
    o, d = _rays(name)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = tintersect.hit_triangles(to, td, sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.tri_active,
                                   tmk.T_MIN)
    want = jintersect.hit_triangles(jnp.asarray(o), jnp.asarray(d), jsd.tri_v0, jsd.tri_v1,
                                    jsd.tri_v2, jsd.tri_active, tmk.T_MIN, jnp.inf)
    _agree_hits(got, want, f"hit_triangles {name}")
    np.testing.assert_allclose(
        tintersect.triangle_normal(sd.tri_v0, sd.tri_v1, sd.tri_v2).numpy(),
        np.asarray(jintersect.triangle_normal(jsd.tri_v0, jsd.tri_v1, jsd.tri_v2)),
        rtol=1e-6, atol=1e-7)
    lo, hi = sd.bvh_min, sd.bvh_max
    np.testing.assert_array_equal(
        tintersect.hit_aabbs(to, td, lo, hi, tmk.T_MIN, 1e30).numpy(),
        np.asarray(jintersect.hit_aabbs(jnp.asarray(o), jnp.asarray(d), jsd.bvh_min,
                                        jsd.bvh_max, tmk.T_MIN, 1e30)))


def test_hit_triangles_gradient_is_the_winners():
    sd, _, _, _ = _bridged("box")
    o, d = (torch.from_numpy(x[:256]) for x in _rays("box"))
    o, d = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
    t, idx, hit = tintersect.hit_triangles(o, d, sd.tri_v0, sd.tri_v1, sd.tri_v2,
                                           sd.tri_active, tmk.T_MIN)
    go, gd = torch.autograd.grad(torch.where(hit, t, 0.0).sum(), (o, d))

    def t_of(o_, d_):
        jt, _, jh = jintersect.hit_triangles(o_, d_, jnp.asarray(sd.tri_v0.numpy()),
                                             jnp.asarray(sd.tri_v1.numpy()),
                                             jnp.asarray(sd.tri_v2.numpy()),
                                             jnp.asarray(sd.tri_active.numpy()), tmk.T_MIN,
                                             jnp.inf)
        return jnp.where(jh, jt, 0.0).sum()

    jgo, jgd = jax.grad(t_of, argnums=(0, 1))(jnp.asarray(o.detach().numpy()),
                                              jnp.asarray(d.detach().numpy()))
    np.testing.assert_allclose(go.numpy(), np.asarray(jgo), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["fan", "torus_teapot"])
def test_bvh_hit_triangles_matches_jax_and_brute(name):
    sd, _, _, _ = _bridged(name)
    jsd = _jax_sd(name)
    o, d = _rays(name)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    args = (sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.bvh_min, sd.bvh_max, sd.bvh_first,
            sd.bvh_count, sd.bvh_miss, tmk.T_MIN, tmk.BIG, sd.bvh_leaf_size)
    got = ttraverse.bvh_hit_triangles(to, td, *args)
    want = jtraverse.bvh_hit_triangles(
        jnp.asarray(o), jnp.asarray(d), jsd.tri_v0, jsd.tri_v1, jsd.tri_v2, jsd.bvh_min,
        jsd.bvh_max, jsd.bvh_first, jsd.bvh_count, jsd.bvh_miss, tmk.T_MIN, tmk.BIG,
        jsd.bvh_leaf_size)
    _agree_hits(got, want, f"bvh_hit_triangles {name}")
    brute = tintersect.hit_triangles(to, td, sd.tri_v0, sd.tri_v1, sd.tri_v2,
                                     sd.tri_active, tmk.T_MIN)
    assert torch.equal(got[2], brute[2]) and torch.equal(got[0], brute[0])
    # Linear motion lerps per leaf row: zero deltas change nothing.
    z = torch.zeros_like(sd.tri_v0)
    moved = ttraverse.bvh_hit_triangles(to, td, *args, v0d=z, v1d=z, v2d=z,
                                        w=torch.rand(o.shape[0]))
    assert all(torch.equal(a, b) for a, b in zip(moved, got))


def test_k7_walk_against_the_brute_test():
    """K7's plain walk (Woop) against the brute Möller–Trumbore over every
    row, as JAX's tests/test_integrator.py holds the Pallas stage to the
    staged walk: winners equal on > 0.999 of the rays."""
    sd, _, _, _ = _bridged("torus_teapot")
    o, d = (torch.from_numpy(x) for x in _rays("torus_teapot"))
    nodes, tris, _, meta = tint.make_tri_tables(sd)
    tmk.TRI_COUNTS.update(nodes=0, rows=0)
    t, idx = tmk.tri_closest_reference(o, d, torch.full((o.shape[0],), tmk.BIG), nodes, meta,
                                       tris)
    assert tmk.TRI_COUNTS["nodes"] > 0 and tmk.TRI_COUNTS["rows"] > 0
    hit = t < tmk.BIG
    bt, bi, bh = tintersect.hit_triangles(o, d, sd.tri_v0, sd.tri_v1, sd.tri_v2,
                                          sd.tri_active, tmk.T_MIN)
    same = (hit == bh) & (~hit | (idx == bi.long()))
    assert same.float().mean() > 0.999 and hit.sum() > 1000
    # Woop's t and Möller–Trumbore's round apart on grazing rays.
    np.testing.assert_allclose(t[hit & bh].numpy(), bt[hit & bh].numpy(), rtol=1e-3)


# --- K7's plain version against the JAX kernel (interpret mode) ----------------------


@functools.cache
def _jax_mega_fan():
    sd, cp = _jax_sd("fan"), _jax_scene("fan").scene_cam.params()
    return np.asarray(jint.trace_persistent_mega(sd, cp, 48, 48, jnp.uint32(4), 5,
                                                 jnp.uint32(SEED), interpret=True))


@functools.cache
def _port_mega_fan():
    sd, cp, w, h = _bridged("fan")
    return tint.trace_persistent_mega(sd, cp, w, h, 4, 5, SEED).numpy()


def test_k7_forward_plain_matches_jax_kernel():
    got, want = _port_mega_fan() / 4, _jax_mega_fan() / 4  # per-pixel means of 4 samples
    close = np.isclose(got, want, rtol=1e-3, atol=1e-3).mean()
    assert close > 0.97, close
    assert abs(got.mean() - want.mean()) < 2e-3


def _fan_lanes(spp=4):
    p = 48 * 48
    return (np.tile(np.arange(p, dtype=np.int32), spp),
            np.repeat(np.arange(spp, dtype=np.int32), p))


def test_k7_record_plain_matches_jax_kernel():
    pix, smp = _fan_lanes()
    sd, cp, w, h = _bridged("fan")
    jsd, jcp = _jax_sd("fan"), _jax_scene("fan").scene_cam.params()
    want = np.asarray(jrep.trace_record_mega(jsd, jcp, w, h, jnp.asarray(pix), jnp.asarray(smp),
                                             jnp.uint32(SEED), 5, interpret=True))
    got = trep.trace_record_mega(sd, cp, w, h, torch.from_numpy(pix), torch.from_numpy(smp),
                                 SEED, 5).numpy()
    assert ((got & tmk.F_TRI) > 0).any()
    same = (got == want).all(axis=0).mean()
    assert same > 0.97, same
    rec_fused, rad = trep.trace_record_mega(sd, cp, w, h, torch.from_numpy(pix),
                                            torch.from_numpy(smp), SEED, 5, radiance=True)
    assert np.array_equal(rec_fused.numpy(), got) and bool(torch.isfinite(rad).all())


def test_k7_plain_matches_the_staged_path():
    """The port's mega against its own staged path at JAX's bounds
    (tests/test_integrator.py:357-360)."""
    sd, cp, w, h = _bridged("fan")
    ref = tint.trace_persistent(sd, cp, w, h, 4, 5, SEED, lanes=512).numpy()
    d = np.abs(ref - _port_mega_fan())
    assert (d > 1e-3).mean() < 0.005, d.max()
    assert d.mean() < 1e-3


def test_floor_and_ball_match_the_oracle():
    sc, tris, (center, radius) = meshes.floor_ball(tscene, 12)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    assert sd.use_bvh and sd.num_tris == 72 and tint.megakernel_supported(sd, cp)
    got = trender.render_image(sc, samples=2, max_depth=3, seed=4, device="cpu").numpy()
    floor = dict(type=0, albedo={"kind": "solid", "color": (0.6, 0.5, 0.2)}, prob=1.0)
    ball = dict(type=1, albedo={"kind": "solid", "color": (0.8, 0.8, 0.9)}, fuzz=0.0)
    objs = [oracle.OracleTriangle(*t, floor) for t in tris]
    objs.append(oracle.OracleSphere(center, radius, ball))
    want = oracle.render(objs, dict(meshes.FLOOR_CAM, focus_dist=10.0), 12, 8, 2, 3, 4)
    got = got.astype(np.float64)
    assert np.isclose(got, want, atol=2e-3).mean() > 0.97
    np.testing.assert_allclose(got.mean(), want.mean(), atol=1.5e-3)


def test_brute_mesh_takes_the_pixel_schedule_like_jax():
    from crucible_tpu.models import render as jrender

    sd, cp, w, h = _bridged("box")
    assert not sd.use_bvh and not tint.megakernel_supported(sd, cp)
    got = trender.render_image_persistent(sd, cp, w, h, 2, 4, SEED, device="cpu").numpy()
    want = np.asarray(jrender.render_image_persistent(
        _jax_sd("box"), _jax_scene("box").scene_cam.params(), w, h, 2, 4, jnp.uint32(SEED),
        schedule="pixel"))
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(got.mean() - want.mean()) < 2e-3


# --- the eager replay's triangle branch and the gradient ---------------------------


@functools.cache
def _fan_records(depth=5):
    pix, smp = _fan_lanes(2)
    jsd, jcp = _jax_sd("fan"), _jax_scene("fan").scene_cam.params()
    jp, js = jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32)
    o, d, _ = jgenerate_rays(jcp, 48, 48, jp, js, jnp.uint32(SEED))
    rec = jrep.trace_record(jsd, o, d, jp, js, jnp.uint32(SEED), depth)
    return pix, smp, np.array(o), np.array(d), np.array(rec)


def test_eager_replay_triangles_match_jax():
    pix, smp, o, d, rec = _fan_records()
    assert ((rec & tmk.F_TRI) > 0).any()
    jsd = _jax_sd("fan")
    base = JG.extract_params(jsd, _jax_scene("fan").scene_cam.params())
    keys = ("tex_color", "mat_emission", "mat_fuzz")

    def run(leaves, o_, d_):
        sd, _ = JG.apply_params(jsd, _jax_scene("fan").scene_cam.params(), dict(base, **leaves))
        return jrep.trace_replay(sd, o_, d_, jnp.asarray(pix, jnp.uint32),
                                 jnp.asarray(smp, jnp.uint32), jnp.uint32(SEED), 5,
                                 jnp.asarray(rec))

    jrad, vjp = jax.vjp(run, {k: base[k] for k in keys}, jnp.asarray(o), jnp.asarray(d))
    wgt = np.random.default_rng(2).standard_normal(np.asarray(jrad).shape).astype(np.float32)
    jg, jgo, jgd = vjp(jnp.asarray(wgt))

    sd, cp, _, _ = _bridged("fan")
    params = G.extract_params(sd, cp)
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in keys}
    sd2, _ = G.apply_params(sd, cp, dict(params, **leaves))
    to = torch.from_numpy(o).requires_grad_(True)
    td = torch.from_numpy(d).requires_grad_(True)
    rad = trep.trace_replay(sd2, to, td, torch.from_numpy(pix), torch.from_numpy(smp), SEED, 5,
                            torch.from_numpy(rec))
    np.testing.assert_allclose(rad.detach().numpy(), np.asarray(jrad), rtol=1e-4, atol=1e-5)
    g = torch.autograd.grad((rad * torch.from_numpy(wgt)).sum(), [*leaves.values(), to, td])
    for key, got in zip(keys, g):
        want = np.asarray(jg[key])
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=1e-3,
                                   err_msg=key)
    # The rays' per-lane cotangents: K3's scheme, as in
    # tests/test_torch_replay_eager.py (a grazing lane amplifies a last-ulp
    # difference, and no sum over lanes averages it out).
    _assert_k3_scheme([np.zeros(1), g[-2].numpy(), g[-1].numpy()],
                      [np.zeros(1), np.asarray(jgo), np.asarray(jgd)])


def _loss_and_grad(pkg, name, **kw):
    if pkg == "jax":
        jsd, jcp = _jax_sd(name), _jax_scene(name).scene_cam.params()
        loss, g = JG.loss_and_grad(JG.extract_params(jsd, jcp), jsd, jcp, jnp.zeros((32 * 18, 3)),
                                   jnp.arange(32 * 18, dtype=jnp.int32), jnp.uint32(SEED),
                                   width=32, height=18, spp=2, max_depth=4, **kw)
        return float(loss), {k: np.asarray(v) for k, v in g.items() if k in G.TENSOR_KEYS}
    sd, cp, _, _ = _bridged(name)
    loss, g = G.loss_and_grad(G.extract_params(sd, cp), sd, cp, torch.zeros((32 * 18, 3)),
                              torch.arange(32 * 18), SEED, width=32, height=18, spp=2,
                              max_depth=4, **kw)
    return float(loss), {k: g[k].numpy() for k in G.TENSOR_KEYS}


@pytest.mark.parametrize("name,method", [("fan", "auto"), ("box", "ad")])
def test_loss_and_grad_matches_jax(name, method):
    """The fan's replay (K7's plain record, the eager replay) and the box's
    direct AD (hit_triangles) against the JAX package's: loss within rel
    2e-3, every leaf within normalized 5e-3 (no glass here: fault C4)."""
    jl, jg = _loss_and_grad("jax", name, method=method)
    tl, tg = _loss_and_grad("torch", name, method=method)
    assert abs(tl - jl) <= 2e-3 * abs(jl), (tl, jl)
    for key in G.TENSOR_KEYS:
        scale = max(float(np.abs(jg[key]).max()), 1e-6)
        np.testing.assert_allclose(tg[key] / scale, jg[key] / scale, rtol=0, atol=5e-3,
                                   err_msg=key)


# --- what still raises ---------------------------------------------------------------


def test_what_still_raises():
    sd, cp, w, h = _bridged("fan")
    # Direct AD through the BVH walk: no reverse mode in either package.
    with pytest.raises(NotImplementedError, match="BVH"):
        G.loss_and_grad(G.extract_params(sd, cp), sd, cp, torch.zeros((16, 3)), torch.arange(16),
                        0, width=4, height=4, spp=1, max_depth=2, method="ad")
    # The exact-time vertex hook (ROADMAP A7): a hook that returns the
    # leaf rows' own vertices walks as the walk without it, bit for bit.
    g = torch.Generator().manual_seed(5)
    o = torch.randn((256, 3), generator=g) * 0.1 + cp.look_from
    d = torch.randn((256, 3), generator=g)
    walk = (o, d, sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.bvh_min, sd.bvh_max, sd.bvh_first,
            sd.bvh_count, sd.bvh_miss, tmk.T_MIN, tmk.BIG, 32)
    hooked = ttraverse.bvh_hit_triangles(
        *walk, vertex_fn=lambda lanes, rows: (sd.tri_v0[rows], sd.tri_v1[rows], sd.tri_v2[rows]))
    plain = ttraverse.bvh_hit_triangles(*walk)
    assert all(torch.equal(x, y) for x, y in zip(hooked, plain)) and bool(plain[2].any())
    # A moving mesh whose keyframe falls inside the shutter renders through
    # the staged bounce (exact time, A7; the megakernel refuses it).
    sc = meshes.fan(tscene, 16)
    sc.translate_y(0.5, 1.0 / 96.0, "lerp", "local", "tri0")
    msd = sc.build(device="cpu")
    assert msd.tri_exact and not tint.megakernel_supported(msd, sc.scene_cam.params(device="cpu"))
    assert bool(torch.isfinite(trender.render_image(sc, 1, 2, device="cpu")).all())
    with pytest.raises(FileNotFoundError, match="teapot.obj"):
        tdemo.moving_teapot()
    # A mesh beside the sphere walk, refused until ROADMAP A11, runs: the
    # megakernel takes it in both modes, and a walk of the fan's sphere
    # table in a tree, then K7's stage, gives the brute search's sums and
    # words. Moving spheres and an animated camera beside a mesh are K7's
    # motion variants.
    from dataclasses import replace

    reason = tint.megakernel_unsupported_reason
    walk = replace(sd, sph_perm=torch.zeros(8, dtype=torch.int32))
    assert reason(walk, cp) is None
    assert tint.megakernel_record_unsupported_reason(walk, cp) is None
    assert reason(sd, replace(cp, animated=True)) is None
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 1, 2, 0)
    tri = dict(zip(("tri_nodes", "tris", "mats", "tri_meta"), tint.make_tri_tables(sd)))
    perm, nodes, meta = (torch.from_numpy(x) for x in tmk.swept_tables(
        sd.sph_center.numpy(), sd.sph_radius.numpy(), sd.sph_active.numpy()))
    tree = dict(inputs, table=tint.permute_table(inputs["table"], perm), swept_nodes=nodes,
                swept_meta=meta)
    assert torch.equal(tmk.run_megakernel(**tree, **tri, animated=False),
                       tmk.run_megakernel(**inputs, **tri, animated=False))
    got = tmk.run_megakernel_record(**tree, **tri, max_depth=2)
    want = tmk.run_megakernel_record(**inputs, **tri, max_depth=2)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # The eager replay of a mesh that says its keyframe falls inside the
    # shutter, without its vertex tracks.
    with pytest.raises(ValueError, match="vertex tracks"):
        trep.trace_replay(replace(sd, animated=True, tri_exact=True), torch.zeros(4, 3),
                          torch.ones(4, 3), torch.arange(4), torch.zeros(4), 0, 2,
                          torch.zeros((2, 4), dtype=torch.int32))
    # A BVH mesh beside a table with the sphere-BVH tables, which the
    # megakernel once refused: asked by name (the brute search, cull=False),
    # it renders the brute image, and auto takes the megakernel.
    img = trender.render_image_persistent(walk, cp, w, h, 1, 2, 0, device="cpu", cull=False,
                                          schedule="mega")
    assert torch.equal(img, trender.render_image_persistent(sd, cp, w, h, 1, 2, 0, device="cpu",
                                                            schedule="mega"))
    assert trender.auto_schedule(walk, cp, "cuda") == "mega"


def test_k7_node_cap():
    """K7 reads its tree's nodes from global memory, so a mesh's tree has no
    cap (the shared-memory staging held at most 6,452 nodes beside 8 rows):
    a tree of any size goes to the kernel as (K, 8) node entries and (K,)
    skip links beside the brute search's 16-byte staged rows; torus_teapot
    at leaf 4 has 3,159 nodes."""
    n = 8
    table = torch.zeros((n, tmk.C_IN))
    tmk.check_rows(n)
    for k in (6452, 6453, 20000):
        tri = (torch.zeros((k, 6)), torch.zeros((k, 3), dtype=torch.int32),
               torch.zeros((1, tmk.TRI_COLS)), torch.zeros((1, tmk.MAT_COLS)))
        _, fk, kt, held = tmk._flat_args(None, tri, table, False)
        assert (fk, kt) == (0, k) and held[0].shape == (n, 4)
        assert held[8].shape == (k, 8) and held[9].shape == (k,)
    sd = meshes.torus_teapot(tscene, 16).build(leaf_size=4, device="cpu")
    assert sd.bvh_min.shape[0] == 3159


def test_tri_tables_are_checked():
    sd, cp, w, h = _bridged("fan")
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 1, 2, 0)
    nodes, tris, mats, meta = tint.make_tri_tables(sd)
    bad_meta = meta.clone()
    bad_meta[0, 2] = 0  # a skip link that does not move forward
    for kw, msg in ((dict(tri_meta=bad_meta), "skip link"),
                    (dict(tris=tris[:, :8].contiguous()), "tris must be"),
                    (dict(mats=mats[:1]), "material id")):
        tri = dict(dict(tri_nodes=nodes, tris=tris, mats=mats, tri_meta=meta), **kw)
        with pytest.raises(ValueError, match=msg):
            tmk.run_megakernel(**inputs, **tri, animated=False)
