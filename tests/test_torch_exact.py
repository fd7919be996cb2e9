"""Exact-time motion (a keyframe strictly inside the shutter window) in
crucible_tpu_torch against the JAX package on the CPU, at small sizes:

- the lowering: every exact-time track field of ``Scene.build`` (spheres, a
  brute mesh, a BVH mesh in leaf order) and the camera's tracks equal the
  JAX package's exactly, and survive a ``bridge`` round trip;
- the winners' geometry (``exact_sphere_winner`` / ``exact_tri_vertices``)
  on random tracks and times, rtol 1e-6, atol 1e-6;
- the JAX package's six exact-time cases (``tests/test_timeline.py``) at
  8x8, 4 spp: ``render_rays`` meets each one's analytic oracle at atol
  1e-5 where it has one, and the JAX ``render_rays`` at atol 1e-5;
- bouncing book1 keyed at 1/96 s (spheres and camera, and the camera
  alone): ``render_image`` (auto) against the JAX package's at fault C6's
  bounds (isclose(1e-3, 1e-3) on > 0.97 of values, means within 2e-3), the
  staged records against JAX ``trace_record`` (whole lanes on > 0.97), and
  the lane chunks of the exact branch bit for bit against one chunk;
- a movie whose first frame holds a key inside its shutter, through
  ``render_movie``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu.models import camera as jcam
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import integrator as jint
from crucible_tpu.models import render as jrender
from crucible_tpu.models import replay as jrep
from crucible_tpu.models import scene as jscene
from crucible_tpu_torch import bridge
from crucible_tpu_torch.models import camera as tcam
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.models import skybox as tsky
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from crucible_tpu_torch.utils import rng as trng
from tests import torch_exact_scenes as X
from tests.test_torch_scene import jax_camera_arrays, jax_scene_arrays
from tests.torch_motion_scenes import bouncing_book1
from tests.torch_threads import one_torch_thread  # noqa: F401

W = H = 8
SPP, DEPTH = 4, 4
SEEDS = {"flash": 5, "radius_nerp": 9, "triangle_wall": 2, "bvh_wall": 2, "kink_wall": 6,
         "camera_teleport": 11}
# BVH meshes are built at 4 triangles a leaf in both packages: the JAX
# walk unrolls one test a leaf slot, and its compile at the CPU default of
# 32 takes minutes.
LEAF = 4


def _build(sc, device=None):
    return sc.build(leaf_size=LEAF, **({} if device is None else dict(device=device)))


def _lanes():
    p = W * H
    return np.tile(np.arange(p), SPP), np.repeat(np.arange(SPP), p)


# --- the lowering -----------------------------------------------------------------


def _spheres(S):
    """The flash beside a still sphere, a hidden one and one whose radius
    LERPs across the shutter."""
    sc, _, _ = X.flash(S)
    sc.add_element(S.Sphere((1.0, 2.0, -5.0), 0.5, S.Lambertian.from_color((0.5, 0.5, 0.5))),
                   "still")
    sc.add_element(S.Sphere((0.0, -2.0, -4.0), 0.7, S.Metal((0.8, 0.8, 0.8), 0.1)), "hidden")
    sc.hide_element("hidden")
    sc.add_element(S.Sphere((-1.0, 0.0, -4.0), 0.3, S.Lambertian.from_color((0.1, 0.2, 0.3))),
                   "grow")
    sc.scale_r(0.6, 0.015, X.LERP, "grow")
    sc.translate_x(0.5, 0.5, X.LERP, X.LOCAL, "grow")
    return sc


def _brute_mesh(S):
    """The triangle wall beside a still triangle (padded rows too)."""
    sc, _, _ = X.triangle_wall(S)
    sc.add_element(S.Triangle((0.0, 0.0, -4.0), (1.0, 0.0, -4.0), (0.0, 1.0, -4.0),
                              S.Lambertian.from_color((0.5, 0.5, 0.5))), "still")
    return sc


def _bvh_mesh(S):
    """The kink wall with every third triangle still: leaf-order rows of
    both kinds."""
    sc = S.Scene(aspect_ratio=1.0, image_width=W)
    for i, al in enumerate(X.grid_wall(S, sc, (0.3, 0.7, 0.5), z=-5.0, y_off=-700.0)):
        if i % 3:
            sc.translate_y(400.0, 0.01, X.LERP, X.LOCAL, al)
            sc.translate_y(-400.0, 0.02, X.LERP, X.LOCAL, al)
    return sc


@pytest.mark.parametrize("make", [_spheres, _brute_mesh, _bvh_mesh],
                         ids=["spheres", "brute_mesh", "bvh_mesh"])
def test_track_fields_equal_jax(make):
    want, want_static = jax_scene_arrays(_build(make(jscene)))
    sd = _build(make(tscene), "cpu")
    got, got_static = bridge.scene_data_to_arrays(sd)
    assert want_static["motion_exact"] and got_static == want_static
    exact = [k for k in bridge.EXACT_ARRAYS if k in want]
    assert exact == [k for k in bridge.EXACT_ARRAYS if k in got]
    assert len(exact) == (16 if want_static["tri_exact"] else 8)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # A bridge round trip keeps every field and flag.
    back = bridge.scene_data_from_arrays(got, device="cpu", **got_static)
    again, again_static = bridge.scene_data_to_arrays(back)
    assert again_static == got_static and again.keys() == got.keys()
    for k in got:
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)


def _camera_scene(name, scene, demo):
    """The camera teleport (its target still: one zero-delta segment), or
    bouncing book1 with its camera alone keyed at 1/96 s."""
    if name == "teleport":
        return X.camera_teleport(scene)[0]
    return bouncing_book1(demo, 16, 1.0 / 96.0, spheres=False)


@pytest.mark.parametrize("name", ["teleport", "bouncing_camera"])
def test_camera_tracks_equal_jax(name):
    jcp = _camera_scene(name, jscene, jdemo).scene_cam.params()
    cp = _camera_scene(name, tscene, tdemo).scene_cam.params(device="cpu")
    assert jcp.motion_exact and cp.motion_exact and cp.animated
    want = jax_camera_arrays(jcp)
    got, static = bridge.camera_params_to_arrays(cp)
    assert static == dict(animated=True, motion_exact=True)
    assert got.keys() == want.keys() and set(bridge.CAMERA_TRACK_ARRAYS) <= set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = bridge.camera_params_from_arrays(got, device="cpu", **static)
    again, again_static = bridge.camera_params_to_arrays(back)
    assert again_static == static
    for k in got:
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)


def test_winner_geometry_matches_jax():
    """Random keys on spheres and on a brute mesh's vertices (numpy seed 4),
    evaluated at random rows and times over the shutter and past it."""
    rng = np.random.default_rng(4)

    def make(S):
        sc = S.Scene(aspect_ratio=1.0, image_width=W)
        for k in range(6):
            sc.add_element(S.Sphere(tuple(rng.normal(size=3)), float(rng.uniform(0.2, 1.0)),
                                    S.Lambertian.from_color((0.5, 0.5, 0.5))), f"s{k}")
            sc.add_element(S.Triangle(*(tuple(rng.normal(size=3)) for _ in range(3)),
                                      S.Lambertian.from_color((0.5, 0.5, 0.5))), f"t{k}")
            for al in (f"s{k}", f"t{k}"):
                for _ in range(3):
                    sc.translate_point(tuple(rng.normal(size=3)), float(rng.uniform(0, 0.04)),
                                       X.LERP if rng.uniform() < 0.5 else X.NERP,
                                       X.WORLD if rng.uniform() < 0.5 else X.LOCAL, al)
            sc.scale_r(float(rng.uniform(0.2, 1.0)), float(rng.uniform(0, 0.04)), X.LERP,
                       f"s{k}")
            sc.scale_all_uniform(float(rng.uniform(0.5, 2.0)), float(rng.uniform(0, 0.04)),
                                 X.NERP, f"t{k}")
        return sc

    state = rng.bit_generator.state
    jsd = make(jscene).build()
    rng.bit_generator.state = state
    sd = make(tscene).build(device="cpu")
    assert jsd.motion_exact and jsd.tri_exact and sd.tri_exact
    r = 4096
    i_s = rng.integers(0, sd.sph_center.shape[0], r)
    pid = rng.integers(0, sd.tri_v0.shape[0], r)
    t = rng.uniform(-0.01, 0.05, r).astype(np.float32)
    jc, jr = jint.exact_sphere_winner(jsd, jnp.asarray(i_s), jnp.asarray(t))
    c, rad = tint.exact_sphere_winner(sd, torch.from_numpy(i_s), torch.from_numpy(t))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rad.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    want = jint.exact_tri_vertices(jsd, jnp.asarray(pid), jnp.asarray(t))
    got = tint.exact_tri_vertices(sd, torch.from_numpy(pid), torch.from_numpy(t))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # Any shape of candidates, the times broadcast against it (the walk's hook).
    got2 = tint.exact_tri_vertices(sd, torch.from_numpy(pid).reshape(64, 64),
                                   torch.from_numpy(t).reshape(64, 64)[:, :1])
    want2 = tint.exact_tri_vertices(sd, torch.from_numpy(pid),
                                    torch.from_numpy(t).reshape(64, 64)[:, :1]
                                    .expand(64, 64).reshape(-1))
    for a, b in zip(got2, want2):
        assert torch.equal(a.reshape(-1, 3), b)


# --- the JAX package's exact-time cases ---------------------------------------------


@functools.cache
def _jax_render(name, brute=False):
    import crucible_tpu.models.scene as jmod

    old = jmod.BVH_MIN_TRIS
    jmod.BVH_MIN_TRIS = 10**9 if brute else old
    try:
        sc, _, _ = X.CASES[name](jscene)
        sd = _build(sc)
    finally:
        jmod.BVH_MIN_TRIS = old
    pix, smp = _lanes()
    return np.asarray(jint.render_rays(sd, sc.scene_cam.params(), W, H,
                                       jnp.asarray(pix, jnp.uint32),
                                       jnp.asarray(smp, jnp.uint32),
                                       jnp.uint32(SEEDS[name]), DEPTH))


def _port(name, brute=False, monkeypatch=None):
    if brute:
        monkeypatch.setattr(tscene, "BVH_MIN_TRIS", 10**9)
    sc, key, value = X.CASES[name](tscene)
    sd, cp = _build(sc, "cpu"), sc.scene_cam.params(device="cpu")
    pix, smp = (torch.from_numpy(x) for x in _lanes())
    rad = tint.render_rays(sd, cp, W, H, pix, smp, SEEDS[name], DEPTH)
    return sc, sd, cp, rad, key, value


@pytest.mark.parametrize("name", ["flash", "radius_nerp", "triangle_wall", "bvh_wall"])
def test_exact_case_meets_its_oracle_and_jax(name):
    sc, sd, cp, rad, key, emission = _port(name)
    assert sd.motion_exact and sd.tri_exact == (name in ("triangle_wall", "bvh_wall"))
    assert sd.use_bvh == (name == "bvh_wall")
    pix, smp = (torch.from_numpy(x) for x in _lanes())
    seed = SEEDS[name]
    t_open, t_close = sc.scene_cam.shutter_window()
    w_frac = trng.uniform1(pix, smp, trng.STREAM_TIME, seed).numpy()
    t_ray = t_open + w_frac * (t_close - t_open)
    _, d, _ = tcam.generate_rays(cp, W, H, pix, smp, seed)
    sky = tsky.radiance(sd.sky_kind, sd.sky_image, d).numpy()
    expected = np.where((t_ray >= key)[:, None], np.asarray(emission, np.float32), sky)
    np.testing.assert_allclose(rad.numpy(), expected, atol=1e-5)
    assert 0.1 < (t_ray >= key).mean() < 0.9  # both sides of the key
    np.testing.assert_allclose(rad.numpy(), _jax_render(name), atol=1e-5)


def test_bvh_matches_brute_across_a_kink(monkeypatch):
    """The kink wall through the BVH's vertex hook and through the brute
    (R, M) evaluation: the same radiance (atol 1e-5), the wall seen near the
    kink (so the node boxes hold the kink), and the JAX brute render."""
    _, sd_b, _, a, _, emission = _port("kink_wall")
    _, sd_f, _, b, _, _ = _port("kink_wall", brute=True, monkeypatch=monkeypatch)
    assert sd_b.use_bvh and sd_b.tri_exact and not sd_f.use_bvh and sd_f.tri_exact
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert (np.abs(a.numpy() - np.asarray(emission, np.float32)) < 1e-4).any()
    np.testing.assert_allclose(b.numpy(), _jax_render("kink_wall", brute=True), atol=1e-5)


def test_camera_teleport_origins_and_render():
    sc, sd, cp, rad, key, after = _port("camera_teleport")
    assert cp.animated and cp.motion_exact and not sd.motion_exact
    pix, smp = (torch.from_numpy(x) for x in _lanes())
    o, _, times = tcam.generate_rays(cp, W, H, pix, smp, SEEDS["camera_teleport"])
    t_ray = times.numpy()
    expected = np.where((t_ray >= key)[:, None], np.asarray(after, np.float32),
                        np.zeros(3, np.float32))
    np.testing.assert_allclose(o.numpy(), expected, atol=1e-5)
    assert 0.1 < (t_ray >= key).mean() < 0.9
    jcp = X.camera_teleport(jscene)[0].scene_cam.params()
    jo, jd, jt = jcam.generate_rays(jcp, W, H, jnp.asarray(pix.numpy(), jnp.uint32),
                                    jnp.asarray(smp.numpy(), jnp.uint32),
                                    jnp.uint32(SEEDS["camera_teleport"]))
    o2, d2, t2 = tcam.generate_rays(cp, W, H, pix, smp, SEEDS["camera_teleport"])
    for x, y in ((o2, jo), (d2, jd), (t2, jt)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(rad.numpy(), _jax_render("camera_teleport"), atol=1e-5)


def test_missing_tracks_raise():
    """A scene or camera that says exact time but carries no tracks."""
    from dataclasses import replace

    sc = tdemo.smoke_scene(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    o, d = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError, match="exact-time sphere tracks"):
        tint.intersect_scene(replace(sd, animated=True, motion_exact=True), o, d,
                             torch.zeros(4))
    with pytest.raises(ValueError, match="vertex tracks"):
        tint.intersect_scene(replace(sd, tri_exact=True), o, d)
    with pytest.raises(ValueError, match="camera says motion_exact"):
        tcam.generate_rays(replace(cp, animated=True, motion_exact=True), 16, 9,
                           torch.arange(4), torch.zeros(4, dtype=torch.int64), 0)


# --- bouncing book1 keyed at 1/96 s ---------------------------------------------------

BOOK_W, BOOK_SPP, BOOK_DEPTH, BOOK_SEED = 24, 2, 6, 3


@pytest.mark.parametrize("spheres", [True, False], ids=["spheres_and_camera", "camera"])
def test_bouncing_book1_renders_as_jax(spheres):
    js = bouncing_book1(jdemo, BOOK_W, 1.0 / 96.0, spheres)
    want = np.asarray(jrender.render_image(js, BOOK_SPP, BOOK_DEPTH))
    ts = bouncing_book1(tdemo, BOOK_W, 1.0 / 96.0, spheres)
    sd, cp = ts.build(device="cpu"), ts.scene_cam.params(device="cpu")
    assert sd.motion_exact == spheres and cp.motion_exact
    assert not tint.megakernel_supported(sd, cp)
    assert not tint.megakernel_record_supported(sd, cp)
    # auto: the pixel schedule, with the fused bounce (K9) for the camera alone.
    assert trender.auto_schedule(sd, cp, "cuda") == "pixel"
    assert tint.fused_supported(sd) == (not spheres)
    got = trender.render_image(ts, BOOK_SPP, BOOK_DEPTH, device="cpu").numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(got.mean() - want.mean()) <= 2e-3


@functools.cache
def _book_records(spheres):
    js = bouncing_book1(jdemo, BOOK_W, 1.0 / 96.0, spheres)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    p = w * h
    pix, smp = np.tile(np.arange(p), BOOK_SPP), np.repeat(np.arange(BOOK_SPP), p)
    jpix, jsmp = jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32)
    o, d, _ = jcam.generate_rays(js.scene_cam.params(), w, h, jpix, jsmp, jnp.uint32(BOOK_SEED))
    want = np.asarray(jrep.trace_record(js.build(), o, d, jpix, jsmp, jnp.uint32(BOOK_SEED),
                                        BOOK_DEPTH))
    ts = bouncing_book1(tdemo, BOOK_W, 1.0 / 96.0, spheres)
    sd, cp = ts.build(device="cpu"), ts.scene_cam.params(device="cpu")
    tpix, tsmp = torch.from_numpy(pix), torch.from_numpy(smp)
    to, td, _ = tcam.generate_rays(cp, w, h, tpix, tsmp, BOOK_SEED)
    got = trep.trace_record(sd, to, td, tpix, tsmp, BOOK_SEED, BOOK_DEPTH)
    return sd, cp, (to, td, tpix, tsmp), got, want


@pytest.mark.parametrize("spheres", [True, False], ids=["spheres_and_camera", "camera"])
def test_bouncing_book1_staged_records_match_jax(spheres):
    sd, cp, _, got, want = _book_records(spheres)
    assert trep.resolve_record_mode("auto", sd, cp) == "staged"
    alive, hit = (want & tmk.F_ALIVE) > 0, (want & tmk.F_HIT) > 0
    canon = np.where(alive, np.where(hit, want, tmk.F_ALIVE), 0)  # the port's form
    assert (got.numpy() == canon).all(axis=0).mean() > 0.97
    assert ((got.numpy() & tmk.F_HIT) > 0).any()


def test_exact_lane_chunks_change_no_bit(monkeypatch):
    """The exact branch and the staged record in 512-lane chunks (a budget
    of one chunk's worth) give the one-chunk words and radiance, bit for
    bit: lanes are independent."""
    sd, cp, (o, d, pix, smp), rec, _ = _book_records(True)
    rad = tint.trace(sd, o, d, pix, smp, BOOK_SEED, BOOK_DEPTH)
    assert tint.exact_lanes(sd) >= o.shape[0]
    monkeypatch.setattr(tint, "EXACT_BUDGET_BYTES", 1)
    assert tint.exact_lanes(sd) == 512 and len(tint.exact_chunks(sd, o.shape[0])) == 2
    assert torch.equal(trep.trace_record(sd, o, d, pix, smp, BOOK_SEED, BOOK_DEPTH), rec)
    assert torch.equal(tint.trace(sd, o, d, pix, smp, BOOK_SEED, BOOK_DEPTH), rad)
    assert tint.exact_lanes(tdemo.smoke_scene(width=8).build(device="cpu")) == 1 << 62
    # No radius keyed: the branch reads the radii from the init segments,
    # what eval_scale gives at any time of the shutter, bit for bit.
    from crucible_tpu_torch.models import timeline as ttl

    assert sd.sph_sc_t0.shape[1] == 1
    t = tint.exact_time(sd, tint.shutter_fraction(pix, smp, BOOK_SEED))
    radii = ttl.eval_scale(sd.sph_sc_t0, sd.sph_sc_t1, sd.sph_sc_from, sd.sph_sc_to, t)[..., 0]
    assert torch.equal(radii, sd.sph_sc_from[None, :, 0, 0].expand_as(radii))


def test_movie_with_a_key_inside_a_frame(tmp_path):
    """render_movie renders a frame whose shutter holds a key (frame 0 of a
    smoke scene whose ball and camera are keyed at 1/96 s), the next frame
    on the linear lowering."""
    sc = tdemo.smoke_scene(width=16)
    sc.duration = 2.0 / 24.0
    sc.translate_y(0.3, 1.0 / 96.0, X.LERP, X.LOCAL, "ball")
    sc.cam_translate_y(0.2, 1.0 / 96.0, X.LERP, X.LOCAL, "from")
    sc.scene_cam.set_samples(2)
    sc.scene_cam.set_max_depth(4)
    assert sc.build(device="cpu").motion_exact
    trender.render_movie(sc, str(tmp_path / "clip"), verbose=False, device="cpu")
    frames = sorted((tmp_path / "clip" / "artifacts").glob("image*.ppm"))
    assert len(frames) == 2 and all(f.stat().st_size > 0 for f in frames)
    sc.scene_cam.frame = 1
    assert not sc.build(device="cpu").motion_exact
