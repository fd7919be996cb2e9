"""The motion slice against the JAX package on the CPU: the linear-shutter
scene and camera lowering, the animated camera's rays, the moving-sphere
closest hit, the sphere table's motion columns, the plain K8 (the
megakernel's motion variants) against the JAX megakernel in interpret
mode, the pixel schedule with moving spheres, and the movie driver; and
what still raises (moving_teapot, a moving scene without shutter
fractions) beside what no longer does (exact-time motion renders and
differentiates, tests/test_torch_exact.py)."""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import integrator as jint
from crucible_tpu.models import render as jrender
from crucible_tpu.models import scene as jscene
from crucible_tpu.models.camera import generate_rays as jgenerate_rays
from crucible_tpu.ops import intersect as jintersect
from crucible_tpu_torch import bridge, grad
from crucible_tpu_torch.io.image import write_ppm
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.models.camera import generate_rays
from crucible_tpu_torch.ops import intersect as tintersect
from tests.test_torch_scene import bridged, jax_camera_arrays, jax_scene_arrays
from tests.torch_motion_scenes import LERP, LOCAL, bouncing_book1
from tests.torch_threads import one_torch_thread  # noqa: F401

WORLD = "world"


def _mid_shutter(pkg_scene):
    """Smoke's ball keyframed inside frame 0's shutter [0, 1/48]."""
    sc = pkg_scene.Scene.new_image(16.0 / 9.0, 32)
    sc.scene_cam.look_from((0.0, 0.5, 3.0))
    sc.scene_cam.look_at((0.0, 0.0, -1.0))
    sc.add_element(pkg_scene.Sphere((0.0, 0.0, -1.0), 0.5,
                                    pkg_scene.Lambertian.from_color((0.7, 0.3, 0.3))), "ball")
    sc.translate_y(1.0, 1.0 / 96.0, LERP, LOCAL, "ball")
    sc.scale_r(0.7, 1.0 / 48.0, LERP, "ball")
    sc.cam_translate_x(0.3, 1.0 / 96.0, LERP, LOCAL, "at")
    return sc


def _lambertian_walk(pkg_scene):
    """tests/test_integrator.py's keyframed-camera scene (lambertian only,
    defocus), at frame 24: the camera moves within this frame's shutter."""
    sc = pkg_scene.Scene.new_movie(16.0 / 9.0, 64, 24.0, 180.0, 2.0)
    cam = sc.scene_cam
    cam.look_from((0.0, 1.0, -8.0))
    cam.look_at((0.0, 0.5, 0.0))
    cam.set_vfov(40.0)
    cam.set_defocus_angle(0.5)
    cam.set_focus_dist(8.0)
    sc.add_element(pkg_scene.Sphere((0.0, -100.0, 0.0), 100.0,
                                    pkg_scene.Lambertian.from_color((0.5, 0.7, 0.3))), "ground")
    sc.add_element(pkg_scene.Sphere((0.0, 1.0, 0.0), 1.0,
                                    pkg_scene.Lambertian.from_color((0.9, 0.3, 0.2))), "ball")
    sc.cam_translate_point((6.0, 2.0, -6.0), 2.0, LERP, WORLD, "from")
    cam.frame = 24
    return sc


CASES = {
    "bouncing_f0": lambda m: (bouncing_book1(m.demo, 32), 0),
    "bouncing_f1": lambda m: (bouncing_book1(m.demo, 32), 1),
    "first_movie_f0": lambda m: (m.demo.first_movie(), 0),
    "first_movie_f59": lambda m: (m.demo.first_movie(), 59),
    "first_movie_f60": lambda m: (m.demo.first_movie(), 60),
    "mid_shutter": lambda m: (_mid_shutter(m.scene), 0),
}


class _Pkg:
    def __init__(self, demo, scene):
        self.demo, self.scene = demo, scene


JAX, PORT = _Pkg(jdemo, jscene), _Pkg(tdemo, tscene)


def _both(case):
    (js, frame), (ts, _) = CASES[case](JAX), CASES[case](PORT)
    js.scene_cam.frame = ts.scene_cam.frame = frame
    return js, ts


@pytest.mark.parametrize("case", list(CASES))
def test_build_and_camera_params_equal_jax(case):
    js, ts = _both(case)
    want, want_static = jax_scene_arrays(js.build())
    got, got_static = bridge.scene_data_to_arrays(ts.build(device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_static == want_static
    jcp, tcp = js.scene_cam.params(), ts.scene_cam.params(device="cpu")
    assert (tcp.animated, tcp.motion_exact) == (jcp.animated, jcp.motion_exact)
    for k, v in jax_camera_arrays(jcp).items():
        np.testing.assert_array_equal(getattr(tcp, k).numpy(), v, err_msg=k)
    expect = {  # (scene animated, exact, camera animated, exact, mega)
        "bouncing_f0": (True, False, True, False, True),
        "bouncing_f1": (True, False, True, False, True),
        "first_movie_f0": (False, False, True, False, False),
        "first_movie_f59": (False, False, True, False, False),
        "first_movie_f60": (False, False, True, False, False),
        "mid_shutter": (True, True, True, True, False),
    }[case]
    sd = ts.build(device="cpu")
    assert (sd.animated, sd.motion_exact, tcp.animated, tcp.motion_exact,
            tint.megakernel_supported(sd, tcp)) == expect


def test_build_cache_is_keyed_by_the_shutter_window():
    """A movie renders each frame's geometry: the build cache holds one
    shutter window, and frame 1 of bouncing book1 is past its keyframe."""
    sc = bouncing_book1(tdemo, 32)
    sd0 = sc.build(device="cpu")
    assert sc.build(device="cpu") is sd0
    assert float(sd0.sph_center_d.abs().max()) > 0.05
    sc.scene_cam.frame = 1
    sd1 = sc.build(device="cpu")
    assert sd1 is not sd0 and float(sd1.sph_center_d.abs().max()) == 0.0
    assert not torch.equal(sd1.sph_center, sd0.sph_center)
    explicit = sc.build(0.0, 1.0 / 48.0, device="cpu")
    assert torch.equal(explicit.sph_center_d, sd0.sph_center_d)


def test_animated_generate_rays_match_jax():
    js, ts = _both("bouncing_f0")
    g = np.random.default_rng(21)
    pix = g.integers(0, 32 * 18, 2048).astype(np.int32)
    smp = g.integers(0, 64, 2048).astype(np.int32)
    want = jgenerate_rays(js.scene_cam.params(), 32, 18, jnp.asarray(pix),
                          jnp.asarray(smp), jnp.uint32(3))
    got = generate_rays(ts.scene_cam.params(device="cpu"), 32, 18,
                        torch.from_numpy(pix), torch.from_numpy(smp), 3)
    # atol and rtol 1e-6: float32 tan differs by up to 2 ulps between XLA
    # and torch, and the per-ray basis carries it.
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)


def test_hit_spheres_moving_matches_jax():
    js, _ = _both("bouncing_f0")
    sd, _ = bridged(js)
    g = np.random.default_rng(22)
    n = 4096
    o = np.stack([g.uniform(-15, 15, n), g.uniform(0.5, 5.0, n), g.uniform(-15, 15, n)], 1)
    target = np.stack([g.uniform(-11, 11, n), g.uniform(0.0, 1.2, n), g.uniform(-11, 11, n)], 1)
    o, d = o.astype(np.float32), (target - o).astype(np.float32)
    w = g.random(n).astype(np.float32)
    geom = [sd.sph_center, sd.sph_center_d, sd.sph_radius, sd.sph_radius_d]
    t, idx, hit = tintersect.hit_spheres_moving(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(w), *geom,
        sd.sph_active, tint.T_MIN)
    jt, jidx, jhit = jintersect.hit_spheres_moving(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(w),
        *(jnp.asarray(x.numpy()) for x in geom), jnp.asarray(sd.sph_active.numpy()),
        tint.T_MIN, jnp.inf)
    jt, jidx, jhit = np.asarray(jt), np.asarray(jidx), np.asarray(jhit)
    same = (idx.numpy() == jidx) & (hit.numpy() == jhit)
    assert same.mean() >= 0.999 and hit.numpy().mean() > 0.5
    both = same & jhit
    # rtol 1e-5 plus atol 1e-4: the expanded quadratic cancels on the
    # radius-1000 ground (ROADMAP fault C6).
    np.testing.assert_allclose(t.numpy()[both], jt[both], rtol=1e-5, atol=1e-4)


def test_make_sphere_table_motion_columns_match_jax():
    js, _ = _both("bouncing_f0")
    sd, _ = bridged(js)
    want = np.asarray(jint.make_sphere_table(js.build()))
    got = tint.make_sphere_table(sd).numpy()
    assert np.abs(want[:, 24:27]).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _jax_mega(js, w, h, spp, depth):
    return np.asarray(jint.trace_persistent_mega(
        js.build(), js.scene_cam.params(), w, h, jnp.uint32(spp), depth, jnp.uint32(0),
        interpret=True))


def test_plain_k8_matches_jax_on_the_lambertian_camera_walk():
    js = _lambertian_walk(jscene)
    sd, cp = bridged(js)
    assert cp.animated and not sd.animated and tint.megakernel_supported(sd, cp)
    got = tint.trace_persistent_mega(sd, cp, 64, 36, 4, 6, 0).numpy()
    d = np.abs(got - _jax_mega(js, 64, 36, 4, 6))
    # The bounds of tests/test_integrator.py's own camera-walk test: the
    # quadratic's rounding flips hits exactly on silhouettes.
    assert (d > 1e-4).mean() < 0.005, d.max()
    assert d.mean() < 1e-3


def test_plain_k8_matches_jax_on_bouncing_book1():
    js, _ = _both("bouncing_f0")
    sd, cp = bridged(js)
    want = _jax_mega(js, 32, 18, 2, 8) / 2
    got = tint.trace_persistent_mega(sd, cp, 32, 18, 2, 8, 0).numpy() / 2
    # Fault C6's statistical bounds, as for static book1.
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(got.mean() - want.mean()) <= 2e-3


def test_pixel_schedule_with_moving_spheres_matches_jax():
    js, _ = _both("bouncing_f0")
    sd, cp = bridged(js)
    want = np.asarray(jint.trace_persistent(
        js.build(), js.scene_cam.params(), 32, 18, 2, 8, jnp.uint32(0), lanes=512,
        use_pallas=False)) / 2
    got = tint.trace_persistent(sd, cp, 32, 18, 2, 8, 0, lanes=512).numpy() / 2
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(got.mean() - want.mean()) <= 2e-3
    # The port's two schedules on the same moving scene.
    mega = tint.trace_persistent_mega(sd, cp, 32, 18, 2, 8, 0).numpy() / 2
    assert np.isclose(got, mega, rtol=1e-3, atol=1e-3).mean() > 0.97


def _small_first_movie(pkg_demo, frames):
    sc = pkg_demo.first_movie(duration=frames / 24.0)
    sc.scene_cam.image_width = 32
    sc.scene_cam.set_samples(2)
    return sc


def test_render_movie_frames_skip_and_on_frame(tmp_path):
    sc = _small_first_movie(tdemo, 3)
    fired = []
    out = trender.render_movie(sc, str(tmp_path / "m"), verbose=False,
                               on_frame=lambda fi, dt: fired.append(fi), device="cpu")
    art = tmp_path / "m" / "artifacts"
    names = sorted(p.name for p in art.iterdir())
    assert names == ["image000.ppm", "image001.ppm", "image002.ppm"]
    assert sorted(fired) == [0, 1, 2]
    assert out == (art if shutil.which("ffmpeg") is None else tmp_path / "m" / "m.mp4")
    stamp = (art / "image001.ppm").stat().st_mtime_ns
    (art / "image002.ppm").unlink()
    fired.clear()
    trender.render_movie(sc, str(tmp_path / "m"), skip_existing=True, verbose=False,
                         on_frame=lambda fi, dt: fired.append(fi), device="cpu")
    assert fired == [2] and (art / "image002.ppm").exists()
    assert (art / "image001.ppm").stat().st_mtime_ns == stamp


def test_first_movie_frame_matches_jax(tmp_path):
    """Frame 1 of a 32-wide first_movie: render_movie's PPM is the port's
    image, which matches the JAX package's frame (pixel schedule)."""
    ts, js = _small_first_movie(tdemo, 2), _small_first_movie(jdemo, 2)
    trender.render_movie(ts, str(tmp_path / "f"), verbose=False, device="cpu")
    js.scene_cam.frame = ts.scene_cam.frame = 1
    got = trender.render_image(ts, device="cpu")
    write_ppm(tmp_path / "again.ppm", trender.to_u8(got))
    assert (tmp_path / "again.ppm").read_bytes() == (
        tmp_path / "f" / "artifacts" / "image001.ppm").read_bytes()
    want = np.asarray(jrender.render_image_persistent(
        js.build(), js.scene_cam.params(), 32, 18, 2, 5, 0, schedule="pixel"))
    assert np.isclose(got.numpy(), want, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(got.numpy().mean() - want.mean()) <= 2e-3


def test_movie_helpers(tmp_path, monkeypatch):
    assert trender.compute_frame_count(2 / 24, 24.0) == 2
    assert trender.compute_frame_count(0.25, 24.0) == 6
    assert trender.compute_frame_count(15.0, 24.0) == 360
    monkeypatch.setattr(trender.shutil, "which", lambda name: None)
    assert trender.make_mp4(tmp_path, tmp_path / "x.mp4", 24.0, 3) == tmp_path
    img = trender.render_image_to_file(tdemo.smoke_scene(width=16), str(tmp_path / "s"),
                                       device="cpu")
    assert img.shape == (9, 16, 3) and (tmp_path / "s.ppm").exists()
    with pytest.raises(ValueError, match="movie"):
        trender.render_movie(tdemo.smoke_scene(width=16), str(tmp_path / "n"), device="cpu")


@pytest.mark.parametrize(
    "call",
    [
        lambda sc: sc.build(),
        lambda sc: sc.scene_cam.params(),
        lambda sc: trender.render_movie(sc, "unused"),
    ],
    ids=["scene_build", "camera_params", "render_movie"],
)
def test_motion_entry_points_default_to_cuda(call, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works here")
    monkeypatch.chdir(tmp_path)
    sc = bouncing_book1(tdemo, 16)
    sc.duration = 1 / 24
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        call(sc)


def test_what_still_raises():
    sc = _mid_shutter(tscene)
    assert bool(torch.isfinite(trender.render_image(sc, 1, 2, device="cpu")).all())
    sd = sc.build(device="cpu")
    assert sd.motion_exact
    hit = tint.intersect_scene(sd, torch.zeros(1, 3), torch.ones(1, 3), torch.zeros(1))
    assert bool(torch.isfinite(hit["t"]).all())
    with pytest.raises(FileNotFoundError, match="teapot.obj"):  # fault C1
        tdemo.MOVIE_WORLDS[2]()
    moving = bouncing_book1(tdemo, 16)
    msd, mcp = moving.build(device="cpu"), moving.scene_cam.params(device="cpu")
    with pytest.raises(ValueError, match="shutter"):
        tint.intersect_scene(msd, torch.zeros(1, 3), torch.ones(1, 3))
    # Linear motion differentiates (K8's record, the eager replay), and so
    # does exact time (the staged record, the eager replay).
    assert tint.megakernel_record_supported(msd, mcp)
    cp = sc.scene_cam.params(device="cpu")
    assert not tint.megakernel_record_supported(sd, cp)
    loss, _ = grad.loss_and_grad(grad.extract_params(sd, cp), sd, cp, torch.zeros(32 * 18, 3),
                                 torch.arange(32 * 18), 0, width=32, height=18, spp=1,
                                 max_depth=2)
    assert math.isfinite(float(loss))
    assert math.isfinite(float(trender.render_image(moving, 1, 2, device="cpu").mean()))
