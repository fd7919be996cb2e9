"""The port's scene, camera and shading building blocks against the JAX
package, at small sizes, on the same inputs (made with numpy from a seed
or built by both packages from the same demo scene)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu.models import camera as jcam
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import integrator as jint
from crucible_tpu.models import materials as jmat
from crucible_tpu.models import skybox as jsky
from crucible_tpu.models import textures as jtex
from crucible_tpu.ops import sampling as jsampling
from crucible_tpu.utils import color as jcolor
from crucible_tpu.utils import vec as jvec
from crucible_tpu_torch import bridge
from crucible_tpu_torch.models import camera as tcam
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import materials as tmat
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.models import skybox as tsky
from crucible_tpu_torch.models import textures as ttex
from crucible_tpu_torch.ops import sampling as tsampling
from crucible_tpu_torch.utils import angles as tangles
from crucible_tpu_torch.utils import color as tcolor
from crucible_tpu_torch.utils import interval as tinterval
from crucible_tpu_torch.utils import vec as tvec
from tests.torch_threads import one_torch_thread  # noqa: F401

SCENES = ["book1_end_scene", "smoke_scene", "checkered_spheres"]


# --- JAX -> numpy side of the bridge (the port never imports JAX) ---------


def jax_scene_arrays(sd):
    """(arrays, static) of a JAX SceneData, in bridge.scene_data_from_arrays'
    keys."""
    arrays = {k: np.asarray(getattr(sd, k)) for k in bridge.SCENE_ARRAYS}
    arrays.update(
        {f"tex_{k}": np.asarray(getattr(sd.tex, k)) for k in bridge.TEX_ARRAYS}
    )
    arrays.update({k: np.asarray(getattr(sd, k)) for k in bridge.OPTIONAL_ARRAYS
                   if getattr(sd, k) is not None})
    static = {k: getattr(sd, k) for k in bridge.SCENE_STATIC}
    static["max_nest"] = sd.tex.max_nest
    return arrays, static


def jax_camera_arrays(cp):
    return {
        k: np.asarray(getattr(cp, k))
        for k in bridge.CAMERA_ARRAYS
        if getattr(cp, k) is not None
    }


def bridged(jax_scene):
    """The port's (SceneData, CameraParams) on the CPU, carried over from a
    JAX-built scene."""
    arrays, static = jax_scene_arrays(jax_scene.build())
    jcp = jax_scene.scene_cam.params()
    sd = bridge.scene_data_from_arrays(arrays, device="cpu", **static)
    cp = bridge.camera_params_from_arrays(
        jax_camera_arrays(jcp), device="cpu",
        animated=jcp.animated, motion_exact=jcp.motion_exact,
    )
    return sd, cp


def _both(name, width=32):
    return getattr(jdemo, name)(width=width), getattr(tdemo, name)(width=width)


# --- scene build ----------------------------------------------------------------


@pytest.mark.parametrize("name", SCENES)
def test_scene_tables_equal_jax(name):
    js, ts = _both(name)
    want, want_static = jax_scene_arrays(js.build())
    got, got_static = bridge.scene_data_to_arrays(ts.build(device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_static == want_static


@pytest.mark.parametrize("name", SCENES)
def test_bridge_round_trips(name):
    sd = getattr(tdemo, name)(width=32).build(device="cpu")
    arrays, static = bridge.scene_data_to_arrays(sd)
    back = bridge.scene_data_from_arrays(arrays, device="cpu", **static)
    again, again_static = bridge.scene_data_to_arrays(back)
    assert again_static == static
    for k in arrays:
        np.testing.assert_array_equal(again[k], arrays[k], err_msg=k)
    assert back.tex.max_nest == sd.tex.max_nest


def test_bridge_refuses_unknown_static():
    arrays, static = bridge.scene_data_to_arrays(
        tdemo.smoke_scene(width=32).build(device="cpu")
    )
    with pytest.raises(TypeError, match="use_bvh"):
        bridge.scene_data_from_arrays(arrays, device="cpu", use_bvh=True, **static)


@pytest.mark.parametrize("name", SCENES)
def test_make_sphere_table_matches_jax(name):
    js, _ = _both(name)
    sd, _ = bridged(js)
    want = np.asarray(jint.make_sphere_table(js.build()))
    got = tint.make_sphere_table(sd)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_mega_cam_vector_matches_jax(name):
    js, ts = _both(name)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    want = np.asarray(jint.mega_cam_vector(js.scene_cam.params(), w, h))
    got = tint.mega_cam_vector(ts.scene_cam.params(device="cpu"), w, h)
    assert tuple(got.shape) == want.shape == (1, 48)
    # atol 1e-6, plus 1e-6 relative: float32 tan differs by up to 2 ulps
    # between XLA and torch, and viewport_h (slot 31) is ~11.5.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_generate_rays_static_matches_jax(name):
    js, ts = _both(name)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    g = np.random.default_rng(5)
    pix = g.integers(0, w * h, 512).astype(np.int32)
    smp = g.integers(0, 64, 512).astype(np.int32)
    want = jcam.generate_rays(
        js.scene_cam.params(), w, h, jnp.asarray(pix), jnp.asarray(smp), jnp.uint32(3)
    )
    got = tcam.generate_rays(
        ts.scene_cam.params(device="cpu"), w, h,
        torch.from_numpy(pix), torch.from_numpy(smp), 3,
    )
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)


def test_generate_rays_refuses_animated_camera():
    """A linearly animated camera renders (tests/test_torch_motion.py); one
    whose keyframe falls inside the shutter needs exact-time tracks, which
    are not ported."""
    cp = tdemo.smoke_scene(width=32).scene_cam.params(device="cpu")
    cp.animated = cp.motion_exact = True
    with pytest.raises(NotImplementedError, match="exact-time"):
        tcam.generate_rays(cp, 32, 18, torch.zeros(4, dtype=torch.int64),
                           torch.zeros(4, dtype=torch.int64), 0)


# --- shading building blocks ----------------------------------------------------


def test_texture_value_matches_jax():
    js, ts = _both("checkered_spheres")
    g = np.random.default_rng(6)
    jtable = js.build().tex
    ttable = ts.build(device="cpu").tex
    n_tex = int(jtable.kind.shape[0])
    tid = g.integers(0, n_tex, 1000).astype(np.int32)
    p = (g.normal(size=(1000, 3)) * 5).astype(np.float32)
    uv = g.random((2, 1000)).astype(np.float32)
    want = jtex.value(jtable, jnp.asarray(tid), jnp.asarray(uv[0]),
                      jnp.asarray(uv[1]), jnp.asarray(p))
    got = ttex.value(ttable, torch.from_numpy(tid), torch.from_numpy(uv[0]),
                     torch.from_numpy(uv[1]), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_texture_value_refuses_nested_checkers():
    """Checkers nested three levels deep (``nested_checkers``), which the
    port once refused, evaluate as the JAX package's, bit for bit."""
    jtable = jdemo.nested_checkers(width=32).build().tex
    ttable = tdemo.nested_checkers(width=32).build(device="cpu").tex
    assert ttable.max_nest == jtable.max_nest == 3
    g = np.random.default_rng(8)
    tid = g.integers(0, int(jtable.kind.shape[0]), 1000).astype(np.int32)
    p = (g.normal(size=(1000, 3)) * 20).astype(np.float32)
    uv = g.random((2, 1000)).astype(np.float32)
    want = jtex.value(jtable, jnp.asarray(tid), jnp.asarray(uv[0]),
                      jnp.asarray(uv[1]), jnp.asarray(p))
    got = ttex.value(ttable, torch.from_numpy(tid), torch.from_numpy(uv[0]),
                     torch.from_numpy(uv[1]), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_gradient_matches_jax():
    d = np.random.default_rng(7).normal(size=(1000, 3)).astype(np.float32)
    want = jsky.radiance(jsky.DEFAULT, None, jnp.asarray(d))
    got = tsky.radiance(tsky.DEFAULT, None, torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="image"):
        tsky.radiance(tsky.SPHERICAL, None, torch.from_numpy(d))


@pytest.mark.parametrize("mat_type", [0, 1, 2, 3])
def test_scatter_matches_jax(mat_type):
    g = np.random.default_rng(8 + mat_type)
    n = 2000
    normal = g.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d_in = g.normal(size=(n, 3)).astype(np.float32)
    front = (d_in * normal).sum(1) < 0
    normal[~front] *= -1.0  # normals face against the incoming ray
    args = dict(
        mat_type=np.full(n, mat_type, np.int32),
        fuzz=g.uniform(0.0, 0.5, n).astype(np.float32),
        ior=np.full(n, 1.5, np.float32),
        scatter_prob=np.ones(n, np.float32),
        albedo=g.random((n, 3)).astype(np.float32),
        d_in=d_in,
        normal=normal,
        front_face=front,
        u_dir1=g.random(n).astype(np.float32),
        u_dir2=g.random(n).astype(np.float32),
        u_decide=g.random(n).astype(np.float32),
    )
    want = jmat.scatter(**{k: jnp.asarray(v) for k, v in args.items()})
    got = tmat.scatter(**{k: torch.from_numpy(v) for k, v in args.items()})
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)


def test_schlick_matches_jax():
    g = np.random.default_rng(9)
    cos, ri = g.random(1000).astype(np.float32), g.uniform(0.5, 2.0, 1000).astype(np.float32)
    want = jmat.schlick(jnp.asarray(cos), jnp.asarray(ri))
    got = tmat.schlick(torch.from_numpy(cos), torch.from_numpy(ri))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "fn,arity",
    [("dot", 2), ("cross", 2), ("length", 1), ("near_zero", 1), ("reflect", 2),
     ("safe_arccos", 0), ("safe_arcsin", 0), ("safe_arctan2", -2)],
)
def test_vec_helpers_match_jax(fn, arity):
    g = np.random.default_rng(10)
    if arity > 0:
        xs = [g.normal(size=(500, 3)).astype(np.float32) for _ in range(arity)]
        if fn == "near_zero":
            xs[0][::3] *= 1e-9
    elif arity == 0:
        xs = [g.uniform(-1.5, 1.5, 500).astype(np.float32)]
    else:
        xs = [g.normal(size=500).astype(np.float32) for _ in range(2)]
        xs[0][:5] = xs[1][:5] = 0.0
    want = np.asarray(getattr(jvec, fn)(*(jnp.asarray(x) for x in xs)))
    got = getattr(tvec, fn)(*(torch.from_numpy(x) for x in xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unit_and_refract_match_jax():
    g = np.random.default_rng(11)
    v = g.normal(size=(500, 3)).astype(np.float32)
    n = g.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    eta = g.uniform(0.6, 1.6, 500).astype(np.float32)
    want_u = jvec.unit(jnp.asarray(v), eps=1e-20)
    got_u = tvec.unit(torch.from_numpy(v), eps=1e-20)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=0, atol=1e-6)
    want = jvec.refract(want_u, jnp.asarray(n), jnp.asarray(eta))
    got = tvec.refract(got_u, torch.from_numpy(n), torch.from_numpy(eta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fn", ["unit_vector", "in_unit_disk", "square_offset"])
def test_sampling_matches_jax(fn):
    u = np.random.default_rng(12).random((2, 1000)).astype(np.float32)
    want = getattr(jsampling, fn)(jnp.asarray(u[0]), jnp.asarray(u[1]))
    got = getattr(tsampling, fn)(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_color_matches_jax():
    c = np.random.default_rng(13).uniform(-0.5, 1.5, (64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tcolor.to_bytes(torch.from_numpy(c)).numpy(), np.asarray(jcolor.to_bytes(c))
    )
    # XLA's CPU sqrt is not always correctly rounded: allow 2 ulps.
    np.testing.assert_allclose(
        tcolor.linear_to_gamma(torch.from_numpy(c)).numpy(),
        np.asarray(jcolor.linear_to_gamma(c)), rtol=2.4e-7, atol=0,
    )


def test_interval_helpers():
    x = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0])
    lo, hi = torch.tensor(0.0), torch.tensor(1.0)
    assert tinterval.contains(lo, hi, x).tolist() == [False, True, True, True, False]
    assert tinterval.surrounds(lo, hi, x).tolist() == [False, False, True, False, False]
    assert tinterval.clamp(0.0, 1.0, x).tolist() == [0.0, 0.0, 0.5, 1.0, 1.0]
    assert tinterval.proportion(lo, hi, x).tolist() == [-1.0, 0.0, 0.5, 1.0, 2.0]
    step = tinterval.proportion(torch.tensor(0.5), torch.tensor(0.5), x)
    assert step.tolist() == [0.0, 0.0, 1.0, 1.0, 1.0]
    assert tinterval.expand(0.0, 1.0, 1.0) == (-0.5, 1.5)
    assert tinterval.size(2.0, 5.0) == 3.0


def test_angles_round_trip():
    assert tangles.Degrees(180.0).to_radians().get_angle() == pytest.approx(math.pi)
    assert tangles.Radians(math.pi / 2).to_degrees().get_angle() == pytest.approx(90.0)


# --- host-side scene surface ------------------------------------------------------


def test_alias_collision_raises():
    sc = tdemo.smoke_scene(width=32)
    with pytest.raises(ValueError):
        sc.add_element(tscene.Sphere((0.0, 0.0, 0.0), 1.0,
                                     tscene.Lambertian.from_color((1, 1, 1))), "ball")


def test_hide_show_element():
    sc = tdemo.smoke_scene(width=32)
    before = sc.build(device="cpu").sph_active.clone()
    sc.hide_element("ball")
    hidden = sc.build(device="cpu").sph_active
    assert before[0] and not hidden[0] and bool(hidden[1])
    sc.show_element("ball")
    assert torch.equal(sc.build(device="cpu").sph_active, before)
    with pytest.raises(KeyError):
        sc.hide_element("nope")


def test_camera_matches_jax_settings():
    jc, tc = jcam.Camera(image_width=400), tcam.Camera(image_width=400)
    for c in (jc, tc):
        c.set_hfov(70.0)
        c.next_frame()
    assert tc.vfov_deg == pytest.approx(jc.vfov_deg)
    assert tc.get_res() == jc.get_res() and tc.shutter_window() == jc.shutter_window()
