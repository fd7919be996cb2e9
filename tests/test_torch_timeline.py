"""The port's keyframe timelines against the JAX package's: the lowering,
the host-side evaluators and the tensor evaluators on seeded random key
sequences (LERP and NERP, local and world keys, every axis), and the
animator surface of the scene and camera."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu.models import timeline as jtl
from crucible_tpu_torch.models import camera as tcam
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.models import timeline as ttl
from tests.torch_threads import one_torch_thread  # noqa: F401

SEEDS = range(8)


def _random_timelines(seed):
    """The same random key sequence authored on a JAX and a port timeline."""
    g = np.random.default_rng(seed)
    init = tuple(g.normal(size=3))
    r0 = float(g.uniform(0.2, 2.0))
    tls = (jtl.TransformTimeline(init_pos=init, init_scale=r0),
           ttl.TransformTimeline(init_pos=init, init_scale=r0))
    for _ in range(int(g.integers(1, 7))):
        kind = g.integers(0, 4)  # x, y, z, point
        key = float(np.round(g.uniform(0.0, 3.0), 2))
        interp = (ttl.LERP, ttl.NERP)[g.integers(0, 2)]
        space = (ttl.LOCAL, ttl.WORLD)[g.integers(0, 2)]
        value = g.normal(size=3) if kind == 3 else float(g.normal())
        for tl in tls:
            name = ("translate_x", "translate_y", "translate_z", "translate_point")[kind]
            getattr(tl, name)(value, key, interp, space)
    for _ in range(int(g.integers(0, 5))):
        kind = g.integers(0, 4)  # x, y, z, uniform
        key = float(np.round(g.uniform(0.0, 3.0), 2))
        interp = (ttl.LERP, ttl.NERP)[g.integers(0, 2)]
        f = float(g.uniform(0.3, 2.5))
        for tl in tls:
            getattr(tl, ("scale_x", "scale_y", "scale_z", "scale_uniform")[kind])(f, key, interp)
    return tls


@pytest.mark.parametrize("seed", SEEDS)
def test_lowering_and_host_evaluation_equal_jax(seed):
    jt, pt = _random_timelines(seed)
    assert pt.animated == jt.animated
    for a, b in zip(pt.lower_translate(), jt.lower_translate()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pt.lower_scale(), jt.lower_scale()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt.boundary_times(), jt.boundary_times())
    times = np.random.default_rng(100 + seed).uniform(-0.2, 3.5, 40)
    times = np.concatenate([times, pt.boundary_times()])
    for t in times:
        np.testing.assert_array_equal(pt.position_at(t), jt.position_at(t))
        np.testing.assert_array_equal(pt.scale_at(t), jt.scale_at(t))


def _padded(seed, n=5):
    """Padded tracks of n random timelines (both packages lower alike)."""
    tls = [_random_timelines(seed * 10 + i)[1] for i in range(n)]
    tr = ttl.pad_tracks([tl.lower_translate() for tl in tls])
    sc = ttl.pad_scale_tracks([tl.lower_scale() for tl in tls])
    init = np.asarray([tl.init_pos for tl in tls], np.float32)
    jtr = jtl.pad_tracks([tl.lower_translate() for tl in tls])
    jsc = jtl.pad_scale_tracks([tl.lower_scale() for tl in tls])
    for a, b in zip(tr + sc, jtr + jsc):
        np.testing.assert_array_equal(a, b)
    return tr, sc, init


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_numpy_batch_evaluators_equal_jax(seed):
    tr, sc, init = _padded(seed)
    for t in np.random.default_rng(seed).uniform(-0.2, 3.5, 12):
        np.testing.assert_array_equal(ttl.eval_translate_np(*tr, init, t),
                                      jtl.eval_translate_np(*tr, init, t))
        np.testing.assert_array_equal(ttl.eval_scale_np(*sc, t), jtl.eval_scale_np(*sc, t))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_tensor_evaluators_match_jax(seed):
    tr, sc, init = _padded(seed)
    t = np.random.default_rng(seed).uniform(-0.2, 3.5, 64).astype(np.float32)
    tt = [torch.from_numpy(a) for a in (*tr, init)]
    jj = [jnp.asarray(a) for a in (*tr, init)]
    # float32 ramps; the K-term sums may add in another order: 1e-6.
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ttl.eval_translate(*tt, torch.from_numpy(t)).numpy(),
                               np.asarray(jtl.eval_translate(*jj, jnp.asarray(t))), **tol)
    np.testing.assert_allclose(ttl.eval_translate(*tt, 0.7).numpy(),
                               np.asarray(jtl.eval_translate(*jj, 0.7)), **tol)
    st = [torch.from_numpy(a) for a in sc]
    sj = [jnp.asarray(a) for a in sc]
    np.testing.assert_allclose(ttl.eval_scale(*st, torch.from_numpy(t)).numpy(),
                               np.asarray(jtl.eval_scale(*sj, jnp.asarray(t))), **tol)
    np.testing.assert_allclose(ttl.eval_scale(*st, 1.3).numpy(),
                               np.asarray(jtl.eval_scale(*sj, 1.3)), **tol)
    # Row-aligned: row i's track at row i's time.
    rows = np.random.default_rng(seed).integers(0, tr[0].shape[0], 64)
    rt = [torch.from_numpy(a[rows]) for a in (*tr, init)]
    rj = [jnp.asarray(a[rows]) for a in (*tr, init)]
    np.testing.assert_allclose(ttl.eval_translate_rows(*rt, torch.from_numpy(t)).numpy(),
                               np.asarray(jtl.eval_translate_rows(*rj, jnp.asarray(t))), **tol)
    srt = [torch.from_numpy(a[rows]) for a in sc]
    srj = [jnp.asarray(a[rows]) for a in sc]
    np.testing.assert_allclose(ttl.eval_scale_rows(*srt, torch.from_numpy(t)).numpy(),
                               np.asarray(jtl.eval_scale_rows(*srj, jnp.asarray(t))), **tol)


def test_documented_fixes_are_kept():
    """scale_y scales the y axis alone (no shear), and scale_point is one
    key per axis, each of which holds."""
    tl = ttl.TransformTimeline(init_scale=1.0)
    tl.scale_y(3.0, 1.0)
    np.testing.assert_array_equal(tl.scale_at(1.0), [1.0, 3.0, 1.0])
    sc = tscene.Scene.new_movie(1.0, 16, 24.0, 180.0, 1.0)
    sc.add_element(tscene.Sphere((0.0, 0.0, 0.0), 1.0,
                                 tscene.Lambertian.from_color((1, 1, 1))), "ball")
    with pytest.raises(TypeError, match="sphere"):
        sc.scale_point((2.0, 3.0, 4.0), 1.0, ttl.LERP, "ball")
    tl = ttl.TransformTimeline()
    for axis, f in zip("xyz", (2.0, 3.0, 4.0)):
        getattr(tl, f"scale_{axis}")(f, 1.0)
    # Most recent wins per evaluation: the z key holds z, x and y reset to 1.
    np.testing.assert_array_equal(tl.scale_at(1.0), [1.0, 1.0, 4.0])


def test_animator_type_checks_and_camera_reset():
    sc = tdemo.smoke_scene(width=16)
    with pytest.raises(TypeError):
        sc.scale_x(2.0, 1.0, ttl.LERP, "ball")  # per-axis scales refuse spheres
    with pytest.raises(TypeError):
        sc.translate_x(1.0, 1.0, ttl.LERP, ttl.LOCAL, "cam")
    with pytest.raises(KeyError):
        sc.translate_y(1.0, 1.0, ttl.LERP, ttl.LOCAL, "nope")
    with pytest.raises(KeyError):
        sc.cam_translate_x(1.0, 1.0, ttl.LERP, ttl.LOCAL, "up")
    assert not sc.is_animated
    sc.scale_r(0.25, 1.0, ttl.LERP, "ball")
    assert sc.is_animated
    cam = sc.scene_cam
    sc.cam_translate_z(1.0, 1.0, ttl.LERP, ttl.LOCAL, "from")
    sc.cam_translate_z(1.0, 1.0, ttl.LERP, ttl.LOCAL, "at")
    assert cam.params(device="cpu").animated
    cam.look_from((0.0, 0.0, 5.0))
    cam.look_at((0.0, 0.0, 0.0))
    assert cam.from_timeline is None and cam.at_timeline is None
    assert not cam.params(device="cpu").animated
    assert isinstance(cam, tcam.Camera)
