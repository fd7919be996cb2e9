"""The port's native BVH builder (``crucible_tpu_torch/native``): its trees
against the port's Python builder and the JAX package's C++ builder, bit
for bit, on every input the port builds (sphere tables static and swept,
the procedural torus mesh) and on degenerate ones; its routes (the swept
tree's median fallback, ``Scene.build``'s mesh tree); a failed build
raises; ``refit_bounds``; and ``Scene.build``'s vectorized test for a
keyframe inside the shutter against the JAX package's."""

import functools

import numpy as np
import pytest

from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import scene as jscene
from crucible_tpu.ops import bvh as jbvh
from crucible_tpu_torch import native
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops import bvh as tbvh
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests import torch_mesh_scenes as meshes
from tests.torch_motion_scenes import bouncing_stress
from tests.torch_threads import one_torch_thread  # noqa: F401

FIELDS = ("node_min", "node_max", "node_first", "node_count", "node_miss", "node_parent",
          "perm")


def assert_same_tree(got, want, what=""):
    assert got.num_nodes == want.num_nodes, what
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a, b), (what, f)


def _sphere_boxes(sd, swept):
    """The active spheres' boxes as ``megakernel.sphere_bvh_tables`` forms
    them: at shutter open, and with ``swept`` at close too."""
    c = np.asarray(sd.sph_center, np.float64)
    r = np.abs(np.asarray(sd.sph_radius, np.float64))
    lo, hi = c - r[:, None], c + r[:, None]
    if swept:
        c1 = c + np.asarray(sd.sph_center_d, np.float64)
        r1 = np.abs(r + np.asarray(sd.sph_radius_d, np.float64))
        lo, hi = np.minimum(lo, c1 - r1[:, None]), np.maximum(hi, c1 + r1[:, None])
    ids = np.nonzero(np.asarray(sd.sph_active))[0]
    return lo[ids].astype(np.float32), hi[ids].astype(np.float32)


@functools.cache
def boxes(name):
    """(bb_min, bb_max) float32 of the named input."""
    rng = np.random.default_rng(5)
    if name == "n1936_static":
        return _sphere_boxes(jdemo.sphere_stress(width=24, copies=4).build(), False)
    if name == "n1936_swept":
        return _sphere_boxes(bouncing_stress(tdemo, 24, 4).build(device="cpu"), True)
    if name == "torus_6320":
        sd = meshes.torus_teapot(tscene, 32).build(device="cpu")
        v = np.stack([np.asarray(sd.tri_v0), np.asarray(sd.tri_v1), np.asarray(sd.tri_v2)], 1)
        return v.min(axis=1), v.max(axis=1)
    if name == "m1":
        return np.float32([[0, 0, 0]]), np.float32([[1, 2, 3]])
    if name == "coincident":
        half = rng.uniform(0.1, 2.0, (300, 1)).astype(np.float32)
        return -half * np.ones(3, np.float32), half * np.ones(3, np.float32)
    if name == "grid_ties":
        c = rng.integers(0, 4, (500, 3)).astype(np.float32)
        return c - 0.5, c + 0.5
    if name == "duplicates":
        c = np.repeat(rng.normal(size=(64, 3)).astype(np.float32), 7, axis=0)
        return c - 0.1, c + 0.1
    raise KeyError(name)


INPUTS = ("m1", "coincident", "grid_ties", "duplicates", "n1936_static", "n1936_swept",
          "torus_6320")


@pytest.mark.parametrize("leaf", [4, 8, 128])
@pytest.mark.parametrize("method", ["median", "sah"])
@pytest.mark.parametrize("name", INPUTS)
def test_native_tree_equals_the_python_and_jax_trees(name, method, leaf):
    lo, hi = boxes(name)
    got = tbvh.build_bvh(lo, hi, leaf_size=leaf, method=method)
    assert_same_tree(got, tbvh.build_bvh(lo, hi, leaf_size=leaf, method=method,
                                         use_native=False), "python")
    assert_same_tree(got, jbvh.build_bvh(lo, hi, leaf_size=leaf, method=method,
                                         use_native=True), "jax native")


@pytest.mark.parametrize("view", [(1.0, 0.0, 0.0), (-13.0, -10.0, -3.0)])
def test_near_first_reorder_of_the_native_mesh_tree(view):
    """The torus's tree as Scene.build orders it (leaf 4, near-first along
    the view) from either builder, and from the JAX package's."""
    lo, hi = boxes("torus_6320")
    got = tbvh.reorder_front_to_back(tbvh.build_bvh(lo, hi, 4, "sah"), view)
    plain = tbvh.reorder_front_to_back(tbvh.build_bvh(lo, hi, 4, "sah", use_native=False), view)
    want = jbvh.reorder_front_to_back(jbvh.build_bvh(lo, hi, leaf_size=4, method="sah"), view)
    assert_same_tree(got, plain, "python")
    assert_same_tree(got, want, "jax")


@pytest.mark.parametrize("swept", [False, True], ids=["static", "swept"])
def test_swept_tables_take_the_native_builder(swept, monkeypatch):
    """megakernel.swept_tables (K5's and K6's trees) through the native
    builder equals its tables through the Python builder, and so does its
    median fallback past the stack: both builds go native."""
    sc = bouncing_stress(tdemo, 24, 4) if swept else tdemo.sphere_stress(width=24, copies=4)
    sd = sc.build(device="cpu")
    args = [np.asarray(a) for a in (sd.sph_center, sd.sph_radius, sd.sph_active)]
    if swept:
        args += [np.asarray(sd.sph_center_d), np.asarray(sd.sph_radius_d)]
    real = tbvh.build_bvh
    calls = []

    def spy(*a, use_native=True, **kw):
        calls.append((kw["method"], use_native))
        return real(*a, use_native=use_native, **kw)

    def plain(*a, use_native=True, **kw):
        return real(*a, use_native=False, **kw)

    for stack in (tmk.TREE_STACK, 4):  # 4: the SAH tree is deeper, median follows
        monkeypatch.setattr(tmk, "TREE_STACK", stack)
        calls.clear()
        monkeypatch.setattr(tbvh, "build_bvh", spy)
        got = tmk.swept_tables(*args)
        assert calls == ([("sah", True)] if stack > 4 else [("sah", True), ("median", True)])
        monkeypatch.setattr(tbvh, "build_bvh", plain)
        want = tmk.swept_tables(*args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_scene_build_mesh_tree_takes_the_native_builder(monkeypatch):
    """Scene.build's mesh tree is the native one and equals the Python
    builder's (the torus, leaf 4, near-first)."""
    sc = meshes.torus_teapot(tscene, 32)
    got = sc.build(device="cpu", leaf_size=4)
    real = tbvh.build_bvh
    monkeypatch.setattr(tscene, "build_bvh",
                        lambda *a, use_native=True, **kw: real(*a, use_native=False, **kw))
    sc._cache = None
    want = sc.build(device="cpu", leaf_size=4)
    for f in ("tri_v0", "tri_v1", "tri_v2", "tri_mat", "bvh_min", "bvh_max", "bvh_first",
              "bvh_count", "bvh_miss"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and bool((a == b).all()), f


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    lo, hi = boxes("grid_ties")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-g++")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"no-such-g\+\+.*-shared -fPIC"):
            tbvh.build_bvh(lo, hi, 4, "sah")
        assert not any(tmp_path.rglob("*.so"))
    finally:
        native.load.cache_clear()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag",))
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed.*g\\+\\+.*-fno-such-flag"):
            native.load()
        assert not any(tmp_path.rglob("*.so"))
    finally:
        native.load.cache_clear()


def test_the_library_lands_in_the_build_root(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    native.load.cache_clear()
    try:
        native.load()
        path = native.library_path()
        assert path.is_file() and path.parent.parent == tmp_path
    finally:
        native.load.cache_clear()


def test_refit_bounds_matches_jax():
    lo, hi = boxes("torus_6320")
    b = tbvh.build_bvh(lo, hi, 4, "sah")
    shift = np.float32([5.0, -1.0, 0.5])
    got = tbvh.refit_bounds(b, lo + shift, hi + shift)
    want = jbvh.refit_bounds(jbvh.FlatBVH(**{f: getattr(b, f) for f in FIELDS}),
                             lo + shift, hi + shift)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and np.array_equal(a, w)
    np.testing.assert_array_equal(got[0], b.node_min + shift)


def _keyframed(pkg, sphere_key, tri_key):
    """A still scene's shutter frame 0 ([0, 1/48] s) with a sphere and a
    triangle keyframed at the given times (None: not keyframed)."""
    sc = pkg.Scene.new_movie(16.0 / 9.0, 32, 24.0, 180.0, 1.0)
    mat = pkg.Lambertian.from_color((0.5, 0.5, 0.5))
    sc.add_element(pkg.Sphere((0.0, 0.0, -1.0), 0.5, mat), "ball")
    sc.add_element(pkg.Triangle((0, 0, -2), (1, 0, -2), (0, 1, -2), mat), "tri")
    if sphere_key is not None:
        sc.translate_y(0.3, sphere_key, "lerp", "local", "ball")
    if tri_key is not None:
        sc.translate_x(0.2, tri_key, "lerp", "local", "tri")
    return sc


INSIDE, OUTSIDE = 1 / 96, 1.0  # frame 0's shutter is [0, 1/48]


@pytest.mark.parametrize("sphere_key,tri_key", [
    (None, None), (OUTSIDE, None), (None, OUTSIDE), (INSIDE, None), (None, INSIDE),
    (INSIDE, INSIDE), (OUTSIDE, INSIDE)])
def test_mid_shutter_flags_match_jax(sphere_key, tri_key):
    got = _keyframed(tscene, sphere_key, tri_key).build(device="cpu")
    want = _keyframed(jscene, sphere_key, tri_key).build()
    assert got.animated == want.animated == ((sphere_key, tri_key) != (None, None))
    assert got.motion_exact == want.motion_exact == (INSIDE in (sphere_key, tri_key))
    assert got.tri_exact == want.tri_exact == (tri_key == INSIDE)
