"""Sharded renders and gradients (ROADMAP A9, ``crucible_tpu_torch/parallel``)
in one process on the CPU: eight grid positions on one device. The band
render bit for bit against one dispatch (an odd height: the last band is
short, its tail lanes never issue), the pixel-sharded staged render against
``integrator.render_rays``, ``loss_and_grad_sharded`` over eight shards
against one call (the JAX package's ``tests/test_parallel.py`` case), the
band render against the JAX package's ``render_image_sharded_mega`` on
conftest's eight virtual CPU devices at fault C6's bounds, the mesh's axes
and ranges, and ``initialize_distributed`` as a no-op. Two processes over
``gloo``: ``tests/test_torch_distributed.py``."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from crucible_tpu.models import demo as jdemo
from crucible_tpu.parallel import mesh as jmesh
from crucible_tpu.parallel import render as jprender
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from crucible_tpu_torch.parallel import mesh as pmesh
from crucible_tpu_torch.parallel import render as prender
from tests import torch_mesh_scenes as meshes
from tests.torch_threads import one_torch_thread  # noqa: F401

EIGHT = ["cpu"] * 8


def _mesh(n=8, sp=1):
    return pmesh.make_mesh(n, sample_parallel=sp, devices=["cpu"] * n)


def test_mesh_axes_and_ranges():
    mesh = _mesh(8, sp=2)
    assert mesh.shape == {"dp": 4, "sp": 2} and mesh.size == 8
    assert mesh.axis_names == (pmesh.DP_AXIS, pmesh.SP_AXIS) == ("dp", "sp")
    assert mesh.world == 1 and not mesh.group and list(mesh.local_positions()) == list(range(8))
    assert mesh.device(5) == torch.device("cpu")
    assert pmesh.make_mesh(3, devices=EIGHT).size == 3
    with pytest.raises(ValueError, match="sample_parallel"):
        pmesh.make_mesh(6, sample_parallel=4, devices=EIGHT)
    # A flat axis over every position: ceil(n / 8) each, the last ones short.
    assert pmesh.ray_sharding(mesh, 21) == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 15),
                                            (15, 18), (18, 21), (21, 21)]
    assert pmesh.ray_sharding(mesh, 16) == [(2 * i, 2 * i + 2) for i in range(8)]


def test_make_mesh_without_cuda_names_the_devices(monkeypatch):
    """Without a process group the default grid is the local CUDA devices:
    with none, it raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()


def test_initialize_distributed_is_a_no_op_for_one_process():
    for n in (None, 0, 1):
        pmesh.initialize_distributed("127.0.0.1:1", n, 0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("name,width,n", [("book1_end_scene", 42, 8), ("smoke_scene", 32, 8),
                                          ("book1_end_scene", 42, 5)],
                         ids=["book1_8_bands", "smoke_8_bands", "book1_5_bands"])
def test_bands_equal_one_dispatch(name, width, n):
    """book1 42 wide is 23 rows: 8 bands of 3 (the last of 2, one row past
    the image), or 5 bands of 5 (the last of 3); each band one launch of the
    megakernel's plain version, the image the same bits as one dispatch."""
    sc = getattr(tdemo, name)(width=width)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    want = trender.render_image_persistent(sd, cp, w, h, 2, 6, sc.seed, device="cpu")
    got = prender.render_image_sharded_mega(sc, _mesh(n), samples=2, max_depth=6)
    assert got.shape == (h, w, 3) and torch.equal(got, want)
    if name == "book1_end_scene":
        assert h % n  # the last band is short


def test_bands_of_a_mesh_beside_a_tree():
    """Each band walks the table's tree and then the mesh's (K5 + K7), as the
    one-dispatch render does."""
    sc = meshes.torus_beside_stress(tdemo, tscene, 16, nu=8, nv=6)  # 96 triangles: a BVH
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    tmk.WALK_COUNTS.update(nodes=0)
    got = prender.render_image_sharded_mega(sc, _mesh(4), samples=1, max_depth=3)
    assert tmk.WALK_COUNTS["nodes"] > 0
    assert torch.equal(got, trender.render_image_persistent(sd, cp, w, h, 1, 3, sc.seed,
                                                            device="cpu"))


def test_band_inputs():
    """A band's lanes carry the image's pixel ids; lanes past the band or
    the image carry sample0 = 2**30 and never issue."""
    sc = tdemo.smoke_scene(width=40)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    w, h = 40, sc.scene_cam.image_height
    inputs, lane_of = tint.mega_inputs(sd, cp, w, h, 2, 4, 0, row0=h - 3, band_height=5)
    pix, s0 = inputs["pix"][0].long(), inputs["sample0"][0]
    live = s0 < tmk.NO_SAMPLE
    assert int(live.sum()) == 3 * w and lane_of.shape == (5 * w,)
    assert torch.equal(pix[lane_of[:3 * w]], torch.arange((h - 3) * w, h * w))
    assert not live[lane_of[3 * w:]].any()  # the band's rows past the image
    with pytest.raises(ValueError, match="band"):
        tint.mega_inputs(sd, cp, w, h, 2, 4, 0, row0=0, band_height=0)


def test_unsupported_scene_names_the_staged_render():
    """A scene the megakernel does not render raises, naming
    render_image_sharded, which renders it (no fallback, no warning)."""
    sc = meshes.box(tscene, 16)  # 12 triangles, no BVH
    with pytest.raises(NotImplementedError, match="render_image_sharded"):
        prender.render_image_sharded_mega(sc, _mesh(2), samples=1, max_depth=2)
    img = prender.render_image_sharded(sc, _mesh(3), samples=1, max_depth=2)
    assert img.shape == (9, 16, 3) and torch.isfinite(img).all()


def test_pixel_shards_equal_render_rays():
    """Pixel shards padded with the last pixel id (23 x 42 = 966 pixels
    over 8 shards of 121), each through integrator.render_rays (K10's plain
    version), averaged over the samples: bit for bit the whole batch."""
    sc = tdemo.book1_end_scene(width=42)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    p = w * h
    want = tint.render_rays(sd, cp, w, h, torch.arange(p).repeat(2),
                            torch.arange(2).repeat_interleave(p), sc.seed, 4)
    want = want.reshape(2, p, 3).mean(dim=0).reshape(h, w, 3)
    got = prender.render_image_sharded(sc, _mesh(8), samples=2, max_depth=4)
    assert torch.equal(got, want)


def test_sharded_gradients_match_one_call():
    """loss_and_grad_sharded over 8 pixel shards (each shard's loss and
    gradients weighted by its share of the pixels and summed) against one
    loss_and_grad: the smoke scene 32 x 18, 2 spp, depth 3, as the JAX
    package's test holds its psum: loss rel 1e-6, gradients rtol 1e-5, atol
    1e-8 (camera leaves included)."""
    sc = tdemo.smoke_scene(width=32)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    kw = dict(width=w, height=h, spp=2, max_depth=3)
    params = G.extract_params(sd, cp)
    args = (torch.zeros((w * h, 3)), torch.arange(w * h), 0)
    want_l, want_g = G.loss_and_grad(params, sd, cp, *args, **kw)
    got_l, got_g = prender.loss_and_grad_sharded(params, sd, cp, *args, mesh=_mesh(8), **kw)
    assert abs(float(got_l) - float(want_l)) <= 1e-6 * abs(float(want_l))
    assert got_g.keys() == want_g.keys() and got_g["sky_image"] is None
    for key, leaf in G.leaves(want_g).items():
        torch.testing.assert_close(G.leaves(got_g)[key], leaf, rtol=1e-5, atol=1e-8,
                                   msg=key)
    # One position is one call.
    one_l, one_g = prender.loss_and_grad_sharded(params, sd, cp, *args, mesh=_mesh(1), **kw)
    assert torch.equal(one_l, want_l) and torch.equal(one_g["tex_color"], want_g["tex_color"])


@functools.cache
def _jax_bands(width=32, spp=2, depth=4):
    js = jdemo.smoke_scene(width=width)
    return np.asarray(jprender.render_image_sharded_mega(
        js, jmesh.make_mesh(8), samples=spp, max_depth=depth, seed=0))


def test_bands_match_jax():
    """The JAX package's band render (shard_map over 8 virtual CPU devices,
    its megakernel in interpret mode) against the port's 8 bands: C6's
    bounds, isclose > 0.97 and means within 2e-3."""
    want = _jax_bands()
    sc = tdemo.smoke_scene(width=32)
    got = prender.render_image_sharded_mega(sc, _mesh(8), samples=2, max_depth=4, seed=0)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(got.mean() - want.mean()) <= 2e-3
