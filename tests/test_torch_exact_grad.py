"""Gradients of exact-time motion (a keyframe strictly inside the shutter)
in crucible_tpu_torch, on the CPU:

- ``render_rays_replay`` (the staged record, then the eager replay with the
  winners' spheres and vertices re-derived at each path's time) against
  ``render_rays`` on the JAX package's emissive cases: rtol 1e-5, atol
  1e-6 (its ``test_exact_mesh_replay``);
- ``loss_and_grad`` (replay and ``method="ad"``) against the JAX package's
  on bouncing book1 keyed at 1/96 s, spheres and camera and the camera
  alone: loss rel 2e-3, radiometric leaves normalized 5e-3 (fault C6's
  bounds) -- the replays on the JAX package's records, direct AD against
  the JAX package's where C6 lets the two packages' decisions agree that
  far (spheres and camera), and against the port's own replay; every leaf
  on a smoke-sized scene (fault C4), where the camera's position and
  target come out zero in both packages under a camera track;
- the deep path (depth 16: two-level staged record, depth buckets; the
  camera alone replays through K4 / K3's plain versions) against
  ``grad_split=False``: loss rel 1e-5, radiometric gradients normalized
  1e-4;
- ``loss_and_grad_accum`` against its chunks, and ``render_image_sharded``
  over 8 CPU positions against one ``render_rays`` call, bit for bit; the
  record schedule (the staged record for an exact scene) against
  ``render_rays``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops.kernels import replay_kernel as trk
from crucible_tpu_torch.parallel import mesh as pmesh
from crucible_tpu_torch.parallel import render as prender
from tests import torch_exact_scenes as X
from tests.test_torch_scene import bridged
from tests.torch_motion_scenes import bouncing_book1
from tests.torch_threads import one_torch_thread  # noqa: F401

KEY = 1.0 / 96.0  # inside frame 0's shutter [0, 1/48)


@pytest.mark.parametrize("name", ["flash", "triangle_wall", "bvh_wall"])
def test_replay_matches_the_staged_bounce(name):
    sc, _, _ = X.CASES[name](tscene)
    sd, cp = sc.build(leaf_size=4, device="cpu"), sc.scene_cam.params(device="cpu")
    assert sd.motion_exact and trep.resolve_record_mode("auto", sd, cp) == "staged"
    w = h = 8
    p, spp, depth, seed = w * h, 4, 4, 2
    pix, smp = torch.arange(p).repeat(spp), torch.arange(spp).repeat_interleave(p)
    ref = tint.render_rays(sd, cp, w, h, pix, smp, seed, depth)
    rep = trep.render_rays_replay(sd, cp, w, h, pix, smp, seed, depth)
    np.testing.assert_allclose(rep.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def test_record_schedule_takes_exact_scenes():
    """The record schedule, asked by name (auto takes pixel), records an
    exact scene staged and replays it: the flash's image is its
    render_rays mean (rtol 1e-5, atol 1e-6)."""
    from crucible_tpu_torch.models import render as trender

    sc, _, _ = X.flash(tscene)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    img = trender.render_image_persistent(sd, cp, 8, 8, 4, 4, 2, device="cpu",
                                          schedule="record")
    pix, smp = torch.arange(64).repeat(4), torch.arange(4).repeat_interleave(64)
    want = tint.render_rays(sd, cp, 8, 8, pix, smp, 2, 4).reshape(4, 64, 3).mean(dim=0)
    np.testing.assert_allclose(img.reshape(64, 3).numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def _smoke(demo):
    """Smoke with its ball and its camera keyed at 1/96 s."""
    sc = demo.smoke_scene(width=24)
    sc.translate_y(0.3, KEY, X.LERP, X.LOCAL, "ball")
    sc.cam_translate_y(0.5, KEY, X.LERP, X.LOCAL, "from")
    return sc


SCENES = {
    "bouncing_book1": lambda demo: bouncing_book1(demo, 32, KEY),
    "bouncing_camera": lambda demo: bouncing_book1(demo, 32, KEY, spheres=False),
    "smoke": _smoke,
}


@functools.cache
def _both(name, method, shared_records=False, spp=2, depth=8, seed=3):
    """(JAX (loss, grads), the port's (loss, grads)) of ``loss_and_grad``
    on the same scene and lanes (the port's scene bridged from the JAX
    lowering). ``shared_records``: both replay the JAX package's decision
    records (``record_decisions``), so that no grazing hit decided by the
    last ulp (fault C6) parts them."""
    js = SCENES[name](jdemo)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    jsd, jcp = js.build(), js.scene_cam.params()
    kw = dict(width=w, height=h, spp=spp, max_depth=depth, method=method)
    jpix = jnp.arange(w * h, dtype=jnp.uint32)
    rec = None
    if shared_records:
        rec = JG.record_decisions(jsd, jcp, jpix, jnp.uint32(seed), width=w, height=h, spp=spp,
                                  max_depth=depth)
    jl, jg = JG.loss_and_grad(JG.extract_params(jsd, jcp), jsd, jcp, jnp.zeros((w * h, 3)),
                              jpix, jnp.uint32(seed), rec=rec, **kw)
    sd, cp = bridged(js)
    assert cp.motion_exact and sd.motion_exact == (name != "bouncing_camera")
    params = bridge.params_from_arrays(
        {k: np.asarray(v) for k, v in JG.extract_params(jsd, jcp).items()
         if k in G.TENSOR_KEYS}, device="cpu")
    trec = None if rec is None else torch.from_numpy(np.array(rec))
    tl, tg = G.loss_and_grad(params, sd, cp, torch.zeros((w * h, 3)), torch.arange(w * h),
                             seed, rec=trec, **kw)
    return (float(jl), jg), (float(tl), tg)


def _close(key, got, want, atol=5e-3):
    a, b = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(b).max()), 1e-6)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol, err_msg=key)


def _radiometric_close(got, want):
    """Loss rel 2e-3, radiometric leaves normalized 5e-3 (fault C4)."""
    (jl, jg), (tl, tg) = want, got
    assert tl == pytest.approx(jl, rel=2e-3)
    for key in ("mat_emission", "tex_color"):
        assert float(tg[key].abs().max()) > 0, key
        _close(key, tg[key].numpy(), jg[key])


@pytest.mark.parametrize("name", ["bouncing_book1", "bouncing_camera"])
def test_replay_matches_jax_on_the_same_records(name):
    want, got = _both(name, "replay", shared_records=True)
    _radiometric_close(got, want)


def test_direct_ad_matches_jax_on_bouncing_book1():
    want, got = _both("bouncing_book1", "ad")
    _radiometric_close(got, want)


def test_direct_ad_matches_the_replay_under_the_camera_alone():
    """The port's direct AD against its own replay (record and bounce take
    the same decisions) at the JAX package's bound between the two. With
    the replay held to the JAX replay on shared records, this holds the
    direct AD of the camera alone to the JAX package's: directly, the two
    packages' direct AD part by C6 at this size, as they do on the linearly
    moving camera (loss rel 2.6e-3)."""
    sc = SCENES["bouncing_camera"](tdemo)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    params = G.extract_params(sd, cp)
    args = (torch.zeros((w * h, 3)), torch.arange(w * h), 3)
    kw = dict(width=w, height=h, spp=2, max_depth=8)
    replay = G.loss_and_grad(params, sd, cp, *args, method="replay", **kw)
    ad = G.loss_and_grad(params, sd, cp, *args, method="ad", **kw)
    _radiometric_close((float(ad[0]), ad[1]), (float(replay[0]), replay[1]))


@pytest.mark.parametrize("method", ["replay", "ad"])
def test_every_leaf_matches_jax_on_smoke(method):
    (jl, jg), (tl, tg) = _both("smoke", method)
    assert tl == pytest.approx(jl, rel=2e-3)
    for key in G.TENSOR_KEYS:
        _close(key, tg[key].numpy(), jg[key])
    # Under a camera track the rays do not read look_from / look_at.
    for key in ("cam_look_from", "cam_look_at"):
        assert not tg[key].any() and not np.asarray(jg[key]).any(), key
    assert float(tg["cam_vfov"].abs()) > 0


@pytest.mark.parametrize("name", ["bouncing_book1", "bouncing_camera"])
def test_deep_path_matches_unsplit(name, monkeypatch):
    sc = SCENES[name](tdemo)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    params = G.extract_params(sd, cp)
    args = (torch.zeros((w * h, 3)), torch.arange(w * h), 0)
    kw = dict(width=w, height=h, spp=2, max_depth=16)
    calls = []
    real = trk.trace_replay_mega
    monkeypatch.setattr(trk, "trace_replay_mega", lambda *a, **k: calls.append(1) or real(*a, **k))
    split_loss, split_g = G.loss_and_grad(params, sd, cp, *args, **kw)
    # The camera alone keeps a static table: K4 / K3 (their plain versions
    # here) replay its buckets; exact spheres replay eagerly.
    assert bool(calls) == (name == "bouncing_camera")
    loss, g = G.loss_and_grad(params, sd, cp, *args, grad_split=False, **kw)
    assert np.isfinite(float(loss))
    assert float(split_loss) == pytest.approx(float(loss), rel=1e-5)
    for key in ("mat_emission", "tex_color", "mat_fuzz"):  # book1: fault C4
        _close(key, split_g[key].numpy(), g[key].numpy(), atol=1e-4)


def test_accum_is_the_mean_of_its_chunks():
    sc = _smoke(tdemo)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    params = G.extract_params(sd, cp)
    args = (torch.zeros((w * h, 3)), torch.arange(w * h), 0)
    kw = dict(width=w, height=h, max_depth=4)
    loss, g = G.loss_and_grad_accum(params, sd, cp, *args, spp=2, chunk_spp=1, **kw)
    parts = [G.loss_and_grad(params, sd, cp, *args, spp=1, sample0=k, **kw) for k in (0, 1)]
    assert float(loss) == pytest.approx(np.mean([float(lc) for lc, _ in parts]), rel=1e-6)
    for key in G.TENSOR_KEYS:
        want = (parts[0][1][key] + parts[1][1][key]) / 2
        np.testing.assert_allclose(g[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_sharded_render_takes_exact_scenes():
    sc = bouncing_book1(tdemo, 16, KEY)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    mesh = pmesh.make_mesh(8, devices=["cpu"] * 8)
    got = prender.render_image_sharded(sc, mesh, samples=2, max_depth=4)
    p = w * h
    want = tint.render_rays(sd, cp, w, h, torch.arange(p).repeat(2),
                            torch.arange(2).repeat_interleave(p), sc.seed, 4)
    assert torch.equal(got, want.reshape(2, p, 3).mean(dim=0).reshape(h, w, 3))
    with pytest.raises(NotImplementedError, match="render_image_sharded"):
        prender.render_image_sharded_mega(sc, mesh, samples=1, max_depth=2)
