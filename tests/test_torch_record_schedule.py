"""The ``record`` schedule, the texel gradient and ``train_demo`` of
crucible_tpu_torch against the JAX package, on the CPU (K2's plain version
writes the records; the JAX record megakernel runs in interpret mode). The
earth map is a generated stand-in (``tests/test_torch_textures.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import replay as jrep
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch import train_demo
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from tests.test_torch_scene import jax_camera_arrays, jax_scene_arrays
from tests.test_torch_textures import earth_asset, with_images  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 1


def _bridged(js):
    """The port's (SceneData, CameraParams) of a JAX-built scene, texture
    images included."""
    jsd, jcp = js.build(), js.scene_cam.params()
    arrays, static = jax_scene_arrays(jsd)
    sd = bridge.scene_data_from_arrays(with_images(arrays, jsd), device="cpu", **static)
    cp = bridge.camera_params_from_arrays(jax_camera_arrays(jcp), device="cpu",
                                          animated=jcp.animated)
    return sd, cp


def _lanes(w, h, spp):
    pix = np.tile(np.arange(w * h, dtype=np.int32), spp)
    smp = np.repeat(np.arange(spp, dtype=np.int32), w * h)
    return pix, smp


@pytest.mark.parametrize("world,width,depth", [("earth", 24, 6), ("garden_skybox", 32, 5)])
def test_record_schedule_matches_jax(world, width, depth, earth_asset):  # noqa: F811
    """The image at the cross-path bound of fault C6 (isclose > 0.97, means
    within 2e-3), and the record words lane by lane on > 0.99 of lanes."""
    js = getattr(jdemo, world)(width=width)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    jsd, jcp = js.build(), js.scene_cam.params()
    want = np.asarray(jrep.render_record_replay(jsd, jcp, w, h, 2, depth, SEED)) / np.float32(2)
    sd, cp = _bridged(js)
    got = trender.render_image_persistent(sd, cp, w, h, 2, depth, SEED, device="cpu",
                                          schedule="record").numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    want = want.reshape(h, w, 3)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-3).mean()
    assert close > 0.97, close
    assert abs(got.mean() - want.mean()) <= 2e-3
    pix, smp = _lanes(w, h, 2)
    jrec = np.asarray(jrep.trace_record_mega(
        jsd, jcp, w, h, jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32),
        jnp.uint32(SEED), depth, interpret=True))
    trec = trep.trace_record_mega(sd, cp, w, h, torch.from_numpy(pix), torch.from_numpy(smp),
                                  SEED, depth).numpy()
    same = (trec == jrec).all(axis=0).mean()
    assert same > 0.99, same


def test_record_schedule_chunks_and_masks_the_tail(earth_asset):  # noqa: F811
    """A budget of 2 samples a chunk over 3 samples (a ragged tail masked
    by sample id 2**30) sums the same per-pixel radiance as one chunk, and
    progress reports each chunk."""
    sc = tdemo.earth(width=24)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    one = trep.render_record_replay(sd, cp, w, h, 3, 4, SEED)
    calls = []
    chunked = trep.render_record_replay(sd, cp, w, h, 3, 4, SEED,
                                        rec_budget_bytes=2 * 4 * 4 * w * h,
                                        progress=lambda *a: calls.append(a[:2]))
    assert calls == [(2, 3), (3, 3)]
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def test_nested_checkers_record_matches_pixel():
    """tests/test_replay.py:497-510's bounds: record against the staged
    pixel schedule on a three-level nested checker."""
    sc = tdemo.nested_checkers(width=24, nest=3)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    assert sd.tex.max_nest == 3
    img = {s: trender.render_image_persistent(sd, cp, w, h, 2, 4, 0, device="cpu",
                                              schedule=s).numpy()
           for s in ("record", "pixel")}
    d = np.abs(img["record"] - img["pixel"])
    assert d.mean() < 3e-3 and (d > 1e-3).mean() < 0.03, d.max()


def test_auto_routes_as_jax(earth_asset):  # noqa: F811
    """'auto' on a CUDA device takes 'record' where the JAX package on an
    accelerator does (image textures, nested checkers), 'mega' and 'pixel'
    where it does; on the CPU 'pixel' for both, as the JAX package off an
    accelerator."""
    def route(sc, device):
        return trender.auto_schedule(sc.build(device="cpu"), sc.scene_cam.params(device="cpu"),
                                     device)

    for sc in (tdemo.earth(width=24), tdemo.nested_checkers(width=24)):
        assert route(sc, "cuda") == "record" and route(sc, "cpu") == "pixel"
    assert route(tdemo.book1_end_scene(width=24), "cuda") == "mega"
    assert route(tdemo.garden_skybox(width=24), "cuda") == "pixel"


def test_texel_gradient_matches_jax(earth_asset):  # noqa: F811
    """Earth at 24x13, 2 spp, depth 3: the loss against the JAX package's at
    rel 2e-3, the texel gradient at 5e-3 normalized, and the largest texel
    entry against a central difference of the port's loss at rel 2e-2."""
    js = jdemo.earth(width=24)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    assert (w, h) == (24, 13)
    jsd, jcp = js.build(), js.scene_cam.params()
    kw = dict(width=w, height=h, spp=2, max_depth=3)
    jparams = JG.extract_params(jsd, jcp)
    jl, jg = JG.loss_and_grad(jparams, jsd, jcp, jnp.zeros((w * h, 3)),
                              jnp.arange(w * h, dtype=jnp.uint32), jnp.uint32(0), **kw)
    sd, cp = _bridged(js)
    params = bridge.params_from_arrays(
        {k: (tuple(np.asarray(i) for i in v) if k == "tex_images" else v)
         for k, v in jparams.items()}, device="cpu")
    target, pix = torch.zeros((w * h, 3)), torch.arange(w * h)
    tl, tg = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
    assert float(tl) == pytest.approx(float(jl), rel=2e-3)
    got, want = tg["tex_images"][0].numpy(), np.asarray(jg["tex_images"][0])
    assert np.abs(want).max() > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=5e-3)

    idx = np.unravel_index(np.argmax(np.abs(got)), got.shape)

    def loss_at(delta):
        img = params["tex_images"][0].numpy().astype(np.float64).copy()
        img[idx] += delta
        p2 = dict(params, tex_images=(torch.tensor(img, dtype=torch.float32),))
        return float(G.l2_loss(p2, sd, cp, target, pix, 0, **kw))

    eps = 1e-3
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert got[idx] == pytest.approx(fd, rel=2e-2)


def test_train_demo_resumes_bit_for_bit(tmp_path, earth_asset):  # noqa: F811
    """4 steps at 24 wide (rerecord 2, a checkpoint every 2 steps): a run cut
    after 2 steps and resumed equals the uninterrupted run bit for bit, the
    loss descends, and the frozen leaves never move."""
    kw = dict(scene="earth", width=24, steps=4, spp=2, depth=3, target_spp=2, rerecord=2,
              ckpt_every=2, lr=5e-2, verbose=False, device="cpu")
    p_full, l_full = train_demo.run(out_dir=tmp_path / "full", **kw)
    train_demo.run(out_dir=tmp_path / "resumed", **dict(kw, steps=2))
    p_res, l_res = train_demo.run(out_dir=tmp_path / "resumed", **kw)
    assert [r["loss"] for r in l_res] == [r["loss"] for r in l_full]
    assert l_full[-1]["loss"] < l_full[0]["loss"], l_full
    flat_full, flat_res = G.leaves(p_full), G.leaves(p_res)
    assert flat_full.keys() == flat_res.keys() and "tex_images/0" in flat_full
    for k in flat_full:
        assert torch.equal(flat_full[k].detach(), flat_res[k].detach()), k
    sc = tdemo.earth(width=24)
    true = G.leaves(G.extract_params(sc.build(device="cpu"), sc.scene_cam.params(device="cpu")))
    for k, v in flat_full.items():
        assert torch.equal(v.detach(), true[k]) != train_demo.trainable(k), k
    assert (tmp_path / "full" / "recovered.png").is_file()
