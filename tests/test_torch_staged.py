"""The staged slice end to end: HDR assets and the procedural garden sky,
the spherical sky, the staged bounce, the ``pixel`` schedule (the fused
bounce, K9) and the direct-AD gradient (closest hits by K10), each against
the JAX package on the same scenes, and the port's own estimators against
each other. Their card-only twins are in tests/test_torch_sphere_hit.py
(the direct-AD step) and tests/test_torch_sphere_shade.py (the pixel
schedule), which run without JAX."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.io import hdr as jhdr
from crucible_tpu.io import procedural as jproc
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import integrator as jint
from crucible_tpu.models import skybox as jsky
from crucible_tpu.models import textures as jtex
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.io import hdr as thdr
from crucible_tpu_torch.io import image as timage
from crucible_tpu_torch.io import procedural as tproc
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import skybox as tsky
from crucible_tpu_torch.models import textures as ttex
from crucible_tpu_torch.models.camera import generate_rays
from tests.test_torch_scene import bridged
from tests.torch_threads import one_torch_thread  # noqa: F401

# --- assets -------------------------------------------------------------------------


def test_hdr_round_trip_matches_jax(tmp_path):
    rgb = np.random.default_rng(0).uniform(0, 40, (5, 9, 3)).astype(np.float32)
    rgb[0, 0] = 0.0
    thdr.write_hdr(tmp_path / "port.hdr", rgb)
    jhdr.write_hdr(tmp_path / "jax.hdr", rgb)
    assert (tmp_path / "port.hdr").read_bytes() == (tmp_path / "jax.hdr").read_bytes()
    got = thdr.read_hdr(tmp_path / "port.hdr")
    np.testing.assert_array_equal(got, jhdr.read_hdr(tmp_path / "jax.hdr"))
    # RGBE keeps 8 bits of mantissa per channel of the largest.
    assert (np.abs(got - rgb) <= rgb.max(-1, keepdims=True) / 128).all()


def test_hdr_reads_rle_scanlines(tmp_path):
    w = 12
    line = bytes([2, 2, 0, w]) + b"".join(bytes([128 + w, v]) for v in (10, 20, 30, 129))
    (tmp_path / "rle.hdr").write_bytes(b"#?RADIANCE\n\n-Y 2 +X 12\n" + line * 2)
    got = thdr.read_hdr(tmp_path / "rle.hdr")
    np.testing.assert_array_equal(got, jhdr.read_hdr(tmp_path / "rle.hdr"))
    assert got.shape == (2, w, 3) and np.allclose(got[..., 0], 10 * 2.0 ** (129 - 136))


def test_garden_bytes_equal_jax(tmp_path):
    np.testing.assert_array_equal(tproc.generate_garden_hdr(32), jproc.generate_garden_hdr(32))
    path = tproc.ensure_garden_hdr()
    jhdr.write_hdr(tmp_path / "garden.hdr", jproc.generate_garden_hdr())
    assert path.read_bytes() == (tmp_path / "garden.hdr").read_bytes()
    assert tproc.ensure_garden_hdr() == path  # a complete file stays


def test_load_image_takes_hdr_only(tmp_path, monkeypatch):
    """``.hdr`` decodes with the port's own codec; other formats, which the
    port once refused, decode through PIL (tests/test_torch_textures.py
    holds them to the JAX package), and a missing asset raises
    ``FileNotFoundError``, as the JAX package's does."""
    tproc.ensure_garden_hdr()
    assert timage.load_image("garden.hdr").shape == (512, 1024, 3)
    monkeypatch.setenv("ASSET_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        timage.load_image("no_such_map.jpg")
    Image = pytest.importorskip("PIL.Image")
    Image.fromarray(np.full((2, 3, 3), 51, np.uint8)).save(tmp_path / "grey.png")
    np.testing.assert_array_equal(timage.load_image("grey.png"),
                                  np.full((2, 3, 3), np.float32(51) / 255.0))


# --- the spherical sky --------------------------------------------------------------


def test_image_lookup_matches_jax():
    g = np.random.default_rng(1)
    img = g.random((7, 11, 3)).astype(np.float32)
    u, v = (g.uniform(-0.2, 1.2, 2000).astype(np.float32) for _ in range(2))
    want = jtex.image_lookup(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    got = ttex.image_lookup(torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spherical_sky_matches_jax():
    """Texel indices of random directions: an image whose texels hold their
    own index."""
    h, w = 64, 128
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = np.arange(h * w).reshape(h, w)
    d = np.random.default_rng(2).normal(size=(4000, 3)).astype(np.float32)
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [1e-30, 0, 0]]
    want = np.asarray(jsky.radiance(jsky.SPHERICAL, jnp.asarray(img), jnp.asarray(d)))
    got = tsky.radiance(tsky.SPHERICAL, torch.from_numpy(img), torch.from_numpy(d)).numpy()
    # float32 atan2 / asin differ by an ulp between XLA and torch: a
    # direction on a texel edge may fall to the neighbour.
    assert (got[:, 0] == want[:, 0]).mean() >= 0.999


def test_garden_scene_equals_jax():
    js, ts = jdemo.garden_skybox(width=32), tdemo.garden_skybox(width=32)
    sd, jsd = ts.build(device="cpu"), js.build()
    assert sd.sky_kind == tsky.SPHERICAL
    np.testing.assert_array_equal(sd.sky_image.numpy(), np.asarray(jsd.sky_image))
    bsd, _ = bridged(js)
    assert torch.equal(bsd.sky_image, sd.sky_image)
    arrays, static = bridge.scene_data_to_arrays(sd)
    back = bridge.scene_data_from_arrays(arrays, device="cpu", **static)
    assert torch.equal(back.sky_image, sd.sky_image)


# --- the staged bounce and trace ----------------------------------------------------


def _rays(name, width, n=512, seed=3):
    js = getattr(jdemo, name)(width=width)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    g = np.random.default_rng(seed)
    pix = g.integers(0, w * h, n).astype(np.int32)
    smp = g.integers(0, 8, n).astype(np.int32)
    sd, cp = bridged(js)
    o, d, _ = generate_rays(cp, w, h, torch.from_numpy(pix), torch.from_numpy(smp), seed)
    return js, sd, cp, pix, smp, o, d


@pytest.mark.parametrize("name", ["book1_end_scene", "garden_skybox"])
def test_bounce_step_matches_jax(name):
    js, sd, _, pix, smp, o, d = _rays(name, 32)
    want = jint.bounce_step(js.build(), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                            jnp.asarray(pix), jnp.asarray(smp), 0, jnp.uint32(3))
    got = tint.bounce_step(sd, o, d, torch.from_numpy(pix), torch.from_numpy(smp), 0, 3,
                           return_decisions=True)
    same = got["hit"].numpy() == np.asarray(want["hit"])
    assert same.mean() >= 0.99 and np.asarray(want["hit"]).any()
    for key in ("contrib", "new_o", "new_d", "atten"):
        ok = np.isclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-3, atol=1e-3)
        assert ok[same].mean() > 0.99, key
    np.testing.assert_array_equal(got["scattered"].numpy()[same],
                                  np.asarray(want["scattered"])[same])
    # The decisions the staged record keeps, on the lanes that hit alike.
    jdec = jint.bounce_step(js.build(), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                            jnp.asarray(pix), jnp.asarray(smp), 0, jnp.uint32(3),
                            return_decisions=True)
    hit = same & np.asarray(want["hit"])
    for key, a, b in (("front", got["front"], jdec["front"]),
                      ("i_sph", got["i_sph"], jdec["i_sph"]),
                      ("reflect", got["decisions"]["reflect"], jdec["decisions"]["reflect"]),
                      ("degenerate", got["decisions"]["degenerate"],
                       jdec["decisions"]["degenerate"])):
        assert (a.numpy()[hit] == np.asarray(b)[hit]).mean() >= 0.99, key


def test_trace_differentiable_is_bit_identical():
    _, sd, _, pix, smp, o, d = _rays("book1_end_scene", 32)
    args = (sd, o, d, torch.from_numpy(pix), torch.from_numpy(smp), 3, 8)
    assert torch.equal(tint.trace(*args), tint.trace(*args, differentiable=True))


@pytest.mark.parametrize("name", ["book1_end_scene", "garden_skybox"])
def test_fused_and_staged_bounces_agree(name):
    """K9's plain version at w = 0 is K10's search term for term, and the
    shading after it the same arithmetic."""
    _, sd, _, pix, smp, o, d = _rays(name, 32)
    args = (o, d, torch.from_numpy(pix), torch.from_numpy(smp), 2, 3)
    fused = tint.bounce_step_fused(sd, tint.make_sphere_table(sd), *args)
    staged = tint.bounce_step(sd, *args)
    assert fused.keys() == staged.keys() and torch.equal(fused["hit"], staged["hit"])
    hit = staged["hit"]
    assert hit.any()
    # Miss lanes shade no row in the fused bounce and row 0 in the staged
    # one; both drop them (a path continues only where it hit).
    for key, want in staged.items():
        got, want = (fused[key], want) if key == "contrib" else (fused[key][hit], want[hit])
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6, msg=key)


@pytest.mark.parametrize(
    "name,width", [("smoke_scene", 32), ("book1_end_scene", 32), ("garden_skybox", 48)]
)
def test_pixel_schedule_matches_jax(name, width):
    js = getattr(jdemo, name)(width=width)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    want = np.asarray(jint.trace_persistent(
        js.build(), js.scene_cam.params(), w, h, 2, 8, jnp.uint32(0), lanes=1 << 13,
        use_pallas=False,
    )) / 2
    sd, cp = bridged(js)
    got = (tint.trace_persistent(sd, cp, w, h, 2, 8, 0, lanes=1 << 13) / 2).numpy()
    assert got.shape == want.shape == (w * h, 3) and np.isfinite(got).all()
    # The cross-path bounds, at 0.97 for book1 on the CPU (fault C6).
    close = np.isclose(got, want, rtol=1e-3, atol=1e-3).mean()
    assert close > 0.97, close
    assert abs(got.mean() - want.mean()) <= 2e-3 * max(abs(float(want.mean())), 1.0)


def test_sample_groups_sum_to_the_same_image():
    """More lanes than pixels: sample groups, reduced by one reshape-sum."""
    sd, cp = bridged(jdemo.smoke_scene(width=16))
    one = tint.trace_persistent(sd, cp, 16, 9, 4, 6, 0, lanes=1)
    four = tint.trace_persistent(sd, cp, 16, 9, 4, 6, 0, lanes=4 * 144)
    np.testing.assert_allclose(four.numpy(), one.numpy(), rtol=1e-5, atol=1e-6)


def test_auto_takes_pixel_for_garden(monkeypatch):
    def no_mega(*args, **kwargs):
        raise AssertionError("garden must not take the megakernel")

    monkeypatch.setattr(tint, "trace_persistent_mega", no_mega)
    sc = tdemo.garden_skybox(width=32)
    img = trender.render_image(sc, samples=2, max_depth=4, device="cpu")
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    want = tint.trace_persistent(sd, cp, 32, 18, 2, 4, 0, lanes=trender.LANES_CPU) / 2
    assert img.shape == (18, 32, 3) and torch.equal(img, want.reshape(18, 32, 3))


# --- the direct-AD gradient ---------------------------------------------------------


def _close(key, got, want, atol=5e-3):
    """Normalized agreement (tests/test_replay.py:1130-1135)."""
    a, b = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(b).max()), 1e-6)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol, err_msg=key)


def _both_ad(name, width, spp, depth, seed=3):
    js = getattr(jdemo, name)(width=width)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    jsd, jcp = js.build(), js.scene_cam.params()
    kw = dict(width=w, height=h, spp=spp, max_depth=depth, method="ad")
    jp = JG.extract_params(jsd, jcp)
    jl, jg = JG.loss_and_grad(jp, jsd, jcp, jnp.zeros((w * h, 3)),
                              jnp.arange(w * h, dtype=jnp.uint32), jnp.uint32(seed), **kw)
    sd, cp = bridged(js)
    arrays = {k: np.asarray(v) for k, v in jp.items() if k in G.TENSOR_KEYS}
    if sd.sky_image is not None:
        arrays["sky_image"] = np.asarray(jp["sky_image"])
    params = bridge.params_from_arrays(arrays, device="cpu")
    tl, tg = G.loss_and_grad(params, sd, cp, torch.zeros((w * h, 3)), torch.arange(w * h),
                             seed, **kw)
    return (float(jl), jg), (float(tl), tg)


@pytest.mark.parametrize(
    "name,width,keys",
    [
        ("smoke_scene", 16, G.TENSOR_KEYS),  # camera leaves too (fault C4)
        ("book1_end_scene", 32, ("tex_color", "mat_emission")),
        ("garden_skybox", 16, G.TENSOR_KEYS + ("sky_image",)),
    ],
)
def test_ad_loss_and_grad_matches_jax(name, width, keys):
    (jl, jg), (tl, tg) = _both_ad(name, width, 2, 4)
    assert tl == pytest.approx(jl, rel=2e-3)
    for key in keys:
        _close(key, tg[key].numpy(), jg[key])


def test_ad_matches_the_ports_replay():
    """Both estimators make the same decisions on the same samples: the
    losses and the radiometric gradients agree."""
    sc = tdemo.book1_end_scene(width=32)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    params = G.extract_params(sd, cp)
    kw = dict(width=32, height=18, spp=2, max_depth=4)
    args = (params, sd, cp, torch.zeros((576, 3)), torch.arange(576), 0)
    la, ga = G.loss_and_grad(*args, method="ad", **kw)
    lr, gr = G.loss_and_grad(*args, method="replay", **kw)
    assert float(la) == pytest.approx(float(lr), rel=2e-3)
    for key in ("tex_color", "mat_emission"):
        _close(key, ga[key].numpy(), gr[key].numpy())


def test_auto_method_takes_ad_under_a_spherical_sky():
    """Under the spherical sky ``auto`` now takes the (eager) replay, as in
    the JAX package; direct AD gives the same loss and sky gradient within
    the estimators' cross-path bounds."""
    sc = tdemo.garden_skybox(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    params = G.extract_params(sd, cp)
    kw = dict(width=16, height=9, spp=1, max_depth=3)
    args = (params, sd, cp, torch.zeros((144, 3)), torch.arange(144), 0)
    la, ga = G.loss_and_grad(*args, **kw)
    lr, gr = G.loss_and_grad(*args, method="replay", **kw)
    assert torch.equal(la, lr) and torch.equal(ga["sky_image"], gr["sky_image"])
    lb, gb = G.loss_and_grad(*args, method="ad", **kw)
    assert float(la) == pytest.approx(float(lb), rel=2e-3)
    _close("sky_image", ga["sky_image"].numpy(), gb["sky_image"].numpy())
    assert ga["sky_image"].abs().sum() > 0
    with pytest.raises(ValueError, match="rec"):
        G.loss_and_grad(*args, method="ad", rec=torch.zeros((3, 144), dtype=torch.int32), **kw)


def test_sky_image_leaf_round_trips_through_apply_params():
    sd = tdemo.garden_skybox(width=16).build(device="cpu")
    cp = tdemo.garden_skybox(width=16).scene_cam.params(device="cpu")
    p = G.extract_params(sd, cp)
    assert p["sky_image"] is sd.sky_image and G.leaf_keys(p)[-1] == "sky_image"
    sd2, _ = G.apply_params(sd, cp, dict(p, sky_image=p["sky_image"] * 2))
    assert torch.equal(sd2.sky_image, sd.sky_image * 2)
    assert replace(sd2, sky_image=None).sky_image is None
