"""The reference against the program's CPU path at tiny sizes (16-64
pixels wide, 1-2 samples, depth 4): the image of each configuration, and
the fit step's loss and texture-color gradient; and the scene generator's
counts."""

import json

import numpy as np
import pytest
import torch

from harness import manifest
from reference import adam as ref_adam
from reference import pathtrace as ref

CONFIGS = ("rtiow_book1", "rttnw_bouncing")


def _config(name):
    return json.loads(manifest.config_path(name).read_text())


def _scenes(cfg):
    return manifest.load_module(manifest.scene_path(cfg["scene"]), "bench_scene_test")


def _describe(cfg, seed):
    return _scenes(cfg).describe(cfg, seed)


@pytest.mark.parametrize("name", CONFIGS)
def test_scene_module_names_its_reference(name):
    """Both sides of a configuration come from its scene module: the
    program's scene, and the reference it names."""
    mod = _scenes(_config(name))
    assert callable(mod.describe) and callable(mod.program_scene)
    assert manifest.reference_path(mod.REFERENCE).is_file()
    loaded = manifest.load_module(manifest.reference_path(mod.REFERENCE), "bench_ref_test")
    for fn in ("prepare", "leaf", "render_pixels", "loss_and_grad"):
        assert callable(getattr(loaded, fn)), fn


@pytest.mark.parametrize("name", CONFIGS)
def test_scene_counts_fixed(name):
    cfg = _config(name)
    a, b = _describe(cfg, 3), _describe(cfg, 2**31 + 5)
    again = _describe(cfg, 3)
    for d in (a, b):
        assert len(d["names"]) == 484
        small = np.array([n.startswith("small") for n in d["names"]])
        assert small.sum() == 480
        assert [(d["mat"][small] == k).sum() for k in range(3)] == [384, 72, 24]
        moving = (d["center_d"] != 0).any(axis=1)
        assert moving.sum() == (384 if cfg["motion"] else 0)
        assert not (moving & (d["mat"] != 0)).any()
    assert all(np.array_equal(a[k], again[k]) for k in ("center", "tex_color", "center_d"))
    # One layout (geometry, materials, fuzz, rise); the seed draws the albedos.
    assert all(np.array_equal(a[k], b[k]) for k in ("center", "center_d", "mat", "fuzz", "tex"))
    assert not np.array_equal(a["tex_color"], b["tex_color"])


def _port_image(cfg, desc, width, spp, depth, seed):
    from crucible_tpu_torch.models import render

    sc = _scenes(cfg).program_scene(cfg, desc, width)
    return sc, render.render_image(sc, spp, depth, seed, device="cpu")


@pytest.mark.parametrize("name,width,spp", [("rtiow_book1", 32, 2), ("rttnw_bouncing", 32, 2),
                                            ("rtiow_book1", 64, 1), ("rttnw_bouncing", 16, 2)])
def test_image_matches_program(name, width, spp):
    cfg = _config(name)
    desc = _describe(cfg, 11)
    sc, img = _port_image(cfg, desc, width, spp, 4, 12345)
    h = sc.scene_cam.image_height
    prep = ref.prepare(cfg, desc, width, h, "cpu")
    counts = {}
    want = ref.render_pixels(prep, torch.arange(width * h), spp, 12345, 4, counts=counts)
    # The same arithmetic on both sides: only the sum over samples rounds
    # in another order.
    assert float((img.reshape(-1, 3) - want).abs().max()) <= 1e-6
    assert counts["searches"] >= width * h * spp


def _port_fit(cfg, desc, width, spp, depth, seed, target):
    from crucible_tpu_torch import grad as G

    sc = _scenes(cfg).program_scene(cfg, desc, width)
    h = sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    params = G.extract_params(sd, cp)
    params["tex_color"] = torch.full_like(params["tex_color"], 0.5)
    pix = torch.arange(width * h)
    kw = dict(width=width, height=h, spp=spp, max_depth=depth)
    rec = G.record_decisions(sd, cp, pix, seed, **kw)
    replay = G.loss_and_grad(params, sd, cp, target, pix, seed, rec=rec, method="replay", **kw)
    ad = G.loss_and_grad(params, sd, cp, target, pix, seed, method="ad", **kw)
    return h, replay, ad


@pytest.mark.parametrize("name", CONFIGS)
def test_fit_step_matches_program(name):
    """Loss and texture-color gradient of one step against the program's
    replay (the fit's estimator) and, for the static scene, its direct
    reverse mode (the program's semantic reference), row by row."""
    cfg = _config(name)
    desc = _describe(cfg, 21)
    width, spp, depth, seed = 48, 2, 4, 777
    h = int(width * 9 / 16)
    target = torch.rand((width * h, 3), generator=torch.Generator().manual_seed(4))
    _, (loss, g), (loss_ad, g_ad) = _port_fit(cfg, desc, width, spp, depth, seed, target)
    prep = ref.prepare(cfg, desc, width, h, "cpu")
    color = torch.full(ref.leaf(prep, "tex_color").shape, 0.5)
    want_loss, want = ref.loss_and_grad(prep, {"tex_color": color}, target, spp, seed, depth)
    want_g = want["tex_color"]
    assert g["tex_color"].shape == want_g.shape
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * float(want_loss)
    gap = abs(float(g["tex_color"].norm()) - float(want_g.norm())) / float(want_g.norm())
    assert gap <= 5e-3
    if name == "rtiow_book1":
        assert abs(float(loss_ad) - float(want_loss)) <= 1e-6 * float(want_loss)
        assert float((g_ad["tex_color"] - want_g).abs().max()) <= 1e-6 * float(want_g.abs().max())


def test_adam_from_a_state_matches_torch():
    """The reference's Adam started from torch's state after two steps
    takes the third as torch does (the fit's window steps)."""
    p = torch.randn(5, 3)
    leaf = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([leaf], lr=0.05)
    gs = [torch.randn(5, 3, generator=torch.Generator().manual_seed(k)) for k in range(3)]
    for g in gs[:2]:
        leaf.grad = g.clone()
        opt.step()
    st = opt.state[leaf]
    theta = leaf.detach().clone()
    mine = ref_adam.Adam(lr=0.05, step_count=int(st["step"]), m=st["exp_avg"].clone(),
                         v=st["exp_avg_sq"].clone())
    leaf.grad = gs[2].clone()
    opt.step()
    assert torch.allclose(leaf.detach(), mine.step(theta, gs[2]), rtol=0, atol=1e-6)


def test_adam_matches_torch():
    p = torch.randn(7, 3)
    leaf = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([leaf], lr=0.05)
    mine = ref_adam.Adam(lr=0.05)
    q = p.clone()
    for k in range(3):
        g = torch.randn(7, 3, generator=torch.Generator().manual_seed(k))
        leaf.grad = g.clone()
        opt.step()
        q = mine.step(q, g)
    assert torch.allclose(leaf.detach(), q, rtol=0, atol=1e-6)


def test_bfloat16_control_departs():
    """The control computes the same image in bfloat16: far from float32."""
    cfg = _config("rtiow_book1")
    desc = _describe(cfg, 5)
    prep = ref.prepare(cfg, desc, 32, 18, "cpu")
    prep16 = ref.prepare(cfg, desc, 32, 18, "cpu", torch.bfloat16)
    px = torch.arange(32 * 18)
    a = ref.render_pixels(prep, px, 2, 9, 4)
    b = ref.render_pixels(prep16, px, 2, 9, 4).float()
    assert float((a - b).abs().max()) > 0.05
