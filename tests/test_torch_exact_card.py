"""Exact-time motion on the card: under a camera keyed inside the shutter
(bouncing book1's camera alone, keyed at 1/96 s: a static table, so the
scene keeps its kernels), K9 (the fused hit + fetch), K10 (the closest
sphere hit of the staged record), K4 (the replay forward) and K3 (the
replay backward) against their plain versions: K9, K10 and K4 bit for bit,
K3 within the JAX replay backward's scheme; the routes launch them and
never their plain versions; and the flash (a sphere that teleports around
the camera mid-shutter) at 320 wide against its analytic oracle. Every
test here needs an NVIDIA GPU and skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_exact_card.py
"""

import numpy as np
import pytest
import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.models import skybox as tsky
from crucible_tpu_torch.models.camera import generate_rays
from crucible_tpu_torch.ops.kernels import replay_kernel as trk
from crucible_tpu_torch.ops.kernels import sphere_hit as tsh
from crucible_tpu_torch.ops.kernels import sphere_shade as tss
from crucible_tpu_torch.utils import rng as trng
from tests import torch_exact_scenes as X
from tests.torch_motion_scenes import bouncing_book1

KEY = 1.0 / 96.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_exact_card.py)"
        )
    return torch.device("cuda")


def _camera_scene(cuda, width=192, spp=2):
    """Bouncing book1's camera alone keyed at 1/96 s on the card -> (sd,
    cp, w, h, pix, smp, o, d): every pixel at ``spp`` samples, sample-major."""
    sc = bouncing_book1(tdemo, width, KEY, spheres=False)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    assert cp.motion_exact and not sd.motion_exact
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    p = w * h
    pix = torch.arange(p, device=cuda).repeat(spp)
    smp = torch.arange(spp, device=cuda).repeat_interleave(p)
    o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
    return sd, cp, w, h, pix, smp, o.contiguous(), d.contiguous()


@pytest.mark.cuda
def test_k9_and_k10_under_a_camera_track(cuda):
    sd, cp, w, h, pix, smp, o, d = _camera_scene(cuda)
    table = tint.make_sphere_table(sd).contiguous()
    before = tss.LAUNCHES
    w0 = torch.zeros((o.shape[0],), device=cuda)
    got = tss.hit_spheres_fetch(o, d, w0, table)
    assert tss.LAUNCHES == before + 1
    assert torch.equal(got, tss.hit_spheres_fetch_reference(o, d, w0, table))
    cols = (table[:, 0:3].contiguous(), table[:, 4].contiguous(), table[:, 5].contiguous())
    before = tsh.LAUNCHES
    hits = tsh.hit_spheres(o, d, *cols)
    assert tsh.LAUNCHES == before + 1
    for a, b in zip(hits, tsh.hit_spheres_reference(o, d, *cols)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k4_and_k3_under_a_camera_track(cuda):
    sd, cp, w, h, pix, smp, o, d = _camera_scene(cuda)
    before = tsh.LAUNCHES
    rec = trep.trace_record(sd, o, d, pix, smp, 0, 8)  # the staged record: K10 a bounce
    assert tsh.LAUNCHES > before
    table = tint.make_sphere_table(sd).contiguous()
    args = (table, o, d, torch.ones_like(pix, dtype=torch.int32), pix.to(torch.int32),
            smp.to(torch.int32), rec, 0)
    before = trk.LAUNCHES_FORWARD
    rad = trk.replay_forward(*args)
    assert trk.LAUNCHES_FORWARD == before + 1
    assert torch.equal(rad, trk.replay_forward_reference(*args))
    g_rad = torch.randn((o.shape[0], 3), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    got = trk.replay_backward(*args, g_rad)
    assert torch.equal(got[0], trk.replay_backward(*args, g_rad)[0])
    want = trk.replay_backward_reference(*args, g_rad)
    for name, a, b in zip(("g_table", "g_o", "g_d"), got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all(), name
        nd = np.abs(a - b) / max(float(np.abs(b).max()), 1e-6)
        assert float((nd > 2e-4).mean()) < (0.005 if name == "g_table" else 0.02), name
        assert float(nd.max()) < 0.1, name


@pytest.mark.cuda
def test_camera_track_routes_launch_the_kernels(cuda, monkeypatch):
    """render_image (auto -> pixel, K9) and the gradient step (the staged
    record with K10, the replay with K4 / K3) under a camera track never
    reach a plain version."""
    def no_plain(*args, **kwargs):
        raise AssertionError("CUDA tensors must not reach a plain version")

    for mod, name in ((tss, "hit_spheres_fetch_reference"), (tsh, "hit_spheres_reference"),
                      (trk, "replay_forward_reference"), (trk, "replay_backward_reference")):
        monkeypatch.setattr(mod, name, no_plain)
    sc = bouncing_book1(tdemo, 64, KEY, spheres=False)
    counts = (tss.LAUNCHES, tsh.LAUNCHES, trk.LAUNCHES_FORWARD, trk.LAUNCHES_BACKWARD)
    img = trender.render_image(sc, 2, 8, device=cuda)
    assert bool(torch.isfinite(img).all()) and tss.LAUNCHES > counts[0]
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    loss, grads = G.loss_and_grad(G.extract_params(sd, cp), sd, cp,
                                  torch.zeros((w * h, 3), device=cuda),
                                  torch.arange(w * h, device=cuda), 0, width=w, height=h,
                                  spp=2, max_depth=8)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss)) and bool(torch.isfinite(grads["tex_color"]).all())
    assert tsh.LAUNCHES > counts[1]
    assert trk.LAUNCHES_FORWARD > counts[2]  # the staged record sums no radiance: K4 does
    assert trk.LAUNCHES_BACKWARD > counts[3]


@pytest.mark.cuda
def test_flash_meets_its_oracle_on_card(cuda):
    sc, key, emission = X.flash(tscene, 320)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    p, spp, seed = w * h, 2, 5
    pix = torch.arange(p, device=cuda).repeat(spp)
    smp = torch.arange(spp, device=cuda).repeat_interleave(p)
    rad = tint.render_rays(sd, cp, w, h, pix, smp, seed, 4)
    t_open, t_close = sc.scene_cam.shutter_window()
    t_ray = t_open + trng.uniform1(pix, smp, trng.STREAM_TIME, seed) * (t_close - t_open)
    _, d, _ = generate_rays(cp, w, h, pix, smp, seed)
    sky = tsky.radiance(sd.sky_kind, sd.sky_image, d)
    expected = torch.where((t_ray >= key)[:, None],
                           torch.tensor(emission, device=cuda), sky)
    assert float((rad - expected).abs().max()) <= 1e-5
