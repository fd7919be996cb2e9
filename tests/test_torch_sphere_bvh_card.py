"""K5 (the megakernel's walk of a static table's tree in its flat loop,
forward and record, with a static or a moving camera) and K3 at the 1936
rows of sphere_stress on the card: each CUDA kernel against its plain
version and against the brute kernels (K1, K2, K8's camera), bit for bit,
at each leaf size the card's sweep times. Every test here needs an NVIDIA
GPU and skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sphere_bvh_card.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models.camera import generate_rays
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from crucible_tpu_torch.ops.kernels import replay_kernel as trk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_sphere_bvh_card.py)"
        )
    return torch.device("cuda")


def _scene(cuda, copies, width):
    sc = tdemo.sphere_stress(width=width, copies=copies)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    return sd, cp, sc.scene_cam.image_width, sc.scene_cam.image_height


def _tree(sd, leaf=None):
    """K5's tree of the scene (perm, nodes, meta): Scene.build's, or built
    at ``leaf`` spheres a leaf."""
    if leaf is None:
        return sd.sph_swept_perm, sd.sph_swept_nodes, sd.sph_swept_meta
    arrays = (x.cpu().numpy() for x in (sd.sph_center, sd.sph_radius, sd.sph_active))
    return tuple(torch.from_numpy(x).to(sd.sph_center.device)
                 for x in tmk.swept_tables(*arrays, leaf_size=leaf))


def _walk(inputs, tree):
    perm, nodes, meta = tree
    return dict(inputs, table=tint.permute_table(inputs["table"], perm), swept_nodes=nodes,
                swept_meta=meta)


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", [None, 4, 16])
@pytest.mark.parametrize("copies", [4, 16])
def test_walk_forward_equals_plain_walk_and_brute(cuda, copies, leaf):
    sd, cp, w, h = _scene(cuda, copies, 96)
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 4, 16, 0)
    permuted = _walk(inputs, _tree(sd, leaf))
    before = (tmk.FORWARD_LAUNCHES["brute"], tmk.FORWARD_LAUNCHES["walk"])
    walk = tmk.run_megakernel(**permuted, animated=False)
    brute = tmk.run_megakernel(**inputs, animated=False)
    torch.cuda.synchronize()
    assert (tmk.FORWARD_LAUNCHES["brute"], tmk.FORWARD_LAUNCHES["walk"]) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(walk).all()
    assert torch.equal(walk, brute)
    assert torch.equal(walk, tmk.run_megakernel_reference(**permuted))


@pytest.mark.cuda
def test_walk_with_a_moving_camera_equals_plain_walk_and_brute(cuda):
    """K8's camera on K5's walk, forward and record (fused and plain): the
    launches count as "motion_walk" and equal the plain walk and K8's brute
    camera variant."""
    sc = tdemo.sphere_stress(width=96, copies=4)
    sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    assert cp.animated and not sd.animated
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 2, 16, 0)
    walk = _walk(inputs, _tree(sd))
    flags = dict(animated=False, cam_animated=True)
    tmk.zero_counts()
    out = tmk.run_megakernel(**walk, **flags)
    p = w * h
    rec_in = dict(walk, pix=torch.arange(p, device=cuda, dtype=torch.int32).repeat(2)[None],
                  sample0=torch.arange(2, device=cuda,
                                       dtype=torch.int32).repeat_interleave(p)[None])
    acc, rec = tmk.run_megakernel_record(**rec_in, max_depth=8, radiance=True, **flags)
    plain = tmk.run_megakernel_record(**rec_in, max_depth=8, **flags)[1]
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES["motion_walk"] == 1 and tmk.RECORD_LAUNCHES["motion_walk"] == 2
    assert torch.equal(out, tmk.run_megakernel_reference(**walk, **flags))
    assert torch.equal(out, tmk.run_megakernel(**inputs, **flags))
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**rec_in, max_depth=8,
                                                           radiance=True, **flags)
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc) and torch.equal(plain, rec)
    brute_in = dict(rec_in, table=inputs["table"])
    del brute_in["swept_nodes"], brute_in["swept_meta"]
    b_acc, b_rec = tmk.run_megakernel_record(**brute_in, max_depth=8, radiance=True, **flags)
    assert torch.equal(rec, b_rec) and torch.equal(acc, b_acc)


@pytest.mark.cuda
def test_walk_record_equals_plain_walk_and_brute(cuda):
    sd, cp, w, h = _scene(cuda, 4, 96)
    p = w * h
    pix = torch.arange(p, device=cuda).repeat(2)
    smp = torch.arange(2, device=cuda).repeat_interleave(p)
    args = (cp, w, h, pix, smp, 0, 8)
    brute_sd = replace(sd, sph_perm=None, sph_nodes=None, sph_meta=None, sph_swept_perm=None,
                       sph_swept_nodes=None, sph_swept_meta=None)
    before = (tmk.RECORD_LAUNCHES["brute"], tmk.RECORD_LAUNCHES["walk"])
    rec, rad = trep.trace_record_mega(sd, *args, radiance=True)
    plain = trep.trace_record_mega(sd, *args)
    b_rec, b_rad = trep.trace_record_mega(brute_sd, *args, radiance=True)
    torch.cuda.synchronize()
    assert (tmk.RECORD_LAUNCHES["brute"], tmk.RECORD_LAUNCHES["walk"]) == (before[0] + 1, before[1] + 2)
    assert torch.equal(rec, plain) and torch.equal(rec, b_rec) and torch.equal(rad, b_rad)
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 1, 8, 0)
    table = tint.permute_table(tint.make_sphere_table(sd), sd.sph_swept_perm)
    smem = torch.tensor([0, 0, w, 8, 0, 0, 0, 0], dtype=torch.int32, device=cuda)
    lanes = (pix.to(torch.int32)[None], smp.to(torch.int32)[None])
    ref_rad, ref_rec = tmk.run_megakernel_record_reference(
        smem, *lanes, inputs["cam"], table, sd.sph_swept_nodes, sd.sph_swept_meta,
        max_depth=8, radiance=True,
    )
    assert torch.equal(rec, ref_rec) and torch.equal(rad, ref_rad.t())


def _assert_k3_scheme(got, want):
    """The JAX replay kernel's backward scheme (tests/test_replay.py:1017-
    1029), as tests/test_torch_replay.py holds K3 on book1."""
    for name, a, b in zip(("g_table", "g_o", "g_d"), got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max()), 1e-6)
        nd = np.abs(a - b) / scale
        cap = 0.005 if name == "g_table" else 0.02
        assert float((nd > 2e-4).mean()) < cap, f"{name}: outlier fraction"
        assert float(nd.max()) < 0.1, f"{name}: max {nd.max():.4f}"


@pytest.mark.cuda
def test_replay_kernels_at_1936_rows(cuda):
    sd, cp, w, h = _scene(cuda, 4, 128)
    p = w * h
    pix = torch.arange(p, device=cuda, dtype=torch.int32).repeat(2)
    smp = torch.arange(2, device=cuda, dtype=torch.int32).repeat_interleave(p)
    o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
    rec = trep.trace_record_mega(sd, cp, w, h, pix, smp, 0, 8)
    table = tint.make_sphere_table(sd).contiguous()
    assert table.shape[0] == 1936 and trk.supported(sd, table.shape[0])
    args = (table, o.contiguous(), d.contiguous(), torch.ones_like(pix), pix, smp, rec, 0)
    rad = trk.replay_forward(*args)
    assert torch.equal(rad, trk.replay_forward_reference(*args))
    g_rad = torch.randn(rad.shape, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    got = trk.replay_backward(*args, g_rad)
    again = trk.replay_backward(*args, g_rad)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0])
    _assert_k3_scheme(got, trk.replay_backward_reference(*args, g_rad))
