"""K8's record mode (the record megakernel's motion variants) on the card:
each instantiation of the CUDA kernel, fused and plain, against its plain
version, bit for bit; the zero-motion table against K2; and a moving scene
on CUDA tensors never reaching the plain record loop. Every test here needs
an NVIDIA GPU and skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_motion_record_card.py
"""

import pytest
import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.torch_motion_scenes import bouncing_book1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_motion_record_card.py)"
        )
    return torch.device("cuda")


def _record_inputs(sc, cuda, spp, depth):
    """Record-kernel inputs for every pixel of ``sc`` at ``spp`` samples,
    lanes sample-major as ``grad`` lays them out."""
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    inputs, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    p = w * h
    inputs["pix"] = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)[None]
    inputs["sample0"] = torch.arange(spp, device=cuda, dtype=torch.int32).repeat_interleave(p)[None]
    return sd, cp, inputs


def _counts():
    return tuple(tmk.RECORD_LAUNCHES[k] for k in ("brute", "walk", "motion", "motion_walk"))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "animated,cam_animated", [(True, False), (False, True), (True, True)],
    ids=["animated", "camera", "both"],
)
def test_k8_record_matches_plain_on_card(cuda, animated, cam_animated):
    _, _, inputs = _record_inputs(bouncing_book1(tdemo, 96), cuda, 2, 8)
    flags = dict(animated=animated, cam_animated=cam_animated)
    before = _counts()
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True, **flags)
    zero, plain = tmk.run_megakernel_record(**inputs, max_depth=8, **flags)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 2, before[3])
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(
        **inputs, max_depth=8, radiance=True, **flags)
    assert torch.equal(rec, ref_rec) and torch.equal(plain, rec)
    assert torch.equal(acc, ref_acc) and not bool(zero.any())
    assert bool(((rec & tmk.F_HIT) > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("accum_from", [0, 3])
def test_k8_record_flat_loop_hands_out_paths_in_any_order(cuda, accum_from):
    """K8's record in the flat loop at bouncing book1 320 wide, 8 spp,
    depth 50 (both flags): more paths than resident lanes, every seventh
    lane padding, the fused radiance from bounce ``accum_from`` on. Two
    launches hand the paths out in other orders and give the same bits,
    the plain version's."""
    flags = dict(animated=True, cam_animated=True)
    _, _, inputs = _record_inputs(bouncing_book1(tdemo, 320), cuda, 8, 50)
    r = inputs["pix"].shape[1]
    inputs["sample0"][:, ::7] = tmk.NO_SAMPLE
    inputs["smem"][4] = accum_from
    shape = tmk.flat_launch_shape(True, True, inputs["table"].shape[0], r, **flags)
    assert shape["grid"] * shape["threads"] < r
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=50, radiance=True, **flags)
    acc2, rec2 = tmk.run_megakernel_record(**inputs, max_depth=50, radiance=True, **flags)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**inputs, max_depth=50,
                                                           radiance=True, **flags)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)
    assert torch.equal(rec2, rec) and torch.equal(acc2, acc) and not rec[:, ::7].any()


@pytest.mark.cuda
def test_k8_record_walk_with_a_moving_camera_matches_plain_and_brute(cuda):
    sc = tdemo.sphere_stress(width=96, copies=4)
    sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
    sd, cp, inputs = _record_inputs(sc, cuda, 2, 8)
    assert cp.animated and not sd.animated and sd.sph_perm is not None
    walk = dict(inputs, table=tint.permute_table(inputs["table"], sd.sph_swept_perm),
                swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
    before = _counts()
    acc, rec = tmk.run_megakernel_record(**walk, max_depth=8, radiance=True, cam_animated=True)
    _, plain = tmk.run_megakernel_record(**walk, max_depth=8, cam_animated=True)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2], before[3] + 2)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(
        **walk, max_depth=8, radiance=True, cam_animated=True)
    assert torch.equal(rec, ref_rec) and torch.equal(plain, rec) and torch.equal(acc, ref_acc)
    b_acc, b_rec = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True,
                                             cam_animated=True)
    assert torch.equal(rec, b_rec) and torch.equal(acc, b_acc)


@pytest.mark.cuda
def test_k8_record_with_zero_motion_equals_k2(cuda):
    _, _, inputs = _record_inputs(tdemo.book1_end_scene(width=96), cuda, 2, 8)
    assert not bool(inputs["table"][:, 24:30].any())
    k2 = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True)
    k8 = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True, animated=True)
    torch.cuda.synchronize()
    assert torch.equal(k2[1], k8[1]) and torch.equal(k2[0], k8[0])


@pytest.mark.cuda
def test_k8_record_takes_its_row_cap(cuda):
    _, _, inputs = _record_inputs(bouncing_book1(tdemo, 32), cuda, 1, 2)
    t = inputs["table"]
    big = t[torch.arange(tmk.MAX_ROWS_ANIMATED, device=cuda) % t.shape[0]].contiguous()
    args = dict(inputs, pix=inputs["pix"][:, :256].contiguous(),
                sample0=inputs["sample0"][:, :256].contiguous(), table=big)
    _, rec = tmk.run_megakernel_record(**args, max_depth=2, animated=True)
    torch.cuda.synchronize()
    assert torch.equal(rec, tmk.run_megakernel_record_reference(**args, max_depth=2,
                                                                animated=True)[1])
    over = torch.cat([big, t[:1]]).contiguous()
    with pytest.raises(ValueError, match="shared"):
        tmk.run_megakernel_record(**dict(args, table=over), max_depth=2, animated=True)


@pytest.mark.cuda
@pytest.mark.parametrize("cam_only", [False, True], ids=["both", "camera"])
def test_cuda_motion_record_never_takes_the_twin(cuda, monkeypatch, cam_only):
    """A moving scene on CUDA tensors launches K8's record, in the kernel
    wrapper and through the gradient step, never the plain loop."""
    def no_twin(*args, **kwargs):
        raise AssertionError("CUDA tensors must not reach the plain record loop")

    monkeypatch.setattr(tmk, "run_megakernel_record_reference", no_twin)
    monkeypatch.setattr(tmk, "_reference_loop", no_twin)
    sc = bouncing_book1(tdemo, 32)
    if cam_only:
        sc = tdemo.smoke_scene(width=32)
        sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
    sd, cp, inputs = _record_inputs(sc, cuda, 1, 3)
    flags = dict(animated=bool(sd.animated), cam_animated=bool(cp.animated))
    before = tmk.RECORD_LAUNCHES["motion"]
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=3, radiance=True, **flags)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    loss, grads = G.loss_and_grad(G.extract_params(sd, cp), sd, cp,
                                  torch.zeros((w * h, 3), device=cuda),
                                  torch.arange(w * h, device=cuda), 0,
                                  width=w, height=h, spp=1, max_depth=3)
    torch.cuda.synchronize()
    assert tmk.RECORD_LAUNCHES["motion"] == before + 2
    assert rec.is_cuda and torch.isfinite(acc).all() and torch.isfinite(loss)
    assert all(bool(torch.isfinite(grads[k]).all()) for k in G.TENSOR_KEYS)
