"""K6 (the megakernel's chunk-cull branch, forward and record) on the card:
each instantiation of the CUDA kernel against its plain version and
against the brute kernels on the original table (K8's moving search, K1's
static one), bit for bit, on bouncing stress n1936 96 wide. Every test here
needs an NVIDIA GPU and skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cull_card.py
"""

import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.torch_motion_scenes import bouncing_stress

# The instantiated flag sets: K6 moves its spheres (with or without the
# camera) in both modes; over a static table it runs forward only, with a
# static camera.
RECORD_FLAGS = {"spheres": dict(animated=True, cam_animated=False),
                "both": dict(animated=True, cam_animated=True)}
FLAGS = {"static": dict(animated=False, cam_animated=False), **RECORD_FLAGS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_cull_card.py)"
        )
    return torch.device("cuda")


def _inputs(cuda, spp, depth, record=False):
    """(brute inputs on the original table, the same in cluster order with
    the cluster bounds) for every pixel of bouncing stress n1936 96 wide;
    record mode lays the lanes out sample-major."""
    sc = bouncing_stress(tdemo, 96, 4)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    brute, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    if record:
        p = w * h
        brute["pix"] = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)[None]
        brute["sample0"] = torch.arange(spp, device=cuda,
                                        dtype=torch.int32).repeat_interleave(p)[None]
    cull = dict(brute, table=tint.permute_table(brute["table"], sd.sph_perm),
                cbounds=sd.sph_cbounds)
    return brute, cull


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS.values(), ids=FLAGS.keys())
def test_cull_forward_equals_plain_and_brute(cuda, flags):
    """Without ``animated`` the moving table's clusters are walked at w = 0
    of the static search, as K1 / K8's camera variant test every row."""
    brute, cull = _inputs(cuda, 4, 16)
    before = tmk.FORWARD_LAUNCHES["cull"]
    got = tmk.run_megakernel(**cull, **flags)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES["cull"] == before + 1
    assert torch.isfinite(got).all() and got.abs().sum() > 0
    assert torch.equal(got, tmk.run_megakernel_reference(**cull, **flags))
    assert torch.equal(got, tmk.run_megakernel(**brute, **flags))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", RECORD_FLAGS.values(), ids=RECORD_FLAGS.keys())
def test_cull_record_equals_plain_and_brute(cuda, flags):
    brute, cull = _inputs(cuda, 2, 8, record=True)
    before = tmk.RECORD_LAUNCHES["cull"]
    acc, rec = tmk.run_megakernel_record(**cull, max_depth=8, radiance=True, **flags)
    plain = tmk.run_megakernel_record(**cull, max_depth=8, **flags)[1]
    torch.cuda.synchronize()
    assert tmk.RECORD_LAUNCHES["cull"] == before + 2
    assert torch.equal(rec, plain)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**cull, max_depth=8, radiance=True,
                                                           **flags)
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)
    b_acc, b_rec = tmk.run_megakernel_record(**brute, max_depth=8, radiance=True, **flags)
    assert torch.equal(rec, b_rec) and torch.equal(acc, b_acc)


@pytest.mark.cuda
def test_cull_walks_a_static_tables_clusters_as_k1(cuda):
    """book1's static table in clusters (no deltas): K6 without motion gives
    K1's sums."""
    sc = tdemo.book1_end_scene(width=96)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    perm, bounds = tmk.cluster_spheres(sd.sph_center.cpu().numpy(),
                                       sd.sph_radius.cpu().numpy(),
                                       sd.sph_active.cpu().numpy())
    inputs, _ = tint.mega_inputs(sd, cp, 96, 54, 4, 16, 0)
    cull = dict(inputs, table=tint.permute_table(inputs["table"],
                                                 torch.from_numpy(perm).to(cuda)),
                cbounds=torch.from_numpy(bounds).to(cuda))
    assert torch.equal(tmk.run_megakernel(**cull, animated=False),
                       tmk.run_megakernel(**inputs, animated=False))


@pytest.mark.cuda
def test_moving_big_scene_never_reaches_the_plain_walk(cuda, monkeypatch):
    """On CUDA tensors the render and the gradient's record launch K6 and
    never the plain loop."""
    from crucible_tpu_torch import grad as G
    from crucible_tpu_torch.models import render as trender

    def refuse(*args, **kwargs):
        raise AssertionError("the plain loop ran on CUDA tensors")

    monkeypatch.setattr(tmk, "_reference_loop", refuse)
    sc = bouncing_stress(tdemo, 96, 4)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    tmk.zero_counts()
    img = trender.render_image_persistent(sd, cp, w, h, 2, 8, 0)
    pix = torch.arange(w * h, device=cuda)
    loss, _ = G.loss_and_grad(G.extract_params(sd, cp), sd, cp,
                              torch.zeros((w * h, 3), device=cuda), pix, 0,
                              width=w, height=h, spp=2, max_depth=4)
    torch.cuda.synchronize()
    assert torch.isfinite(img).all() and torch.isfinite(loss)
    assert tmk.FORWARD_LAUNCHES["cull"] == 1 and tmk.RECORD_LAUNCHES["cull"] == 1


@pytest.mark.cuda
def test_mesh_beside_a_moving_table_launches_the_brute_search(cuda):
    """A moving mesh beside bouncing stress n1936: the render and the
    record launch K8's brute search beside K7 moving, never K6, and give
    what the same scene without cluster tables gives."""
    from dataclasses import replace

    from crucible_tpu_torch.models import render as trender
    from crucible_tpu_torch.models import replay as trep
    from crucible_tpu_torch.models import scene as tscene
    from tests.torch_mesh_scenes import add_fan

    sc = add_fan(tscene, bouncing_stress(tdemo, 96, 4))
    for i in range(80):
        sc.translate_x(0.5, 1.0 / 48.0, "lerp", "world", f"tri{i}")
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    brute = replace(sd, sph_perm=None, sph_cbounds=None)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    pix = torch.arange(w * h, device=cuda)
    tmk.zero_counts()
    img = trender.render_image_persistent(sd, cp, w, h, 2, 8, 0)
    rec = trep.trace_record_mega(sd, cp, w, h, pix, torch.zeros_like(pix), 0, 8)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES["cull"] == 0 and tmk.FORWARD_LAUNCHES["tri_motion"] == 1
    assert tmk.RECORD_LAUNCHES["cull"] == 0 and tmk.RECORD_LAUNCHES["tri_motion"] == 1
    assert torch.equal(img, trender.render_image_persistent(brute, cp, w, h, 2, 8, 0))
    assert torch.equal(rec, trep.trace_record_mega(brute, cp, w, h, pix,
                                                   torch.zeros_like(pix), 0, 8))
    assert ((rec & tmk.F_TRI) > 0).any()
