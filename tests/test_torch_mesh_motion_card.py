"""K7 moving, the megakernel's triangle-BVH stage over a moving mesh, and
K7 for a static mesh seen by a keyframed camera, on the card: the CUDA
kernel's forward and record instantiations (fused and plain) against the
plain version, bit for bit, on the moving fan, the fan beside a moving
sphere, the moving fan and the static fan under a rising camera, and moving
torus_teapot's 6,320 triangles; and a moving mesh's render on CUDA tensors
never reaching the plain loop. Every test here needs an NVIDIA GPU and
skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_motion_card.py
"""

import functools

import pytest
import torch

from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests import torch_mesh_scenes as meshes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_mesh_motion_card.py)"
        )
    return torch.device("cuda")


SCENES = {
    "moving_fan": meshes.moving_fan,
    "fan_moving_sphere": meshes.fan_beside_moving_sphere,
    "moving_fan_camera": functools.partial(meshes.moving_fan, camera=True),
    "fan_rising_camera": meshes.fan_rising_camera,
    "moving_torus_teapot": meshes.moving_torus_teapot,
}


@functools.cache
def _scene(name):
    return SCENES[name](tscene, 96)


def _inputs(name, cuda, spp, depth, record=False):
    """The kernel's inputs for every pixel of the scene at 96 wide, with its
    triangle tables and motion flags; record mode lays lanes out
    sample-major."""
    sc = _scene(name)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    assert sd.use_bvh and tint.megakernel_supported(sd, cp) and (sd.animated or cp.animated)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    inputs, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    inputs.update(zip(("tri_nodes", "tris", "mats", "tri_meta"), tint.make_tri_tables(sd)))
    assert inputs["tris"].shape[1] == (32 if sd.animated else 16)
    if record:
        p = w * h
        inputs["pix"] = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)[None]
        inputs["sample0"] = torch.arange(
            spp, device=cuda, dtype=torch.int32).repeat_interleave(p)[None]
    return inputs, dict(animated=bool(sd.animated), cam_animated=bool(cp.animated))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_k7_motion_forward_matches_plain_on_card(cuda, name):
    inputs, flags = _inputs(name, cuda, 4, 16)
    before = dict(tmk.FORWARD_LAUNCHES)
    out = tmk.run_megakernel(**inputs, **flags)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES == dict(before, tri_motion=before["tri_motion"] + 1)
    assert torch.isfinite(out).all()
    assert torch.equal(out, tmk.run_megakernel_reference(**inputs, **flags))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_k7_motion_record_matches_plain_on_card(cuda, name):
    inputs, flags = _inputs(name, cuda, 2, 8, record=True)
    before = dict(tmk.RECORD_LAUNCHES)
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True, **flags)
    zero, plain = tmk.run_megakernel_record(**inputs, max_depth=8, **flags)
    torch.cuda.synchronize()
    assert tmk.RECORD_LAUNCHES == dict(before, tri_motion=before["tri_motion"] + 2)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**inputs, max_depth=8,
                                                            radiance=True, **flags)
    assert torch.equal(rec, ref_rec) and torch.equal(plain, rec)
    assert torch.equal(acc, ref_acc) and not bool(zero.any())
    # Triangle winners carry F_TRI and no far-root bit.
    tri = (rec & tmk.F_TRI) > 0
    assert bool(tri.any()) and not bool((rec[tri] & tmk.F_ROOT1).any())


@pytest.mark.cuda
def test_moving_mesh_render_on_card_launches_k7_moving_only(cuda):
    sc = meshes.moving_fan(tscene, 32)
    tmk.TRI_COUNTS.update(nodes=0, rows=0)
    before = dict(tmk.FORWARD_LAUNCHES)
    img = trender.render_image(sc, 2, 8)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert tmk.FORWARD_LAUNCHES == dict(before, tri_motion=before["tri_motion"] + 1)
    assert tmk.TRI_COUNTS == {"nodes": 0, "rows": 0}  # the plain walk never ran
