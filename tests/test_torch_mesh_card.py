"""K7, the megakernel's triangle-BVH stage for static meshes (in its flat
loop, its nodes read from global memory), on the card: the CUDA kernel's
forward and record instantiations (fused and plain) against the plain
version, bit for bit, on the 80-triangle fan and on torus_teapot's 6,320
triangles; an exact tie between duplicated triangles in two leaves (K7 and
K7 moving); and a mesh render on CUDA tensors never reaching the plain
loop. Every test here needs an NVIDIA GPU and skips
elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_card.py
"""

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
            "python -m pytest --noconftest -m cuda tests/test_torch_mesh_card.py)"
        )
    return torch.device("cuda")


SCENES = {"fan": meshes.fan, "torus_teapot": meshes.torus_teapot}


def _inputs(name, cuda, spp, depth, record=False):
    """The kernel's inputs for every pixel of the scene at 96 wide, with its
    triangle tables; record mode lays lanes out sample-major."""
    sc = SCENES[name](tscene, 96)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    assert sd.use_bvh and tint.megakernel_supported(sd, cp)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    inputs, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    inputs.update(zip(("tri_nodes", "tris", "mats", "tri_meta"), tint.make_tri_tables(sd)))
    if record:
        p = w * h
        inputs["pix"] = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)[None]
        inputs["sample0"] = torch.arange(
            spp, device=cuda, dtype=torch.int32).repeat_interleave(p)[None]
    return inputs


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_k7_forward_matches_plain_on_card(cuda, name):
    inputs = _inputs(name, cuda, 4, 16)
    before = dict(tmk.FORWARD_LAUNCHES)
    out = tmk.run_megakernel(**inputs, animated=False)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES == dict(before, tri=before["tri"] + 1)
    assert torch.isfinite(out).all()
    assert torch.equal(out, tmk.run_megakernel_reference(**inputs))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_k7_record_matches_plain_on_card(cuda, name):
    inputs = _inputs(name, cuda, 2, 8, record=True)
    before = dict(tmk.RECORD_LAUNCHES)
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True)
    zero, plain = tmk.run_megakernel_record(**inputs, max_depth=8)
    torch.cuda.synchronize()
    assert tmk.RECORD_LAUNCHES == dict(before, tri=before["tri"] + 2)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**inputs, max_depth=8,
                                                            radiance=True)
    assert torch.equal(rec, ref_rec) and torch.equal(plain, rec)
    assert torch.equal(acc, ref_acc) and not bool(zero.any())
    # Triangle winners carry F_TRI and no far-root bit.
    tri = (rec & tmk.F_TRI) > 0
    assert bool(tri.any()) and not bool((rec[tri] & tmk.F_ROOT1).any())


@pytest.mark.cuda
def test_mesh_render_on_card_launches_k7_only(cuda):
    sc = meshes.fan(tscene, 32)
    tmk.TRI_COUNTS.update(nodes=0, rows=0)
    before = dict(tmk.FORWARD_LAUNCHES)
    img = trender.render_image(sc, 2, 8)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert tmk.FORWARD_LAUNCHES == dict(before, tri=before["tri"] + 1)
    assert tmk.TRI_COUNTS == {"nodes": 0, "rows": 0}  # the plain walk never ran


def _tie_inputs(cuda, moving, spp, depth, record=False):
    """tests/test_torch_tri_walk.py's exact tie (two copies of one triangle
    in two leaves, the higher row's entered first), its inputs built on the
    CPU and moved to the card, so that kernel and plain version read the
    same bits."""
    from tests.test_torch_tri_walk import tie_scene

    sd, cp, w, h = tie_scene(moving=moving)
    inputs, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    inputs.update(zip(("tri_nodes", "tris", "mats", "tri_meta"), tint.make_tri_tables(sd)))
    if record:
        p = w * h
        inputs["pix"] = torch.arange(p, dtype=torch.int32).repeat(spp)[None]
        inputs["sample0"] = torch.arange(spp, dtype=torch.int32).repeat_interleave(p)[None]
    return {k: v.to(cuda) for k, v in inputs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("moving", [False, True], ids=["woop", "moving"])
def test_k7_exact_tie_takes_the_dfs_winner_on_card(cuda, moving):
    """The exact tie between duplicated triangles in two leaves: K7 (and K7
    moving) give the plain version's sums and words, every triangle word
    holding row 0, the DFS walk's winner."""
    inputs = _tie_inputs(cuda, moving, 2, 8)
    out = tmk.run_megakernel(**inputs, animated=moving)
    assert torch.equal(out, tmk.run_megakernel_reference(**inputs, animated=moving))
    inputs = _tie_inputs(cuda, moving, 1, 8, record=True)
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True, animated=moving)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**inputs, max_depth=8,
                                                            radiance=True, animated=moving)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)
    words = rec[(rec & tmk.F_TRI) > 0]
    assert words.numel() > 0 and not (words // tmk.REC_ID_SCALE).any()


@pytest.mark.cuda
def test_k7_reads_its_nodes_from_global_memory(cuda):
    """K7 stages only the brute search's rows: torus_teapot's launch shape
    takes 16 bytes a sphere row of shared memory, none for its 3,159 nodes,
    and keeps several 256-thread blocks resident; the launch gives the
    plain version's sums and words."""
    inputs = _inputs("torus_teapot", cuda, 2, 16)
    n, kt = inputs["table"].shape[0], inputs["tri_nodes"].shape[0]
    for record in (False, True):
        shape = tmk.flat_launch_shape(record, True, n, 1 << 22, tri_nodes=kt)
        assert shape["threads"] == 256 and shape["blocks_per_sm"] >= 3
        assert shape["smem_bytes"] == -(-n // 4) * 4 * 16
    out = tmk.run_megakernel(**inputs, animated=False)
    assert torch.equal(out, tmk.run_megakernel_reference(**inputs))
    inputs = _inputs("torus_teapot", cuda, 1, 8, record=True)
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**inputs, max_depth=8,
                                                            radiance=True)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)
