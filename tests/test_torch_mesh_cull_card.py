"""A mesh beside a sphere tree on the card: ``flat_kernel`` with TREE and
TRI, K5's static walk then K7's triangle walk (``walk_tri``), and with
ANIMATED K6's swept-tree walk then K7 moving's (``cull_tri``), each with
and without K8's camera flag, forward and record (fused and plain):
against their plain versions and against the brute search with the same
triangle stage (K1 + K7, K8 + K7 moving) on the original table, bit for
bit; and their launch shapes. The scenes: sphere_stress n1936 with a
576-triangle torus, and bouncing stress n1936 with the torus rising
(``tests/torch_mesh_scenes.torus_beside_stress``), 96 wide. Every test
here needs an NVIDIA GPU and skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cull_card.py
"""

import functools

import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.torch_mesh_scenes import torus_beside_stress

# (moving scene, flags): the static scene's tree walked by K5 (with or
# without K8's camera flag, whose deltas are zero there), the moving one's
# swept tree by K6 (the spheres alone, or with the rising camera).
CASES = {
    "walk": (False, dict(animated=False, cam_animated=False)),
    "walk_camera": (False, dict(animated=False, cam_animated=True)),
    "cull": (True, dict(animated=True, cam_animated=False)),
    "cull_camera": (True, dict(animated=True, cam_animated=True)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_mesh_cull_card.py)"
        )
    return torch.device("cuda")


@functools.cache
def _scene(moving: bool):
    return torus_beside_stress(tdemo, tscene, 96, moving=moving)


def _inputs(cuda, moving, spp, depth, record=False):
    """(brute inputs on the original table with the mesh's tables, the same
    in the tree's order with the tree) for every pixel; record mode lays
    the lanes out sample-major."""
    sc = _scene(moving)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    assert sd.use_bvh and sd.sph_swept_nodes is not None and sd.animated == moving
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    brute, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    brute.update(zip(("tri_nodes", "tris", "mats", "tri_meta"), tint.make_tri_tables(sd)))
    if record:
        p = w * h
        brute["pix"] = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)[None]
        brute["sample0"] = torch.arange(spp, device=cuda,
                                        dtype=torch.int32).repeat_interleave(p)[None]
    walk = dict(brute, table=tint.permute_table(brute["table"], sd.sph_swept_perm),
                swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
    return brute, walk


def _key(flags):
    return "cull_tri" if flags["animated"] else "walk_tri"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=CASES.keys())
def test_pair_forward_equals_plain_and_brute(cuda, case):
    moving, flags = CASES[case]
    brute, walk = _inputs(cuda, moving, 2, 12)
    before = dict(tmk.FORWARD_LAUNCHES)
    got = tmk.run_megakernel(**walk, **flags)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES == dict(before, **{_key(flags): before[_key(flags)] + 1})
    assert torch.isfinite(got).all() and got.abs().sum() > 0
    assert torch.equal(got, tmk.run_megakernel_reference(**walk, **flags))
    assert torch.equal(got, tmk.run_megakernel(**brute, **flags))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=CASES.keys())
def test_pair_record_equals_plain_and_brute(cuda, case):
    moving, flags = CASES[case]
    brute, walk = _inputs(cuda, moving, 2, 6, record=True)
    before = tmk.RECORD_LAUNCHES[_key(flags)]
    acc, rec = tmk.run_megakernel_record(**walk, max_depth=6, radiance=True, **flags)
    zero, plain = tmk.run_megakernel_record(**walk, max_depth=6, **flags)
    torch.cuda.synchronize()
    assert tmk.RECORD_LAUNCHES[_key(flags)] == before + 2
    assert torch.equal(rec, plain) and not bool(zero.any())
    assert ((rec & tmk.F_TRI) > 0).any() and ((rec & tmk.F_HIT) > 0).sum() > ((rec & tmk.F_TRI) > 0).sum()
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**walk, max_depth=6, radiance=True,
                                                           **flags)
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)
    b_acc, b_rec = tmk.run_megakernel_record(**brute, max_depth=6, radiance=True, **flags)
    assert torch.equal(rec, b_rec) and torch.equal(acc, b_acc)


@pytest.mark.cuda
@pytest.mark.parametrize("record", [False, True], ids=["forward", "record"])
@pytest.mark.parametrize("case", CASES, ids=CASES.keys())
def test_pair_launch_shape(cuda, case, record):
    """Both walks in one thread: the shape the pair launches with (its
    registers and local bytes, the sphere walk's stack among them, are
    PERF.md's)."""
    moving, flags = CASES[case]
    _, walk = _inputs(cuda, moving, 1, 4)
    shape = tmk.flat_launch_shape(record, True, walk["table"].shape[0], walk["pix"].shape[1],
                                  nodes=int(walk["swept_nodes"].shape[0]),
                                  tri_nodes=int(walk["tri_nodes"].shape[0]), **flags)
    assert shape["threads"] == 256 and shape["blocks_per_sm"] >= 1 and shape["grid"] >= 1
    assert shape["smem_bytes"] == int(walk["swept_nodes"].shape[0]) * tmk.NODE_BYTES
    assert shape["spill_bytes"] >= 8 * tmk.TREE_STACK  # the sphere walk's stack
