"""K6 (the swept-tree walk in the megakernel's flat loop, forward and
record) on the card: each instantiation of the CUDA kernel against its
plain version and against the brute kernels on the original table (K8's
moving search, K1's static one), bit for bit, on bouncing stress n1936 96
wide; mixed path lengths and padding lanes, n7744, a tree whose nodes do
not fit in shared memory, and the launch shape. Every test here needs an
NVIDIA GPU and skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cull_card.py
"""

import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.torch_motion_scenes import bouncing_stress

# The flag sets: K6 moves its spheres (with or without the camera); without
# ``animated`` the same tree is walked by K5's static search (the moving
# table at w = 0), with either camera. Each runs in both modes.
RECORD_FLAGS = {"spheres": dict(animated=True, cam_animated=False),
                "both": dict(animated=True, cam_animated=True)}
FLAGS = {"static": dict(animated=False, cam_animated=False),
         "camera": dict(animated=False, cam_animated=True), **RECORD_FLAGS}


def _key(flags):
    """The launch count a tree walk with these flags adds to."""
    return tmk._variant(object(), None, flags["animated"], flags["cam_animated"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_cull_card.py)"
        )
    return torch.device("cuda")


def _inputs(cuda, spp, depth, record=False, copies=4, width=96):
    """(brute inputs on the original table, the same in the swept tree's
    order with the tree) for every pixel of bouncing stress (n1936 96 wide
    by default); record mode lays the lanes out sample-major."""
    sc = bouncing_stress(tdemo, width, copies)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    brute, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    if record:
        p = w * h
        brute["pix"] = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)[None]
        brute["sample0"] = torch.arange(spp, device=cuda,
                                        dtype=torch.int32).repeat_interleave(p)[None]
    cull = dict(brute, table=tint.permute_table(brute["table"], sd.sph_swept_perm),
                swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
    return brute, cull


def _lanes(x, lanes):
    return dict(x, pix=x["pix"][:, lanes].contiguous(), sample0=x["sample0"][:, lanes].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS.values(), ids=FLAGS.keys())
def test_cull_forward_equals_plain_and_brute(cuda, flags):
    """Without ``animated`` the moving table's tree is walked by K5's
    static search (w = 0), as K1 / K8's camera variant test every row."""
    brute, cull = _inputs(cuda, 4, 16)
    before = tmk.FORWARD_LAUNCHES[_key(flags)]
    got = tmk.run_megakernel(**cull, **flags)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES[_key(flags)] == before + 1
    assert torch.isfinite(got).all() and got.abs().sum() > 0
    assert torch.equal(got, tmk.run_megakernel_reference(**cull, **flags))
    assert torch.equal(got, tmk.run_megakernel(**brute, **flags))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS.values(), ids=FLAGS.keys())
def test_cull_record_equals_plain_and_brute(cuda, flags):
    brute, cull = _inputs(cuda, 2, 8, record=True)
    before = tmk.RECORD_LAUNCHES[_key(flags)]
    acc, rec = tmk.run_megakernel_record(**cull, max_depth=8, radiance=True, **flags)
    plain = tmk.run_megakernel_record(**cull, max_depth=8, **flags)[1]
    torch.cuda.synchronize()
    assert tmk.RECORD_LAUNCHES[_key(flags)] == before + 2
    assert torch.equal(rec, plain)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**cull, max_depth=8, radiance=True,
                                                           **flags)
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)
    b_acc, b_rec = tmk.run_megakernel_record(**brute, max_depth=8, radiance=True, **flags)
    assert torch.equal(rec, b_rec) and torch.equal(acc, b_acc)


@pytest.mark.cuda
def test_cull_walks_a_static_tables_clusters_as_k1(cuda):
    """book1's static table in a tree (zero deltas): the walk without
    motion (K5) gives K1's sums and its plain version's."""
    sc = tdemo.book1_end_scene(width=96)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    c = sd.sph_center.cpu().numpy()
    perm, snodes, smeta = tmk.swept_tables(c, sd.sph_radius.cpu().numpy(),
                                           sd.sph_active.cpu().numpy(), 0 * c, 0 * c[:, 0])
    inputs, _ = tint.mega_inputs(sd, cp, 96, 54, 4, 16, 0)
    cull = dict(inputs, table=tint.permute_table(inputs["table"],
                                                 torch.from_numpy(perm).to(cuda)),
                swept_nodes=torch.from_numpy(snodes).to(cuda),
                swept_meta=torch.from_numpy(smeta).to(cuda))
    got = tmk.run_megakernel(**cull, animated=False)
    assert torch.equal(got, tmk.run_megakernel(**inputs, animated=False))
    assert torch.equal(got, tmk.run_megakernel_reference(**cull))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", RECORD_FLAGS.values(), ids=RECORD_FLAGS.keys())
def test_cull_lanes_of_mixed_length_and_padding(cuda, flags):
    """Depth 50 at 2 spp, every fifth lane padding (sample0 = 2**30), more
    items than resident lanes: each lane's paths end at other bounces, and
    the flat loop gives the plain version's sums, the same bits twice."""
    brute, cull = _inputs(cuda, 2, 50, width=640)
    cull["sample0"][:, ::5] = tmk.NO_SAMPLE
    r = cull["pix"].shape[1]
    shape = tmk.flat_launch_shape(False, True, cull["table"].shape[0], r, nodes=int(
        cull["swept_nodes"].shape[0]), **flags)
    assert shape["grid"] * shape["threads"] < r
    got = tmk.run_megakernel(**cull, **flags)
    again = tmk.run_megakernel(**cull, **flags)
    lanes = torch.randperm(r, generator=torch.Generator().manual_seed(2))[:4096].sort().values
    lanes = lanes.to(cuda)
    ref = tmk.run_megakernel_reference(**_lanes(cull, lanes), **flags)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got[:, lanes], ref)
    assert not got[:, ::5].any()
    brute["sample0"][:, ::5] = tmk.NO_SAMPLE
    assert torch.equal(got, tmk.run_megakernel(**brute, **flags))


@pytest.mark.cuda
def test_cull_on_n7744_equals_plain(cuda):
    """bouncing stress n7744 (the main path's table) at 64 wide, both
    flags, forward and record, against the plain walk."""
    flags = RECORD_FLAGS["both"]
    _, cull = _inputs(cuda, 2, 16, copies=16, width=64)
    got = tmk.run_megakernel(**cull, **flags)
    assert torch.equal(got, tmk.run_megakernel_reference(**cull, **flags))
    _, cull = _inputs(cuda, 2, 8, record=True, copies=16, width=64)
    acc, rec = tmk.run_megakernel_record(**cull, max_depth=8, radiance=True, **flags)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**cull, max_depth=8,
                                                           radiance=True, **flags)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)


@pytest.mark.cuda
def test_cull_reads_nodes_from_global_memory_past_shared_memory(cuda):
    """A tree of more nodes than a block's shared memory holds (bouncing
    stress with 64 copies, 30,976 rows) is walked from global memory, and
    gives the plain version's sums and words."""
    flags = RECORD_FLAGS["both"]
    _, cull = _inputs(cuda, 1, 6, copies=64, width=32)
    k = int(cull["swept_nodes"].shape[0])
    assert k * tmk.NODE_BYTES > tmk.SHARED_MEM_BYTES
    shape = tmk.flat_launch_shape(False, True, cull["table"].shape[0], 1, nodes=k, **flags)
    assert shape["smem_bytes"] == 0
    got = tmk.run_megakernel(**cull, **flags)
    assert torch.equal(got, tmk.run_megakernel_reference(**cull, **flags))
    acc, rec = tmk.run_megakernel_record(**cull, max_depth=6, radiance=True, **flags)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(**cull, max_depth=6,
                                                           radiance=True, **flags)
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)


@pytest.mark.cuda
def test_cull_refuses_a_tree_deeper_than_its_stack(cuda):
    """A chain tree of n1936's rows is deeper than the near-first walk's
    stack (``TREE_STACK``): both wrappers refuse it and launch nothing."""
    from tests.test_torch_swept_tree import chain_tree

    flags = RECORD_FLAGS["both"]
    sc = bouncing_stress(tdemo, 96, 4)
    _, snodes, smeta = chain_tree(sc.build(device="cpu"))
    k = snodes.shape[0]
    assert tmk.tree_depth(torch.from_numpy(smeta[: 3 * k].reshape(k, 3))) > tmk.TREE_STACK
    chain = dict(swept_nodes=torch.from_numpy(snodes).to(cuda),
                 swept_meta=torch.from_numpy(smeta).to(cuda))
    before = tmk.FORWARD_LAUNCHES["cull"], tmk.RECORD_LAUNCHES["cull"]
    _, cull = _inputs(cuda, 2, 8)
    with pytest.raises(ValueError, match="deeper than K6's stack"):
        tmk.run_megakernel(**dict(cull, **chain), **flags)
    _, cull = _inputs(cuda, 2, 8, record=True)
    with pytest.raises(ValueError, match="deeper than K6's stack"):
        tmk.run_megakernel_record(**dict(cull, **chain), max_depth=8, radiance=True, **flags)
    assert (tmk.FORWARD_LAUNCHES["cull"], tmk.RECORD_LAUNCHES["cull"]) == before


@pytest.mark.cuda
def test_cull_launch_shape_fills_the_card(cuda):
    """n7744's tree fits in shared memory: K6 stages its nodes and keeps
    at least one 256-thread block resident on every SM; a launch of many
    lanes takes every resident block."""
    _, cull = _inputs(cuda, 1, 2, copies=16, width=32)
    k = int(cull["swept_nodes"].shape[0])
    for record in (False, True):
        shape = tmk.flat_launch_shape(record, True, cull["table"].shape[0], 1 << 22,
                                      nodes=k, animated=True, cam_animated=True)
        assert shape["smem_bytes"] == k * tmk.NODE_BYTES and shape["threads"] == 256
        assert shape["blocks_per_sm"] >= 1
        assert shape["grid"] == shape["blocks_per_sm"] * shape["sms"]


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
    record launch K6's walk, then K7 moving's stage (``cull_tri``; until
    ROADMAP A11 they launched K8's brute search beside K7 moving), and give
    what the same scene without its walk tables gives, which launches the
    brute search beside K7 moving."""
    from dataclasses import replace

    from crucible_tpu_torch.models import render as trender
    from crucible_tpu_torch.models import replay as trep
    from crucible_tpu_torch.models import scene as tscene
    from tests.torch_mesh_scenes import add_fan

    sc = add_fan(tscene, bouncing_stress(tdemo, 96, 4))
    for i in range(80):
        sc.translate_x(0.5, 1.0 / 48.0, "lerp", "world", f"tri{i}")
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    brute = replace(sd, sph_perm=None, sph_cbounds=None, sph_swept_perm=None,
                    sph_swept_nodes=None, sph_swept_meta=None)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    pix = torch.arange(w * h, device=cuda)
    tmk.zero_counts()
    img = trender.render_image_persistent(sd, cp, w, h, 2, 8, 0)
    rec = trep.trace_record_mega(sd, cp, w, h, pix, torch.zeros_like(pix), 0, 8)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES["cull_tri"] == 1 and tmk.FORWARD_LAUNCHES["tri_motion"] == 0
    assert tmk.RECORD_LAUNCHES["cull_tri"] == 1 and tmk.RECORD_LAUNCHES["tri_motion"] == 0
    assert torch.equal(img, trender.render_image_persistent(brute, cp, w, h, 2, 8, 0,
                                                            cull=False))
    assert torch.equal(rec, trep.trace_record_mega(brute, cp, w, h, pix,
                                                   torch.zeros_like(pix), 0, 8))
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES["tri_motion"] == 1 and tmk.RECORD_LAUNCHES["tri_motion"] == 1
    assert ((rec & tmk.F_TRI) > 0).any()
