"""K8 (the megakernel's motion variants) and the movie driver on the card:
each instantiation of the CUDA kernel against its plain version, bit for
bit, and ``render_movie`` through it. Every test here needs an NVIDIA GPU
and skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_motion_card.py
"""

import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from crucible_tpu_torch.ops.kernels import sphere_shade as tss
from tests.torch_motion_scenes import bouncing_book1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_motion_card.py)"
        )
    return torch.device("cuda")


def _inputs(sc, cuda, spp, depth):
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    inputs, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    return sd, cp, inputs


@pytest.mark.cuda
@pytest.mark.parametrize(
    "animated,cam_animated", [(True, False), (False, True), (True, True)],
    ids=["animated", "camera", "both"],
)
def test_k8_brute_matches_plain_on_card(cuda, animated, cam_animated):
    _, _, inputs = _inputs(bouncing_book1(tdemo, 96), cuda, 2, 50)
    flags = dict(animated=animated, cam_animated=cam_animated)
    before = (tmk.FORWARD_LAUNCHES["brute"], tmk.FORWARD_LAUNCHES["motion"])
    out = tmk.run_megakernel(**inputs, **flags)
    torch.cuda.synchronize()
    assert (tmk.FORWARD_LAUNCHES["brute"], tmk.FORWARD_LAUNCHES["motion"]) == (
        before[0], before[1] + 1)
    assert torch.isfinite(out).all()
    assert torch.equal(out, tmk.run_megakernel_reference(**inputs, **flags))


FLAG_SETS = {"animated": dict(animated=True, cam_animated=False),
             "camera": dict(animated=False, cam_animated=True),
             "both": dict(animated=True, cam_animated=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAG_SETS.values(), ids=FLAG_SETS.keys())
def test_k8_flat_loop_lanes_of_mixed_length_and_padding(cuda, flags):
    """K8's brute search in the flat loop: bouncing book1 640 wide, 2 spp,
    depth 50, every fifth lane padding (sample0 = 2**30), more items than
    resident lanes, so lanes take items whose paths end at other bounces;
    two launches give the same bits, the plain version's on 4096 lanes."""
    _, _, inputs = _inputs(bouncing_book1(tdemo, 640), cuda, 2, 50)
    inputs["sample0"][:, ::5] = tmk.NO_SAMPLE
    r = inputs["pix"].shape[1]
    shape = tmk.flat_launch_shape(False, True, inputs["table"].shape[0], r, **flags)
    assert shape["grid"] * shape["threads"] < r
    out = tmk.run_megakernel(**inputs, **flags)
    again = tmk.run_megakernel(**inputs, **flags)
    lanes = torch.randperm(r, generator=torch.Generator().manual_seed(4))[:4096].sort().values
    lanes = lanes.to(cuda)
    sub = dict(inputs, pix=inputs["pix"][:, lanes], sample0=inputs["sample0"][:, lanes])
    ref = tmk.run_megakernel_reference(**sub, **flags)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out[:, lanes], ref)
    assert not out[:, ::5].any()


@pytest.mark.cuda
def test_k8_launch_shape_is_the_flat_loops(cuda):
    """K8's brute search stages 36 bytes a moving row (16 with the camera
    alone) and runs 128-thread blocks; a launch of many lanes takes every
    resident block."""
    _, _, inputs = _inputs(bouncing_book1(tdemo, 32), cuda, 1, 2)
    n = inputs["table"].shape[0]
    for flags, row in ((FLAG_SETS["both"], 36), (FLAG_SETS["camera"], 16)):
        shape = tmk.flat_launch_shape(False, True, n, 1 << 22, **flags)
        assert shape["threads"] == 128 and shape["smem_bytes"] == -(-n // 4) * 4 * row
        assert shape["blocks_per_sm"] >= 1
        assert shape["grid"] == shape["blocks_per_sm"] * shape["sms"]


@pytest.mark.cuda
def test_k8_walk_with_a_moving_camera_matches_plain_and_brute(cuda):
    sc = tdemo.sphere_stress(width=96, copies=4)
    sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
    sd, cp, inputs = _inputs(sc, cuda, 2, 16)
    assert cp.animated and not sd.animated and sd.sph_perm is not None
    walk = dict(inputs, table=tint.permute_table(inputs["table"], sd.sph_swept_perm),
                swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
    before = tmk.FORWARD_LAUNCHES["motion_walk"]
    out = tmk.run_megakernel(**walk, animated=False, cam_animated=True)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES["motion_walk"] == before + 1
    assert torch.equal(out, tmk.run_megakernel_reference(**walk, cam_animated=True))
    assert torch.equal(out, tmk.run_megakernel(**inputs, animated=False, cam_animated=True))


@pytest.mark.cuda
def test_k8_takes_its_row_cap(cuda):
    """An animated table of MAX_ROWS_ANIMATED rows fits a block's shared
    memory; one row more is refused before the launch."""
    _, _, inputs = _inputs(bouncing_book1(tdemo, 32), cuda, 1, 2)
    t = inputs["table"]
    big = t[torch.arange(tmk.MAX_ROWS_ANIMATED, device=cuda) % t.shape[0]].contiguous()
    lanes = dict(pix=inputs["pix"][:, :256].contiguous(),
                 sample0=inputs["sample0"][:, :256].contiguous())
    args = dict(inputs, **lanes, table=big)
    out = tmk.run_megakernel(**args, animated=True)
    torch.cuda.synchronize()
    assert torch.equal(out, tmk.run_megakernel_reference(**args, animated=True))
    over = torch.cat([big, t[:1]]).contiguous()
    with pytest.raises(ValueError, match="shared"):
        tmk.run_megakernel(**dict(args, table=over), animated=True)


@pytest.mark.cuda
def test_render_movie_on_card(cuda, tmp_path):
    """Two frames of bouncing book1 (moving, then past its keyframe) through
    K8, and two of first_movie through the pixel schedule (K9)."""
    sc = bouncing_book1(tdemo, 64)
    sc.duration = 2 / 24
    sc.scene_cam.set_samples(2)
    sc.scene_cam.set_max_depth(8)
    before = (tmk.FORWARD_LAUNCHES["brute"], tmk.FORWARD_LAUNCHES["motion"])
    frames = []
    out = trender.render_movie(sc, str(tmp_path / "bounce"), verbose=False,
                               on_frame=lambda fi, dt: frames.append(fi))
    assert frames == [0, 1]
    assert (tmk.FORWARD_LAUNCHES["brute"], tmk.FORWARD_LAUNCHES["motion"]) == (
        before[0], before[1] + 2)
    assert sorted(p.name for p in (tmp_path / "bounce" / "artifacts").iterdir()) == [
        "image000.ppm", "image001.ppm"]
    assert out.exists()

    movie = tdemo.first_movie(duration=2 / 24)
    movie.scene_cam.image_width = 64
    movie.scene_cam.set_samples(2)
    before = tss.LAUNCHES
    trender.render_movie(movie, str(tmp_path / "first"), verbose=False)
    assert tss.LAUNCHES > before
    assert len(list((tmp_path / "first" / "artifacts").iterdir())) == 2
