"""K1, the forward megakernel: the port's eager version against the JAX
package's Pallas kernel (interpret mode on the CPU) on the same bridged
tables, the wrapper's dispatch and checks, and — on a GPU only — the CUDA
kernel against its eager version."""

import numpy as np
import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops.kernels import build as tbuild
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.torch_motion_scenes import bouncing_stress
from tests.torch_threads import one_torch_thread  # noqa: F401

# The JAX side is imported inside the helpers that use it, so that the
# card-only tests at the end also run where JAX is not installed:
#   python -m pytest --noconftest -m cuda tests/test_torch_megakernel.py

INPUTS = ("smem", "pix", "sample0", "cam", "table")


def _inputs(name, width, spp, depth, seed=0):
    """Megakernel inputs as numpy: the table and camera vector built by the
    JAX package, the lane layout by the port. Also returns lane_of and the
    JAX scene."""
    from crucible_tpu.models import demo as jdemo
    from crucible_tpu.models import integrator as jint
    from tests.test_torch_scene import bridged

    js = getattr(jdemo, name)(width=width)
    jsd, jcp = js.build(), js.scene_cam.params()
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    sd, cp = bridged(js)
    inputs, lane_of = tint.mega_inputs(sd, cp, w, h, spp, depth, seed)
    arrays = {k: v.numpy() for k, v in inputs.items()}
    arrays["table"] = np.array(jint.make_sphere_table(jsd))  # writable copies
    arrays["cam"] = np.array(jint.mega_cam_vector(jcp, w, h))
    return arrays, lane_of.numpy(), js


def _jax(arrays):
    import jax.numpy as jnp
    from crucible_tpu.ops.pallas import megakernel as jmk

    acc = jmk.run_megakernel(
        *(jnp.asarray(arrays[k]) for k in INPUTS), animated=False, interpret=True
    )
    return np.asarray(acc)


def _port(arrays):
    return tmk.run_megakernel(
        **{k: torch.from_numpy(arrays[k]) for k in INPUTS}, animated=False
    ).numpy()


def test_smoke_matches_jax_kernel():
    arrays, _, _ = _inputs("smoke_scene", 32, 4, 6)
    want, got = _jax(arrays), _port(arrays)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_book1_matches_jax_kernel_statistically():
    arrays, lane_of, _ = _inputs("book1_end_scene", 32, 2, 8)
    want, got = _jax(arrays).T[lane_of] / 2, _port(arrays).T[lane_of] / 2
    # Glass chains and self-intersections flip on last-ulp differences, and
    # XLA's CPU code contracts multiply-adds where torch rounds each op, so
    # book1 agrees only statistically. The JAX package's own staged and
    # megakernel schedules agree on 97.7-99.4% of pixel values here (seeds
    # 0-7), under the 0.99 of its earth/garden cross-path test; hence 0.97.
    close = np.isclose(got, want, rtol=1e-3, atol=1e-3).mean()
    assert close > 0.97, close
    assert abs(got.mean() - want.mean()) <= 2e-3


def test_lane_layout_matches_jax():
    """mega_inputs lays lanes out as the JAX trace_persistent_mega does:
    un-swizzling the JAX kernel's sums by the port's lane_of gives the JAX
    path's per-pixel sums bit for bit."""
    import jax.numpy as jnp
    from crucible_tpu.models import integrator as jint

    arrays, lane_of, js = _inputs("smoke_scene", 48, 2, 3)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    want = jint.trace_persistent_mega(
        js.build(), js.scene_cam.params(), w, h, jnp.uint32(2), 3, jnp.uint32(0),
        interpret=True,
    )
    np.testing.assert_array_equal(_jax(arrays).T[lane_of], np.asarray(want))
    assert (arrays["sample0"] == 2**30).sum() == arrays["pix"].size - w * h


def test_cpu_tensors_take_the_reference(monkeypatch):
    def no_launch(*args):
        raise AssertionError("CPU tensors must not reach the kernel launch")

    monkeypatch.setattr(tmk, "_launch", no_launch)
    arrays, _, _ = _inputs("smoke_scene", 32, 2, 3)
    before = tmk.FORWARD_LAUNCHES["brute"]
    got = _port(arrays)
    ref = tmk.run_megakernel_reference(
        **{k: torch.from_numpy(arrays[k]) for k in INPUTS}
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    assert tmk.FORWARD_LAUNCHES["brute"] == before


def test_reference_lanes_are_independent():
    """Any subset of lanes traces to the same sums (chip_smoke.py relies on
    this to check a full-size launch on a few lanes)."""
    arrays, _, _ = _inputs("book1_end_scene", 64, 2, 6)
    full = _port(arrays)
    lanes = np.r_[512:1024, 2048:2560]
    sub = dict(arrays, pix=arrays["pix"][:, lanes], sample0=arrays["sample0"][:, lanes])
    np.testing.assert_array_equal(_port(sub), full[:, lanes])


def _by_sample_inputs(route):
    """(inputs, flags) of one forward launch of each search, built by the port
    alone at a few pixels' width: K1 (book1), K5 (book1's static tree), K6
    and K8's camera (bouncing stress's swept tree, both flags), K7 moving
    with the camera (the moving fan)."""
    from tests import torch_mesh_scenes as meshes

    if route == "tri":
        sc = meshes.moving_fan(tscene, 16, camera=True)
    elif route == "cull":
        sc = bouncing_stress(tdemo, 16, 4)
    else:
        sc = tdemo.book1_end_scene(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 3, 6, 0)
    inputs["sample0"][0, ::5] = 1  # a few lanes start at their second sample
    flags = dict(animated=bool(sd.animated), cam_animated=bool(cp.animated))
    if route == "walk":
        zero = np.zeros_like(sd.sph_center.numpy())
        perm, nodes, meta = tmk.swept_tables(sd.sph_center.numpy(), sd.sph_radius.numpy(),
                                             sd.sph_active.numpy(), zero, zero[:, 0])
        inputs.update(table=tint.permute_table(inputs["table"], torch.from_numpy(perm)),
                      swept_nodes=torch.from_numpy(nodes), swept_meta=torch.from_numpy(meta))
    elif route == "cull":
        inputs.update(table=tint.permute_table(inputs["table"], sd.sph_swept_perm),
                      swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
    elif route == "tri":
        inputs.update(zip(("tri_nodes", "tris", "mats", "tri_meta"),
                          tint.make_tri_tables(sd)))
    return inputs, flags


@pytest.mark.parametrize("route", ["brute", "walk", "cull", "tri"])
def test_plain_forward_by_sample_gives_the_same_bits(route):
    """The plain forward with each sample a lane of its own (chip_smoke.py
    holds full-size launches against it) sums to the lane-by-lane loop's
    bits, padding lanes and lanes that start past sample 0 included, and
    counts the same searches."""
    inputs, flags = _by_sample_inputs(route)
    assert flags["animated"] == (route in ("cull", "tri"))
    tmk.SEARCH_COUNTS.update(searches=0, issued=0)
    want = tmk.run_megakernel_reference(**inputs, **flags)
    counts = dict(tmk.SEARCH_COUNTS)
    tmk.SEARCH_COUNTS.update(searches=0, issued=0)
    got = tmk.run_megakernel_reference(**inputs, **flags, by_sample=True)
    assert dict(tmk.SEARCH_COUNTS) == counts and counts["searches"] > counts["issued"]
    assert got.abs().sum() > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(swept_nodes=torch.zeros(2, 16)),
        dict(swept_meta=torch.zeros(3 * (2 + tmk.NODE_WIN), dtype=torch.int32)),
        dict(tri_nodes=torch.zeros(2, 16)),
        dict(animated=True),
        dict(cam_animated=True),
    ],
    ids=["cull", "sphere_bvh", "triangles", "animated", "cam_animated"],
)
def test_refuses_unported_branches(kwargs):
    arrays, _, _ = _inputs("smoke_scene", 32, 1, 1)
    t = {k: torch.from_numpy(arrays[k]) for k in INPUTS}
    if "animated" in kwargs or "cam_animated" in kwargs:
        # K8 is ported in both modes (tests/test_torch_motion.py,
        # tests/test_torch_motion_grad.py), and so is K6, the walk over a
        # moving table's swept tree (tests/test_torch_cull.py): it runs its
        # plain version and gives K8's brute sums and words. A static
        # table's tree (K5's) does not follow moving spheres, so a moving
        # table on it is refused, in either mode.
        sc = bouncing_stress(tdemo, 16, 4)
        sd = sc.build(device="cpu")
        inputs, _ = tint.mega_inputs(sd, sc.scene_cam.params(device="cpu"), 16, 9, 1, 2, 0)
        cull = dict(inputs, table=tint.permute_table(inputs["table"], sd.sph_swept_perm),
                    swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
        motion = dict(animated=True, cam_animated="cam_animated" in kwargs)
        assert torch.equal(tmk.run_megakernel(**cull, **motion),
                           tmk.run_megakernel(**inputs, **motion))
        assert torch.equal(tmk.run_megakernel_record(**cull, max_depth=2, **motion)[1],
                           tmk.run_megakernel_record(**inputs, max_depth=2, **motion)[1])
        static = tdemo.sphere_stress(width=16, copies=4).build(device="cpu")
        walk = dict(inputs, table=tint.permute_table(inputs["table"], static.sph_swept_perm),
                    swept_nodes=static.sph_swept_nodes, swept_meta=static.sph_swept_meta)
        with pytest.raises(ValueError, match="swept tree"):
            tmk.run_megakernel_record(**walk, max_depth=1, **motion)
        with pytest.raises(ValueError, match="swept tree"):
            tmk.run_megakernel(**walk, **motion)
        return
    # The tree walks (K5, K6) and the triangle stage (K7) are ported: part
    # of their tables, or tables of another table's size, is an error.
    with pytest.raises(ValueError):
        tmk.run_megakernel(**t, animated=False, **kwargs)


@pytest.mark.parametrize(
    "name,change,error",
    [
        ("table", lambda t: t.double(), TypeError),
        ("cam", lambda t: t.reshape(-1), ValueError),
        ("table", lambda t: t.t().contiguous().t(), ValueError),
        ("sample0", lambda t: t[:, :-1].contiguous(), ValueError),
        ("table", lambda t: t[:, :16].contiguous(), ValueError),
        ("pix", lambda t: t.long(), TypeError),
    ],
    ids=["dtype", "cam_shape", "contiguity", "lanes", "columns", "pix_dtype"],
)
def test_validates_inputs(name, change, error):
    arrays, _, _ = _inputs("smoke_scene", 32, 1, 1)
    t = {k: torch.from_numpy(arrays[k]) for k in INPUTS}
    t[name] = change(t[name])
    with pytest.raises(error):
        tmk.run_megakernel(**t, animated=False)


def test_ties_go_to_the_lowest_row():
    """Two coincident emitters: every hit must shade with the first row."""
    sc = tscene.Scene.new_image(1.0, 16)
    sc.scene_cam.look_from((0.0, 0.0, 2.0))
    sc.scene_cam.look_at((0.0, 0.0, 0.0))
    sc.scene_cam.set_vfov(20.0)
    for alias, color in (("red", (1.0, 0.0, 0.0)), ("green", (0.0, 1.0, 0.0))):
        sc.add_element(tscene.Sphere((0.0, 0.0, 0.0), 1.0, tscene.Emissive(color)), alias)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    acc = tint.trace_persistent_mega(sd, cp, 16, 16, 1, 1, 0)
    assert torch.equal(acc, torch.tensor([1.0, 0.0, 0.0]).expand(256, 3))


def test_a_miss_reads_no_row():
    """With no active row every lane misses; poisoned shading columns must
    not reach the sums, which are then the sky's."""
    sc = tdemo.smoke_scene(width=32)
    sc.hide_element("ball")
    sc.hide_element("ground")
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    inputs, _ = tint.mega_inputs(sd, cp, 32, 18, 2, 4, 0)
    clean = tmk.run_megakernel(**inputs, animated=False)
    inputs["table"][:, 6:32] = float("nan")
    poisoned = tmk.run_megakernel(**inputs, animated=False)
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, clean)


def test_max_rows_fill_a_blocks_shared_memory():
    assert tmk.MAX_ROWS == 232448 // (5 * 4)


def test_brute_rows_keep_the_active_rows_in_order():
    """K1 / K2's staged list: the active rows first, in table order, with
    their table row ids and centers and |c|^2 - r^2; then the inactive
    ones (a NaN flag is inactive, as the kernels read it)."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(37, tmk.C_IN)).astype(np.float32))
    table[:, 5] = torch.from_numpy((rng.random(37) < 0.6).astype(np.float32))
    table[[0, 9], 5] = torch.tensor([float("nan"), 0.0])
    rows, ids, live = tmk.brute_rows(table)
    act = table[:, 5] > 0.0
    n = int(act.sum())
    assert rows.shape == (37, 4) and rows.dtype == torch.float32 and rows.is_contiguous()
    assert ids.dtype == torch.int32 and live.dtype == torch.int32 and live.tolist() == [n]
    assert torch.equal(ids[:n].long(), torch.nonzero(act).squeeze(1))
    assert torch.equal(ids[n:].long(), torch.nonzero(~act).squeeze(1))
    assert torch.equal(rows, table[ids.long()][:, [0, 1, 2, 4]])
    empty = tmk.brute_rows(table[:0])
    assert empty[0].shape == (0, 4) and empty[2].tolist() == [0]


def test_max_rows_and_routes_are_unchanged():
    """The flat brute search stages 16 bytes a live row (K1 / K2), 36 a
    moving one (K8): MAX_ROWS and MAX_ROWS_ANIMATED rows, padded to a
    multiple of 4, fit a block's shared memory, and the row caps and the
    routes built on them are the brute search's as before."""
    from crucible_tpu_torch.models import render as trender

    assert (tmk.MAX_ROWS, tmk.MAX_ROWS_ANIMATED, trender.CULL_MIN_ROWS) == (11622, 5811, 1024)
    assert -(-tmk.MAX_ROWS // 4) * 4 * 16 <= tmk.SHARED_MEM_BYTES
    assert -(-tmk.MAX_ROWS_ANIMATED // 4) * 4 * 36 <= tmk.SHARED_MEM_BYTES
    tmk.check_rows(tmk.MAX_ROWS)
    tmk.check_rows(tmk.MAX_ROWS_ANIMATED, animated=True)
    for n, animated in ((tmk.MAX_ROWS + 1, False), (tmk.MAX_ROWS_ANIMATED + 1, True)):
        with pytest.raises(ValueError, match="exceed"):
            tmk.check_rows(n, animated=animated)
    # The brute search of the flat loop (K1 / K2, K8 with any flags) takes
    # the staged rows and a work counter; with a mesh (K7) also the mesh's
    # rows as the walk reads them (Woop rows as they are, moving rows
    # packed), its rows, materials, nodes and skip links.
    table = torch.zeros((8, tmk.C_IN))
    for animated in (False, True):
        ptrs, k, kt, held = tmk._flat_args(None, None, table, animated)
        assert k == 0 and kt == 0 and len(held) == 11
        assert [p is None for p in ptrs] == [False] * 3 + [True] * 7 + [False]
        assert held[0].shape == (8, 12 if animated else 4)
        cols = tmk.TRI_MOVING_COLS if animated else tmk.TRI_COLS
        tri = (torch.zeros((3, 6)), torch.tensor([[0, 0, 3], [0, 1, 2], [1, 1, 3]],
                                                 dtype=torch.int32),
               torch.zeros((2, cols)), torch.zeros((1, tmk.MAT_COLS)))
        ptrs, k, kt, held = tmk._flat_args(None, tri, table, animated)
        assert k == 0 and kt == 3
        assert [p is None for p in ptrs] == [False] * 3 + [True] * 2 + [False] * 6
        assert held[5].shape == (2, 20 if animated else 16) and held[6] is tri[2]
        assert held[8].shape == (3, 8) and torch.equal(held[9], tri[1][:, 2])


def test_build_compiles_for_hopper_without_fast_math():
    flags = " ".join(tbuild.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags and "-shared" in flags
    assert [s.name for s in tbuild.sources()] == [
        "common.cuh", "megakernel.cu", "replay_kernel.cu", "sphere_hit.cu",
        "sphere_shade.cu",
    ]
    # One library per .cu, each with its declared C entry points; the
    # megakernel's take the flat loop's rows, K6's tree, the work counter
    # and the grid of the flat loop's launch shape, which they report.
    assert set(tbuild.SIGNATURES) == {s.stem for s in tbuild.sources() if s.suffix == ".cu"}
    mega = tbuild.SIGNATURES["megakernel"]
    assert len(mega["crucible_megakernel_forward"][0]) == 26
    assert len(mega["crucible_megakernel_record"][0]) == 29
    assert "crucible_megakernel_flat_shape" in mega
    source = (tbuild.CSRC / "megakernel.cu").read_text()
    for needle in ("__ballot_sync", "atomicAdd(f.next", "float4", "cudaMemsetAsync",
                   "cudaOccupancyMaxActiveBlocksPerMultiprocessor"):
        assert needle in source, needle


def test_build_without_nvcc_is_an_error(monkeypatch):
    monkeypatch.setattr(tbuild.shutil, "which", lambda name: None)
    monkeypatch.setattr(tbuild.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        tbuild._nvcc()


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernel has no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_megakernel.py)"
        )
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,width,spp,depth",
    [("smoke_scene", 64, 8, 8), ("book1_end_scene", 320, 8, 50)],
)
def test_kernel_matches_reference_on_card(cuda, name, width, spp, depth):
    sc = getattr(tdemo, name)(width=width)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    inputs, lane_of = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    before = tmk.FORWARD_LAUNCHES["brute"]
    out = tmk.run_megakernel(**inputs, animated=False)
    torch.cuda.synchronize()
    assert tmk.FORWARD_LAUNCHES["brute"] == before + 1
    ref = tmk.run_megakernel_reference(**inputs)
    # Both round every operation alike (-fmad=false), and each lane's sum
    # is added in the same order: bit for bit.
    assert torch.equal(out, ref)
    assert torch.isfinite(out.t()[lane_of]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("width,spp", [(320, 8), (1920, 1)])
def test_flat_forward_is_the_plain_version_bit_for_bit(cuda, width, spp):
    """K1's persistent lanes at book1 d50, with padding lanes (sample0 =
    2**30): at 1920 wide far more work items than resident lanes, held on
    4096 lanes spread over the launch (lanes are independent). Two
    launches hand the items out in other orders and give the same bits."""
    sc = tdemo.book1_end_scene(width=width)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    inputs, _ = tint.mega_inputs(sd, cp, w, h, spp, 50, 0)
    r = inputs["pix"].shape[1]
    assert (inputs["sample0"] == tmk.NO_SAMPLE).any()
    shape = tmk.flat_launch_shape(False, True, inputs["table"].shape[0], r)
    if width == 1920:
        assert shape["grid"] * shape["threads"] < r
    out = tmk.run_megakernel(**inputs, animated=False)
    again = tmk.run_megakernel(**inputs, animated=False)
    lanes = torch.arange(r, device=cuda)
    if width == 1920:
        g = torch.Generator().manual_seed(5)
        lanes = torch.randperm(r, generator=g)[:4096].sort().values.to(cuda)
    sub = dict(inputs, pix=inputs["pix"][:, lanes], sample0=inputs["sample0"][:, lanes])
    ref = tmk.run_megakernel_reference(**sub)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out[:, lanes], ref)


def _tie_scene():
    """A hidden sphere (an inactive table row 0), then two coincident
    emitters: every hit is an exact tie, which row 1 (red) must win."""
    sc = tscene.Scene.new_image(1.0, 16)
    sc.scene_cam.look_from((0.0, 0.0, 2.0))
    sc.scene_cam.look_at((0.0, 0.0, 0.0))
    sc.scene_cam.set_vfov(20.0)
    sc.add_element(tscene.Sphere((0.0, 0.0, 1.0), 0.2, tscene.Emissive((0.0, 0.0, 1.0))),
                   "hidden")
    for alias, color in (("red", (1.0, 0.0, 0.0)), ("green", (0.0, 1.0, 0.0))):
        sc.add_element(tscene.Sphere((0.0, 0.0, 0.0), 1.0, tscene.Emissive(color)), alias)
    sc.hide_element("hidden")
    return sc


@pytest.mark.cuda
@pytest.mark.parametrize("max_depth", [1, 4])
def test_flat_forward_ties_and_inactive_rows_on_card(cuda, max_depth):
    sc = _tie_scene()
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    inputs, lane_of = tint.mega_inputs(sd, cp, 16, 16, 2, max_depth, 0)
    assert inputs["table"][0, 5].item() == 0.0
    out = tmk.run_megakernel(**inputs, animated=False)
    ref = tmk.run_megakernel_reference(**inputs)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(out.t()[lane_of], torch.tensor([2.0, 0.0, 0.0], device=cuda).expand(256, 3))


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_reference(cuda, monkeypatch):
    def no_reference(*args, **kwargs):
        raise AssertionError("CUDA tensors must not reach the eager version")

    monkeypatch.setattr(tmk, "run_megakernel_reference", no_reference)
    sc = tdemo.smoke_scene(width=32)
    inputs, _ = tint.mega_inputs(
        sc.build(device=cuda), sc.scene_cam.params(device=cuda), 32, 18, 1, 2, 0
    )
    out = tmk.run_megakernel(**inputs, animated=False)
    torch.cuda.synchronize()
    assert out.is_cuda and torch.isfinite(out).all()
