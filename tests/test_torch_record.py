"""K2, the record-mode megakernel: the port's eager twin against the JAX
package's Pallas record kernel (interpret mode on the CPU) on the same
bridged scenes, the record-word layout and the wrapper's dispatch, and — on
a GPU only — the CUDA kernel against its twin."""

import functools

import numpy as np
import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.torch_threads import one_torch_thread  # noqa: F401

# The JAX side is imported inside the helpers that use it, so that the
# card-only tests at the end also run where JAX is not installed:
#   python -m pytest --noconftest -m cuda tests/test_torch_record.py


def _lanes(p, spp):
    pix = np.tile(np.arange(p, dtype=np.int64), spp)
    smp = np.repeat(np.arange(spp, dtype=np.int64), p)
    return pix, smp


@functools.cache
def _both(name, width, spp, depth, seed=3):
    """Fused records + radiance of the JAX record kernel (interpret mode) and
    of the port's twin on the same bridged scene, plus the port's plain
    records."""
    import jax.numpy as jnp
    from crucible_tpu.models import demo as jdemo
    from crucible_tpu.models import replay as jrep
    from tests.test_torch_scene import bridged

    js = getattr(jdemo, name)(width=width)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    pix, smp = _lanes(w * h, spp)
    jrec, jrad = jrep.trace_record_mega(
        js.build(), js.scene_cam.params(), w, h, jnp.asarray(pix, jnp.uint32),
        jnp.asarray(smp, jnp.uint32), jnp.uint32(seed), depth,
        interpret=True, radiance=True,
    )
    sd, cp = bridged(js)
    args = (sd, cp, w, h, torch.from_numpy(pix), torch.from_numpy(smp), seed, depth)
    rec, rad = trep.trace_record_mega(*args, radiance=True)
    plain = trep.trace_record_mega(*args)
    return (np.asarray(jrec), np.asarray(jrad)), (rec.numpy(), rad.numpy(), plain.numpy())


def test_smoke_records_match_jax():
    (jrec, jrad), (rec, rad, _) = _both("smoke_scene", 32, 2, 6)
    assert rec.shape == jrec.shape == (6, 32 * 18 * 2) and rec.dtype == np.int32
    # Integers: every lane's words identical (K1's smoke sums already
    # match JAX to 1e-4, so no path flips here).
    assert (rec == jrec).all(axis=0).mean() > 0.99
    np.testing.assert_allclose(rad, jrad, rtol=0, atol=1e-4)


def test_book1_records_match_jax_statistically():
    (jrec, jrad), (rec, rad, _) = _both("book1_end_scene", 32, 2, 8)
    # Glass chains and self-intersections flip on last-ulp differences
    # (ROADMAP fault C6: the JAX package's own schedules agree on 97.7-99.4%
    # of values here), so whole lanes are held at 0.97.
    assert (rec == jrec).all(axis=0).mean() > 0.97
    assert np.isclose(rad, jrad, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(rad.mean() - jrad.mean()) <= 2e-3


@pytest.mark.parametrize("name", ["smoke_scene", "book1_end_scene"])
def test_fused_and_plain_records_are_identical(name):
    depth = 6 if name == "smoke_scene" else 8
    _, (rec, _, plain) = _both(name, 32, 2, depth)
    np.testing.assert_array_equal(rec, plain)


def test_plain_record_returns_zero_radiance():
    sc = tdemo.smoke_scene(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    inputs, _ = tint.mega_inputs(sd, cp, 16, 9, 1, 4, 0)
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=4)
    assert torch.equal(acc, torch.zeros_like(acc)) and rec.shape == (4, inputs["pix"].shape[1])


def test_record_word_layout():
    from crucible_tpu.models import replay as jrep

    names = ("F_ALIVE", "F_HIT", "F_TRI", "F_SCAT", "F_FRONT", "F_REFL", "F_DEGEN", "F_ROOT1")
    assert [getattr(trep, k) for k in names] == [getattr(jrep, k) for k in names]
    assert (trep.REC_ID_SCALE, trep.REC_MAX_IDS) == (jrep.REC_ID_SCALE, jrep.REC_MAX_IDS)
    ids = torch.tensor([0, 5, 487, (1 << 23) - 1])
    flags = torch.tensor([1, 3, 27, 255], dtype=torch.int32)
    words = trep.pack_record(ids, flags)
    assert torch.equal(trep.rec_winner_id(words), ids.to(torch.int32))
    assert torch.equal(words & 255, flags) and bool((words >= 0).all())


def test_rows_after_the_path_end_stay_zero():
    _, (rec, _, _) = _both("book1_end_scene", 32, 2, 8)
    alive = (rec & trep.F_ALIVE) > 0
    # Alive rows form a prefix of every lane; a row continues exactly when
    # the next row is alive.
    depth_lane = alive.sum(axis=0)
    assert (alive == (np.arange(8)[:, None] < depth_lane[None, :])).all()
    assert (rec[~alive] == 0).all()
    cont = (rec[:-1] & trep.F_SCAT) > 0
    assert (cont == alive[1:]).all()
    # A miss keeps the alive bit alone.
    miss = alive & ((rec & trep.F_HIT) == 0)
    assert (rec[miss] == trep.F_ALIVE).all()


def test_padding_lanes_issue_nothing():
    sc = tdemo.book1_end_scene(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    pix = torch.arange(64)
    smp = torch.where(pix % 2 == 0, 0, 2**30)
    rec, rad = trep.trace_record_mega(sd, cp, 16, 9, pix, smp, 0, 5, radiance=True)
    assert (rec[:, 1::2] == 0).all() and (rad[1::2] == 0).all()
    assert ((rec[0, 0::2] & trep.F_ALIVE) == 1).all()


def test_accum_from_masks_the_fused_radiance_only():
    sc = tdemo.book1_end_scene(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    pix, smp = (torch.from_numpy(a) for a in _lanes(16 * 9, 2))
    args = (sd, cp, 16, 9, pix, smp, 1, 6)
    rec0, rad0 = trep.trace_record_mega(*args, radiance=True)
    rec2, rad2 = trep.trace_record_mega(*args, radiance=True, accum_from=2)
    rec6, rad6 = trep.trace_record_mega(*args, radiance=True, accum_from=6)
    assert torch.equal(rec0, rec2) and torch.equal(rec0, rec6)
    assert torch.equal(rad6, torch.zeros_like(rad6))
    # Lanes whose path ended before bounce 2 keep nothing.
    short = ((rec0[2] & trep.F_ALIVE) == 0)
    assert bool(short.any()) and (rad2[short] == 0).all()
    assert not torch.equal(rad0, rad2)


def test_record_supported_predicate():
    from dataclasses import replace

    sc = tdemo.book1_end_scene(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    assert tint.megakernel_record_supported(sd, cp)
    assert not tint.megakernel_record_supported(replace(sd, num_tris=6), cp)
    # Linear motion records through K8; exact-time motion does not.
    assert tint.megakernel_record_supported(replace(sd, animated=True), cp)
    assert tint.megakernel_record_supported(sd, replace(cp, animated=True))
    assert not tint.megakernel_record_supported(replace(sd, motion_exact=True), cp)
    assert not tint.megakernel_record_supported(sd, replace(cp, motion_exact=True))
    with pytest.raises(NotImplementedError, match="triangle"):
        trep.trace_record_mega(replace(sd, num_tris=6), cp, 16, 9, torch.arange(4),
                               torch.zeros(4), 0, 3)


def test_cpu_tensors_take_the_twin(monkeypatch):
    def no_launch(*args):
        raise AssertionError("CPU tensors must not reach the kernel launch")

    monkeypatch.setattr(tmk, "_launch", no_launch)
    sc = tdemo.smoke_scene(width=16)
    inputs, _ = tint.mega_inputs(
        sc.build(device="cpu"), sc.scene_cam.params(device="cpu"), 16, 9, 1, 4, 0
    )
    before = tmk.RECORD_LAUNCHES["brute"]
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=4, radiance=True)
    ref = tmk.run_megakernel_record_reference(**inputs, max_depth=4, radiance=True)
    assert torch.equal(acc, ref[0]) and torch.equal(rec, ref[1])
    assert tmk.RECORD_LAUNCHES["brute"] == before


def test_depth_must_be_positive():
    sc = tdemo.smoke_scene(width=16)
    inputs, _ = tint.mega_inputs(
        sc.build(device="cpu"), sc.scene_cam.params(device="cpu"), 16, 9, 1, 4, 0
    )
    with pytest.raises(ValueError):
        tmk.run_megakernel_record(**inputs, max_depth=0)


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernel has no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_record.py)"
        )
    return torch.device("cuda")


def _card_inputs(cuda, name, width, spp, depth):
    sc = getattr(tdemo, name)(width=width)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    inputs, _ = tint.mega_inputs(sd, cp, w, h, spp, depth, 0)
    p = w * h
    inputs["pix"] = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)[None]
    inputs["sample0"] = torch.arange(spp, device=cuda, dtype=torch.int32).repeat_interleave(p)[None]
    return inputs


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,width,spp,depth",
    [("smoke_scene", 64, 4, 8), ("book1_end_scene", 320, 4, 8)],
)
def test_record_kernel_matches_twin_on_card(cuda, name, width, spp, depth):
    inputs = _card_inputs(cuda, name, width, spp, depth)
    before = tmk.RECORD_LAUNCHES["brute"]
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=depth, radiance=True)
    _, plain = tmk.run_megakernel_record(**inputs, max_depth=depth)
    torch.cuda.synchronize()
    assert tmk.RECORD_LAUNCHES["brute"] == before + 2
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(
        **inputs, max_depth=depth, radiance=True
    )
    # Both round every operation alike (-fmad=false): bit for bit.
    assert torch.equal(rec, ref_rec) and torch.equal(plain, rec)
    assert torch.equal(acc, ref_acc)


@pytest.mark.cuda
@pytest.mark.parametrize("accum_from", [0, 2, 6])
def test_flat_record_is_the_twin_bit_for_bit(cuda, accum_from):
    """K2's persistent lanes at book1 320w 8 spp d50: more paths than
    resident lanes, every seventh lane padding (sample0 = 2**30), the fused
    radiance from bounce ``accum_from`` on. Two launches hand the paths out
    in other orders and give the same bits."""
    inputs = _card_inputs(cuda, "book1_end_scene", 320, 8, 50)
    r = inputs["pix"].shape[1]
    inputs["sample0"][:, ::7] = tmk.NO_SAMPLE
    inputs["smem"][4] = accum_from
    shape = tmk.flat_launch_shape(True, True, inputs["table"].shape[0], r)
    assert shape["grid"] * shape["threads"] < r
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=50, radiance=True)
    acc2, rec2 = tmk.run_megakernel_record(**inputs, max_depth=50, radiance=True)
    zero, plain = tmk.run_megakernel_record(**inputs, max_depth=50)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(
        **inputs, max_depth=50, radiance=True
    )
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)
    assert torch.equal(rec2, rec) and torch.equal(acc2, acc) and torch.equal(plain, rec)
    assert not zero.any() and not rec[:, ::7].any()


@pytest.mark.cuda
@pytest.mark.parametrize("max_depth", [1, 3])
def test_flat_record_ties_and_inactive_rows_on_card(cuda, max_depth):
    """An inactive table row 0 and an exact tie, which row 1 wins."""
    from tests.test_torch_megakernel import _tie_scene

    sc = _tie_scene()
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    inputs, _ = tint.mega_inputs(sd, cp, 16, 16, 2, max_depth, 0)
    inputs["pix"] = torch.arange(256, device=cuda, dtype=torch.int32).repeat(2)[None]
    inputs["sample0"] = torch.arange(2, device=cuda, dtype=torch.int32).repeat_interleave(256)[None]
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=max_depth, radiance=True)
    ref_acc, ref_rec = tmk.run_megakernel_record_reference(
        **inputs, max_depth=max_depth, radiance=True
    )
    torch.cuda.synchronize()
    assert torch.equal(rec, ref_rec) and torch.equal(acc, ref_acc)
    assert (rec[0] // tmk.REC_ID_SCALE == 1).all() and not rec[1:].any()


@pytest.mark.cuda
def test_cuda_record_never_takes_the_twin(cuda, monkeypatch):
    def no_twin(*args, **kwargs):
        raise AssertionError("CUDA tensors must not reach the eager twin")

    monkeypatch.setattr(tmk, "run_megakernel_record_reference", no_twin)
    inputs = _card_inputs(cuda, "smoke_scene", 32, 1, 3)
    acc, rec = tmk.run_megakernel_record(**inputs, max_depth=3, radiance=True)
    torch.cuda.synchronize()
    assert rec.is_cuda and torch.isfinite(acc).all()
