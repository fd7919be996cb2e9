"""The staged record (ROADMAP A10): ``replay.trace_record`` over the staged
bounce, the record modes of ``render_rays_replay``, ``record_two_level``
and ``grad.record_decisions`` ('auto' takes the record megakernel where it
takes the scene, else the staged record), against the port's record
megakernel (its plain version) and the JAX package's ``trace_record``.

Bounds:
- staged against mega words, ``tests/test_replay.py:280-290``'s: the
  essential bits (alive, hit, scattered) on > 0.99 of entries, winner ids
  and flag bytes on > 0.99 of the rows both record as hits;
- against the JAX package's staged words, ``tests/test_torch_record.py``'s
  whole-lane bounds: > 0.99 on the smoke scene, > 0.97 elsewhere (fault
  C6). The JAX staged record leaves the flags of a finished path's rows
  and a miss's front / reflect / degenerate / root bits as its bounce
  computed them, which the replay never reads; its words are compared in
  the port's form (:func:`_canon`: F_ALIVE alone on a miss, zero after the
  path ends, as the record megakernels of both packages write them);
- gradients of a fan without a BVH (40 triangles) and of its moving twin
  against the JAX package's staged route (its CPU default): loss rel 2e-3,
  radiometric gradients normalized 5e-3.
"""

import functools
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import replay as jrep
from crucible_tpu.models import scene as jscene
from crucible_tpu.models.camera import generate_rays as jgenerate_rays
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models.camera import generate_rays
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests import torch_mesh_scenes as meshes
from tests.test_torch_scene import bridged
from tests.torch_threads import one_torch_thread  # noqa: F401

SPP, DEPTH, SEED = 2, 6, 3
ESS = tmk.F_ALIVE | tmk.F_HIT | tmk.F_SCAT
SCENES = {
    "smoke": lambda: jdemo.smoke_scene(width=32),
    "book1": lambda: jdemo.book1_end_scene(width=32),
    "fan": lambda: meshes.fan(jscene, 24),  # 80 triangles: a BVH
    "moving_fan": lambda: meshes.moving_fan(jscene, 24),
    "fan40": lambda: meshes.fan(jscene, 24, 40),  # no BVH
    "moving_fan40": lambda: meshes.moving_fan(jscene, 24, count=40),
}
JAX_BOUND = {"smoke": 0.99}


def _canon(rec):
    """Packed words in the port's form: F_ALIVE alone on a miss, zero where
    F_ALIVE is clear."""
    alive, hit = (rec & tmk.F_ALIVE) > 0, (rec & tmk.F_HIT) > 0
    return np.where(alive, np.where(hit, rec, tmk.F_ALIVE), 0)


@functools.cache
def _records(name):
    """(port staged words, port mega words or None where the record
    megakernel does not take the scene, JAX staged words) of every pixel,
    SPP samples, DEPTH rows."""
    js = SCENES[name]()
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    p = w * h
    pix, smp = np.tile(np.arange(p), SPP), np.repeat(np.arange(SPP), p)
    jpix, jsmp = jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32)
    o, d, _ = jgenerate_rays(js.scene_cam.params(), w, h, jpix, jsmp, jnp.uint32(SEED))
    want = np.asarray(jrep.trace_record(js.build(), o, d, jpix, jsmp, jnp.uint32(SEED), DEPTH))
    sd, cp = bridged(js)
    tpix, tsmp = torch.from_numpy(pix), torch.from_numpy(smp)
    to, td, _ = generate_rays(cp, w, h, tpix, tsmp, SEED)
    staged = trep.trace_record(sd, to, td, tpix, tsmp, SEED, DEPTH).numpy()
    mega = None
    if tint.megakernel_record_supported(sd, cp):
        mega = trep.trace_record_mega(sd, cp, w, h, tpix, tsmp, SEED, DEPTH).numpy()
    return staged, mega, want


@pytest.mark.parametrize("name", ["smoke", "book1", "fan", "moving_fan"])
def test_staged_matches_mega(name):
    staged, mega, _ = _records(name)
    assert staged.shape == mega.shape == (DEPTH, staged.shape[1]) and staged.dtype == np.int32
    assert ((staged & ESS) == (mega & ESS)).mean() > 0.99
    hit_both = ((staged & mega) & tmk.F_HIT) > 0
    assert ((staged >> 8)[hit_both] == (mega >> 8)[hit_both]).mean() > 0.99
    assert ((staged & 255)[hit_both] == (mega & 255)[hit_both]).mean() > 0.99
    if name.endswith("fan"):
        assert ((staged & tmk.F_TRI) > 0).any()


@pytest.mark.parametrize("name", list(SCENES))
def test_staged_matches_jax(name):
    staged, _, want = _records(name)
    assert (staged == _canon(want)).all(axis=0).mean() > JAX_BOUND.get(name, 0.97)


@pytest.mark.parametrize("name", ["fan40", "moving_fan40"])
def test_rows_after_the_path_end_stay_zero(name):
    staged, mega, _ = _records(name)
    assert mega is None  # a mesh without a BVH: the record megakernel refuses it
    alive = (staged & tmk.F_ALIVE) > 0
    assert (staged[~alive] == 0).all()
    assert (alive[1:] <= alive[:-1]).all()  # alive rows form a prefix
    miss = alive & ((staged & tmk.F_HIT) == 0)
    assert (staged[miss] == tmk.F_ALIVE).all()
    assert ((staged & tmk.F_TRI) > 0).any()


def test_record_modes_route():
    fan_sd, fan_cp = bridged(SCENES["fan40"]())
    book_sd, book_cp = bridged(SCENES["book1"]())
    assert trep.resolve_record_mode("auto", fan_sd, fan_cp) == "staged"
    assert trep.resolve_record_mode("auto", book_sd, book_cp) == "mega"
    assert trep.resolve_record_mode("staged", book_sd, book_cp) == "staged"
    with pytest.raises(ValueError, match="record_mode"):
        trep.resolve_record_mode("lockstep", book_sd, book_cp)
    with pytest.raises(NotImplementedError, match="triangle"):  # asked by name
        trep.trace_record_mega(fan_sd, fan_cp, 24, 13, torch.arange(4), torch.zeros(4), 0, 2)
    with pytest.raises(ValueError, match="megakernel"):  # only mega fuses the radiance
        trep.record_pass("staged", book_sd, book_cp, 32, 18, torch.arange(4), torch.zeros(4),
                         0, 2, radiance=True)
    # Exact-time motion records staged (tests/test_torch_exact.py); a scene
    # that says so without its tracks raises ValueError.
    with pytest.raises(ValueError, match="tracks"):
        trep.trace_record(replace(book_sd, animated=True, motion_exact=True),
                          torch.zeros(4, 3), torch.ones(4, 3), torch.arange(4), torch.zeros(4),
                          0, 2)


@functools.cache
def _gradients(name):
    """(JAX loss, grads) of its staged route and the port's params, scene,
    camera and keyword arguments."""
    js = SCENES[name]()
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    jsd, jcp = js.build(), js.scene_cam.params()
    kw = dict(width=w, height=h, spp=SPP, max_depth=4)
    p = w * h
    jl, jg = JG.loss_and_grad(JG.extract_params(jsd, jcp), jsd, jcp, jnp.zeros((p, 3)),
                              jnp.arange(p, dtype=jnp.uint32), jnp.uint32(SEED), **kw)
    sd, cp = bridged(js)
    params = bridge.params_from_arrays(
        {k: np.asarray(v) for k, v in JG.extract_params(jsd, jcp).items() if k in G.TENSOR_KEYS},
        device="cpu")
    jrec = np.asarray(JG.record_decisions(jsd, jcp, jnp.arange(p, dtype=jnp.uint32),
                                          jnp.uint32(SEED), **kw))
    return (float(jl), jg, jrec), (params, sd, cp, kw)


@pytest.mark.parametrize("name", ["fan40", "moving_fan40"])
def test_staged_gradient_matches_jax(name):
    (jl, jg, _), (params, sd, cp, kw) = _gradients(name)
    p = kw["width"] * kw["height"]
    args = (torch.zeros((p, 3)), torch.arange(p), SEED)
    # A mesh without a BVH: the gradient's record pass is the staged record.
    assert trep.resolve_record_mode("auto", sd, cp) == "staged"
    tl, tg = G.loss_and_grad(params, sd, cp, *args, **kw)
    assert abs(float(tl) - jl) <= 2e-3 * abs(jl)
    for key in ("mat_emission", "tex_color", "mat_fuzz"):
        want = np.asarray(jg[key])
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(tg[key].numpy() / scale, want / scale, rtol=0, atol=5e-3,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["fan40", "moving_fan40"])
def test_record_decisions_staged(name):
    """``record_decisions`` records the fan through the staged record, as
    the JAX package's does off an accelerator, and the frozen-decision step
    on them is the unfrozen step bit for bit."""
    (_, _, jrec), (params, sd, cp, kw) = _gradients(name)
    p = kw["width"] * kw["height"]
    rec = G.record_decisions(sd, cp, torch.arange(p), SEED, **kw)
    assert rec.shape == jrec.shape
    assert (rec.numpy() == _canon(jrec)).all(axis=0).mean() > 0.97
    args = (torch.zeros((p, 3)), torch.arange(p), SEED)
    fl, fg = G.loss_and_grad(params, sd, cp, *args, rec=rec, **kw)
    sl, sg = G.loss_and_grad(params, sd, cp, *args, **kw)
    assert torch.equal(fl, sl) and torch.equal(fg["mat_emission"], sg["mat_emission"])


def test_staged_two_level_record_matches_unsplit():
    """Above GRAD_SPLIT_MIN_DEPTH the staged record runs two-level (the head
    rows, then the survivors re-recorded narrow; no fused radiance) under
    the depth-bucketed replay: loss within rel 1e-5 of the unsplit replay,
    gradients within 1e-4."""
    _, (params, sd, cp, kw) = _gradients("fan40")
    p = kw["width"] * kw["height"]
    kw = dict(kw, max_depth=14)
    args = (torch.zeros((p, 3)), torch.arange(p), SEED)
    out = trep.record_two_level(sd, cp, kw["width"], kw["height"], torch.arange(p),
                                torch.zeros(p, dtype=torch.int64), SEED, 14, head=6,
                                head_radiance=True)
    assert out[-2] is None and out[-1] is None  # the staged record fuses no radiance
    split_l, split_g = G.loss_and_grad(params, sd, cp, *args, **kw)
    flat_l, flat_g = G.loss_and_grad(params, sd, cp, *args, grad_split=False, **kw)
    assert abs(float(split_l) - float(flat_l)) <= 1e-5 * abs(float(flat_l))
    for key in ("mat_emission", "tex_color"):
        torch.testing.assert_close(split_g[key], flat_g[key], rtol=1e-4, atol=1e-7)


def test_book1_staged_route_matches_mega():
    """On book1 (which the megakernel records, and whose replay runs the
    replay kernels' plain versions) the step on the staged record (passed
    in as ``rec``) equals the mega route's step: the two records agree
    here, and only the primal radiance differs in rounding (the record
    megakernel's fused sum against the replay's), so the loss within rel
    1e-5 and the gradients within 1e-5 of each leaf's largest entry."""
    js = SCENES["book1"]()
    sd, cp = bridged(js)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    kw = dict(width=w, height=h, spp=1, max_depth=4)
    args = (torch.zeros((w * h, 3)), torch.arange(w * h), SEED)
    params = G.extract_params(sd, cp)
    assert trep.resolve_record_mode("auto", sd, cp) == "mega"
    staged = trep.record_pass("staged", sd, cp, w, h, torch.arange(w * h),
                              torch.zeros(w * h, dtype=torch.int64), SEED, 4)
    sl, sg = G.loss_and_grad(params, sd, cp, *args, rec=staged, **kw)
    ml, mg = G.loss_and_grad(params, sd, cp, *args, **kw)
    assert abs(float(sl) - float(ml)) <= 1e-5 * abs(float(ml))
    for key in ("mat_emission", "tex_color"):
        scale = float(mg[key].abs().max())
        torch.testing.assert_close(sg[key] / scale, mg[key] / scale, rtol=0, atol=1e-5)
