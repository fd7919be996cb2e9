"""The eager per-bounce replay of crucible_tpu_torch (models/replay.py)
against the JAX package's ``trace_replay``, which takes its jnp branch on
the CPU: the same JAX records, rays and scene go through both, on moving
spheres, an animated camera, the spherical sky, a one-level checker and
the accumulation floor; the split and early-exit walks against the whole
one; and the eager replay against the replay kernels' twins (K4, K3)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import replay as jrep
from crucible_tpu.models.camera import generate_rays as jgenerate_rays
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.ops.kernels import replay_kernel as trk
from tests.test_torch_replay import _assert_k3_scheme
from tests.test_torch_scene import bridged
from tests.torch_motion_scenes import LERP, LOCAL, bouncing_book1
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 5
WORLD = "world"


def _moving_smoke():
    """tests/test_replay.py:94-99: smoke's ball moving along x, frame 6."""
    sc = jdemo.smoke_scene(width=32)
    sc.translate_x(1.0, 1.0, LERP, WORLD, "ball")
    sc.scene_cam.frame = 6
    return sc


def _moving_camera():
    """Smoke seen by a camera rising over frame 0's shutter."""
    sc = jdemo.smoke_scene(width=32)
    sc.cam_translate_y(0.5, 1.0 / 48.0, LERP, LOCAL, "from")
    return sc


SCENES = {
    "moving_smoke": _moving_smoke,
    "bouncing_book1": lambda: bouncing_book1(jdemo, 32),
    "moving_camera": _moving_camera,
    "garden": lambda: jdemo.garden_skybox(width=32),
    "checker": lambda: jdemo.checkered_spheres(width=32),
}


@functools.cache
def _case(name, spp=2, depth=8):
    """A JAX scene, its lanes, JAX rays and JAX (staged) records, as numpy."""
    js = SCENES[name]()
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    pix = np.tile(np.arange(w * h, dtype=np.int32), spp)
    smp = np.repeat(np.arange(spp, dtype=np.int32), w * h)
    jsd, jcp = js.build(), js.scene_cam.params()
    jp, js_ = jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32)
    o, d, _ = jgenerate_rays(jcp, w, h, jp, js_, jnp.uint32(SEED))
    rec = jrep.trace_record(jsd, o, d, jp, js_, jnp.uint32(SEED), depth)
    return js, dict(pix=pix, smp=smp, o=np.array(o), d=np.array(d), rec=np.array(rec),
                    depth=depth)


def _jax_replay(name, **kw):
    """JAX radiance, and a function from weights ``wgt`` (R, 3) to the
    gradients of sum(rad * wgt) w.r.t. the scene's leaves and the rays
    (one ``jax.vjp`` through the jnp trace_replay)."""
    js, x = _case(name)
    jsd, jcp = js.build(), js.scene_cam.params()
    base = JG.extract_params(jsd, jcp)
    keys = [k for k in G.leaf_keys(G.extract_params(*bridged(js))) if not k.startswith("cam_")]
    args = (jnp.asarray(x["pix"], jnp.uint32), jnp.asarray(x["smp"], jnp.uint32),
            jnp.uint32(SEED), x["depth"], jnp.asarray(x["rec"]))
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}

    def run(leaves, o, d):
        sd, _ = JG.apply_params(jsd, jcp, dict(base, **leaves))
        return jrep.trace_replay(sd, o, d, *args, **kw)

    rad, vjp = jax.vjp(run, {k: base[k] for k in keys}, jnp.asarray(x["o"]),
                       jnp.asarray(x["d"]))

    def grads(wgt):
        lv, go, gd = vjp(jnp.asarray(wgt))
        return {**{k: np.asarray(v) for k, v in lv.items()}, "o": np.asarray(go),
                "d": np.asarray(gd)}

    return np.asarray(rad), grads


def _port_replay(name, **kw):
    """The port's radiance and the same function, through the eager
    replay (``return_carry=True`` keeps every scene off the kernels)."""
    js, x = _case(name)
    sd, cp = bridged(js)
    params = G.extract_params(sd, cp)
    keys = [k for k in G.leaf_keys(params) if not k.startswith("cam_")]
    leaves = {k: params[k].detach().clone().requires_grad_(True) for k in keys}
    o = torch.from_numpy(x["o"]).requires_grad_(True)
    d = torch.from_numpy(x["d"]).requires_grad_(True)
    sd2, _ = G.apply_params(sd, cp, dict(params, **leaves))
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    rad, _ = trep.trace_replay(
        sd2, o, d, torch.from_numpy(x["pix"]), torch.from_numpy(x["smp"]), SEED, x["depth"],
        torch.from_numpy(x["rec"]), return_carry=True, **kw)
    inputs = [*leaves.values(), o, d]

    def grads(wgt):
        g = torch.autograd.grad((rad * torch.from_numpy(wgt)).sum(), inputs,
                                allow_unused=True, retain_graph=True)
        # Under the spherical sky nothing reaches the rays: the nearest-
        # texel lookup is flat in the direction (JAX gives zeros there).
        g = [torch.zeros_like(x) if v is None else v for x, v in zip(inputs, g)]
        return {k: v.numpy() for k, v in zip([*leaves, "o", "d"], g)}

    return rad.detach().numpy(), grads


def _normalized(key, got, want, atol):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol, err_msg=key)


def _both(name, wgt, **kw):
    """(JAX radiance, JAX gradients), (port radiance, port gradients) of
    sum(rad * wgt), held to each other.

    Radiance: every lane within rtol 1e-4, atol 1e-5; the decisions are
    frozen and identical, so only XLA's and torch's orders of the same
    float32 operations differ. On book1's 488 spheres two things amplify
    that past the bound on a few lanes (fault C6): near-tangent hits (the
    recorded root's sqrt of a small discriminant) and the checker's
    parity, floor(p / scale), a discrete choice the record does not hold,
    which a last-ulp move of the hit point flips at a cell border (its
    gradient then goes to the other color). There 99% of lanes are held to
    the bound, the image mean to 1e-4, and the gradients are taken over
    the lanes that hold it. Gradients: every scene leaf within normalized
    1e-3; the rays' per-lane cotangents within K3's scheme, as in
    tests/test_torch_replay.py (a near-tangent lane amplifies a last-ulp
    difference through d(sqrt)/d(disc), where no sum over lanes averages
    it out).
    """
    jrad, jgrads = _jax_replay(name, **kw)
    rad, grads = _port_replay(name, **kw)
    close = np.isclose(rad, jrad, rtol=1e-4, atol=1e-5).all(axis=1)
    if name != "bouncing_book1":
        np.testing.assert_allclose(rad, jrad, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.99, close.mean()
    assert abs(float(rad.mean()) - float(jrad.mean())) < 1e-4
    wgt = wgt * close[:, None]
    jg, g = jgrads(wgt), grads(wgt)
    assert jg.keys() == g.keys()
    for key in g:
        if key not in ("o", "d"):
            _normalized(key, g[key], jg[key], 1e-3)
    _assert_k3_scheme([np.zeros(1), g["o"], g["d"]], [np.zeros(1), jg["o"], jg["d"]])
    return rad, g


def _wgt(name):
    _, x = _case(name)
    r = x["pix"].shape[0]
    return np.random.default_rng(3).standard_normal((r, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(SCENES))
def test_eager_replay_matches_jax(name):
    _, g = _both(name, _wgt(name))
    if name == "garden":
        assert "sky_image" in g and np.abs(g["sky_image"]).max() > 0


def test_accum_from_and_thr_mask_match_jax():
    name = "bouncing_book1"
    _, x = _case(name)
    r = x["pix"].shape[0]
    mask = np.random.default_rng(4).random(r) < 0.7
    thr0 = np.where(mask[:, None], 1.0, 0.0).astype(np.float32) * np.ones((r, 3), np.float32)
    rad, _ = _both(name, _wgt(name), accum_from=3, thr_in=thr0)
    assert (rad[~mask] == 0).all() and np.abs(rad[mask]).max() > 0
    # thr_mask alone starts the throughput at the same 0/1 mask.
    sd, (o, d, pix, smp), rec = _port_inputs(name)
    via_mask, _ = trep.trace_replay(sd, o, d, pix, smp, SEED, 8, rec, accum_from=3,
                                    thr_mask=torch.from_numpy(mask), return_carry=True)
    assert torch.equal(via_mask, torch.from_numpy(rad))


def _port_inputs(name):
    js, x = _case(name)
    sd, _ = bridged(js)
    return sd, tuple(torch.from_numpy(x[k]) for k in ("o", "d", "pix", "smp")), \
        torch.from_numpy(x["rec"])


@pytest.mark.parametrize("k", [1, 3, 6])
def test_split_replay_equals_unsplit(k):
    """Rows [0, k) with return_carry, then [k, D) from that carry at
    bounce0 = k: the head is the unsplit replay of k rows, and the tail is
    the unsplit replay with accum_from = k, bit for bit; so is the carry."""
    sd, (o, d, pix, smp), rec = _port_inputs("bouncing_book1")
    head, (o_k, d_k, thr_k) = trep.trace_replay(sd, o, d, pix, smp, SEED, k, rec[:k],
                                                return_carry=True)
    tail, carry = trep.trace_replay(sd, o_k, d_k, pix, smp, SEED, 8 - k, rec[k:], bounce0=k,
                                    thr_in=thr_k, return_carry=True)
    whole_k, _ = trep.trace_replay(sd, o, d, pix, smp, SEED, k, rec, return_carry=True)
    from_k, whole_carry = trep.trace_replay(sd, o, d, pix, smp, SEED, 8, rec, accum_from=k,
                                            return_carry=True)
    assert torch.equal(head, whole_k) and torch.equal(tail, from_k)
    for a, b in zip(carry, whole_carry):
        assert torch.equal(a, b)
    whole = trep.trace_replay(sd, o, d, pix, smp, SEED, 8, rec, return_carry=True)[0]
    np.testing.assert_allclose((head + tail).numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)


def test_early_exit_equals_the_static_walk():
    sd, (o, d, pix, smp), rec = _port_inputs("bouncing_book1")
    # Depth 8 with every lane dead after a few rows: the early walk stops
    # at the last live row.
    deep = torch.cat([rec, torch.zeros((4, rec.shape[1]), dtype=rec.dtype)])
    rows = int(((deep & trep.F_ALIVE) > 0).any(dim=1).sum())
    assert rows < deep.shape[0]
    static = trep.trace_replay(sd, o, d, pix, smp, SEED, 12, deep, return_carry=True)[0]
    early = trep.trace_replay(sd, o, d, pix, smp, SEED, 12, deep, early_exit=True)
    assert torch.equal(early, static)


def test_eager_replay_matches_the_kernel_twins_on_static_book1():
    """Static book1 at 32 wide: the eager replay against the twins of K4
    (radiance) and K3 (table and ray cotangents, within K3's scheme)."""
    js = jdemo.book1_end_scene(width=32)
    w, h = 32, js.scene_cam.image_height
    jsd, jcp = js.build(), js.scene_cam.params()
    pix = np.tile(np.arange(w * h, dtype=np.int32), 2)
    smp = np.repeat(np.arange(2, dtype=np.int32), w * h)
    jp, js_ = jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32)
    o, d, _ = jgenerate_rays(jcp, w, h, jp, js_, jnp.uint32(SEED))
    rec = torch.from_numpy(np.array(jrep.trace_record(jsd, o, d, jp, js_, jnp.uint32(SEED), 8)))
    sd, _ = bridged(js)
    assert trep._use_replay_kernel(sd)
    pix_t, smp_t = torch.from_numpy(pix), torch.from_numpy(smp)
    wgt = torch.from_numpy(np.random.default_rng(6).standard_normal((pix.shape[0], 3))
                           .astype(np.float32))

    def grads(fn):
        table = tint.make_sphere_table(sd).detach().requires_grad_(True)
        oo = torch.from_numpy(np.array(o)).requires_grad_(True)
        dd = torch.from_numpy(np.array(d)).requires_grad_(True)
        rad = fn(table, oo, dd)
        return rad.detach(), [g.numpy() for g in torch.autograd.grad((rad * wgt).sum(),
                                                                      (table, oo, dd))]

    before = (trk.LAUNCHES_FORWARD, trk.LAUNCHES_BACKWARD)
    k_rad, k_g = grads(lambda t, oo, dd: trk.trace_replay_mega(t, oo, dd, pix_t, smp_t, SEED,
                                                                rec))
    e_rad, e_g = grads(lambda t, oo, dd: trep._replay_eager(
        sd, t, oo, dd, pix_t, smp_t, SEED, rec, early_exit=False, bounce0=0,
        thr_in=torch.ones_like(oo), return_carry=False, accum_from=0))
    assert (trk.LAUNCHES_FORWARD, trk.LAUNCHES_BACKWARD) == before  # CPU: twins
    np.testing.assert_allclose(e_rad.numpy(), k_rad.numpy(), rtol=1e-5, atol=1e-6)
    _assert_k3_scheme(e_g, k_g)
    # The eager replay's table cotangent lies in the columns it fetches.
    unused = [c for c in range(32) if c not in trep.EAGER_COLS]
    assert (e_g[0][:, unused] == 0).all()


def test_routing_follows_jax():
    """Kernels for the JAX kernel's calls on its scenes; eager for the rest."""
    sd = bridged(jdemo.book1_end_scene(width=16))[0]
    moving = bridged(_case("moving_smoke")[0])[0]
    garden = bridged(jdemo.garden_skybox(width=16))[0]
    assert trep._use_replay_kernel(sd)
    assert not trep._use_replay_kernel(moving) and not trep._use_replay_kernel(garden)
    assert all(trep.replay_supported(x) for x in (sd, moving, garden))
    calls = []
    real = trk.trace_replay_mega
    try:
        trk.trace_replay_mega = lambda *a, **k: calls.append(1) or real(*a, **k)
        r = 16
        o, d = torch.zeros((r, 3)), torch.ones((r, 3))
        pix, smp = torch.arange(r), torch.zeros(r, dtype=torch.int64)
        rec = torch.zeros((2, r), dtype=torch.int32)
        trep.trace_replay(sd, o, d, pix, smp, 0, 2, rec)
        trep.trace_replay(sd, o, d, pix, smp, 0, 2, rec, thr_in=torch.ones_like(o),
                          thr_mask=torch.ones(r, dtype=torch.bool))
        assert len(calls) == 2
        for kw in (dict(early_exit=True), dict(return_carry=True), dict(bounce0=1),
                   dict(thr_in=torch.ones_like(o))):
            trep.trace_replay(sd, o, d, pix, smp, 0, 2, rec, **kw)
        trep.trace_replay(moving, o, d, pix, smp, 0, 2, rec)
        trep.trace_replay(garden, o, d, pix, smp, 0, 2, rec)
        assert len(calls) == 2
    finally:
        trk.trace_replay_mega = real


def test_eager_replay_names_what_it_lacks():
    """Exact-time motion raises, naming its queue item (A7). Nested checkers
    under the spherical sky, which the replay once refused too, replay: K2's
    records (its plain version) replayed match the staged bounce loop on
    the same lanes, at the JAX package's cross-schedule bounds
    (tests/test_replay.py:368-370)."""
    from dataclasses import replace

    from crucible_tpu_torch.models import demo as tdemo
    from crucible_tpu_torch.models import skybox as tsky

    sd = bridged(_case("moving_smoke")[0])[0]
    args = (torch.zeros((4, 3)), torch.ones((4, 3)), torch.arange(4), torch.zeros(4),
            0, 2, torch.zeros((2, 4), dtype=torch.int32))
    for change in (dict(tri_exact=True), dict(motion_exact=True)):
        with pytest.raises(NotImplementedError, match="A7"):
            trep.trace_replay(replace(sd, **change), *args)

    sc = tdemo.nested_checkers(width=32, nest=3)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sky = torch.rand((8, 16, 3), generator=torch.Generator().manual_seed(2))
    sd = replace(sc.build(device="cpu"), sky_kind=tsky.SPHERICAL, sky_image=sky)
    cp = sc.scene_cam.params(device="cpu")
    assert sd.tex.max_nest == 3 and not trep._use_replay_kernel(sd)
    pix, smp = G._lanes(torch.arange(w * h), 2, 0)
    replayed = trep.render_rays_replay(sd, cp, w, h, pix, smp, SEED, 6).numpy()
    staged = tint.render_rays(sd, cp, w, h, pix, smp, SEED, 6).numpy()
    close = np.isclose(replayed, staged, rtol=1e-3, atol=1e-3).mean()
    assert close > 0.99, close
    assert abs(replayed.mean() - staged.mean()) <= 2e-3
