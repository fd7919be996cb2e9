"""Gradients of moving scenes in crucible_tpu_torch against the JAX package
on the CPU: the plain K8 record (the record megakernel's motion variants)
against the JAX record kernel in interpret mode, the record predicate, the
winner-only backward of ``hit_spheres_moving`` against ``jax.vjp``, and
``loss_and_grad`` on moving scenes against the JAX ``grad.loss_and_grad``,
against the port's own direct AD and against a finite difference."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import replay as jrep
from crucible_tpu.ops import intersect as jintersect
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.ops import intersect as tintersect
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.test_torch_scene import bridged
from tests.torch_motion_scenes import LERP, LOCAL, bouncing_book1, bouncing_stress
from tests.torch_threads import one_torch_thread  # noqa: F401


def _moving_smoke(demo):
    """Smoke in motion over frame 0's shutter [0, 1/48]: the ball rises
    and the camera's position rises; no keyframe inside the shutter."""
    sc = demo.smoke_scene(width=32)
    sc.translate_y(0.3, 1.0 / 48.0, LERP, LOCAL, "ball")
    sc.cam_translate_y(0.5, 1.0 / 48.0, LERP, LOCAL, "from")
    return sc


def _moving_ball(demo):
    sc = demo.smoke_scene(width=32)
    sc.translate_y(0.3, 1.0 / 48.0, LERP, LOCAL, "ball")
    return sc


def _moving_camera(demo):
    sc = demo.smoke_scene(width=32)
    sc.cam_translate_y(0.5, 1.0 / 48.0, LERP, LOCAL, "from")
    return sc


def _lanes(p, spp):
    return (np.tile(np.arange(p, dtype=np.int64), spp),
            np.repeat(np.arange(spp, dtype=np.int64), p))


# --- K8 record: the plain version against the JAX record kernel -------------------


@pytest.mark.parametrize("make", [_moving_ball, _moving_camera, _moving_smoke],
                         ids=["spheres", "camera", "both"])
def test_plain_k8_record_matches_jax(make):
    js = make(jdemo)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    pix, smp = _lanes(w * h, 2)
    jrec, jrad = jrep.trace_record_mega(
        js.build(), js.scene_cam.params(), w, h, jnp.asarray(pix, jnp.uint32),
        jnp.asarray(smp, jnp.uint32), jnp.uint32(3), 6, interpret=True, radiance=True)
    sd, cp = bridged(js)
    assert sd.animated or cp.animated
    rec, rad = trep.trace_record_mega(sd, cp, w, h, torch.from_numpy(pix),
                                      torch.from_numpy(smp), 3, 6, radiance=True)
    jrec, jrad = np.asarray(jrec), np.asarray(jrad)
    # Whole lanes equal on > 0.97 (fault C6: last-ulp differences flip
    # grazing hits); the fused radiance within the same bounds.
    assert (rec.numpy() == jrec).all(axis=0).mean() > 0.97
    assert np.isclose(rad.numpy(), jrad, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert abs(rad.numpy().mean() - jrad.mean()) <= 2e-3
    # The plain (unfused) records are the fused ones.
    plain = trep.trace_record_mega(sd, cp, w, h, torch.from_numpy(pix), torch.from_numpy(smp),
                                   3, 6)
    assert torch.equal(plain, rec)


def test_plain_k8_record_with_zero_motion_is_k2():
    """A static table given the animated flag (all-zero motion columns):
    x + w 0 is x, so the moving search and the winner lerp change nothing."""
    sc = tdemo.book1_end_scene(width=32)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    inputs, _ = tint.mega_inputs(sd, cp, 32, 18, 1, 8, 0)
    assert (inputs["table"][:, 24:30] == 0).all()
    static = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True)
    moving = tmk.run_megakernel_record(**inputs, max_depth=8, radiance=True, animated=True)
    assert torch.equal(static[1], moving[1]) and torch.equal(static[0], moving[0])


def test_record_predicate_takes_linear_motion():
    sc = bouncing_book1(tdemo, 16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    assert sd.animated and cp.animated
    assert tint.megakernel_record_supported(sd, cp)
    assert tint.megakernel_record_supported(replace(sd, animated=False), cp)
    reason = tint.megakernel_record_unsupported_reason
    assert "exact-time" in reason(replace(sd, motion_exact=True), cp)
    assert "exact-time" in reason(sd, replace(cp, motion_exact=True))
    assert "K7" in reason(replace(sd, num_tris=4), cp)
    # A moving table with the cluster tables walks them (K6); above the
    # brute search's MAX_ROWS_ANIMATED without them, or with the sphere
    # BVH's tables (whose boxes do not follow moving spheres), it is
    # refused, naming the chunk-cull tables.
    bouncing = bouncing_stress(tdemo, 16, 4).build(device="cpu")
    assert bouncing.sph_cbounds is not None and reason(bouncing, cp) is None
    big = replace(sd, sph_center=torch.zeros((tmk.MAX_ROWS_ANIMATED + 1, 3)))
    assert "K6" in reason(big, cp) and "sph_cbounds" in reason(big, cp)
    assert reason(replace(big, sph_perm=bouncing.sph_perm,
                          sph_cbounds=bouncing.sph_cbounds), cp) is None
    stress = tdemo.sphere_stress(width=16, copies=4).build(device="cpu")
    assert "K6" in reason(replace(stress, animated=True), cp)
    with pytest.raises(NotImplementedError, match="K6"):
        trep.trace_record_mega(big, cp, 16, 9, torch.arange(4), torch.zeros(4), 0, 2)


# --- the winner-only backward of hit_spheres_moving --------------------------------


def test_hit_spheres_moving_backward_matches_jax_vjp():
    g = np.random.default_rng(31)
    n, r = 24, 512
    ca = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    cd = g.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    ra = g.uniform(0.2, 0.8, n).astype(np.float32)
    rd = g.uniform(-0.1, 0.1, n).astype(np.float32)
    active = g.random(n) < 0.9
    o = np.concatenate([g.uniform(-1, 1, (r, 2)), np.full((r, 1), 8.0)], 1).astype(np.float32)
    d = np.concatenate([g.uniform(-0.6, 0.6, (r, 2)), -np.ones((r, 1))], 1).astype(np.float32)
    w = g.random(r).astype(np.float32)
    t_bar = g.standard_normal(r).astype(np.float32)
    args = (o, d, w, ca, cd, ra, rd)

    jargs = tuple(jnp.asarray(a) for a in args)
    jt, jvjp = jax.vjp(
        lambda *x: jintersect.hit_spheres_moving(*x, jnp.asarray(active), 1e-3, jnp.inf)[0],
        *jargs)
    _, jidx, jhit = jintersect.hit_spheres_moving(*jargs, jnp.asarray(active), 1e-3, jnp.inf)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    t, idx, hit = tintersect.hit_spheres_moving(*leaves, torch.from_numpy(active), 1e-3)
    hit_np = hit.numpy()
    assert 0.2 < hit_np.mean() < 0.95  # some rays miss
    assert (idx.numpy() == np.asarray(jidx)).all() and (hit_np == np.asarray(jhit)).all()
    np.testing.assert_allclose(t.detach().numpy()[hit_np], np.asarray(jt)[hit_np], rtol=1e-5)
    got = torch.autograd.grad(t, leaves, torch.from_numpy(t_bar))
    # The backward against jax.vjp's backward (``_moving_hit_bwd``) on the
    # same residuals: the forward's t differs in its last ulps between
    # XLA's matrix products and torch's sums, which a grazing hit's 1/den
    # amplifies past any rtol, so each side's own t would compare two
    # inputs, not two backwards.
    res = (*jargs, jnp.asarray(t.detach().numpy()), jnp.asarray(idx.numpy()),
           jnp.asarray(hit_np))
    want = jintersect._moving_hit_bwd(res, (jnp.asarray(t_bar), None, None))[:7]
    for name, a, b in zip(("o", "d", "w", "ca", "cd", "ra", "rd"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert (got[2] == 0).all()  # w is a random sample: detached
    # And end to end, jax.vjp on its own forward: the same cotangents
    # wherever the two forwards' t agree to the bit.
    ends = jvjp(jnp.asarray(t_bar))
    same_t = t.detach().numpy() == np.asarray(jt)
    assert same_t.mean() > 0.9
    for name, a, b in zip(("o", "d"), got[:2], ends[:2]):
        np.testing.assert_allclose(a.numpy()[same_t], np.asarray(b)[same_t], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_hit_spheres_moving_saves_no_pair_terms():
    """The forward keeps no (R, N) tensor for the backward."""
    r, n = 64, 40
    o = torch.zeros((r, 3))
    d = torch.ones((r, 3))
    big = []

    def pack(x):
        if x.dim() == 2 and x.shape == (r, n):
            big.append(x.shape)
        return x

    ca = torch.randn((n, 3), requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        t, _, _ = tintersect.hit_spheres_moving(o, d, torch.rand(r), ca, torch.zeros((n, 3)),
                                                torch.ones(n), torch.zeros(n),
                                                torch.ones(n, dtype=torch.bool), 1e-3)
    assert big == [] and t.requires_grad


# --- loss_and_grad on moving scenes ------------------------------------------------


def _both_loss_and_grad(make, spp=2, depth=8, seed=3):
    js = make(jdemo)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    jsd, jcp = js.build(), js.scene_cam.params()
    kw = dict(width=w, height=h, spp=spp, max_depth=depth)
    jl, jg = JG.loss_and_grad(
        JG.extract_params(jsd, jcp), jsd, jcp, jnp.zeros((w * h, 3)),
        jnp.arange(w * h, dtype=jnp.uint32), jnp.uint32(seed), **kw)
    sd, cp = bridged(js)
    params = bridge.params_from_arrays(
        {k: np.asarray(v) for k, v in JG.extract_params(jsd, jcp).items()
         if k in G.TENSOR_KEYS}, device="cpu")
    before = tmk.SEARCH_COUNTS["searches"]
    tl, tg = G.loss_and_grad(params, sd, cp, torch.zeros((w * h, 3)), torch.arange(w * h),
                             seed, **kw)
    assert tmk.SEARCH_COUNTS["searches"] > before  # the plain K8 record ran
    return (float(jl), jg), (float(tl), tg), (sd, cp, params, kw)


def _close(key, got, want, atol=5e-3):
    a, b = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(b).max()), 1e-6)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol, err_msg=key)


def test_loss_and_grad_matches_jax_on_moving_smoke():
    (jl, jg), (tl, tg), _ = _both_loss_and_grad(_moving_smoke)
    # The port records with K8's plain version and replays eagerly; the
    # JAX package on the CPU records staged and replays in jnp (fault C6
    # bounds: loss rel 2e-3, gradients normalized 5e-3).
    assert tl == pytest.approx(jl, rel=2e-3)
    for key in G.TENSOR_KEYS:  # camera leaves on the smoke scene (fault C4)
        _close(key, tg[key].numpy(), jg[key])


def test_loss_and_grad_matches_jax_on_bouncing_book1():
    (jl, jg), (tl, tg), _ = _both_loss_and_grad(lambda demo: bouncing_book1(demo, 32))
    assert tl == pytest.approx(jl, rel=2e-3)
    for key in ("mat_emission", "tex_color"):  # radiometric leaves (fault C4)
        _close(key, tg[key].numpy(), jg[key])


def _moving_setup(spp=2, depth=8):
    sc = _moving_smoke(tdemo)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    n = 32 * 18
    kw = dict(width=32, height=18, spp=spp, max_depth=depth)
    return sd, cp, G.extract_params(sd, cp), torch.arange(n), torch.zeros((n, 3)), kw


def test_replay_matches_direct_ad_on_a_moving_scene():
    sd, cp, params, pix, target, kw = _moving_setup()
    lr, gr = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
    la, ga = G.loss_and_grad(params, sd, cp, target, pix, 0, method="ad", **kw)
    assert float(la) == pytest.approx(float(lr), rel=2e-3)
    for key in G.TENSOR_KEYS:
        _close(key, ga[key].numpy(), gr[key].numpy())


def test_frozen_records_on_a_moving_scene():
    """record_decisions takes K8's record; replaying those records gives
    the fused step's gradients (a loss linear in the image)."""
    sd, cp, params, pix, target, kw = _moving_setup()
    rec = G.record_decisions(sd, cp, pix, 0, **kw)
    assert rec.shape == (8, 2 * pix.shape[0])
    l_fused, g_fused = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
    l_frozen, g_frozen = G.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec, **kw)
    assert torch.equal(l_fused, l_frozen)
    for key in G.TENSOR_KEYS:
        assert torch.equal(g_fused[key], g_frozen[key])


def test_fd_albedo_on_a_moving_scene():
    """Central difference of the port's own loss at the largest albedo
    gradient entry (tests/test_grad.py:26-84)."""
    sd, cp, params, pix, target, kw = _moving_setup(spp=4, depth=4)
    _, grads = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
    g = grads["tex_color"].numpy()
    idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    assert abs(g[idx]) > 0

    def loss_at(delta):
        arr = params["tex_color"].numpy().astype(np.float64).copy()
        arr[idx] += delta
        p2 = dict(params, tex_color=torch.tensor(arr, dtype=torch.float32))
        return float(G.l2_loss(p2, sd, cp, target, pix, 0, **kw))

    eps = 1e-3
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert g[idx] == pytest.approx(fd, rel=2e-2)


def test_train_step_on_a_moving_scene_lowers_the_loss():
    sd, cp, params, pix, target, kw = _moving_setup(depth=4)
    params = dict(params, tex_color=params["tex_color"].clone().requires_grad_(True))
    step = G.make_train_step(torch.optim.Adam([params["tex_color"]], lr=0.05), **kw)
    losses = [float(step(params, sd, cp, target, pix, 0)) for _ in range(3)]
    assert losses[-1] < losses[0]
