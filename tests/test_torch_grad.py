"""The gradient step of crucible_tpu_torch (grad.py over models/replay.py)
against the JAX package's ``grad.loss_and_grad`` on bridged scenes,
finite-difference checks on the port itself, frozen-decision training, the
train step, and the entry points' device default."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models.scene import Emissive, Scene, Sphere
from tests.test_torch_scene import bridged
from tests.torch_threads import one_torch_thread  # noqa: F401


def _setup(sc, spp, depth, n=None):
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    n = n or w * h
    kw = dict(width=w, height=h, spp=spp, max_depth=depth)
    return sd, cp, torch.arange(n), torch.zeros((n, 3)), G.extract_params(sd, cp), kw


def _both_loss_and_grad(name, width, spp, depth, seed=3):
    """(JAX loss, JAX grads), (port loss, port grads) on one bridged scene."""
    js = getattr(jdemo, name)(width=width)
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    jsd, jcp = js.build(), js.scene_cam.params()
    kw = dict(width=w, height=h, spp=spp, max_depth=depth)
    jl, jg = JG.loss_and_grad(
        JG.extract_params(jsd, jcp), jsd, jcp, jnp.zeros((w * h, 3)),
        jnp.arange(w * h, dtype=jnp.uint32), jnp.uint32(seed), **kw,
    )
    sd, cp = bridged(js)
    params = bridge.params_from_arrays(
        {k: np.asarray(v) for k, v in JG.extract_params(jsd, jcp).items()
         if k in G.TENSOR_KEYS},
        device="cpu",
    )
    tl, tg = G.loss_and_grad(
        params, sd, cp, torch.zeros((w * h, 3)), torch.arange(w * h), seed, **kw
    )
    return (float(jl), jg), (float(tl), tg)


def _close(key, got, want, atol=5e-3):
    """Normalized agreement (tests/test_replay.py:1130-1135)."""
    a, b = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(b).max()), 1e-6)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol, err_msg=key)


def test_loss_and_grad_matches_jax_book1():
    (jl, jg), (tl, tg) = _both_loss_and_grad("book1_end_scene", 48, 2, 8)
    # The port's primal is the record kernel's fused radiance (the JAX CPU
    # path replays): the two differ by f32 association, ~1e-3 relative
    # (tests/test_replay.py:1183-1185).
    assert tl == pytest.approx(jl, rel=2e-3)
    # Radiometric leaves only on book1 (ROADMAP fault C4).
    for key in ("mat_emission", "tex_color"):
        _close(key, tg[key].numpy(), jg[key])


def test_all_gradients_match_jax_on_smoke():
    (jl, jg), (tl, tg) = _both_loss_and_grad("smoke_scene", 32, 2, 4)
    assert tl == pytest.approx(jl, rel=2e-3)
    for key in G.TENSOR_KEYS:  # camera leaves included (fault C4)
        _close(key, tg[key].numpy(), jg[key])
    assert tg["tex_images"] == () and tg["sky_image"] is None


def _fd_check(sd, cp, pix, target, params, kw, key, idx=None, eps=1e-3, rel=2e-2):
    """Central difference of the port's own loss at the gradient's largest
    entry (tests/test_grad.py:26-84)."""
    _, grads = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
    g = grads[key].numpy()
    if idx is None:
        idx = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    assert abs(g[idx]) > 0

    def loss_at(delta):
        arr = params[key].numpy().astype(np.float64).copy()
        arr[idx] += delta
        p2 = dict(params, **{key: torch.tensor(arr, dtype=torch.float32)})
        return float(G.l2_loss(p2, sd, cp, target, pix, 0, **kw))

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    assert g[idx] == pytest.approx(fd, rel=rel), f"{key}: grad {g[idx]} fd {fd}"


def test_fd_albedo():
    sd, cp, pix, target, params, kw = _setup(tdemo.smoke_scene(width=32), 4, 4)
    _fd_check(sd, cp, pix, target, params, kw, "tex_color")


def test_fd_emission():
    sc = Scene.new_image(1.0, 32)
    sc.scene_cam.look_from((0, 0, 2))
    sc.scene_cam.look_at((0, 0, 0))
    sc.scene_cam.set_vfov(40.0)
    sc.add_element(Sphere((0, 0, 0), 0.5, Emissive((1.0, 0.5, 0.2))), "light")
    sd, cp, pix, target, params, kw = _setup(sc, 4, 4)
    _fd_check(sd, cp, pix, target, params, kw, "mat_emission")


def test_fd_camera_vfov_on_sky_pixels():
    # The top rows see only sky, which is smooth in the camera.
    sd, cp, pix, target, params, kw = _setup(tdemo.smoke_scene(width=32), 2, 3, n=8)
    _fd_check(sd, cp, pix, target, params, kw, "cam_vfov", idx=(), eps=1e-4)


def test_frozen_and_fused_paths_share_the_backward():
    """The same records and the same backward: for a loss linear in the
    image the gradients are bit-identical; the L2 losses differ only by
    the record kernel's and the replay's primals."""
    sd, cp, pix, target, params, kw = _setup(tdemo.book1_end_scene(width=32), 2, 8)
    rec = G.record_decisions(sd, cp, pix, 0, **kw)
    wgt = torch.from_numpy(
        np.random.default_rng(0).standard_normal((pix.shape[0], 3)).astype(np.float32)
    )

    def linear_grads(rec):
        leaves = {k: params[k].detach().requires_grad_(True) for k in G.TENSOR_KEYS}
        img = G.render_pixels_mean({**params, **leaves}, sd, cp, pix, seed=0, rec=rec, **kw)
        return torch.autograd.grad((img * wgt).sum(), list(leaves.values()))

    for a, b in zip(linear_grads(None), linear_grads(rec)):
        assert torch.equal(a, b)
    l_fused, _ = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
    l_frozen, _ = G.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec, **kw)
    assert float(l_frozen) == pytest.approx(float(l_fused), rel=2e-3)


def test_frozen_records_track_albedo_updates():
    """Five Adam steps on frozen records lower the loss
    (tests/test_grad.py:282-306)."""
    sd, cp, pix, target, params, kw = _setup(tdemo.smoke_scene(width=24), 2, 4)
    rec = G.record_decisions(sd, cp, pix, 0, **kw)
    params = dict(params, tex_color=params["tex_color"].clone().requires_grad_(True))
    step = G.make_train_step(torch.optim.Adam([params["tex_color"]], lr=0.05), **kw)
    losses = [float(step(params, sd, cp, target, pix, 0, rec=rec)) for _ in range(5)]
    assert losses[-1] < losses[0]


def test_train_step_lowers_the_loss():
    sd, cp, pix, target, params, kw = _setup(tdemo.book1_end_scene(width=24), 2, 8)
    opt_keys = ("tex_color", "mat_emission")
    params = dict(
        params, **{k: params[k].clone().requires_grad_(True) for k in opt_keys}
    )
    step = G.make_train_step(torch.optim.Adam([params[k] for k in opt_keys], lr=0.05), **kw)
    losses = [float(step(params, sd, cp, target, pix, 0)) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert params["tex_color"].grad is not None


def test_params_bridge_round_trip():
    js = jdemo.book1_end_scene(width=16)
    jparams = JG.extract_params(js.build(), js.scene_cam.params())
    sd, cp = bridged(js)
    params = G.extract_params(sd, cp)
    assert set(params) == set(jparams)
    arrays = bridge.params_to_arrays(params)
    for k in G.TENSOR_KEYS:
        np.testing.assert_array_equal(arrays[k], np.asarray(jparams[k]), err_msg=k)
    back = bridge.params_from_arrays(arrays, device="cpu")
    assert all(torch.equal(back[k], params[k]) for k in G.TENSOR_KEYS)
    assert back["sky_image"] is None and arrays["sky_image"] is None
    # A spherical sky's image crosses both ways.
    sky = np.random.default_rng(0).random((2, 4, 3)).astype(np.float32)
    back = bridge.params_from_arrays(dict(arrays, sky_image=sky), device="cpu")
    assert G.leaf_keys(back) == G.TENSOR_KEYS + ("sky_image",)
    np.testing.assert_array_equal(bridge.params_to_arrays(back)["sky_image"], sky)


def test_apply_params_leaves_the_inputs_alone():
    sd, cp, _, _, params, _ = _setup(tdemo.smoke_scene(width=16), 1, 2)
    p2 = dict(params, tex_color=params["tex_color"] * 0.5, cam_vfov=params["cam_vfov"] + 0.1)
    sd2, cp2 = G.apply_params(sd, cp, p2)
    assert torch.equal(sd2.tex.color, p2["tex_color"]) and sd.tex.color is params["tex_color"]
    assert float(cp2.vfov_rad) == float(p2["cam_vfov"]) != float(cp.vfov_rad)


def test_split_false_replays_deep_budgets_unsplit():
    """Above GRAD_SPLIT_MIN_DEPTH the default replays depth-bucketed over the
    two-level record; split=False replays the same lanes unsplit, to the
    same loss (f32 association) and gradients."""
    sd, cp, pix, target, params, kw = _setup(tdemo.smoke_scene(width=16), 1, 14)
    calls = []
    real = trep.record_two_level
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trep, "record_two_level", lambda *a, **k: calls.append(1) or real(*a, **k))
        split_loss, split_grads = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
        assert calls
        calls.clear()
        loss, grads = G.loss_and_grad(params, sd, cp, target, pix, 0, grad_split=False, **kw)
        assert not calls
    assert np.isfinite(float(loss)) and torch.isfinite(grads["tex_color"]).all()
    assert float(split_loss) == pytest.approx(float(loss), rel=1e-6)
    for key in G.TENSOR_KEYS:
        np.testing.assert_allclose(split_grads[key].numpy(), grads[key].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=key)


def _with_env(env, fn):
    with pytest.MonkeyPatch.context() as mp:
        for name, value in env.items():
            mp.setenv(name, value)
        return fn()


@pytest.mark.parametrize(
    "call",
    [
        # Direct AD takes moving spheres; exact-time motion raises (A7).
        lambda a: G.loss_and_grad(a[0], replace(a[1], animated=True, motion_exact=True),
                                  *a[2:6], method="ad", **a[6]),
        # The head/tail replay_split is under ROADMAP's "Do not port".
        lambda a: _with_env(
            {"CRUCIBLE_GRAD_DEEP_IMPL": "split"},
            lambda: G.loss_and_grad(*a[:6], grad_split=True, **a[6]),
        ),
        lambda a: trep.render_rays_replay(
            a[1], a[2], 16, 9, a[4], torch.zeros_like(a[4]), 0, 2, record_mode="staged"
        ),
        # Nested checkers under the spherical sky, which the replay once
        # refused, run: _nested_sky_replay_matches_direct_ad.
        None,
    ],
    ids=["method_ad", "split", "staged_record", "sky_image"],
)
def test_unported_paths_raise(call):
    sd, cp, pix, target, params, kw = _setup(tdemo.smoke_scene(width=16), 1, 2)
    if call is None:
        _nested_sky_replay_matches_direct_ad()
        return
    with pytest.raises(NotImplementedError):
        call((params, sd, cp, target, pix, 0, kw))


def _nested_sky_replay_matches_direct_ad():
    """The replay's gradient of a three-level nested checker under the
    spherical sky, whose image is a leaf, against direct AD through the
    staged bounce loop: loss rel 2e-3, tex_color, mat_emission and
    sky_image normalized 5e-3."""
    from crucible_tpu_torch.models import skybox as tsky

    sc = tdemo.nested_checkers(width=24, nest=3)
    sd, cp, pix, target, params, kw = _setup(sc, 2, 4)
    sky = torch.rand((4, 8, 3), generator=torch.Generator().manual_seed(3))
    sd = replace(sd, sky_kind=tsky.SPHERICAL, sky_image=sky)
    params = dict(params, sky_image=sky)
    assert sd.tex.max_nest == 3
    lr, gr = G.loss_and_grad(params, sd, cp, target, pix, 0, method="replay", **kw)
    la, ga = G.loss_and_grad(params, sd, cp, target, pix, 0, method="ad", **kw)
    assert float(lr) == pytest.approx(float(la), rel=2e-3)
    for key in ("tex_color", "mat_emission", "sky_image"):
        assert float(gr[key].abs().max()) > 0, key
        _close(key, gr[key].numpy(), ga[key].numpy())


@pytest.mark.parametrize(
    "call",
    [
        lambda sc: sc.build(),
        lambda sc: sc.scene_cam.params(),
        lambda sc: trender.render_image(sc, 1, 2),
        lambda sc: trender.render_image_data(
            sc.build(device="cpu"), sc.scene_cam.params(device="cpu"), 16, 9, 1, 2, 0
        ),
        lambda sc: trender.render_image_persistent(
            sc.build(device="cpu"), sc.scene_cam.params(device="cpu"), 16, 9, 1, 2, 0
        ),
        lambda sc: bridge.scene_data_from_arrays(
            *bridge.scene_data_to_arrays(sc.build(device="cpu"))[:1],
            **bridge.scene_data_to_arrays(sc.build(device="cpu"))[1],
        ),
        lambda sc: bridge.params_from_arrays(
            bridge.params_to_arrays(
                G.extract_params(sc.build(device="cpu"), sc.scene_cam.params(device="cpu"))
            )
        ),
    ],
    ids=["scene_build", "camera_params", "render_image", "render_image_data",
         "render_image_persistent", "scene_bridge", "params_bridge"],
)
def test_entry_points_default_to_cuda(call):
    """Entry points run on the card unless the caller names the CPU: on a
    machine without CUDA a call that names no device raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works here")
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        call(tdemo.smoke_scene(width=16))
