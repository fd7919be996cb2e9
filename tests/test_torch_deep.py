"""The depth-50 gradient path of crucible_tpu_torch: the depth buckets, the
two-level record and the bucketed replays (models/replay.py) against the
JAX package's on the same records, within the port against the unsplit
replay, their NaN overflow guards, and the training surface of grad.py
(the recovery ladder, sample-chunked accumulation, the recovering train
step, checkpoints and the JAX checkpoint bridge)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crucible_tpu import grad as JG
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import replay as jrep
from crucible_tpu.models import scene as jscene
from crucible_tpu.models.camera import generate_rays as jrays
from crucible_tpu_torch import bridge
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.models.camera import generate_rays as trays
from tests.test_torch_scene import bridged
from tests.torch_threads import one_torch_thread  # noqa: F401

SEED = 3


def _shell(S):
    """tests/test_replay.py's fuzzy-metal enclosure, through either package's
    API: path depths spread over every row, some lanes reach max_depth, and
    the lamp makes hit rows add radiance."""
    sc = S.Scene.new_image(1.0, 24)
    sc.scene_cam.look_from((0, 0, 0))
    sc.scene_cam.look_at((0, 0, -1))
    sc.scene_cam.set_vfov(70.0)
    sc.add_element(S.Sphere((0, 0, 0), 10.0, S.Metal((0.85, 0.8, 0.75), 0.4)), "shell")
    sc.add_element(S.Sphere((0, 1.5, -4), 1.0, S.Emissive((0.6, 0.5, 0.4))), "lamp")
    sc.add_element(
        S.Sphere((0, -2.5, -4), 1.2, S.Lambertian.from_color((0.4, 0.5, 0.6))), "ball")
    return sc


def _mirror_shell(S, light=False, width=24):
    """tests/test_grad.py's overflow scene (there 32 wide): the camera inside
    a perfect mirror, so every lane survives to max_depth and exceeds every
    narrowed capacity (at 24 wide and 2 spp, 1,152 lanes against the
    512-lane floor; at 16 wide the floor holds all 512); ``light`` adds its
    small emitter."""
    sc = S.Scene.new_image(1.0, width)
    sc.scene_cam.look_from((0, 0, 0))
    sc.scene_cam.look_at((0, 0, -1))
    sc.scene_cam.set_vfov(60.0)
    sc.add_element(S.Sphere((0, 0, 0), 10.0, S.Metal((0.9, 0.9, 0.9), 0.0)), "shell")
    if light:
        sc.add_element(S.Sphere((0, 0, -3), 0.6, S.Emissive((2.0, 1.5, 1.0))), "light")
    return sc


def _lanes(p, spp):
    return torch.arange(p).repeat(spp), torch.arange(spp).repeat_interleave(p)


# --- the bucket spec -----------------------------------------------------------------


@pytest.mark.parametrize("max_depth", [2, 6, 8, 16, 20, 50])
@pytest.mark.parametrize(
    "spec,env",
    [(None, None), (None, "8:1,16:8,0:32"), (((4, 1), (8, 2), (0, 4)), None),
     (((4, 1), (0, 1)), "6:1,0:2"), (((6, 1), (6, 4), (30, 8)), None)],
    ids=["default", "env", "given", "given_over_env", "empty_bucket"],
)
def test_bucket_spec_matches_jax(monkeypatch, max_depth, spec, env):
    if env is None:
        monkeypatch.delenv("CRUCIBLE_GRAD_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("CRUCIBLE_GRAD_BUCKETS", env)
    assert trep._bucket_spec(max_depth, spec) == jrep._bucket_spec(max_depth, spec)


def test_capacities_match_jax():
    assert trep.GRAD_BUCKET_SPEC == jrep.GRAD_BUCKET_SPEC
    assert trep.RECORD_DEEP_DIV == jrep.RECORD_DEEP_DIV
    assert trep.GRAD_SPLIT_MIN_DEPTH == jrep.GRAD_SPLIT_MIN_DEPTH
    assert G._RECOVERY_LADDER == JG._RECOVERY_LADDER
    for rung in G._RECOVERY_LADDER:
        assert G._ladder_kwargs(rung) == JG._ladder_kwargs(rung)


@pytest.mark.parametrize("seed", [0, 3, 40])
def test_compaction_matches_nonzero(seed):
    """The sync-free compaction equals the plain one: the first ``cap`` set
    entries in order, unfilled slots 0 (capacities below and above the
    ~90 set entries)."""
    flag = torch.from_numpy(np.random.default_rng(seed).random(300) < 0.3)
    cap = 25 + 2 * seed
    idx, valid = trep._compact(flag, cap)
    want = torch.nonzero(flag).squeeze(1)[:cap]
    assert int(valid.sum()) == want.numel()
    assert torch.equal(idx[:want.numel()], want) and (idx[want.numel():] == 0).all()


# --- against the JAX package on the port's records -----------------------------------


def _port_replay(sd, cp, w, h, spp, fn):
    """(radiance, loss, grads) of the port: ``fn(sd2, cp2, o, d, pix, smp)``
    on the parameters' leaves, loss the weighted mean square."""
    pix, smp = _lanes(w * h, spp)
    wgt = torch.from_numpy(_weights(w * h * spp))
    params = G.extract_params(sd, cp)
    leaves = {k: params[k].detach().requires_grad_(True) for k in G.TENSOR_KEYS}
    sd2, cp2 = G.apply_params(sd, cp, {**params, **leaves})
    o, d, _ = trays(cp2, w, h, pix, smp, SEED)
    rad = fn(sd2, cp2, o, d, pix, smp)
    loss = (rad ** 2 * wgt).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return rad.detach().numpy(), loss.item(), {k: g.numpy() for k, g in zip(leaves, grads)}


def _jax_replay(js, w, h, spp, fn):
    """The same on the JAX side, jitted once."""
    jsd, jcp = js.build(), js.scene_cam.params()
    pix = jnp.tile(jnp.arange(w * h, dtype=jnp.uint32), spp)
    smp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), w * h)
    wgt = _weights(w * h * spp)

    def loss(params):
        sd2, cp2 = JG.apply_params(jsd, jcp, params)
        o, d, _ = jrays(cp2, w, h, pix, smp, jnp.uint32(SEED))
        rad = fn(sd2, cp2, o, d, pix, smp)
        return jnp.mean(rad ** 2 * wgt), rad

    (value, rad), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        JG.extract_params(jsd, jcp))
    return np.asarray(rad), float(value), {k: np.asarray(grads[k]) for k in G.TENSOR_KEYS}


@functools.cache
def _weights(r):
    return np.random.default_rng(0).random((r, 3)).astype(np.float32)


def _close(key, got, want, atol):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol, err_msg=key)


# A spec whose capacities hold the shell's survivors at 1,152 lanes: the
# middle bucket narrowed to half width, the last at full width.
SHELL_SPEC = ((6, 1), (12, 2), (0, 1))
SHELL_DEPTH = 20


@pytest.fixture(scope="module")
def shell_runs():
    """The shell, 24x24, 2 spp, depth 20, on the port's records: the port's
    and the JAX package's replay_bucketed (full record) and
    replay_bucketed_2l (two-level record, narrow capacity 1/1)."""
    js = _shell(jscene)
    sd, cp = bridged(js)
    w = h = 24
    pix, smp = _lanes(w * h, 2)
    rec = trep.trace_record_mega(sd, cp, w, h, pix, smp, SEED, SHELL_DEPTH)
    two = trep.record_two_level(sd, cp, w, h, pix, smp, SEED, SHELL_DEPTH, head=6, div=1)
    assert int(two[4]) > 512  # deep lanes well past a floor-sized capacity
    jrec = jnp.asarray(rec.numpy())
    jtwo = [jnp.asarray(x.numpy()) for x in two]
    runs = {
        "full": (
            _port_replay(sd, cp, w, h, 2, lambda s, c, o, d, p, q: trep.replay_bucketed(
                s, c, w, h, o, d, p, q, SEED, SHELL_DEPTH, rec, spec=SHELL_SPEC)),
            _jax_replay(js, w, h, 2, lambda s, c, o, d, p, q: jrep.replay_bucketed(
                s, c, w, h, o, d, p, q, jnp.uint32(SEED), SHELL_DEPTH, jrec, spec=SHELL_SPEC)),
        ),
        "two_level": (
            _port_replay(sd, cp, w, h, 2, lambda s, c, o, d, p, q: trep.replay_bucketed_2l(
                s, c, w, h, o, d, p, q, SEED, SHELL_DEPTH, *two, spec=SHELL_SPEC)),
            _jax_replay(js, w, h, 2, lambda s, c, o, d, p, q: jrep.replay_bucketed_2l(
                s, c, w, h, o, d, p, q, jnp.uint32(SEED), SHELL_DEPTH, *jtwo,
                spec=SHELL_SPEC)),
        ),
    }
    return runs


@pytest.mark.parametrize("which", ["full", "two_level"])
def test_bucketed_replays_match_jax_on_the_shell(shell_runs, which):
    (rad, loss, grads), (jrad, jloss, jgrads) = shell_runs[which]
    assert np.isfinite(rad).all()
    np.testing.assert_allclose(rad, jrad, rtol=1e-4, atol=1e-5)
    assert loss == pytest.approx(jloss, rel=1e-4)
    for key in G.TENSOR_KEYS:  # camera leaves included: no glass here (C4)
        _close(key, grads[key], jgrads[key], 1e-3)


@pytest.fixture(scope="module")
def book1_runs():
    """book1 32 wide, 2 spp, depth 50, at the shipped capacities: the port's
    two-level record (fused), and both packages' replay_bucketed_2l on it."""
    js = jdemo.book1_end_scene(width=32)
    sd, cp = bridged(js)
    w, h = 32, js.scene_cam.image_height
    pix, smp = _lanes(w * h, 2)
    out = trep.record_two_level(sd, cp, w, h, pix, smp, SEED, 50, head=6, head_radiance=True)
    two, fused = out[:5], out[5:]
    jtwo = [jnp.asarray(x.numpy()) for x in two]
    port = _port_replay(sd, cp, w, h, 2, lambda s, c, o, d, p, q: trep.replay_bucketed_2l(
        s, c, w, h, o, d, p, q, SEED, 50, *two))
    jax_side = _jax_replay(js, w, h, 2, lambda s, c, o, d, p, q: jrep.replay_bucketed_2l(
        s, c, w, h, o, d, p, q, jnp.uint32(SEED), 50, *jtwo))
    return (sd, cp, w, h, two, fused), port, jax_side


def test_two_level_matches_jax_on_book1_at_depth_50(book1_runs):
    (_, _, _, _, two, _), (rad, loss, grads), (jrad, jloss, jgrads) = book1_runs
    assert 0 < int(two[4]) <= two[1].shape[1]  # deep lanes, inside the capacity
    assert np.isfinite(rad).all()
    assert loss == pytest.approx(jloss, rel=1e-4)
    # Glass chains to depth 50 amplify the f32 association (C6): rtol 1e-4
    # on the bulk, the JAX kernel-vs-jnp bound on every lane.
    assert np.isclose(rad, jrad, rtol=1e-4, atol=1e-5).all(axis=1).mean() > 0.98
    assert np.isclose(rad, jrad, rtol=1e-3, atol=1e-3).all(axis=1).mean() > 0.98
    for key in ("tex_color", "mat_emission"):  # radiometric leaves on book1 (C4)
        _close(key, grads[key], jgrads[key], 1e-3)


def test_fused_two_level_shares_the_backward(book1_runs):
    """The fused radiances of the two record passes as the primals: the same
    backward (identical gradients of a loss linear in the radiance), and
    the replayed value up to the record kernel's own association, which
    glass chains to depth 50 amplify (the cross-path bound)."""
    (sd, cp, w, h, two, (rad_h, rad_n)), (rad, _, _), _ = book1_runs
    pix, smp = _lanes(w * h, 2)
    wgt = torch.from_numpy(_weights(w * h * 2))

    def linear(**given):
        params = G.extract_params(sd, cp)
        leaves = {k: params[k].detach().requires_grad_(True) for k in G.TENSOR_KEYS}
        sd2, cp2 = G.apply_params(sd, cp, {**params, **leaves})
        o, d, _ = trays(cp2, w, h, pix, smp, SEED)
        out = trep.replay_bucketed_2l(sd2, cp2, w, h, o, d, pix, smp, SEED, 50, *two, **given)
        return out.detach(), torch.autograd.grad((out * wgt).sum(), list(leaves.values()))

    rad_f, g_f = linear(rad_head=rad_h, rad_narrow=rad_n)
    _, g_r = linear()
    for a, b in zip(g_f, g_r):
        assert torch.equal(a, b)
    rad_f = rad_f.numpy()
    assert np.isclose(rad_f, rad, rtol=1e-3, atol=1e-3).all(axis=1).mean() > 0.98
    np.testing.assert_allclose(rad_f.mean(0), rad.mean(0), rtol=0, atol=2e-3)


# --- within the port: split equals unsplit --------------------------------------------


@pytest.mark.parametrize("two_level", ["1", "0"], ids=["two_level", "full_record"])
def test_split_matches_unsplit(monkeypatch, two_level):
    """tests/test_replay.py:708-742: with every capacity at full width the
    bucketed replay (over the two-level record, or over a full one) equals
    the unsplit replay: the same values up to f32 association (the fused
    primals sum the head and the deep rows apart; the JAX package's
    bucketed-vs-unsplit bound, tests/test_replay.py:705), gradients within
    rtol 1e-5."""
    monkeypatch.setenv("CRUCIBLE_GRAD_BUCKETS", "4:1,0:1")
    monkeypatch.setenv("CRUCIBLE_RECORD_DEEP_DIV", "1")
    monkeypatch.setenv("CRUCIBLE_GRAD_2L", two_level)
    sc = _shell(tscene)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    pix, smp = _lanes(24 * 24, 2)

    def loss_grads(split):
        params = G.extract_params(sd, cp)
        leaves = {k: params[k].detach().requires_grad_(True) for k in G.TENSOR_KEYS}
        sd2, cp2 = G.apply_params(sd, cp, {**params, **leaves})
        rad = trep.render_rays_replay(sd2, cp2, 24, 24, pix, smp, 0, 14, split=split)
        loss = (rad ** 2).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return rad.detach(), loss.item(), dict(zip(leaves, grads))

    r0, v0, g0 = loss_grads(False)
    r1, v1, g1 = loss_grads(True)
    np.testing.assert_allclose(r1.numpy(), r0.numpy(), rtol=1e-6, atol=1e-7)
    assert v1 == pytest.approx(v0, rel=1e-6)
    for key in ("tex_color", "mat_emission", "mat_fuzz", "cam_vfov"):
        np.testing.assert_allclose(g1[key].numpy(), g0[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_default_split_follows_the_depth_and_the_environment(monkeypatch):
    calls = []
    real = trep.record_two_level
    monkeypatch.setattr(trep, "record_two_level", lambda *a, **k: calls.append(1) or real(*a, **k))
    sc = tdemo.book1_end_scene(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    pix, smp = _lanes(16 * 9, 1)
    for depth, env, split in ((12, None, False), (13, None, True), (13, "0", False),
                              (8, "on", True)):
        if env is None:
            monkeypatch.delenv("CRUCIBLE_GRAD_SPLIT", raising=False)
        else:
            monkeypatch.setenv("CRUCIBLE_GRAD_SPLIT", env)
        calls.clear()
        rad = trep.render_rays_replay(sd, cp, 16, 9, pix, smp, 0, depth)
        assert bool(calls) == split and torch.isfinite(rad).all()


# --- overflow -----------------------------------------------------------------------


def test_narrow_record_overflow_poisons():
    sc = _shell(tscene)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    pix, smp = _lanes(24 * 24, 2)
    o, d, _ = trays(cp, 24, 24, pix, smp, 0)
    two = trep.record_two_level(sd, cp, 24, 24, pix, smp, 0, SHELL_DEPTH, head=4, div=100000)
    assert int(two[4]) > two[1].shape[1]  # genuinely overflowing
    # Unfilled narrow slots carry the padding sample id, never recorded.
    assert (two[1][:, ~two[3]] == 0).all()
    rad = trep.replay_bucketed_2l(sd, cp, 24, 24, o, d, pix, smp, 0, SHELL_DEPTH, *two,
                                  spec=((4, 1), (0, 2)))
    assert torch.isnan(rad).all()


def test_bucket_overflow_poisons():
    sc = _shell(tscene)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    pix, smp = _lanes(24 * 24, 2)
    o, d, _ = trays(cp, 24, 24, pix, smp, 0)
    rec = trep.trace_record_mega(sd, cp, 24, 24, pix, smp, 0, SHELL_DEPTH)
    rad = trep.replay_bucketed(sd, cp, 24, 24, o, d, pix, smp, 0, SHELL_DEPTH, rec,
                               spec=((4, 1), (8, 2), (0, 4)))
    assert torch.isnan(rad).all()
    # Wider capacities hold it.
    rad = trep.replay_bucketed(sd, cp, 24, 24, o, d, pix, smp, 0, SHELL_DEPTH, rec,
                               spec=((4, 1), (8, 1), (0, 1)))
    assert torch.isfinite(rad).all()


# --- the training surface --------------------------------------------------------------


def _setup(sc, spp, depth):
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    kw = dict(width=w, height=h, spp=spp, max_depth=depth)
    return sd, cp, torch.arange(w * h), torch.zeros((w * h, 3)), G.extract_params(sd, cp), kw


@pytest.fixture(scope="module")
def mirror():
    return _setup(_mirror_shell(tscene), 2, 13)


def test_default_chunk_poisons_and_the_ladder_recovers(mirror, capsys):
    sd, cp, pix, target, params, kw = mirror
    loss0, _ = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
    assert not np.isfinite(float(loss0))
    loss1, g1 = G.loss_and_grad_recovering(params, sd, cp, target, pix, 0, **kw)
    assert np.isfinite(float(loss1))
    err = capsys.readouterr().err
    assert "retrying with wider" in err and "recovered" in err
    loss2, g2 = G.loss_and_grad(params, sd, cp, target, pix, 0, grad_split=False, **kw)
    assert float(loss1) == float(loss2)
    for key in G.TENSOR_KEYS:
        assert torch.isfinite(g1[key]).all() and torch.equal(g1[key], g2[key]), key


def test_ladder_raises_on_a_true_nan(mirror):
    sd, cp, pix, target, params, kw = mirror
    bad = dict(params, tex_color=params["tex_color"].clone())
    bad["tex_color"][0] = float("nan")
    with pytest.raises(FloatingPointError, match="NOT a lane-narrowing"):
        G.loss_and_grad_recovering(bad, sd, cp, target, pix, 0, verbose=False, **kw)


@pytest.mark.parametrize("recover", [True, False])
def test_accum_is_the_mean_of_its_chunks(recover):
    sd, cp, pix, target, params, kw = _setup(tdemo.smoke_scene(width=16), 2, 14)
    kw.pop("spp")
    loss, grads = G.loss_and_grad_accum(params, sd, cp, target, pix, 0, spp=2, chunk_spp=1,
                                        recover=recover, **kw)
    chunks = [G.loss_and_grad(params, sd, cp, target, pix, 0, spp=1, sample0=s0, **kw)
              for s0 in (0, 1)]
    loss_sum = torch.zeros(())
    for chunk_loss, _ in chunks:
        loss_sum += chunk_loss
    assert float(loss) == float(loss_sum * 0.5) and np.isfinite(float(loss))
    for key in G.TENSOR_KEYS:
        total = torch.zeros_like(params[key])
        for _, g in chunks:
            total += g[key]
        assert torch.equal(grads[key], total * 0.5), key
    assert grads["tex_images"] == () and grads["sky_image"] is None


def test_accum_recovers_poisoned_chunks(mirror, capsys):
    sd, cp, pix, target, params, kw = mirror
    loss, grads = G.loss_and_grad_accum(params, sd, cp, target, pix, 0, chunk_spp=1, **kw)
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(grads[k]).all() for k in G.TENSOR_KEYS)
    assert "recovering" in capsys.readouterr().err


def _lit_mirror(width=24):
    sd, cp, pix, target, params, kw = _setup(_mirror_shell(tscene, True, width), 2, 13)
    keys = ("tex_color", "mat_emission")
    params = dict(params, **{k: params[k].clone().requires_grad_(True) for k in keys})
    return sd, cp, pix, target, params, kw, keys


def test_recovering_train_step_descends():
    """tests/test_grad.py:418-460: the overflow still holds, and three
    recovering Adam steps lower the loss."""
    sd, cp, pix, target, params, kw, keys = _lit_mirror()
    loss0, _ = G.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
    assert not np.isfinite(float(loss0))
    step = G.make_train_step(torch.optim.Adam([params[k] for k in keys], lr=2e-2), **kw,
                             recover=True)
    losses = [float(step(params, sd, cp, target, pix, i)) for i in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_checkpoint_resume_is_bit_identical(tmp_path):
    """Three recovering Adam steps equal one step, a checkpoint, a load into
    a new optimizer, and two more steps, bit for bit (16 wide: no rung
    past the default; the ladder's steps are the test above)."""
    sd, cp, pix, target, params, kw, keys = _lit_mirror(width=16)

    def run(params, opt, steps, first):
        step = G.make_train_step(opt, **kw, recover=True)
        return [float(step(params, sd, cp, target, pix, first + i)) for i in range(steps)]

    full = {k: params[k].detach().clone().requires_grad_(True) for k in keys}
    p_full = dict(params, **full)
    l_full = run(p_full, torch.optim.Adam([p_full[k] for k in keys], lr=2e-2), 3, 0)

    part = {k: params[k].detach().clone().requires_grad_(True) for k in keys}
    p_part = dict(params, **part)
    opt = torch.optim.Adam([p_part[k] for k in keys], lr=2e-2)
    l_part = run(p_part, opt, 1, 0)
    path = tmp_path / "ckpt.npz"
    G.save_checkpoint(path, p_part, opt, step=1)
    del p_part, opt
    loaded, state, step0 = G.load_checkpoint(path, device="cpu")
    assert step0 == 1 and loaded["tex_images"] == () and loaded["sky_image"] is None
    p_res = dict(loaded, **{k: loaded[k].requires_grad_(True) for k in keys})
    opt = torch.optim.Adam([p_res[k] for k in keys], lr=2e-2)
    opt.load_state_dict(state)
    l_res = l_part + run(p_res, opt, 2, step0)
    assert l_res == l_full
    for key in G.TENSOR_KEYS:
        assert torch.equal(p_res[key].detach(), p_full[key].detach()), key


def test_checkpoint_round_trips_a_spherical_sky(tmp_path):
    sd, cp, _, _, params, _ = _setup(tdemo.smoke_scene(width=16), 1, 2)
    sky = torch.rand((4, 8, 3), generator=torch.Generator().manual_seed(0))
    params = dict(params, sky_image=sky)
    G.save_checkpoint(tmp_path / "c.npz", params, step=7)
    loaded, state, step = G.load_checkpoint(tmp_path / "c.npz", device="cpu")
    assert state is None and step == 7
    assert G.leaf_keys(loaded) == G.leaf_keys(params)
    for key in G.leaf_keys(params):
        assert torch.equal(loaded[key], params[key]), key
    with np.load(tmp_path / "c.npz", allow_pickle=False) as z:
        assert "__treedef__" not in z.files


def test_params_from_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package's save_checkpoint writes (with its optax
    state): the port reads the parameter leaves and the step; the optax
    state is not carried over."""
    js = jdemo.smoke_scene(width=16)
    jparams = JG.extract_params(js.build(), js.scene_cam.params())
    opt = optax.adam(1e-2)
    JG.save_checkpoint(tmp_path / "jax.npz", jparams, opt.init(jparams), step=5)
    params, state, step = bridge.params_from_jax_checkpoint(tmp_path / "jax.npz", device="cpu")
    assert state is None and step == 5
    assert params["sky_image"] is None and params["tex_images"] == ()
    for key in G.TENSOR_KEYS:
        np.testing.assert_array_equal(params[key].numpy(), np.asarray(jparams[key]), err_msg=key)
    # A spherical sky's image is a leaf in its sorted place.
    sky = np.random.default_rng(0).random((2, 4, 3)).astype(np.float32)
    JG.save_checkpoint(tmp_path / "sky.npz", dict(jparams, sky_image=jnp.asarray(sky)))
    params, _, _ = bridge.params_from_jax_checkpoint(tmp_path / "sky.npz", device="cpu")
    np.testing.assert_array_equal(params["sky_image"].numpy(), sky)
    np.testing.assert_array_equal(params["tex_color"].numpy(), np.asarray(jparams["tex_color"]))
    # Texture images are not ported.
    JG.save_checkpoint(tmp_path / "tex.npz",
                       dict(jparams, tex_images=(jnp.zeros((2, 2, 3)),)))
    with pytest.raises(NotImplementedError, match="image textures"):
        bridge.params_from_jax_checkpoint(tmp_path / "tex.npz", device="cpu")
