"""K4-legacy, the unblocked replay pair (``trace_replay_mega(blocked=False)``):
the port's channel-major layout against the JAX package's unblocked Pallas
pair in interpret mode (tests/test_replay.py:1031-1067's size: depth 6,
1,152 lanes), against the port's own blocked pair, its routing by
``CRUCIBLE_REPLAY_BLOCKED``, and its input checks. Its CUDA kernels are
held against their plain versions in tests/test_torch_deep_card.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu.ops.pallas import replay_kernel as jrk
from crucible_tpu_torch.ops.kernels import replay_kernel as trk
from tests.test_torch_replay import SEED, _assert_k3_scheme, _setup, _t
from tests.torch_threads import one_torch_thread  # noqa: F401

DEPTH, LANES = 6, 1024 + 128


@functools.cache
def _inputs():
    x = _setup(DEPTH, LANES)
    wgt = np.random.default_rng(5).standard_normal((LANES, 3)).astype(np.float32)
    return x, wgt


@pytest.fixture(scope="module")
def jax_legacy():
    """The JAX unblocked pair in interpret mode: radiance and the cotangents
    of sum(rad * wgt) w.r.t. (table, o, d)."""
    x, wgt = _inputs()
    pix = jnp.asarray(x["pix"], jnp.uint32)
    smp = jnp.asarray(x["smp"], jnp.uint32)
    rec = jnp.asarray(x["rec"])

    def replay(table, o, d):
        return jrk.trace_replay_mega(table, o, d, pix, smp, jnp.uint32(SEED), rec,
                                     interpret=True, blocked=False)

    leaves = [jnp.asarray(x[k]) for k in ("table", "o", "d")]
    rad = np.asarray(replay(*leaves))
    grads = jax.grad(lambda *a: jnp.sum(replay(*a) * wgt), argnums=(0, 1, 2))(*leaves)
    return rad, [np.asarray(g) for g in grads]


def _port(blocked, **kw):
    """The port's trace_replay_mega: radiance and the cotangents of
    sum(rad * wgt) w.r.t. (table, o, d)."""
    x, wgt = _inputs()
    leaves = [_t(x[k]).requires_grad_(True) for k in ("table", "o", "d")]
    rad = trk.trace_replay_mega(*leaves, _t(x["pix"]), _t(x["smp"]), SEED, _t(x["rec"]),
                                blocked=blocked, **kw)
    grads = torch.autograd.grad((rad * _t(wgt)).sum(), leaves)
    return rad.detach().numpy(), [g.numpy() for g in grads]


def test_legacy_matches_jax_legacy_pair(jax_legacy):
    want_rad, want = jax_legacy
    rad, got = _port(blocked=False)
    assert rad.shape == want_rad.shape == (LANES, 3) and np.isfinite(rad).all()
    # The same frozen decisions; XLA's CPU contracts multiply-adds inside
    # the interpreted kernel, and silhouettes amplify the last ulp (fault
    # C6): the JAX package's own jnp replay and legacy pair differ by more
    # than rtol 1e-4 on 14 of these 1,152 lanes, the port on 24. So the
    # eager replay's rtol 1e-4 / atol 1e-5 holds the bulk, the JAX
    # kernel-vs-jnp bound (tests/test_replay.py:962-964) the rest.
    lanes = np.isclose(rad, want_rad, rtol=1e-4, atol=1e-5).all(axis=1)
    assert lanes.mean() > 0.97, f"{(~lanes).sum()} lanes beyond rtol 1e-4"
    assert np.isclose(rad, want_rad, rtol=1e-3, atol=1e-3).all(axis=1).mean() > 0.99
    np.testing.assert_allclose(rad.mean(0), want_rad.mean(0), rtol=0, atol=1e-5)
    # Cotangents, the table's included, within the JAX replay backward's
    # scheme: the same association forbids the legacy-vs-blocked test's
    # normalized 1e-5 (here up to 1.7e-2 on 0.09% of the table entries).
    _assert_k3_scheme(got, want)


@pytest.mark.parametrize(
    "kw",
    [{}, {"accum_from": 3, "valid": torch.arange(LANES) % 3 != 0},
     {"rad_given": torch.full((LANES, 3), 0.25)}],
    ids=["plain", "accum_from_valid", "rad_given"],
)
def test_legacy_equals_blocked_bit_for_bit(kw):
    """One per-lane arithmetic in both layouts: the same radiance and
    cotangents, bit for bit (on the card the kernels too; see
    tests/test_torch_deep_card.py)."""
    rad_l, grads_l = _port(blocked=False, **kw)
    rad_b, grads_b = _port(blocked=True, **kw)
    np.testing.assert_array_equal(rad_l, rad_b)
    for a, b in zip(grads_l, grads_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("value", [None, "1", "0", "false", "OFF", "on", ""])
def test_blocked_default_parses_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("CRUCIBLE_REPLAY_BLOCKED", raising=False)
    else:
        monkeypatch.setenv("CRUCIBLE_REPLAY_BLOCKED", value)
    assert trk._blocked_default() == jrk._blocked_default()


@pytest.mark.parametrize("env,legacy", [("0", True), ("1", False)])
def test_environment_routes_the_layout(monkeypatch, env, legacy):
    """CRUCIBLE_REPLAY_BLOCKED=0 sends trace_replay_mega's forward and
    backward to the legacy pair; the default to the blocked one."""
    calls = []
    for name in ("replay_forward", "replay_backward", "replay_legacy_forward",
                 "replay_legacy_backward"):
        real = getattr(trk, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(trk, name, spy)
    monkeypatch.setenv("CRUCIBLE_REPLAY_BLOCKED", env)
    _port(blocked=None)
    prefix = "replay_legacy_" if legacy else "replay_"
    assert calls == [prefix + "forward", prefix + "backward"]


def test_legacy_twins_are_the_transposed_blocked_twins():
    x, wgt = _inputs()
    table, o, d, pix, smp, rec = (_t(x[k]) for k in ("table", "o", "d", "pix", "smp", "rec"))
    valid = torch.ones(LANES, dtype=torch.int32)
    rows = [v.reshape(1, LANES) for v in (valid, pix, smp)]
    o3, d3, g3 = o.t().contiguous(), d.t().contiguous(), _t(wgt).t().contiguous()
    rad3 = trk.replay_legacy_forward(table, o3, d3, *rows, rec, SEED, accum_from=2)
    assert rad3.shape == (3, LANES)
    rad = trk.replay_forward_reference(table, o, d, valid, pix, smp, rec, SEED, accum_from=2)
    assert torch.equal(rad3, rad.t())
    got = trk.replay_legacy_backward(table, o3, d3, *rows, rec, SEED, g3, accum_from=2)
    want = trk.replay_backward_reference(table, o, d, valid, pix, smp, rec, SEED, _t(wgt),
                                         accum_from=2)
    assert got[1].shape == got[2].shape == (3, LANES)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1].t()) and torch.equal(got[2], want[2].t())


def test_cpu_tensors_take_the_legacy_twins(monkeypatch):
    def no_kernel():
        raise AssertionError("CPU tensors must not reach a kernel")

    monkeypatch.setattr(trk, "_lib", no_kernel)
    before = (trk.LAUNCHES_LEGACY_FORWARD, trk.LAUNCHES_LEGACY_BACKWARD)
    rad, grads = _port(blocked=False)
    assert np.isfinite(rad).all() and all(np.isfinite(g).all() for g in grads)
    assert (trk.LAUNCHES_LEGACY_FORWARD, trk.LAUNCHES_LEGACY_BACKWARD) == before


@pytest.mark.parametrize(
    "name,change,error",
    [
        ("o", lambda t: t.t().contiguous(), ValueError),  # (R, 3), the blocked layout
        ("pix", lambda t: t.reshape(-1), ValueError),  # (R,), not a (1, R) row
        ("d", lambda t: t[:, :-1].contiguous(), ValueError),
        ("valid", lambda t: t.float(), TypeError),
        ("rec", lambda t: t[:, :-1].contiguous(), ValueError),
    ],
    ids=["lane_major_rays", "flat_ids", "lanes", "valid_dtype", "rec_lanes"],
)
def test_legacy_validates_inputs(name, change, error):
    x, _ = _inputs()
    t = {k: _t(x[k]) for k in ("table", "o", "d", "pix", "smp", "rec")}
    t["o"], t["d"] = t["o"].t().contiguous(), t["d"].t().contiguous()
    t["valid"] = torch.ones((1, LANES), dtype=torch.int32)
    t["pix"], t["smp"] = t["pix"].reshape(1, -1), t["smp"].reshape(1, -1)
    t[name] = change(t[name])
    with pytest.raises(error):
        trk.replay_legacy_forward(t["table"], t["o"], t["d"], t["valid"], t["pix"], t["smp"],
                                  t["rec"], SEED)
