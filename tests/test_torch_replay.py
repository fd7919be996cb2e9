"""K4 and K3, the replay forward and backward: the port's twins against the
JAX package's replay (its jnp path on the CPU, and jax.grad through the
same per-bounce math) on the same records, rays and table; the autograd
wiring; and — on a GPU only — the CUDA kernels against their twins."""

import functools

import numpy as np
import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.ops.kernels import replay_kernel as trk
from tests.torch_threads import one_torch_thread  # noqa: F401

# The JAX side is imported inside the helpers that use it, so that the
# card-only tests at the end also run where JAX is not installed:
#   python -m pytest --noconftest -m cuda tests/test_torch_replay.py

SEED = 7


@functools.cache
def _setup(depth, r, width=64):
    """The JAX replay test's inputs (tests/test_replay.py TestReplayKernel):
    book1, r lanes cycling over the pixels, sample 0, seed 7, records from
    the JAX staged record pass. Returns numpy arrays."""
    import jax.numpy as jnp
    from crucible_tpu.models import demo as jdemo
    from crucible_tpu.models import integrator as jint
    from crucible_tpu.models import replay as jrep
    from crucible_tpu.models.camera import generate_rays

    sc = jdemo.book1_end_scene(width=width)
    sd, cp = sc.build(), sc.scene_cam.params()
    h = sc.scene_cam.image_height
    pix = jnp.arange(r, dtype=jnp.uint32) % (width * h)
    smp = jnp.zeros((r,), jnp.uint32)
    o, d, _ = generate_rays(cp, width, h, pix, smp, jnp.uint32(SEED))
    rec = jrep.trace_record(sd, o, d, pix, smp, jnp.uint32(SEED), depth)
    table = jint.make_sphere_table(sd)
    return dict(
        table=np.array(table), o=np.array(o), d=np.array(d),
        pix=np.array(pix).astype(np.int32), smp=np.array(smp).astype(np.int32),
        rec=np.array(rec),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(x, wgt=None, **kw):
    """The port's replay; with ``wgt``, also the cotangents of
    sum(rad * wgt) w.r.t. (table, o, d)."""
    table, o, d = (_t(x[k]).requires_grad_(wgt is not None) for k in ("table", "o", "d"))
    rad = trk.trace_replay_mega(
        table, o, d, _t(x["pix"]), _t(x["smp"]), SEED, _t(x["rec"]), **kw
    )
    if wgt is None:
        return rad.detach().numpy()
    grads = torch.autograd.grad((rad * _t(wgt)).sum(), (table, o, d))
    return rad.detach().numpy(), [g.numpy() for g in grads]


def _jax_grad(x, wgt, depth):
    """jax.grad of sum(rad * wgt) through a jnp loop over the JAX `_bounce`
    with exact row gathers (tests/test_replay.py:981-1009)."""
    import jax
    import jax.numpy as jnp
    from crucible_tpu.ops.pallas import replay_kernel as jrk
    from crucible_tpu.utils import rng as jrng

    r = x["o"].shape[0]
    rec = jnp.asarray(x["rec"])
    pix = jnp.asarray(x["pix"], jnp.uint32)
    smp = jnp.asarray(x["smp"], jnp.uint32)

    def loss(table, o, d):
        carry = tuple(
            v[None, :] for v in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
        )
        ones = jnp.ones((1, r), jnp.float32)
        carry = carry + (ones, ones, ones)
        acc = [jnp.zeros((1, r), jnp.float32)] * 3
        for it in range(depth):
            dec = jrk._decode(rec[it][None, :])
            srow = jnp.take(table, dec["idx"][0], axis=0).T
            u1, u2, ud = jrng.uniform3(pix, smp, jnp.uint32(3 + it), jnp.uint32(SEED))
            carry, inc = jrk._bounce(
                carry, srow, dec, u1[None, :], u2[None, :], ud[None, :], True
            )
            acc = [a + b for a, b in zip(acc, inc)]
        rad = jnp.stack([a[0] for a in acc], axis=1)
        return jnp.sum(rad * wgt)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x[k]) for k in ("table", "o", "d"))
    )
    return [np.asarray(g) for g in grads]


def _assert_k3_scheme(got, want):
    """The JAX replay kernel's backward scheme (tests/test_replay.py:1017-
    1029): near-tangent lanes amplify 1-ulp differences through
    d(sqrt)/d(disc), so the bulk is held tight and the tail bounded."""
    for name, a, b in zip(("g_table", "g_o", "g_d"), got, want):
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max()), 1e-6)
        nd = np.abs(a - b) / scale
        cap = 0.005 if name == "g_table" else 0.02
        assert float((nd > 2e-4).mean()) < cap, f"{name}: outlier fraction"
        assert float(nd.max()) < 0.1, f"{name}: max {nd.max():.4f}"


def test_forward_matches_jax_replay():
    import jax.numpy as jnp
    from crucible_tpu.models import demo as jdemo
    from crucible_tpu.models import replay as jrep

    x = _setup(8, 1024 + 128)
    sd = jdemo.book1_end_scene(width=64).build()
    ref = np.asarray(jrep.trace_replay(
        sd, *(jnp.asarray(x[k]) for k in ("o", "d")),
        jnp.asarray(x["pix"], jnp.uint32), jnp.asarray(x["smp"], jnp.uint32),
        jnp.uint32(SEED), 8, jnp.asarray(x["rec"]),
    ))
    got = _port(x)
    assert got.shape == ref.shape and np.isfinite(got).all()
    # tests/test_replay.py:962-964: f32 association differs (XLA contracts
    # multiply-adds), silhouettes amplify it.
    np.testing.assert_allclose(got.mean(0), ref.mean(0), rtol=1e-3, atol=1e-3)
    assert np.isclose(got, ref, rtol=1e-3, atol=1e-3).all(axis=-1).mean() > 0.98


def test_backward_matches_jax_grad():
    depth = 6
    x = _setup(depth, 1024)
    wgt = np.random.default_rng(0).standard_normal((1024, 3)).astype(np.float32)
    _, got = _port(x, wgt)
    _assert_k3_scheme(got, _jax_grad(x, wgt, depth))


def test_accum_from_and_valid_mask():
    """Bucket semantics: rows below accum_from update the carry only;
    invalid lanes replay to exactly zero, value and cotangent
    (tests/test_replay.py:1069-1104)."""
    import jax.numpy as jnp
    from crucible_tpu.models import demo as jdemo
    from crucible_tpu.models import replay as jrep

    depth, r = 6, 1024
    x = _setup(depth, r)
    valid = np.arange(r) % 3 != 0
    thr0 = np.where(valid[:, None], np.ones((r, 3), np.float32), 0.0).astype(np.float32)
    ref = np.asarray(jrep.trace_replay(
        jdemo.book1_end_scene(width=64).build(),
        *(jnp.asarray(x[k]) for k in ("o", "d")),
        jnp.asarray(x["pix"], jnp.uint32), jnp.asarray(x["smp"], jnp.uint32),
        jnp.uint32(SEED), depth, jnp.asarray(x["rec"]),
        thr_in=jnp.asarray(thr0), accum_from=3,
    ))
    wgt = np.ones((r, 3), np.float32)
    got, (g_table, g_o, g_d) = _port(x, wgt, accum_from=3, valid=_t(valid))
    assert (got[~valid] == 0).all() and (ref[~valid] == 0).all()
    np.testing.assert_allclose(got[valid].mean(0), ref[valid].mean(0), rtol=1e-3, atol=1e-3)
    assert (g_o[~valid] == 0).all() and (g_d[~valid] == 0).all()
    assert np.isfinite(g_table).all() and np.abs(g_table).max() > 0
    # Rows below accum_from add nothing: a lane that died there is zero.
    head = (x["rec"][3] & trep.F_ALIVE) == 0
    assert (got[head] == 0).all()


def test_table_cotangent_lives_in_the_used_columns():
    x = _setup(6, 1024)
    wgt = np.random.default_rng(1).standard_normal((1024, 3)).astype(np.float32)
    _, (g_table, _, _) = _port(x, wgt)
    unused = [c for c in range(trk.C_IN) if c not in trk.USED]
    assert (g_table[:, unused] == 0).all()
    # Material type, texture kind and checker scale are flat (comparisons,
    # floor): no gradient either.
    assert (g_table[:, [6, 13, 17]] == 0).all()


def test_dead_rows_add_nothing():
    """Rows with the alive bit clear are the identity: records padded with
    dead rows replay to the same bits, value and cotangents."""
    x = _setup(6, 1024)
    wgt = np.random.default_rng(2).standard_normal((1024, 3)).astype(np.float32)
    rad, grads = _port(x, wgt)
    longer = dict(x, rec=np.concatenate([x["rec"], np.zeros((3, 1024), np.int32)]))
    rad2, grads2 = _port(longer, wgt)
    np.testing.assert_array_equal(rad, rad2)
    for a, b in zip(grads, grads2):
        np.testing.assert_array_equal(a, b)


def test_given_radiance_is_the_primal_and_shares_the_backward():
    x = _setup(6, 1024)
    wgt = np.random.default_rng(3).standard_normal((1024, 3)).astype(np.float32)
    rad, grads = _port(x, wgt)
    given = torch.full((1024, 3), 0.25)
    rad_g, grads_g = _port(x, wgt, rad_given=given)
    assert (rad_g == 0.25).all() and not np.array_equal(rad, rad_g)
    for a, b in zip(grads, grads_g):
        np.testing.assert_array_equal(a, b)


def test_decode_matches_jax():
    import jax.numpy as jnp
    from crucible_tpu.ops.pallas import replay_kernel as jrk

    words = np.random.default_rng(4).integers(0, 1 << 31, 4096).astype(np.int32)
    want = jrk._decode(jnp.asarray(words))
    got = trk._decode(torch.from_numpy(words))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_used_channels_match_jax():
    from crucible_tpu.ops.pallas import replay_kernel as jrk

    assert trk.USED == jrk.USED and trk.NUSE == 22


def test_supported_predicate():
    from dataclasses import replace

    sd = tdemo.book1_end_scene(width=16).build(device="cpu")
    assert trk.supported(sd, 488) and trep.replay_supported(sd)
    assert not trk.supported(sd, trk.MAX_TABLE_ROWS + 1)
    assert not trk.supported(replace(sd, num_tris=6), 488)
    assert not trk.supported(replace(sd, animated=True), 488)
    assert not trk.supported(replace(sd, sky_kind=1), 488)
    # The JAX kernel's cap (tests/test_torch_sphere_bvh.py holds 2048/2049).
    from crucible_tpu.ops.pallas import replay_kernel as jrk

    assert trk.MAX_TABLE_ROWS == jrk.MAX_TABLE_ROWS


def test_cpu_tensors_take_the_twins(monkeypatch):
    def no_kernel():
        raise AssertionError("CPU tensors must not reach a kernel")

    monkeypatch.setattr(trk, "_lib", no_kernel)
    x = _setup(6, 1024)
    before = (trk.LAUNCHES_FORWARD, trk.LAUNCHES_BACKWARD)
    wgt = np.ones((1024, 3), np.float32)
    rad, grads = _port(x, wgt)
    args = [_t(x[k]) for k in ("table", "o", "d")] + [
        torch.ones(1024, dtype=torch.int32), _t(x["pix"]), _t(x["smp"]), _t(x["rec"]), SEED
    ]
    np.testing.assert_array_equal(rad, trk.replay_forward_reference(*args).numpy())
    ref = trk.replay_backward_reference(*args, _t(wgt))
    for a, b in zip(grads, ref):
        np.testing.assert_array_equal(a, b.numpy())
    assert (trk.LAUNCHES_FORWARD, trk.LAUNCHES_BACKWARD) == before


@pytest.mark.parametrize(
    "name,change,error",
    [
        ("table", lambda t: t.double(), TypeError),
        ("o", lambda t: t[:-1].contiguous(), ValueError),
        ("d", lambda t: t.t().contiguous().t(), ValueError),
        ("rec", lambda t: t.long(), TypeError),
        ("rec", lambda t: t[:, :-1].contiguous(), ValueError),
        ("table", lambda t: t[:, :16].contiguous(), ValueError),
    ],
    ids=["dtype", "lanes", "contiguity", "rec_dtype", "rec_lanes", "columns"],
)
def test_validates_inputs(name, change, error):
    x = _setup(6, 1024)
    t = {k: _t(x[k]) for k in ("table", "o", "d", "pix", "smp", "rec")}
    t[name] = change(t[name])
    valid = torch.ones(1024, dtype=torch.int32)
    with pytest.raises(error):
        trk.replay_forward(t["table"], t["o"], t["d"], valid, t["pix"], t["smp"], t["rec"], SEED)


def test_backward_launch_is_sized_from_the_card():
    """K3's host-side sizing: a persistent grid of as many blocks as stay
    resident, none more than the lanes need; the carry scratch (depth x 9
    floats a resident thread) and one partial of n x 22 floats a block."""
    assert trk.grid_size(2, 132, trk.BACKWARD_BLOCK, 1920 * 1080 * 4) == 264
    assert trk.grid_size(2, 132, trk.BACKWARD_BLOCK, 1000) == 4  # 1000 lanes: 4 tiles
    assert trk.grid_size(1, 132, trk.FORWARD_BLOCK, 17) == 1
    assert trk.grid_size(3, 132, trk.BACKWARD_BLOCK, 0) == 0
    ck, part = trk.backward_scratch(488, 8, 264)
    assert ck == 8 * 9 * 264 * trk.BACKWARD_BLOCK and part == 264 * 488 * trk.NUSE
    # 19.5 MB of carries at d8 for 264 blocks, within the card's 50 MB L2.
    assert 4 * ck < 20e6
    assert trk.backward_scratch(2048, 50, 132) == (50 * 9 * 132 * 256, 132 * 2048 * 22)


def test_kernel_source_keeps_the_static_deterministic_design():
    """The C source: K4 fetches lanes from a warp-aggregated work counter;
    K3 assigns lanes statically and reduces without float atomics."""
    from crucible_tpu_torch.ops.kernels import build

    src = (build.CSRC / "replay_kernel.cu").read_text()
    assert "atomicAdd(next" in src and "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src
    assert src.count("atomicAdd(") == 1  # the work counter's, an integer
    assert "__match_any_sync" in src and "__reduce_max_sync" in src
    assert "atomicAdd(b_part" not in src and "atomicAdd(p" not in src


def test_launches_query_nothing():
    """The C launches take their grid (and K3 its partial placement) from the
    wrapper's cached launch shape: no occupancy query, device attribute or
    function attribute is read or set per launch."""
    import re

    from crucible_tpu_torch.ops.kernels import build

    src = (build.CSRC / "replay_kernel.cu").read_text()
    for launch in ("launch_forward", "launch_backward"):
        body = re.search(r"int " + launch + r"\(.*?\n}\n", src, re.S).group(0)
        for call in ("cudaOccupancy", "cudaFuncSetAttribute", "cudaGetDevice",
                     "cudaDeviceGetAttribute", "cudaFuncGetAttributes"):
            assert call not in body, (launch, call)
        assert "int grid" in body, launch
    assert "int shared" in re.search(r"int launch_backward\(.*?\)", src, re.S).group(0)


def test_deep_buckets_lay_out_the_chunk_as_the_replay_does():
    """``tools/torch_replay_ab.deep_buckets`` (the buckets chip_smoke.py and
    the A/B tool time and hold, and the card tests use): replaying each
    bucket and adding it at its lanes gives ``replay_bucketed_2l``'s
    radiance on the same two-level record, bit for bit (CPU twins)."""
    from crucible_tpu_torch import grad as G
    from crucible_tpu_torch.models.camera import generate_rays
    from tools.torch_replay_ab import deep_buckets

    cpu = torch.device("cpu")
    sc = tdemo.book1_end_scene(width=16)
    sd, cp = sc.build(device=cpu), sc.scene_cam.params(device=cpu)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    pix, smp = G._lanes(torch.arange(w * h), 2, 0)
    buckets = deep_buckets(sd, cp, w, h, pix, smp, max_depth=50)
    lims, _ = trep._bucket_spec(50)
    assert [name for name, _, _ in buckets] == [f"d{lim}" for lim in lims]
    rad = torch.zeros((pix.shape[0], 3))
    for j, (_, args, accum_from) in enumerate(buckets):
        assert accum_from == (0 if j == 0 else lims[0]) and args[6].shape[0] == lims[j]
        out = trk.replay_forward(*args, 0, accum_from=accum_from)
        if j == 0:
            rad = out
            continue
        filled = args[3] > 0
        lanes = args[5].long() * (w * h) + args[4].long()  # sample-major
        rad = rad.index_add(0, lanes[filled], out[filled])
    o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
    rec = trep.record_two_level(sd, cp, w, h, pix, smp, 0, 50, head=lims[0])
    want = trep.replay_bucketed_2l(sd, cp, w, h, o, d, pix, smp, 0, 50, *rec)
    assert bool(want.isfinite().all())
    assert torch.equal(rad, want)


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_replay.py)"
        )
    return torch.device("cuda")


def _card_inputs(cuda, width=320, spp=4, depth=8):
    """book1 at ``width``: rays, ids and records from the port's record
    kernel (K2), on the card."""
    from crucible_tpu_torch.models.camera import generate_rays

    sc = tdemo.book1_end_scene(width=width)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    p = w * h
    pix = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)
    smp = torch.arange(spp, device=cuda, dtype=torch.int32).repeat_interleave(p)
    o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
    rec = trep.trace_record_mega(sd, cp, w, h, pix, smp, 0, depth)
    from crucible_tpu_torch.models import integrator

    table = integrator.make_sphere_table(sd).contiguous()
    valid = torch.ones_like(pix)
    return table, o.contiguous(), d.contiguous(), valid, pix, smp, rec


@pytest.mark.cuda
def test_forward_kernel_matches_twin_on_card(cuda):
    args = _card_inputs(cuda)
    before = trk.LAUNCHES_FORWARD
    rad = trk.replay_forward(*args, 0)
    torch.cuda.synchronize()
    assert trk.LAUNCHES_FORWARD == before + 1
    # Same operations, each rounded (-fmad=false): bit for bit.
    assert torch.equal(rad, trk.replay_forward_reference(*args, 0))


@pytest.mark.cuda
def test_backward_kernel_matches_twin_on_card(cuda):
    args = _card_inputs(cuda, width=192)
    g_rad = torch.randn((args[1].shape[0], 3), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    before = trk.LAUNCHES_BACKWARD
    got = trk.replay_backward(*args, 0, g_rad)
    g_table2 = trk.replay_backward(*args, 0, g_rad)[0]
    torch.cuda.synchronize()
    assert trk.LAUNCHES_BACKWARD == before + 2
    # The table cotangent is summed in a fixed order: the same bits twice.
    assert torch.equal(got[0], g_table2)
    want = trk.replay_backward_reference(*args, 0, g_rad)
    _assert_k3_scheme([g.cpu().numpy() for g in got], [g.cpu().numpy() for g in want])


@pytest.mark.cuda
def test_cuda_replay_never_takes_the_twins(cuda, monkeypatch):
    def no_twin(*args, **kwargs):
        raise AssertionError("CUDA tensors must not reach an eager twin")

    monkeypatch.setattr(trk, "replay_forward_reference", no_twin)
    monkeypatch.setattr(trk, "replay_backward_reference", no_twin)
    table, o, d, valid, pix, smp, rec = _card_inputs(cuda, width=32, spp=1, depth=4)
    table.requires_grad_(True)
    rad = trk.trace_replay_mega(table, o, d, pix, smp, 0, rec)
    (g,) = torch.autograd.grad(rad.sum(), (table,))
    torch.cuda.synchronize()
    assert rad.is_cuda and torch.isfinite(rad).all() and torch.isfinite(g).all()


def _table_rows(table, n):
    """``table`` cut or padded (with copies of its last row) to n rows."""
    if n <= table.shape[0]:
        return table[:n].contiguous()
    pad = table[-1:].expand(n - table.shape[0], -1)
    return torch.cat([table, pad]).contiguous()


def _one_winner(rec, row=0):
    """The records with every hit's winner replaced by table row ``row``."""
    hit = (rec & trep.F_HIT) > 0
    return torch.where(hit, (rec & 0xFF) | (row << 8), rec).contiguous()


def _check_pair(args, accum_from=0, what=""):
    """K4 bit for bit with its plain version; K3 within the scheme and the
    same bits twice; their launch counts."""
    before = (trk.LAUNCHES_FORWARD, trk.LAUNCHES_BACKWARD)
    rad = trk.replay_forward(*args, 0, accum_from=accum_from)
    assert torch.equal(rad, trk.replay_forward_reference(*args, 0, accum_from=accum_from)), what
    g_rad = torch.randn(rad.shape, device=rad.device,
                        generator=torch.Generator(device=rad.device).manual_seed(0))
    got = trk.replay_backward(*args, 0, g_rad, accum_from=accum_from)
    again = trk.replay_backward(*args, 0, g_rad, accum_from=accum_from)
    torch.cuda.synchronize()
    assert (trk.LAUNCHES_FORWARD, trk.LAUNCHES_BACKWARD) == (before[0] + 1, before[1] + 2)
    for a, b in zip(got, again):
        assert torch.equal(a, b), what
    want = trk.replay_backward_reference(*args, 0, g_rad, accum_from=accum_from)
    _assert_k3_scheme([g.cpu().numpy() for g in got], [g.cpu().numpy() for g in want])
    return rad, got


@pytest.mark.cuda
@pytest.mark.parametrize("r", [17, 1000, 8191])
def test_kernels_at_ragged_lane_counts(cuda, r):
    """Below a warp, and lane counts that are no multiple of 32, of K4's
    512-thread block or of K3's 256-lane tile."""
    table, o, d, valid, pix, smp, rec = _card_inputs(cuda, width=128, spp=1, depth=8)
    sub = slice(5, 5 + r)
    args = (table, o[sub].contiguous(), d[sub].contiguous(), valid[sub].contiguous(),
            pix[sub].contiguous(), smp[sub].contiguous(), rec[:, sub].contiguous())
    _check_pair(args, what=f"{r} lanes")


@pytest.mark.cuda
def test_kernels_with_every_lane_on_one_winner(cuda):
    """Every hit on table row 0 (the ground): each warp's lanes form one
    group, the merge's worst case."""
    table, o, d, valid, pix, smp, rec = _card_inputs(cuda, width=192, spp=2, depth=8)
    _check_pair((table, o, d, valid, pix, smp, _one_winner(rec)), what="one winner")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, trk.MAX_TABLE_ROWS])
def test_kernels_at_one_row_and_at_the_row_limit(cuda, n):
    """n = 1 (the partial in shared memory) and n = 2048 (in global
    memory): the records' winners moved into the table's range. Two
    256-thread blocks an SM hold book1's 488 rows with the partial beside
    them; 2048 rows leave no room for it."""
    table, o, d, valid, pix, smp, rec = _card_inputs(cuda, width=128, spp=2, depth=8)
    if n == 1:
        rec = _one_winner(rec)
    assert trk.launch_shape("backward", n, rec.shape[1])["shared_partial"] == (n == 1)
    _check_pair((_table_rows(table, n), o, d, valid, pix, smp, rec), what=f"{n} rows")


@pytest.mark.cuda
def test_launch_shapes_fill_the_card(cuda):
    """Resident grids from the occupancy query: K3 at least 16 warps an SM
    at book1's 488 rows with no spill; K4 at least 16."""
    for kind in ("backward", "legacy_backward"):
        s = trk.launch_shape(kind, 488, 8_294_400)
        assert s["blocks_per_sm"] * s["threads"] // 32 >= 16, s
        assert s["spill_bytes"] == 0 and s["shared_partial"]
        assert s["grid"] == s["blocks_per_sm"] * s["sms"]
    s = trk.launch_shape("forward", 488, 8_294_400)
    assert s["blocks_per_sm"] * s["threads"] // 32 >= 16 and s["threads"] == trk.FORWARD_BLOCK
    assert not trk.launch_shape("backward", 2048, 100)["shared_partial"]
    assert trk.launch_shape("backward", 488, 100)["grid"] == 1
    # 800 rows fit beside the table with the partial, but one such block an
    # SM where two hold the partial in global memory: placed by residency.
    s = trk.launch_shape("backward", 800, 8_294_400)
    assert not s["shared_partial"] and s["blocks_per_sm"] >= 2, s
    for kind in ("backward", "legacy_backward"):  # K4-legacy: K3's grid
        assert trk.launch_shape(kind, 800, 8_294_400)["grid"] == s["grid"]
