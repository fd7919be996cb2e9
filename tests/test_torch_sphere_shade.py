"""K9, the fused closest hit + winner-attribute fetch: the port's plain
version against the JAX package's Pallas kernel (interpret mode on the CPU)
on the same rays and tables — book1's (at w = 0 and at random w), garden's,
and one with moving rows — the static arithmetic against the moving one on
signed-zero motion columns, the cached launch shape, the wrapper's dispatch
and checks, and — on a GPU only — the CUDA kernel against its plain version
bit for bit on all 28 rows: past one staged chunk, inactive rows among
active ones and none active, duplicated spheres, ray counts around the
kernel's forms and its grid, static tables at w = 0 and w != 0, signed-zero
motion columns, static and moving rows mixed."""

import functools

import numpy as np
import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models.camera import generate_rays
from crucible_tpu_torch.ops.kernels import build as tbuild
from crucible_tpu_torch.ops.kernels import sphere_hit as tsh
from crucible_tpu_torch.ops.kernels import sphere_shade as tss
from tests.torch_threads import one_torch_thread  # noqa: F401

# The JAX side is imported inside the helpers that use it, so that the
# card-only tests at the end also run where JAX is not installed:
#   python -m pytest --noconftest -m cuda tests/test_torch_sphere_shade.py

R = 1024
CASES = ["book1", "book1_w", "garden", "moving"]


@functools.cache
def _scene_inputs(name):
    """(o, d, table) of a demo scene 32 wide: the primary rays of 2 spp,
    repeated to R rays, and the scene's (N, 32) table. numpy float32."""
    sc = getattr(tdemo, name)(width=32)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    pix = torch.arange(R) % (w * h)
    o, d, _ = generate_rays(cp, w, h, pix, pix // (w * h), 0)
    return o.numpy(), d.numpy(), tint.make_sphere_table(sd).numpy()


def _inputs(case):
    """(o, d, w, table) numpy float32. 'book1_w' gives book1's static rows
    random shutter fractions; 'moving' gives its rows random center and
    radius deltas (with their s1, s2 columns) and each ray a random shutter
    fraction."""
    if case == "garden":
        o, d, table = _scene_inputs("garden_skybox")
        return o, d, np.zeros(R, np.float32), table
    o, d, table = _scene_inputs("book1_end_scene")
    if case == "book1":
        return o, d, np.zeros(R, np.float32), table
    g = np.random.default_rng(11)
    if case == "book1_w":
        return o, d, g.random(R).astype(np.float32), table
    table = table.copy()
    n = table.shape[0]
    cd = g.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    rd = g.uniform(-0.05, 0.05, n).astype(np.float32)
    c, r = table[:, 0:3], table[:, 3]
    table[:, 24:27], table[:, 27] = cd, rd
    table[:, 28] = (c * cd).sum(1) - r * rd
    table[:, 29] = (cd * cd).sum(1) - rd * rd
    return o, d, g.random(R).astype(np.float32), table


def _jax(o, d, w, table):
    import jax.numpy as jnp
    from crucible_tpu.ops.pallas.sphere_shade import hit_spheres_fetch

    out = hit_spheres_fetch(*(jnp.asarray(x) for x in (o, d, w, table)), interpret=True)
    return np.asarray(out)


def _port(o, d, w, table):
    return tss.hit_spheres_fetch(*(torch.from_numpy(np.ascontiguousarray(x))
                                   for x in (o, d, w, table))).numpy()


@pytest.mark.parametrize("case", CASES)
def test_reference_matches_jax_kernel(case):
    x = _inputs(case)
    want, got = _jax(*x), _port(*x)
    assert got.shape == (tss.C_OUT, R) and got.dtype == np.float32
    t, jt = got[0], want[0]
    hit, jhit = t < tss.BIG, jt < tss.BIG
    assert hit.mean() > 0.05  # garden's ball covers a tenth of the rays
    # Winners agree but for last-ulp near ties (ROADMAP fault C6: XLA
    # contracts multiply-adds on the CPU where the port rounds each op).
    same = (got[1] == want[1]) & (hit == jhit)
    assert same.mean() >= 0.999, same.mean()
    # The fetched attributes are the winner's row exactly.
    np.testing.assert_array_equal(got[2:28, same], want[2:28, same])
    # Distances: the bound of tests/test_torch_sphere_hit.py (the expanded
    # quadratic cancels).
    np.testing.assert_allclose(t[same & hit], jt[same & hit], rtol=1e-5, atol=1e-4)
    # The JAX kernel's (32, R) output never writes its rows 28-31; the port
    # returns rows 0-27 only.
    assert want.shape == (32, R) and tss.C_OUT == 28


def test_a_miss_fetches_nothing():
    o, d, w, table = _inputs("book1")
    d = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (R, 1))  # straight up
    o = np.tile(np.array([[0.0, 5.0, 0.0]], np.float32), (R, 1))
    out = _port(o, d, w, table)
    assert (out[0] == tss.BIG).all() and (out[1:] == 0).all()


def test_rows_match_the_table():
    o, d, w, table = _inputs("book1")
    out = _port(o, d, w, table)
    hit = out[0] < tss.BIG
    rows = table[out[1, hit].astype(np.int64)]
    np.testing.assert_array_equal(out[2:6, hit], rows[:, 0:4].T)
    np.testing.assert_array_equal(out[6:28, hit], rows[:, 6:28].T)


def test_cpu_tensors_take_the_reference(monkeypatch):
    def no_launch(*args):
        raise AssertionError("CPU tensors must not reach the kernel launch")

    monkeypatch.setattr(tss, "_launch", no_launch)
    before = tss.LAUNCHES
    x = _inputs("moving")
    got = _port(*x)
    ref = tss.hit_spheres_fetch_reference(*(torch.from_numpy(a) for a in x)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert tss.LAUNCHES == before


@pytest.mark.parametrize(
    "name,change,error",
    [
        ("o", lambda t: t.double(), TypeError),
        ("w", lambda t: t[:-1].contiguous(), ValueError),
        ("table", lambda t: t[:, :16].contiguous(), ValueError),
        ("d", lambda t: t.t().contiguous().t(), ValueError),
    ],
    ids=["dtype", "w_shape", "columns", "contiguity"],
)
def test_validates_inputs(name, change, error):
    args = dict(zip(("o", "d", "w", "table"), (torch.from_numpy(a) for a in _inputs("book1"))))
    args[name] = change(args[name])
    with pytest.raises(error):
        tss.hit_spheres_fetch(**args)


STAGE = tsh.STAGE_ROWS
# Synthetic tables (see _synthetic): past one staged chunk (static and
# moving), inactive rows among active ones, none active, duplicated
# spheres, static at w = 0 and w != 0, signed-zero motion columns, static
# and moving rows mixed, and 8 rows (one ray a thread, ONE_RAY_ENTRIES).
TABLES = ["chunks", "chunks_moving", "interleaved", "none_active", "duplicates",
          "static_w0", "static_w", "signed_zero", "mixed", "tiny"]


def _synthetic(case, r, seed=1):
    """(o, d, w, table) numpy float32 for a case of TABLES: r rays from a box
    toward random points among N spheres of radius 0.2-1.5 with random
    shading columns, the (N, 32) table in ``make_sphere_table``'s layout
    (s0 = |c|^2 - r^2, s1 = c.cd - r rd, s2 = |cd|^2 - rd^2 in float32). A
    few rays start at the origin, and one sphere sits at it, so that terms
    of the quadratic are zero there."""
    g = np.random.default_rng(seed)
    n = {"chunks": 2 * STAGE + 37, "chunks_moving": STAGE + 5, "none_active": 40,
         "tiny": 8}.get(case, 96)
    f32 = np.float32
    c = g.uniform(-5, 5, (n, 3)).astype(f32)
    c[0] = 0.0
    rad = g.uniform(0.2, 1.5, n).astype(f32)
    table = np.zeros((n, 32), f32)
    table[:, 0:3], table[:, 3] = c, rad
    table[:, 5] = (g.random(n) > 0.1).astype(f32)
    table[:, 6:24] = g.uniform(-1, 1, (n, 18)).astype(f32)
    table[:, 30] = g.integers(0, 3, n).astype(f32)
    table[:, 31] = np.arange(n, dtype=f32)
    if case == "interleaved":
        table[:, 5] = (np.arange(n) % 3 != 1).astype(f32)
    if case == "none_active":
        table[:, 5] = 0.0
    if case == "duplicates":  # rows 48-95 repeat rows 0-47
        table[48:, 0:5] = table[:48, 0:5]
        table[:, 5] = 1.0
    moving = {"chunks_moving": np.ones(n, bool), "mixed": g.random(n) < 0.5}.get(case)
    if moving is not None:
        cd = np.where(moving[:, None], g.uniform(-0.3, 0.3, (n, 3)), 0.0).astype(f32)
        rd = np.where(moving, g.uniform(-0.05, 0.05, n), 0.0).astype(f32)
        table[:, 24:27], table[:, 27] = cd, rd
    if case == "signed_zero":
        sign = np.where(g.random((n, 6)) < 0.5, f32(-1), f32(1))
        table[:, 24:30] = sign * f32(0.0)
    x, y, z, rad = table[:, 0], table[:, 1], table[:, 2], table[:, 3]
    table[:, 4] = x * x + y * y + z * z - rad * rad
    if case != "signed_zero":
        cdx, cdy, cdz, rd = table[:, 24], table[:, 25], table[:, 26], table[:, 27]
        table[:, 28] = x * cdx + y * cdy + z * cdz - rad * rd
        table[:, 29] = cdx * cdx + cdy * cdy + cdz * cdz - rd * rd
    o = g.uniform(-6, 6, (r, 3)).astype(f32)
    o[: max(1, r // 50)] = 0.0
    d = (g.uniform(-4, 4, (r, 3)) - o * 0.5).astype(f32)
    w = np.zeros(r, f32) if case == "static_w0" else g.random(r).astype(f32)
    return o, d, w, table


@pytest.mark.parametrize("case", ["static_w", "signed_zero", "duplicates", "interleaved"])
def test_static_arithmetic_keeps_the_moving_bits(case):
    """Where every motion column is +-0 (the block's static choice), K10's
    static search (``sphere_hit.hit_spheres_reference``: no motion terms)
    gives the moving search's t and winner bit for bit at any finite w,
    signed zeros included, so the 28 fetched rows agree too."""
    o, d, w, table = (torch.from_numpy(x) for x in _synthetic(case, 4096, seed=5))
    t, idx = tss.moving_closest_reference(o, d, w, table)
    st, sidx, _ = tsh.hit_spheres_reference(o, d, table[:, 0:3].contiguous(),
                                            table[:, 4].contiguous(), table[:, 5].contiguous())
    assert (t < tss.BIG).float().mean() > 0.1
    assert torch.equal(t.view(torch.int32), st.view(torch.int32))
    assert torch.equal(idx.to(torch.int32), sidx)
    if case == "duplicates":  # every tie goes to the lower copy
        assert bool((idx[t < tss.BIG] < 48).all())


@pytest.mark.parametrize(
    "n,entries", [(1, 4), (8, 8), (16, 16), (17, 20), (33, 36), (488, 488), (STAGE, STAGE),
                  (STAGE + 1, STAGE), (7744, STAGE)])
def test_launch_shape_is_cached_by_staged_entries(monkeypatch, n, entries):
    """K9's shape is queried per (staged entries, card), as K10's: a table's
    first chunk padded to 4, 40 bytes of shared memory an entry. The grid is
    the resident blocks, or fewer where the rays need fewer at one ray a
    thread; up to ONE_RAY_ENTRIES entries it is one ray a thread."""
    calls = []

    def fake_shape(*key):
        calls.append(key)
        return (4, 132, 128, 120, 0, 40 * key[0], STAGE, 4)

    monkeypatch.setattr(tss, "_shape", fake_shape)
    assert tss.staged_entries(n) == entries
    big = tss.launch_shape(n, 2_073_600, device="cuda:1")
    small = tss.launch_shape(n, 1000, device="cuda:1")
    assert calls == [(entries, 1), (entries, 1)]
    assert small["grid"] == 8
    assert big["chunks"] == -(-n // STAGE) and big["smem_bytes"] == 40 * entries
    assert big["registers"] == 120
    if entries <= tss.ONE_RAY_ENTRIES:
        assert big["grid"] == 2_073_600 // 128 and big["rays_per_thread"] == 1
    else:
        assert big["grid"] == 4 * 132 and big["rays_per_thread"] == 4


def test_launch_shape_rejects_another_stage_size(monkeypatch):
    monkeypatch.setattr(tss, "_shape", lambda *key: (4, 132, 128, 120, 0, 80, STAGE // 2, 4))
    with pytest.raises(RuntimeError, match="sphere_shade.cu stages"):
        tss.launch_shape(10, 100, device="cuda:0")


def test_build_declares_the_entry_points():
    # o, d, w, table; n, r, t_min, grid; out, stream
    argtypes, _ = tbuild.SIGNATURES["sphere_shade"]["crucible_sphere_shade"]
    assert len(argtypes) == 10
    argtypes, _ = tbuild.SIGNATURES["sphere_shade"]["crucible_sphere_shade_shape"]
    assert len(argtypes) == 2  # n, shape[8]


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernel has no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_sphere_shade.py)"
        )
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_reference_on_card(cuda, case):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in _inputs(case)]
    before = tss.LAUNCHES
    out = tss.hit_spheres_fetch(*args)
    torch.cuda.synchronize()
    assert tss.LAUNCHES == before + 1
    assert torch.equal(out, tss.hit_spheres_fetch_reference(*args))


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_reference(cuda, monkeypatch):
    def no_reference(*args, **kwargs):
        raise AssertionError("CUDA tensors must not reach the plain version")

    monkeypatch.setattr(tss, "hit_spheres_fetch_reference", no_reference)
    out = tss.hit_spheres_fetch(*(torch.from_numpy(a).to(cuda) for a in _inputs("garden")))
    torch.cuda.synchronize()
    assert out.is_cuda and torch.isfinite(out).all()


@pytest.mark.cuda
def test_pixel_schedule_on_card_matches_cpu(cuda):
    """Garden through render_image's auto schedule (pixel, with K9) on the
    card and on the CPU: the cross-path bounds."""
    sc = tdemo.garden_skybox(width=64)
    before = tss.LAUNCHES
    card = trender.render_image(sc, samples=4, max_depth=8, device=cuda)
    assert tss.LAUNCHES > before
    cpu = trender.render_image(sc, samples=4, max_depth=8, device="cpu")
    close = torch.isclose(card.cpu(), cpu, rtol=1e-3, atol=1e-3).float().mean().item()
    assert close > 0.99 and abs(card.mean().item() - cpu.mean().item()) <= 2e-3


def _bits(x):
    return x.contiguous().view(torch.int32)


def _held_on_card(args, what):
    """Launch K9 on ``args`` (card tensors) and hold all 28 rows against the
    plain version bit for bit; one launch counted."""
    before = tss.LAUNCHES
    out = tss.hit_spheres_fetch(*args)
    torch.cuda.synchronize()
    assert tss.LAUNCHES == before + 1, what
    ref = tss.hit_spheres_fetch_reference(*args)
    assert out.shape == (tss.C_OUT, args[0].shape[0])
    assert torch.equal(_bits(out), _bits(ref)), what
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", TABLES)
def test_kernel_matches_reference_on_synthetic_tables(cuda, case):
    """Each synthetic table at 20,011 rays (several rays a thread, an uneven
    tail): past one chunk, inactive rows, none active (every ray a miss),
    ties to the lowest row, static at w = 0 and w != 0, signed-zero motion
    columns, mixed rows."""
    args = [torch.from_numpy(x).to(cuda) for x in _synthetic(case, 20_011)]
    out = _held_on_card(args, case)
    hit = out[0] < tss.BIG
    if case == "none_active":
        assert not bool(hit.any()) and not bool(out[1:].any())
    else:
        assert hit.float().mean().item() > 0.1
    if case == "duplicates":
        assert bool((out[1, hit] < 48).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["static_w", "mixed", "tiny"])
def test_kernel_matches_reference_at_ray_counts(cuda, case):
    """1, 2, 3 and 5 rays (the 1-, 2- and 4-ray forms), and the grid's
    threads x 4 +- 1 (every thread four rays, one thread a fifth, or one
    short of four); 'tiny' (one ray a thread) at a block's 128 threads +- 1
    and 300,001."""
    table = _synthetic(case, 1)[3]
    if case == "tiny":
        counts = (1, 2, 3, 5, 127, 128, 129, 300_001)
    else:
        grid = tss.launch_shape(table.shape[0], 1 << 30)
        g4 = 4 * grid["grid"] * grid["threads"]
        counts = (1, 2, 3, 5, g4 - 1, g4, g4 + 1)
    for r in counts:
        args = [torch.from_numpy(x).to(cuda) for x in _synthetic(case, r, seed=r)]
        _held_on_card(args, f"{case} at {r} rays")


@pytest.mark.cuda
def test_launch_shape_on_card(cuda):
    for n in (8, 488, STAGE + 1):
        s = tss.launch_shape(n, 2_073_600)
        resident = s["blocks_per_sm"] * s["sms"]
        assert s["blocks_per_sm"] >= 1
        assert s["grid"] == (2_073_600 // 128 if n == 8 else resident)
        assert s["smem_bytes"] == 40 * tss.staged_entries(n) and s["spill_bytes"] == 0


@pytest.mark.cuda
def test_misaligned_table_raises(cuda):
    """The kernel reads table rows as 16-byte loads: a table that starts off
    a 16-byte boundary is refused, not read."""
    o, d, w, table = (torch.from_numpy(x).to(cuda) for x in _synthetic("static_w", 64))
    flat = torch.zeros(table.numel() + 1, device=cuda)
    shifted = flat[1:].view(table.shape)
    shifted.copy_(table)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        tss.hit_spheres_fetch(o, d, w, shifted)
