"""K10 at the bounds of its staging: tables of 1, 31, 32 and 33 rows (the
kernel's entries go four at a time), around ``STAGE_ROWS`` (the rows a block
stages at a time; a larger table goes through chunks), with every row
inactive, and with duplicated rows, where the lowest row must win. On the
CPU the plain version is held against the JAX package's Pallas kernel in
interpret mode; on a GPU only, the CUDA kernel against the plain version
bit for bit, at ray counts below one block, uneven, and of several rays a
thread:

    python -m pytest --noconftest -m cuda tests/test_torch_sphere_hit_tiles.py
"""

import numpy as np
import pytest
import torch

from crucible_tpu_torch.ops.kernels import build as tbuild
from crucible_tpu_torch.ops.kernels import sphere_hit as tsh
from tests.torch_threads import one_torch_thread  # noqa: F401

CAP = tsh.STAGE_ROWS
TABLES = ["n1", "n31", "n32", "n33", f"n{CAP - 1}", f"n{CAP}", f"n{CAP + 1}",
          "inactive", "duplicates"]


def _table(case, seed=1):
    """(centers, radii, active) numpy float32 for a case of TABLES."""
    g = np.random.default_rng(seed)
    n = {"inactive": 40, "duplicates": 64}.get(case) or int(case[1:])
    centers = g.uniform(-5, 5, (n, 3)).astype(np.float32)
    radii = g.uniform(0.2, 1.5, n).astype(np.float32)
    active = (g.random(n) > 0.1).astype(np.float32)
    if case == "inactive":
        active[:] = 0.0
    if case == "duplicates":  # rows 32-63 repeat rows 0-31
        centers[32:], radii[32:], active[:] = centers[:32], radii[:32], 1.0
    return centers, radii, active


def _rays(r, seed=2):
    """r rays from a box toward random points among the spheres."""
    g = np.random.default_rng(seed)
    o = g.uniform(-6, 6, (r, 3)).astype(np.float32)
    d = (g.uniform(-4, 4, (r, 3)) - o * 0.5).astype(np.float32)
    return o, d


def _csr(centers, radii):
    c = centers
    return (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
            - radii * radii).astype(np.float32)


def _args(o, d, centers, radii, active, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (o, d, centers, _csr(centers, radii), active)]


def _jax_kernel(o, d, centers, radii, active):
    """The Pallas kernel in interpret mode, its table padded with inactive
    rows to a multiple of 8 and its rays to a multiple of TILE_RAYS, as the
    JAX package's scene builder and callers pad them."""
    import jax.numpy as jnp
    from crucible_tpu.ops.pallas.sphere_hit import TILE_RAYS, hit_spheres_pallas

    r, n = o.shape[0], centers.shape[0]
    pr, pn = -r % TILE_RAYS, -n % 8
    pad = lambda x, k: np.concatenate([x, np.zeros((k,) + x.shape[1:], x.dtype)])  # noqa: E731
    o_p, d_p = pad(o, pr), np.concatenate([d, np.ones((pr, 3), np.float32)])
    c_p, csr_p, a_p = pad(centers, pn), pad(_csr(centers, radii), pn), pad(active, pn)
    t, idx, hit = hit_spheres_pallas(*(jnp.asarray(x) for x in (o_p, d_p, c_p, csr_p, a_p)),
                                     interpret=True)
    return np.asarray(t)[:r], np.asarray(idx)[:r], np.asarray(hit)[:r]


@pytest.mark.parametrize("case", TABLES)
def test_reference_matches_jax_kernel_at_staging_bounds(case):
    centers, radii, active = _table(case)
    o, d = _rays(1024)
    jt, ji, jh = _jax_kernel(o, d, centers, radii, active)
    t, i, h = (x.numpy() for x in tsh.hit_spheres(*_args(o, d, centers, radii, active)))
    assert t.dtype == np.float32 and i.dtype == np.int32 and h.dtype == bool
    # The bound of test_torch_sphere_hit.py's test_reference_matches_jax_kernel:
    # XLA contracts multiply-adds on the CPU where the port rounds each
    # operation (ROADMAP fault C6), so a last-ulp root may flip a near tie.
    same = (i == ji) & (h == jh)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(t[same & h], jt[same & h], rtol=1e-5, atol=1e-4)
    assert (t[~h] == tsh.BIG).all() and (i[~h] == 0).all()
    if case == "inactive":
        assert not h.any() and not jh.any()
    elif centers.shape[0] >= 31:
        assert h.mean() > 0.05
    if case == "duplicates":  # a repeated row never beats its first copy
        assert h.mean() > 0.2 and (i[h] < 32).all() and (ji[jh] < 32).all()


@pytest.mark.parametrize(
    "n,entries", [(1, 4), (31, 32), (32, 32), (33, 36), (CAP - 1, CAP), (CAP, CAP),
                  (CAP + 1, CAP), (7744, CAP)])
def test_launch_shape_is_cached_by_staged_entries(monkeypatch, n, entries):
    """The shape is queried per (staged entries, card): a table's first
    chunk padded to 4. The grid is the resident blocks, or fewer where the
    rays need fewer at one ray a thread."""
    calls = []

    def fake_shape(*key):
        calls.append(key)
        return (5, 132, 128, 96, 0, 20 * key[0], CAP, 4)

    monkeypatch.setattr(tsh, "_shape", fake_shape)
    assert tsh.staged_entries(n) == entries
    big = tsh.launch_shape(n, 8_294_400, device="cuda:1")
    small = tsh.launch_shape(n, 1000, device="cuda:1")
    assert calls == [(entries, 1), (entries, 1)]
    assert big["grid"] == 5 * 132 and small["grid"] == 8
    assert big["chunks"] == -(-n // CAP) and big["smem_bytes"] == 20 * entries
    assert big["rays_per_thread"] == 4


def test_launch_shape_rejects_another_stage_size(monkeypatch):
    monkeypatch.setattr(tsh, "_shape", lambda *key: (5, 132, 128, 96, 0, 80, CAP // 2, 4))
    with pytest.raises(RuntimeError, match="stages"):
        tsh.launch_shape(10, 100, device="cuda:0")


def test_build_declares_the_shape_entry_point():
    argtypes, _ = tbuild.SIGNATURES["sphere_hit"]["crucible_sphere_hit_shape"]
    assert len(argtypes) == 2  # n, shape[8]


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernel has no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_sphere_hit_tiles.py)"
        )
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", TABLES + ["n4100"])
@pytest.mark.parametrize("r", [5, 1037, 400_003, 2_000_001])
def test_kernel_matches_reference_at_staging_bounds(cuda, case, r):
    """Bit for bit, at R below one block, R uneven, and R of several rays a
    thread on the resident grid (each thread's last rays in the 2- and 1-ray
    forms); n4100 takes three chunks."""
    args = _args(*_rays(r, seed=r), *_table(case), device=cuda)
    before = tsh.LAUNCHES
    t, i, h = tsh.hit_spheres(*args)
    torch.cuda.synchronize()
    assert tsh.LAUNCHES == before + 1
    rt, ri, rh = tsh.hit_spheres_reference(*args)
    assert torch.equal(t, rt) and torch.equal(i, ri) and torch.equal(h, rh)
    if case == "duplicates":
        assert bool((i[h] < 32).all())


@pytest.mark.cuda
def test_launch_shape_on_card(cuda):
    for n in (1, 488, CAP + 1):
        s = tsh.launch_shape(n, 8_294_400)
        assert s["blocks_per_sm"] >= 1 and s["grid"] == s["blocks_per_sm"] * s["sms"]
        assert s["smem_bytes"] == 20 * tsh.staged_entries(n) and s["spill_bytes"] == 0
