"""K10, the closest sphere hit: the port's plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) on the same inputs, the
winner-only autograd backward of ``ops/intersect.hit_spheres`` against
``jax.vjp`` of the JAX ``hit_spheres``, the wrapper's dispatch and checks,
and — on a GPU only — the CUDA kernel against its plain version."""

import functools

import numpy as np
import pytest
import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models.camera import generate_rays
from crucible_tpu_torch.ops import intersect as tinter
from crucible_tpu_torch.ops.kernels import build as tbuild
from crucible_tpu_torch.ops.kernels import sphere_hit as tsh
from tests.torch_threads import one_torch_thread  # noqa: F401

# The JAX side is imported inside the helpers that use it, so that the
# card-only tests at the end also run where JAX is not installed:
#   python -m pytest --noconftest -m cuda tests/test_torch_sphere_hit.py

R, N = 1024, 64


def _random(seed):
    """R rays from a box toward random points, N spheres of radius 0.2-1.5,
    about 10% of them inactive. numpy float32."""
    g = np.random.default_rng(seed)
    o = g.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = (g.uniform(-4, 4, (R, 3)) - o * 0.5).astype(np.float32)
    centers = g.uniform(-5, 5, (N, 3)).astype(np.float32)
    radii = g.uniform(0.2, 1.5, N).astype(np.float32)
    active = (g.random(N) > 0.1).astype(np.float32)
    return o, d, centers, radii, active


@functools.cache
def _book1():
    """book1's table and the primary rays of its 32-wide image (2 spp),
    padded with repeats to R rays. numpy float32."""
    sc = tdemo.book1_end_scene(width=32)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    pix = torch.arange(R) % (32 * 18)
    o, d, _ = generate_rays(cp, 32, 18, pix, pix // (32 * 18), 0)
    return (o.numpy(), d.numpy(), sd.sph_center.numpy(), sd.sph_radius.numpy(),
            sd.sph_active.numpy().astype(np.float32))


def _inputs(case):
    return _random(3) if case == "random" else _book1()


def _csr(centers, radii):
    c = centers
    return (c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - radii * radii).astype(np.float32)


def _jax_kernel(o, d, centers, radii, active):
    import jax.numpy as jnp
    from crucible_tpu.ops.pallas.sphere_hit import hit_spheres_pallas

    t, idx, hit = hit_spheres_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(centers),
        jnp.asarray(_csr(centers, radii)), jnp.asarray(active), interpret=True,
    )
    return np.asarray(t), np.asarray(idx), np.asarray(hit)


def _port(o, d, centers, radii, active):
    t, idx, hit = tsh.hit_spheres(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        o, d, centers, _csr(centers, radii), active)))
    return t.numpy(), idx.numpy(), hit.numpy()


@pytest.mark.parametrize("case", ["random", "book1"])
def test_reference_matches_jax_kernel(case):
    x = _inputs(case)
    (jt, ji, jh), (t, i, h) = _jax_kernel(*x), _port(*x)
    assert t.dtype == np.float32 and i.dtype == np.int32 and h.dtype == bool
    assert h.mean() > 0.2  # the rays do hit something
    # XLA contracts multiply-adds on the CPU where the port rounds each
    # operation (ROADMAP fault C6): a last-ulp root can flip a near tie, and
    # the expanded quadratic cancels (|c|^2 - 2 c.o + |o|^2; |c|^2 - r^2 of
    # book1's radius-1000 ground), so a few percent of the roots differ by
    # more than rtol 1e-5, up to ~8e-5 absolute (C6 measured hit points off
    # by ~1e-4 on book1): rtol 1e-5 plus atol 1e-4.
    same = (i == ji) & (h == jh)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(t[same & h], jt[same & h], rtol=1e-5, atol=1e-4)
    assert (t[~h] == tsh.BIG).all() and (i[~h] == 0).all()


def test_ties_go_to_the_lowest_row():
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (4, 1))
    centers = np.array([[0, 0, -5]] * 3, np.float32)
    radii = np.ones(3, np.float32)
    active = np.array([0.0, 1.0, 1.0], np.float32)
    t, i, h = _port(o, d, centers, radii, active)
    assert h.all() and (i == 1).all() and np.allclose(t, 4.0)


def _jax_vjp(o, d, centers, radii, active, t, idx, hit, t_bar):
    """The JAX ``hit_spheres``' custom VJP on the given primal: the same
    winners and distances as the port's, so that the two backward rules are
    compared on identical residuals."""
    import jax.numpy as jnp
    from crucible_tpu.ops import intersect as jinter

    res = tuple(jnp.asarray(x) for x in (o, d, centers, radii, active, t, idx, hit))
    cts = (jnp.asarray(t_bar), None, None)
    return [np.asarray(g) for g in jinter._closest_hit_bwd(0.0, False, res, cts)[:4]]


def _port_grads(o, d, centers, radii, active, t_bar):
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (o, d, centers, radii)]
    t, idx, hit = tinter.hit_spheres(*leaves, torch.from_numpy(active) > 0, 1e-3)
    assert not idx.requires_grad and not hit.requires_grad
    grads = torch.autograd.grad((t * torch.from_numpy(t_bar)).sum(), leaves)
    return (t.detach().numpy(), idx.numpy(), hit.numpy()), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", ["random", "book1"])
def test_backward_matches_jax_vjp(case):
    x = _inputs(case)
    t_bar = np.random.default_rng(4).standard_normal(R).astype(np.float32)
    primal, got = _port_grads(*x, t_bar)
    assert primal[2].mean() > 0.2
    want = _jax_vjp(*x, *primal, t_bar)
    for name, a, b in zip(("go", "gd", "gc", "gr"), got, want):
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-5, err_msg=name)


def test_miss_lanes_give_zero_finite_cotangents():
    """t = BIG on a miss: masking it before the products keeps 0 * inf out."""
    o = np.zeros((8, 3), np.float32)
    d = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (8, 1))
    centers = np.array([[0, 0, -5], [3, 0, 0]], np.float32)
    radii = np.ones(2, np.float32)
    (t, _, _), grads = _port_grads(o, d, centers, radii, np.ones(2, np.float32),
                                   np.ones(8, np.float32))
    assert (t == tsh.BIG).all()
    for gr in grads:
        assert np.isfinite(gr).all() and (gr == 0).all()


def test_cotangents_only_where_asked():
    o, d, centers, radii, active = _random(5)
    leaves = [torch.from_numpy(o).requires_grad_(True), torch.from_numpy(d),
              torch.from_numpy(centers), torch.from_numpy(radii).requires_grad_(True)]
    t, _, _ = tinter.hit_spheres(*leaves, torch.from_numpy(active), 1e-3)
    go, gr = torch.autograd.grad(t.clamp_max(1e3).sum(), [leaves[0], leaves[3]])
    assert go.abs().sum() > 0 and gr.abs().sum() > 0


def test_per_ray_tables_raise():
    """Per-ray tables (exact-time motion: (R, N, 3) centers, (R, N) radii,
    once refused) take the plain per-ray search: winners and distances as
    the JAX ``hit_spheres``' per-ray branch gives them, and its custom VJP
    on the same residuals (table cotangents at (ray, winner))."""
    import jax.numpy as jnp
    from crucible_tpu.ops import intersect as jinter

    o, d, centers, radii, active = _random(6)
    g = np.random.default_rng(8)
    r = 512
    o, d = o[:r], d[:r]
    c_rt = (centers[None] + g.normal(0, 0.05, (r, N, 3))).astype(np.float32)
    r_rt = (radii[None] * g.uniform(0.9, 1.1, (r, N))).astype(np.float32)
    want = [np.asarray(x) for x in jinter.hit_spheres(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(c_rt), jnp.asarray(r_rt),
        jnp.asarray(active > 0), 1e-3, jnp.inf)]
    t_bar = g.normal(size=r).astype(np.float32)
    (t, idx, hit), grads = _port_grads(o, d, c_rt, r_rt, active, t_bar)
    assert (hit == want[2]).mean() > 0.99 and hit.any() and not hit.all()
    both = hit & want[2]
    assert (idx[both] == want[1][both]).mean() > 0.99
    np.testing.assert_allclose(t[both], want[0][both], rtol=1e-5)
    jg = _jax_vjp(o, d, c_rt, r_rt, active, t, idx, hit, t_bar)
    for a, b in zip(grads, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # Shared radii (N,) beside per-ray centers broadcast.
    shared = tinter.hit_spheres(*(torch.from_numpy(x) for x in (o, d, c_rt, radii)),
                                torch.from_numpy(active), 1e-3)
    assert shared[2].any()


def test_sphere_uv_matches_jax():
    import jax.numpy as jnp
    from crucible_tpu.ops import intersect as jinter

    n = np.random.default_rng(7).normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:3] = [[0, 1, 0], [0, -1, 0], [1, 0, 0]]
    want = jinter.sphere_uv(jnp.asarray(n))
    got = tinter.sphere_uv(torch.from_numpy(n))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_reference(monkeypatch):
    def no_launch(*args):
        raise AssertionError("CPU tensors must not reach the kernel launch")

    monkeypatch.setattr(tsh, "_launch", no_launch)
    before = tsh.LAUNCHES
    o, d, centers, radii, active = _random(8)
    t, i, h = _port(o, d, centers, radii, active)
    ref = tsh.hit_spheres_reference(*(torch.from_numpy(x) for x in (
        o, d, centers, _csr(centers, radii), active)))
    np.testing.assert_array_equal(t, ref[0].numpy())
    np.testing.assert_array_equal(i, ref[1].numpy())
    assert tsh.LAUNCHES == before


@pytest.mark.parametrize(
    "name,change,error",
    [
        ("o", lambda t: t.double(), TypeError),
        ("d", lambda t: t[:-1].contiguous(), ValueError),
        ("centers", lambda t: t.t().contiguous().t(), ValueError),
        ("csr", lambda t: t[:, None].contiguous(), ValueError),
        ("active", lambda t: t > 0, TypeError),
    ],
    ids=["dtype", "rays", "contiguity", "csr_shape", "active_dtype"],
)
def test_validates_inputs(name, change, error):
    o, d, centers, radii, active = _random(9)
    args = dict(o=o, d=d, centers=centers, csr=_csr(centers, radii), active=active)
    args = {k: torch.from_numpy(v) for k, v in args.items()}
    args[name] = change(args[name])
    with pytest.raises(error):
        tsh.hit_spheres(**args)


def test_build_declares_the_entry_point():
    # o, d, centers, csr, active; n, r, t_min, grid; t, idx, stream
    argtypes, _ = tbuild.SIGNATURES["sphere_hit"]["crucible_sphere_hit"]
    assert len(argtypes) == 12


# --- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernel has no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_sphere_hit.py)"
        )
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "book1"])
def test_kernel_matches_reference_on_card(cuda, case):
    o, d, centers, radii, active = _inputs(case)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in (o, d, centers, _csr(centers, radii), active)]
    before = tsh.LAUNCHES
    t, i, h = tsh.hit_spheres(*args)
    torch.cuda.synchronize()
    assert tsh.LAUNCHES == before + 1
    rt, ri, rh = tsh.hit_spheres_reference(*args)
    assert torch.equal(t, rt) and torch.equal(i, ri) and torch.equal(h, rh)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_reference(cuda, monkeypatch):
    def no_reference(*args, **kwargs):
        raise AssertionError("CUDA tensors must not reach the plain version")

    monkeypatch.setattr(tsh, "hit_spheres_reference", no_reference)
    o, d, centers, radii, active = (torch.from_numpy(x).to(cuda) for x in _random(10))
    t, _, _ = tinter.hit_spheres(o, d, centers, radii, active, 1e-3)
    torch.cuda.synchronize()
    assert t.is_cuda and torch.isfinite(t).all()


@pytest.mark.cuda
def test_ad_step_on_card_matches_cpu(cuda):
    """method='ad' (K10 under the checkpointed bounce loop) on the card and
    on the CPU: the same loss and radiometric gradients."""
    sc = tdemo.book1_end_scene(width=32)
    kw = dict(width=32, height=18, spp=2, max_depth=4, method="ad")
    out = []
    before = tsh.LAUNCHES
    for where in (cuda, torch.device("cpu")):
        sd, cp = sc.build(device=where), sc.scene_cam.params(device=where)
        out.append(G.loss_and_grad(G.extract_params(sd, cp), sd, cp,
                                   torch.zeros((576, 3), device=where),
                                   torch.arange(576, device=where), 0, **kw))
    assert tsh.LAUNCHES - before == 2 * 4  # each bounce, and its recompute
    (lc, gc), (lp, gp) = out
    assert lc.item() == pytest.approx(lp.item(), rel=1e-4)
    for key in ("tex_color", "mat_emission"):
        a, b = gc[key].cpu().numpy(), gp[key].numpy()
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-3, err_msg=key)
