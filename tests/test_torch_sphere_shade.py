"""K9, the fused closest hit + winner-attribute fetch: the port's plain
version against the JAX package's Pallas kernel (interpret mode on the CPU)
on the same rays and tables — book1's, garden's, and one with moving rows —
the wrapper's dispatch and checks, and — on a GPU only — the CUDA kernel
against its plain version."""

import functools

import numpy as np
import pytest
import torch

from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models.camera import generate_rays
from crucible_tpu_torch.ops.kernels import sphere_shade as tss
from tests.torch_threads import one_torch_thread  # noqa: F401

# The JAX side is imported inside the helpers that use it, so that the
# card-only tests at the end also run where JAX is not installed:
#   python -m pytest --noconftest -m cuda tests/test_torch_sphere_shade.py

R = 1024
CASES = ["book1", "garden", "moving"]


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
    """(o, d, w, table) numpy float32. 'moving' gives book1's rows random
    center and radius deltas (with their s1, s2 columns) and each ray a
    random shutter fraction."""
    if case == "garden":
        o, d, table = _scene_inputs("garden_skybox")
        return o, d, np.zeros(R, np.float32), table
    o, d, table = _scene_inputs("book1_end_scene")
    if case == "book1":
        return o, d, np.zeros(R, np.float32), table
    g = np.random.default_rng(11)
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
