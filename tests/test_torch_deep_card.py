"""K4-legacy and the depth-50 gradient path on the card: the channel-major
replay pair against its plain version and against K4 / K3, and the deep
chunk (two-level record, depth buckets) against the unsplit replay on the
same lanes. Every test here needs an NVIDIA GPU and skips elsewhere; the
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_deep_card.py
"""

import pytest
import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models.camera import generate_rays
from crucible_tpu_torch.ops.kernels import replay_kernel as trk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: "
            "python -m pytest --noconftest -m cuda tests/test_torch_deep_card.py)"
        )
    return torch.device("cuda")


def _k3_scheme(got, want):
    """The JAX replay backward's scheme (tests/test_replay.py:1017-1029)."""
    for name, a, b in zip(("g_table", "g_o", "g_d"), got, want):
        assert bool(a.isfinite().all()), name
        scale = max(b.abs().max().item(), 1e-6)
        nd = (a - b).abs() / scale
        cap = 0.005 if name == "g_table" else 0.02
        assert (nd > 2e-4).float().mean().item() < cap, name
        assert nd.max().item() < 0.1, name


def _inputs(cuda, width=64, spp=4, depth=8):
    """book1 at ``width``: K4's inputs (rays (R, 3), ids (R,)) from K2's
    records, and the same in K4-legacy's layouts (rays (3, R), ids (1, R))."""
    sc = tdemo.book1_end_scene(width=width)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    p = w * h
    pix = torch.arange(p, device=cuda, dtype=torch.int32).repeat(spp)
    smp = torch.arange(spp, device=cuda, dtype=torch.int32).repeat_interleave(p)
    o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
    rec = trep.trace_record_mega(sd, cp, w, h, pix, smp, 0, depth)
    table = tint.make_sphere_table(sd).contiguous()
    valid = torch.ones_like(pix)
    blocked = (table, o.contiguous(), d.contiguous(), valid, pix, smp, rec, 0)
    r = pix.shape[0]
    legacy = (table, o.t().contiguous(), d.t().contiguous(), valid.reshape(1, r),
              pix.reshape(1, r), smp.reshape(1, r), rec, 0)
    return blocked, legacy


@pytest.mark.cuda
@pytest.mark.parametrize("accum_from", [0, 3])
def test_legacy_forward_matches_plain_and_k4(cuda, accum_from):
    blocked, legacy = _inputs(cuda)
    before = trk.LAUNCHES_LEGACY_FORWARD
    rad3 = trk.replay_legacy_forward(*legacy, accum_from=accum_from)
    torch.cuda.synchronize()
    assert trk.LAUNCHES_LEGACY_FORWARD == before + 1 and rad3.shape == (3, legacy[1].shape[1])
    assert torch.equal(rad3, trk.replay_legacy_forward_reference(*legacy, accum_from=accum_from))
    assert torch.equal(rad3, trk.replay_forward(*blocked, accum_from=accum_from).t())


@pytest.mark.cuda
def test_legacy_backward_matches_plain_and_k3(cuda):
    blocked, legacy = _inputs(cuda)
    r = blocked[1].shape[0]
    g_rad = torch.randn((r, 3), device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    g3 = g_rad.t().contiguous()
    before = trk.LAUNCHES_LEGACY_BACKWARD
    got = trk.replay_legacy_backward(*legacy, g3)
    again = trk.replay_legacy_backward(*legacy, g3)
    torch.cuda.synchronize()
    assert trk.LAUNCHES_LEGACY_BACKWARD == before + 2
    assert torch.equal(got[0], again[0])  # fixed-order table cotangent
    k3 = trk.replay_backward(*blocked, g_rad)
    # The same per-lane arithmetic and the same reduction as K3.
    assert torch.equal(got[0], k3[0])
    assert torch.equal(got[1], k3[1].t()) and torch.equal(got[2], k3[2].t())
    want = trk.replay_legacy_backward_reference(*legacy, g3)
    _k3_scheme([got[0], got[1].t(), got[2].t()], [want[0], want[1].t(), want[2].t()])


@pytest.mark.cuda
def test_blocked_false_launches_the_legacy_pair(cuda, monkeypatch):
    blocked, _ = _inputs(cuda, width=32, spp=1, depth=4)
    table, o, d, _, pix, smp, rec, seed = blocked
    table = table.clone().requires_grad_(True)
    counts = lambda: (trk.LAUNCHES_FORWARD, trk.LAUNCHES_BACKWARD,  # noqa: E731
                      trk.LAUNCHES_LEGACY_FORWARD, trk.LAUNCHES_LEGACY_BACKWARD)
    monkeypatch.setenv("CRUCIBLE_REPLAY_BLOCKED", "0")
    before = counts()
    rad = trk.trace_replay_mega(table, o, d, pix, smp, seed, rec)
    (g,) = torch.autograd.grad(rad.sum(), (table,))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 1, 1)
    monkeypatch.delenv("CRUCIBLE_REPLAY_BLOCKED")
    rad_b = trk.trace_replay_mega(table, o, d, pix, smp, seed, rec)
    (g_b,) = torch.autograd.grad(rad_b.sum(), (table,))
    assert torch.equal(rad, rad_b) and torch.equal(g, g_b)


def _chunk(cuda, depth, **kw):
    sc = tdemo.book1_end_scene(width=64)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    h = sc.scene_cam.image_height
    pix = torch.arange(64 * h, device=cuda)
    return G.loss_and_grad(G.extract_params(sd, cp), sd, cp,
                           torch.zeros((64 * h, 3), device=cuda), pix, 0,
                           width=64, height=h, spp=4, max_depth=depth, **kw)


@pytest.mark.cuda
def test_deep_chunk_matches_unsplit(cuda):
    """The default depth-50 chunk (two-level record, buckets; K3 on every
    bucket) against split=False on the same lanes: loss within rel 1e-5,
    radiometric gradients within normalized 1e-4."""
    trk.zero_counts()
    loss, grads = _chunk(cuda, 50)
    assert trk.LAUNCHES_BACKWARD >= 3 and trk.LAUNCHES_FORWARD == 0
    ref_loss, ref = _chunk(cuda, 50, grad_split=False)
    assert abs(loss.item() - ref_loss.item()) <= 1e-5 * ref_loss.item()
    for key in ("tex_color", "mat_emission"):
        scale = max(ref[key].abs().max().item(), 1e-6)
        assert ((grads[key] - ref[key]).abs().max() / scale).item() <= 1e-4, key


@pytest.mark.cuda
def test_deep_chunk_takes_the_legacy_layout(cuda, monkeypatch):
    loss, grads = _chunk(cuda, 50)
    monkeypatch.setenv("CRUCIBLE_REPLAY_BLOCKED", "0")
    trk.zero_counts()
    loss_l, grads_l = _chunk(cuda, 50)
    assert trk.LAUNCHES_LEGACY_BACKWARD >= 3 and trk.LAUNCHES_BACKWARD == 0
    assert torch.equal(loss_l, loss)
    # The legacy pair's lane cotangents are K3's bit for bit and come back
    # (R, 3) and contiguous, so every leaf, the camera's too, is the same.
    for key in G.TENSOR_KEYS:
        assert torch.equal(grads_l[key], grads[key]), key


def _deep_bucket(cuda, width=64, spp=4):
    """K4's inputs for the depth-50 chunk's last bucket at ``width``: the
    compacted slots of the lanes whose paths end past row 16, rays
    regenerated, throughput masked by the filled slots (``valid``), as
    ``replay.replay_bucketed_2l`` lays them out
    (``tools/torch_replay_ab.deep_buckets``); radiance from row 6 on."""
    from tools.torch_replay_ab import deep_buckets

    sc = tdemo.book1_end_scene(width=width)
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    pix, smp = G._lanes(torch.arange(w * h, device=cuda), spp, 0)
    _, args, head = deep_buckets(sd, cp, w, h, pix, smp)[-1]
    return args, head


@pytest.mark.cuda
def test_kernels_on_the_deep_bucket(cuda):
    """d50 with accum_from > 0 and a valid mask: K4 bit for bit with its
    plain version, K3 within the scheme and the same bits twice, and
    K4-legacy's pair equal to K4's and K3's."""
    args, head = _deep_bucket(cuda)
    valid = args[3]
    assert head > 0 and 0 < int(valid.sum()) < valid.shape[0]
    kw = dict(accum_from=head)
    rad = trk.replay_forward(*args, 0, **kw)
    assert torch.equal(rad, trk.replay_forward_reference(*args, 0, **kw))
    assert (rad[valid == 0] == 0).all()
    r = valid.shape[0]
    g_rad = torch.randn((r, 3), device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    got = trk.replay_backward(*args, 0, g_rad, **kw)
    again = trk.replay_backward(*args, 0, g_rad, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _k3_scheme(got, trk.replay_backward_reference(*args, 0, g_rad, **kw))
    table, o, d, _, pix, smp, rec = args
    legacy = (table, o.t().contiguous(), d.t().contiguous(), valid.reshape(1, r),
              pix.reshape(1, r), smp.reshape(1, r), rec, 0)
    assert torch.equal(trk.replay_legacy_forward(*legacy, **kw), rad.t())
    lg = trk.replay_legacy_backward(*legacy, g_rad.t().contiguous(), **kw)
    assert torch.equal(lg[0], got[0])
    assert torch.equal(lg[1], got[1].t()) and torch.equal(lg[2], got[2].t())
