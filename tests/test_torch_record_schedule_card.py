"""The ``record`` schedule on the card: ``earth`` (a generated map in place of
``earthmap.jpg``) and ``nested_checkers`` through ``auto``, held against the
``pixel`` schedule; K2's words on earth against its plain version; the
replay's gather backward, the same bits on every run; and ``train_demo``'s
resume, bit for bit on the card. Every test here needs an
NVIDIA GPU and skips elsewhere; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_record_schedule_card.py
"""

import pytest
import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch import train_demo
from crucible_tpu_torch.io import assets as tassets
from crucible_tpu_torch.io.procedural import generate_earth_texture
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from crucible_tpu_torch.ops.kernels import sphere_hit as tsh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU mode (on the card: python -m "
            "pytest --noconftest -m cuda tests/test_torch_record_schedule_card.py)"
        )
    return torch.device("cuda")


@pytest.fixture
def earth(tmp_path, monkeypatch):
    """``width -> Scene``: the earth world over a generated 256x128
    ``earthmap.jpg`` in ``tmp_path``."""
    image = pytest.importorskip("PIL.Image")
    monkeypatch.setenv("ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(tassets, "ASSETS_DIR", tmp_path)
    image.fromarray(generate_earth_texture(128)).save(tmp_path / "earthmap.jpg")
    return lambda width: tdemo.earth(width=width)


def _world(name, earth):
    return earth if name == "earth" else (lambda width: tdemo.nested_checkers(width=width))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["earth", "nested_checkers"])
def test_record_schedule_matches_pixel_on_card(cuda, earth, name):
    sc = _world(name, earth)(96)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    assert trender.auto_schedule(sd, cp, cuda) == "record"
    tmk.zero_counts()
    tsh.LAUNCHES = 0
    rec = trender.render_image(sc, 8, 50, 0, device=cuda)
    assert tmk.RECORD_LAUNCHES["brute"] == 1 and tmk.FORWARD_LAUNCHES["brute"] == 0
    assert tsh.LAUNCHES == 0
    pixel = trender.render_image_persistent(sd, cp, w, h, 8, 50, 0, device=cuda,
                                            schedule="pixel")
    assert tsh.LAUNCHES > 0
    assert rec.shape == pixel.shape == (h, w, 3) and bool(torch.isfinite(rec).all())
    close = torch.isclose(rec, pixel, rtol=1e-3, atol=1e-3).float().mean().item()
    assert close > 0.99, close
    assert abs(rec.mean().item() - pixel.mean().item()) <= 2e-3


@pytest.mark.cuda
def test_k2_words_on_earth_match_plain_on_card(cuda, earth):
    sc = earth(96)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device=cuda), sc.scene_cam.params(device=cuda)
    p = w * h
    pix = torch.arange(p, device=cuda, dtype=torch.int32).repeat(4)
    smp = torch.arange(4, device=cuda, dtype=torch.int32).repeat_interleave(p)
    inputs = dict(smem=torch.tensor([0, 0, w, 50, 0, 0, 0, 0], dtype=torch.int32, device=cuda),
                  pix=pix[None], sample0=smp[None], cam=tint.mega_cam_vector(cp, w, h),
                  table=tint.make_sphere_table(sd).contiguous())
    _, rec = tmk.run_megakernel_record(**inputs, max_depth=50)
    _, ref = tmk.run_megakernel_record_reference(**inputs, max_depth=50)
    assert torch.equal(rec, ref)
    assert int(((rec & 2) > 0).sum()) > 0  # hits recorded


@pytest.mark.cuda
def test_gather_backward_repeats_its_bits_on_card(cuda):
    """ops.gather's backward on the card: a million lookups into a few rows
    and into many, the same bits on every run, index_add's sums within
    float rounding."""
    from crucible_tpu_torch.ops import gather

    gen = torch.Generator(device=cuda).manual_seed(0)
    for n in (3, 65536):
        ids = torch.randint(0, n, (1 << 20,), device=cuda, generator=gen)
        g = torch.rand((1 << 20, 3), device=cuda, generator=gen)
        src = torch.zeros((n, 3), device=cuda, requires_grad=True)
        grads = [torch.autograd.grad((gather.rows(src, ids) * g).sum(), src)[0]
                 for _ in range(3)]
        assert all(torch.equal(grads[0], x) for x in grads[1:])
        want = torch.zeros((n, 3), device=cuda).index_add_(0, ids, g)
        torch.testing.assert_close(grads[0], want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_train_demo_resumes_bit_for_bit_on_card(cuda, earth, tmp_path):
    kw = dict(scene=earth, width=64, steps=3, spp=2, depth=4, target_spp=4, rerecord=2,
              verbose=False, device=cuda)
    p_full, l_full = train_demo.run(out_dir=tmp_path / "full", **kw)
    train_demo.run(out_dir=tmp_path / "cut", **dict(kw, steps=2))
    p_res, l_res = train_demo.run(out_dir=tmp_path / "cut", **kw)
    assert [r["loss"] for r in l_res] == [r["loss"] for r in l_full]
    assert l_full[-1]["loss"] < l_full[0]["loss"]
    for k, v in G.leaves(p_full).items():
        assert torch.equal(v, G.leaves(p_res)[k]), k
    assert not torch.are_deterministic_algorithms_enabled()
