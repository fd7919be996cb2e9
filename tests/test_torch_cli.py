"""The port's command line and the render options on the CPU:
``crucible_tpu_torch.cli`` through the cases of ``tests/test_cli.py`` and
against the JAX CLI (whose ``--cpu`` renders the lockstep tiles, the port's
the persistent schedules: within C6's bounds), ``Scene.render_scene``'s two
branches, the render modes (``auto`` is ``persistent``; the lockstep tiles
are not ported and raise), ``progress`` on the mega, pixel and record
schedules against one dispatch, and ``python -m crucible_tpu_torch.cli``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crucible_tpu import cli as jcli
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import render as jrender
from crucible_tpu_torch import cli
from crucible_tpu_torch.io.image import read_ppm
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import render as trender
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _u8_close(got, want, what):
    """C6's bounds on films: > 0.97 of u8 values within 1, means within
    2e-3 of full scale."""
    got, want = got.astype(np.int64), want.astype(np.int64)
    assert got.shape == want.shape, what
    near = (np.abs(got - want) <= 1).mean()
    dmean = abs(got.mean() - want.mean()) / 255.0
    assert near > 0.97 and dmean <= 2e-3, (what, near, dmean)


# --- the cases of tests/test_cli.py ----------------------------------------------


def test_image_render_default_ppm(tmp_path, capsys):
    out = tmp_path / "img"
    rc = cli.main(["--file", str(out), "--world", "6", "--spp", "2", "--width", "48", "--cpu"])
    assert rc == 0
    img = read_ppm(f"{out}.ppm")
    assert img.shape == (27, 48, 3)
    assert "render 2/2 spp" in capsys.readouterr().err  # verbose progress


def test_invalid_world_warns_and_defaults(tmp_path, capsys):
    out = tmp_path / "img"
    rc = cli.main(["--file", str(out), "--world", "99", "--spp", "1", "--width", "32",
                   "--depth", "8", "--cpu"])
    assert rc == 0
    assert "invalid" in capsys.readouterr().err
    assert read_ppm(f"{out}.ppm").shape == (18, 32, 3)  # book1, the default world


def test_invalid_movie_world_warns(tmp_path, capsys):
    out = tmp_path / "mv"
    rc = cli.main(["--file", str(out), "--movie", "--world", "7", "--seconds", "0.25",
                   "--rate", "4", "--spp", "1", "--depth", "2", "--width", "16", "--cpu"])
    assert rc == 0
    assert "using the default movie" in capsys.readouterr().err
    assert len(list((out / "artifacts").glob("image*.ppm"))) == 1


@pytest.mark.parametrize("argv", [[], ["--seconds", "1"], ["--rate", "24"]])
def test_movie_requires_seconds_and_rate(tmp_path, capsys, argv):
    rc = cli.main(["--file", str(tmp_path / "m"), "--movie", *argv])
    assert rc == 2
    assert "--seconds" in capsys.readouterr().err
    assert not (tmp_path / "m").exists()


def test_movie_renders_frames(tmp_path):
    out = tmp_path / "mv"
    rc = cli.main(["--file", str(out), "--movie", "--world", "1", "--seconds", "0.5",
                   "--rate", "4", "--spp", "2", "--depth", "2", "--width", "32", "--cpu"])
    assert rc == 0
    frames = sorted((out / "artifacts").glob("image*.ppm"))
    assert len(frames) == 2  # ceil(0.5 * 4)
    a, b = (read_ppm(f).astype(float) for f in frames)
    assert np.abs(a - b).mean() > 0.5  # the camera walk moved


def test_threads_flag_accepted(tmp_path):
    rc = cli.main(["--file", str(tmp_path / "x"), "--world", "6", "--spp", "1",
                   "--width", "16", "--threads", "8", "--cpu"])
    assert rc == 0
    assert (tmp_path / "x.ppm").is_file()


def test_the_card_is_the_default(monkeypatch, tmp_path):
    """Without --cpu the scene renders on 'cuda' (no fallback to the CPU)."""
    seen = []

    def render_scene(self, fname, *, device="cuda"):
        seen.append((fname, device))

    monkeypatch.setattr(tdemo.Scene, "render_scene", render_scene)
    assert cli.main(["--file", "a", "--world", "6"]) == 0
    assert cli.main(["--file", "b", "--world", "6", "--cpu"]) == 0
    assert seen == [("a", "cuda"), ("b", "cpu")]


def test_seed_spp_and_depth_reach_the_scene(monkeypatch):
    seen = []
    monkeypatch.setattr(tdemo.Scene, "render_scene",
                        lambda self, fname, *, device="cuda": seen.append(self))
    cli.main(["--file", "x", "--world", "6", "--seed", "5", "--spp", "3", "--depth", "4",
              "--width", "40"])
    sc = seen[0]
    assert (sc.seed, sc.scene_cam.samples, sc.scene_cam.max_depth) == (5, 3, 4)
    assert sc.scene_cam.image_width == 40


# --- against the JAX CLI ---------------------------------------------------------


def test_still_matches_the_jax_cli(tmp_path):
    args = ["--world", "6", "--spp", "2", "--width", "48", "--cpu"]
    assert jcli.main(["--file", str(tmp_path / "jax"), *args]) == 0
    assert cli.main(["--file", str(tmp_path / "port"), *args]) == 0
    _u8_close(read_ppm(tmp_path / "port.ppm"), read_ppm(tmp_path / "jax.ppm"), "smoke")


def test_movie_matches_the_jax_cli(tmp_path):
    args = ["--movie", "--world", "1", "--seconds", "0.5", "--rate", "4", "--spp", "2",
            "--depth", "2", "--width", "32", "--cpu"]
    assert jcli.main(["--file", str(tmp_path / "jax"), *args]) == 0
    assert cli.main(["--file", str(tmp_path / "port"), *args]) == 0
    want = sorted((tmp_path / "jax" / "artifacts").glob("image*.ppm"))
    got = sorted((tmp_path / "port" / "artifacts").glob("image*.ppm"))
    assert [p.name for p in got] == [p.name for p in want] == ["image000.ppm", "image001.ppm"]
    for g, w in zip(got, want):
        _u8_close(read_ppm(g), read_ppm(w), g.name)


def test_python_dash_m(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "crucible_tpu_torch.cli", "--file", str(tmp_path / "m"),
         "--world", "6", "--spp", "1", "--depth", "2", "--width", "16", "--cpu"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr
    assert read_ppm(tmp_path / "m.ppm").shape == (9, 16, 3)


def test_console_script_is_declared():
    text = (REPO / "pyproject.toml").read_text()
    assert 'crucible-tpu-torch = "crucible_tpu_torch.cli:main"' in text
    assert '"native/*.cpp"' in text


# --- Scene.render_scene -------------------------------------------------------------


def test_render_scene_still(tmp_path):
    sc = tdemo.smoke_scene(width=24)
    sc.scene_cam.set_samples(2)
    sc.scene_cam.set_max_depth(3)
    sc.render_scene(str(tmp_path / "still"), device="cpu")
    want = trender.to_u8(trender.render_image(sc, verbose=True, device="cpu"))
    assert np.array_equal(read_ppm(tmp_path / "still.ppm"), want)
    sc.render_scene(str(tmp_path / "named.png"), device="cpu")
    assert (tmp_path / "named.png").is_file()


def test_render_scene_movie(tmp_path):
    sc = tdemo.first_movie(frame_rate=4, duration=0.5)
    sc.scene_cam.image_width = 16
    sc.scene_cam.set_samples(1)
    sc.scene_cam.set_max_depth(2)
    out = sc.render_scene(str(tmp_path / "mv"), device="cpu")
    frames = sorted((tmp_path / "mv" / "artifacts").glob("image*.ppm"))
    assert len(frames) == 2 and Path(out) in (tmp_path / "mv" / "artifacts",
                                              tmp_path / "mv" / "mv.mp4")
    sc.scene_cam.frame = 1
    want = trender.to_u8(trender.render_image(sc, device="cpu"))
    assert np.array_equal(read_ppm(frames[1]), want)


# --- render modes ----------------------------------------------------------------------


def test_auto_mode_is_persistent():
    sc = tdemo.book1_end_scene(width=32)
    kw = dict(samples=4, max_depth=8, device="cpu")
    persistent = trender.render_image(sc, mode="persistent", **kw).numpy()
    assert np.array_equal(trender.render_image(sc, mode="auto", **kw).numpy(), persistent)
    assert np.array_equal(trender.render_image(sc, **kw).numpy(), persistent)


@pytest.mark.parametrize("kw,err,match", [
    (dict(mode="tiled"), NotImplementedError, "lockstep tiles"),
    (dict(rays_per_pass=200), NotImplementedError, "lockstep tiles"),
    (dict(mode="queue"), ValueError, "render mode"),
], ids=["tiled", "rays_per_pass", "unknown"])
def test_mode_raises(kw, err, match):
    """The tiles are not ported: asking for them raises, nothing is
    ignored."""
    sc = tdemo.smoke_scene(width=16)
    with pytest.raises(err, match=match):
        trender.render_image(sc, samples=1, device="cpu", **kw)


# --- progress -------------------------------------------------------------------------


@pytest.mark.parametrize("world,schedule", [("smoke_scene", "mega"), ("garden_skybox", "pixel"),
                                            ("nested_checkers", "record")])
def test_progress_chunks_match_one_dispatch(world, schedule):
    sc = getattr(tdemo, world)(width=24)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    if schedule != "record":
        assert trender.auto_schedule(sd, cp, "cpu") == schedule
    args = (sd, cp, w, h, 10, 4, 2)
    one = trender.render_image_persistent(*args, device="cpu", schedule=schedule)
    calls = []
    chunked = trender.render_image_persistent(
        *args, device="cpu", schedule=schedule,
        progress=lambda done, total, dt: calls.append((done, total, dt)))
    done = [c[0] for c in calls]
    if schedule == "record":  # one record chunk holds all 10 samples here
        assert done == [10]
    else:  # ceil(10 / 8) = 2 samples a chunk
        assert done == [2, 4, 6, 8, 10]
    assert all(c[1] == 10 and c[2] >= 0 for c in calls)
    torch.testing.assert_close(chunked, one, rtol=1e-5, atol=1e-7)


def test_progress_true_prints_and_one_dispatch_prints_nothing(capsys):
    sc = tdemo.smoke_scene(width=16)
    trender.render_image(sc, samples=3, max_depth=2, verbose=True, device="cpu")
    err = capsys.readouterr().err
    assert "render 1/3 spp" in err and "render 3/3 spp" in err and err.endswith("\n")
    trender.render_image(sc, samples=3, max_depth=2, device="cpu")
    assert capsys.readouterr().err == ""


def test_mega_chunk_is_a_sample_range():
    """trace_persistent_mega over [s0, s1) is the samples s0..s1-1 alone:
    the two halves add to the whole, within rounding."""
    from crucible_tpu_torch.models import integrator

    sc = tdemo.smoke_scene(width=16)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    whole = integrator.trace_persistent_mega(sd, cp, 16, 9, 4, 3, 0)
    lo = integrator.trace_persistent_mega(sd, cp, 16, 9, 2, 3, 0)
    hi = integrator.trace_persistent_mega(sd, cp, 16, 9, 4, 3, 0, sample_start=2)
    torch.testing.assert_close(lo + hi, whole, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="sample_start"):
        integrator.trace_persistent_mega(sd, cp, 16, 9, 2, 3, 0, sample_start=2)
