"""The golden check and the ``pixel`` profiler of crucible_tpu_torch on the
CPU (the kernels' plain versions).

``tools/torch_golden.py`` renders each demo world through its production
schedule and holds it to ``tests/goldens/golden_tpu_v1.npz``, the JAX
package's renders, at the JAX harness's bounds (``tools/tpu_bench.py``
``golden``): one case a held config. Its gradient checks (direct AD
against the replay, central differences, the depth-50 gradients) get one
case each, at the JAX harness's sizes and tolerances. Then the rows of the
worlds whose assets are absent, the tools' imports, their copies of the
JAX tool's configs, and ``tools/torch_profile_persistent.py`` at a small
width."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest

from crucible_tpu_torch.io import assets as tassets
from crucible_tpu_torch.models import demo, integrator, render
from tests.torch_threads import one_torch_thread  # noqa: F401
from tools import make_tpu_goldens as jax_goldens
from tools import torch_golden as tg
from tools import torch_profile_persistent as tpp

REPO = Path(__file__).resolve().parents[1]

# Held configs -> the schedule 'auto' takes on the CPU and on a CUDA device.
HELD = {
    "smoke_scene": ("mega", "mega"),
    "book1_end_scene": ("mega", "mega"),
    "checkered_spheres": ("mega", "mega"),
    "garden_skybox": ("pixel", "pixel"),
    "sphere_stress": ("mega", "mega"),
    "nested_checkers": ("pixel", "record"),
}


@pytest.fixture(scope="module")
def goldens():
    return tg.load_goldens()


@pytest.mark.parametrize("name", [*HELD, tg.DEEP_KEY])
def test_golden_config(name, goldens):
    """Each held config on the CPU within all three JAX bounds; 'auto' takes
    the schedule of the table on each device."""
    if name == tg.DEEP_KEY:
        row = tg.deep_row(goldens[name], "cpu")
    else:
        row = tg.world_row(name, goldens[name], "cpu")
        cpu, card = HELD[name]
        sc = getattr(demo, name)(width=64)
        sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
        assert (row["schedule"], render.auto_schedule(sd, cp, "cuda")) == (cpu, card)
    assert row["held"] and row["ok"], row
    assert row["max_lt_2_over_spp"] and row["fliptail_lt_2pct"] and row["mean_lt_3em3"]
    assert row["d_max"] < 2.0 * row["scale"] / row["spp"]
    assert "launches" not in row  # the plain versions count no launch


@pytest.mark.parametrize("tag", list(tg.AD_VS_REPLAY))
def test_ad_vs_replay(tag):
    """Direct AD against the replay at 64 px, 8 spp, depth 4: smoke's camera
    leaves within 0.02 and the rest 5e-3; book1's radiometric leaves 5e-3."""
    out = tg.ad_vs_replay(tag, "cpu")
    assert not out["failed"], out
    keys = {k.rsplit(":", 1)[1] for k in out["checks"]}
    assert keys == {"tex_color", "mat_emission", "mat_fuzz", "cam_look_from", "cam_look_at",
                    "cam_vfov", "cam_defocus", "cam_focus_dist"}
    bound = tg.AD_VS_REPLAY[tag][1]
    held = [k for k in out["checks"] if bound(k.rsplit(":", 1)[1]) is not None]
    assert all(math.isfinite(out["checks"][k]) for k in held)


@pytest.mark.parametrize("name", list(tg.FD_CHECKS))
def test_fd_check(name):
    """The replay's gradient against central differences: |ad| > 0 and
    |ad - fd| <= 5e-2 |fd|."""
    out = tg.fd_check(name, "cpu")
    row = out["checks"][name]
    assert not out["failed"], out
    assert abs(row["ad"]) > 0 and abs(row["ad"] - row["fd"]) <= tg.FD_REL * abs(row["fd"])


def test_deep50_grads_finite():
    out = tg.deep50_finite("cpu")
    assert out["checks"] == {"deep50_grads_finite": True} and not out["failed"]


def test_absent_assets_not_held(goldens, tmp_path, monkeypatch):
    """Without earthmap.jpg and teapot.obj, earth and load_teapot are
    reported as not held: earth rendered over a generated map, the
    teapot's FileNotFoundError."""
    monkeypatch.setenv("ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(tassets, "ASSETS_DIR", tmp_path)
    monkeypatch.chdir(tmp_path)
    earth = tg.asset_row("earth", goldens["earth"], "cpu")
    assert (earth["held"], earth["reason"], earth["map"]) == (False, tg.ABSENT, "generated")
    assert earth["schedule"] == "pixel" and math.isfinite(earth["d_max"])
    assert "ok" not in earth
    teapot = tg.asset_row("load_teapot", goldens["load_teapot"], "cpu")
    assert (teapot["held"], teapot["reason"]) == (False, tg.ABSENT)
    assert teapot["raises"].startswith("FileNotFoundError")
    assert not (tmp_path / "earthmap.jpg").exists()  # the map lived in its own directory


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_tools_import_no_jax():
    """The golden check, the profiler and ``chip_smoke.py`` (whose launch
    counter and timer they import) import neither JAX nor the JAX package."""
    for rel in ("tools/torch_golden.py", "tools/torch_profile_persistent.py", "chip_smoke.py"):
        bad = {n for n in _imports(REPO / rel)
               if n.split(".")[0] in ("jax", "jaxlib", "crucible_tpu", "make_tpu_goldens")}
        assert not bad, (rel, bad)


def test_configs_match_jax_tool():
    """The golden check's own copies of the JAX tool's configs."""
    assert tg.WORLDS == jax_goldens.WORLDS
    assert tg.WORLD_SPP == jax_goldens.WORLD_SPP
    assert (tg.DEEP_WORLD, tg.DEEP_KEY) == (jax_goldens.DEEP_WORLD, jax_goldens.DEEP_KEY)
    assert (tg.SPP, tg.DEPTH) == (jax_goldens.SPP, jax_goldens.DEPTH)
    with np.load(tg.GOLDENS) as z:
        assert set(z.files) == {n for n, _, _ in tg.WORLDS} | {tg.DEEP_KEY}


def test_profile_small(monkeypatch):
    """The profiler at 32 wide, 2 spp, 4096 target lanes: finite fields, and
    its iterations the ``bounce_step_fused`` calls of one ``trace_persistent``
    at the same lanes."""
    inner = integrator.bounce_step_fused
    out = tpp.profile(width=32, spp=2, device="cpu", lanes=4096, reps=2)
    assert integrator.bounce_step_fused is inner  # the tool's wrapper is gone
    for key in ("raygen_ms", "k9_ms", "bounce_ms", "total_ms", "model_ms", "bookkeeping_ms",
                "ms_per_iter", "image_mean"):
        assert math.isfinite(out[key]), (key, out)
    assert out["lanes"] == 2 * 1024 and out["groups"] == 2 and out["timer"] == "host clock"
    assert out["model_ms"] == out["iters"] * (out["raygen_ms"] + out["bounce_ms"])
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(integrator, "bounce_step_fused", counted)
    sc = demo.book1_end_scene(width=32)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    integrator.trace_persistent(sd, cp, 32, 18, 2, tpp.DEPTH, tpp.SEED, lanes=4096)
    assert out["iters"] > 0 and out["iters"] == len(calls)
