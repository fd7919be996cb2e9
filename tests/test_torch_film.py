"""Film output and the render helpers: the port's numpy PPM writer
against the JAX package's writer byte for byte, ``read_ppm`` round trips,
``write_image`` by suffix; ``utils.profiling`` (a Chrome trace, the
``RenderStats`` JSON keys); ``ops.sampling.on_hemisphere`` against the JAX
function."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu.io import image as jimage
from crucible_tpu.ops import sampling as jsampling
from crucible_tpu.utils import profiling as jprofiling
from crucible_tpu_torch.io import image as timage
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.ops import sampling as tsampling
from crucible_tpu_torch.utils import profiling as tprofiling
from tests.torch_threads import one_torch_thread  # noqa: F401

# The values whose digit counts differ on either side.
EDGES = (0, 9, 10, 99, 100, 255)


def _image(h, w, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)
    flat = img.reshape(-1)
    flat[: len(EDGES)] = EDGES[: flat.size]
    return img


@pytest.mark.parametrize("h", [1, 2, 5])
@pytest.mark.parametrize("w", [1, 7, 64])
def test_write_ppm_writes_the_jax_bytes(tmp_path, h, w):
    img = _image(h, w, 10 * h + w)
    jimage.write_ppm(tmp_path / "jax.ppm", img)
    timage.write_ppm(tmp_path / "port.ppm", img)
    want = (tmp_path / "jax.ppm").read_bytes()
    assert (tmp_path / "port.ppm").read_bytes() == want == timage.ppm_bytes(img)
    assert want.startswith(f"P3\n{w} {h}\n255\n".encode()) and want.endswith(b"\n")
    for read in (timage.read_ppm, jimage.read_ppm):
        back = read(tmp_path / "port.ppm")
        assert back.dtype == np.uint8 and np.array_equal(back, img)


def test_every_byte_value_round_trips(tmp_path):
    img = np.arange(256 * 3, dtype=np.int64).reshape(16, 16, 3) % 256
    img = img.astype(np.uint8)
    timage.write_image(tmp_path / "all.ppm", img)
    assert np.array_equal(timage.read_ppm(tmp_path / "all.ppm"), img)
    jimage.write_ppm(tmp_path / "jax.ppm", img)
    assert (tmp_path / "all.ppm").read_bytes() == (tmp_path / "jax.ppm").read_bytes()


def test_render_image_to_file_adds_ppm(tmp_path):
    sc = tdemo.smoke_scene(width=16)
    sc.scene_cam.set_samples(1)
    sc.scene_cam.set_max_depth(2)
    img = trender.render_image_to_file(sc, str(tmp_path / "still"), verbose=False,
                                       device="cpu")
    assert np.array_equal(timage.read_ppm(tmp_path / "still.ppm"), trender.to_u8(img))


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprofiling.trace(str(tmp_path / "prof")):
        torch.ones(64).cumsum(0)
    files = list((tmp_path / "prof").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
    with tprofiling.trace(None):  # nothing traced, nothing written
        torch.ones(4).sum()
    with tprofiling.trace(""):
        torch.ones(4).sum()
    assert list((tmp_path / "prof").glob("*.json")) == files


def test_render_stats_json_matches_jax(monkeypatch):
    def run(mod):
        stats = mod.RenderStats()
        clock = iter([10.0, 12.5, 20.0, 21.0])
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        stats.start()
        stats.stop(1000)
        stats.start()
        stats.stop(3000)
        return json.loads(stats.json()), stats.rays_per_sec

    got, got_rate = run(tprofiling)
    want, want_rate = run(jprofiling)
    assert list(got) == list(want) == ["rays", "seconds", "passes", "rays_per_sec"]
    assert got == want and got_rate == want_rate
    assert tprofiling.RenderStats().rays_per_sec == 0.0


def test_on_hemisphere_matches_jax():
    rng = np.random.default_rng(3)
    u1, u2 = rng.random((2, 512), dtype=np.float32)
    normal = rng.normal(size=(512, 3)).astype(np.float32)
    got = tsampling.on_hemisphere(torch.from_numpy(u1), torch.from_numpy(u2),
                                  torch.from_numpy(normal)).numpy()
    want = np.asarray(jsampling.on_hemisphere(jnp.asarray(u1), jnp.asarray(u2),
                                              jnp.asarray(normal)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert ((got * normal).sum(-1) >= -1e-6).all()
    # A fixed normal, as the JAX package's own test draws it.
    up = tsampling.on_hemisphere(torch.from_numpy(u1), torch.from_numpy(u2),
                                 torch.tensor([0.0, 1.0, 0.0]))
    assert bool((up[:, 1] >= 0).all())
