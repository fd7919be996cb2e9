"""The slice end to end: the port's render_image against the JAX package's
megakernel schedule, the features the port refuses, and the port's
independence from JAX."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import render as jrender
from crucible_tpu_torch import bridge
from crucible_tpu_torch.io import image as timage
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import scene as tscene
from tests.test_torch_scene import bridged
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _jax_render(name, width, samples, depth, seed=0):
    sc = getattr(jdemo, name)(width=width)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    return np.asarray(jrender.render_image_persistent(
        sc.build(), sc.scene_cam.params(), w, h, samples, depth, seed, schedule="mega"
    ))


def test_book1_render_matches_jax():
    want = _jax_render("book1_end_scene", 32, 2, 8)
    img = trender.render_image(
        tdemo.book1_end_scene(width=32), samples=2, max_depth=8, device="cpu"
    )
    got = img.numpy()
    assert got.shape == want.shape == (18, 32, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    # Statistical bounds, for the reason given in test_torch_megakernel.py
    # (the JAX package's own two schedules agree on 97.7-99.4% here).
    close = np.isclose(got, want, rtol=1e-3, atol=1e-3).mean()
    assert close > 0.97, close
    assert abs(got.mean() - want.mean()) <= 2e-3


def test_smoke_render_matches_jax():
    want = _jax_render("smoke_scene", 32, 4, 6)
    got = trender.render_image(
        tdemo.smoke_scene(width=32), samples=4, max_depth=6, device="cpu"
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 / 4)


def test_bridged_scene_renders_like_the_port_built_one():
    sd, cp = bridged(jdemo.smoke_scene(width=32))
    a = trender.render_image_data(sd, cp, 32, 18, 2, 4, 0, device="cpu")
    b = trender.render_image(tdemo.smoke_scene(width=32), 2, 4, 0, device="cpu")
    assert torch.equal(a, b)


def test_hide_then_show_restores_the_image_bit_for_bit():
    sc = tdemo.smoke_scene(width=32)
    before = trender.render_image(sc, 2, 4, device="cpu")
    sc.hide_element("ball")
    assert not torch.equal(trender.render_image(sc, 2, 4, device="cpu"), before)
    sc.show_element("ball")
    assert torch.equal(trender.render_image(sc, 2, 4, device="cpu"), before)


def _sphere(material=None):
    return tscene.Sphere((0.0, 0.0, -1.0), 0.5,
                         material or tscene.Lambertian.from_color((0.5, 0.5, 0.5)))


def _render(sc):
    return trender.render_image(sc, 1, 2, device="cpu")


def _triangle(sc):
    """Static triangles render (K7, tests/test_torch_mesh.py), and so do
    moving ones (tests/test_torch_mesh_motion.py); a triangle whose keyframe
    falls inside the shutter needs exact-time motion, not ported."""
    sc.add_element(tscene.Triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                                   tscene.Metal((0.5, 0.5, 0.5))), "tri")
    _render(sc)
    sc.translate_y(0.5, 1.0, "lerp", "local", "tri")
    _render(sc)
    sc.translate_y(0.5, 1.0 / 96.0, "lerp", "local", "tri")
    _render(sc)


def _obj_asset(sc):
    """An OBJ asset loads (here from a temporary asset directory) and its
    mesh moves; a keyframe inside the shutter needs exact-time motion, not
    ported."""
    import tempfile

    from crucible_tpu_torch.io import assets

    old = assets.ASSETS_DIR
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        assets.ASSETS_DIR = Path(tmp)
        try:
            sc.load_asset("tri.obj", "mesh", 0.5, (0, 0, 0), tscene.Metal((0.5, 0.5, 0.5)))
        finally:
            assets.ASSETS_DIR = old
    assert sc.build(device="cpu").num_tris == 1
    sc.translate_x(1.0, 1.0, "lerp", "world", "mesh")
    _render(sc)
    sc.translate_x(1.0, 1.0 / 96.0, "lerp", "world", "mesh")
    _render(sc)


def _movie(sc):
    """A movie renders frame by frame (``first_movie``, and moving meshes in
    tests/test_torch_mesh_motion.py); a frame whose shutter holds a
    keyframe needs exact-time motion, not ported. (``moving_teapot`` needs
    ``teapot.obj``: fault C1.)"""
    import tempfile

    sc.duration = 2.0 / 24.0
    sc.translate_y(0.5, 1.0 / 96.0, "lerp", "local", "ball")
    with tempfile.TemporaryDirectory() as tmp:
        trender.render_movie(sc, str(Path(tmp) / "movie"), verbose=False, device="cpu")


def _temp_asset(name, texels):
    """Write (H, W, 3) uint8 ``texels`` as the image asset ``name`` into a
    temporary directory -> (the directory, its cleanup)."""
    import tempfile

    from PIL import Image

    tmp = tempfile.TemporaryDirectory()
    Image.fromarray(texels).save(Path(tmp.name) / name)
    return tmp


def _with_asset_dir(path, fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ASSET_DIR", str(path))
        return fn()


def _image_texture(sc):
    """An image texture renders (here from a temporary PNG asset; a missing
    asset raises FileNotFoundError, tests/test_torch_textures.py holds the
    lookups to the JAX package); the megakernel, asked by name, does not
    shade it (the JAX package's does not either: auto takes 'record' on a
    card, 'pixel' elsewhere)."""
    texels = np.random.default_rng(0).integers(0, 256, (4, 8, 3), dtype=np.uint8)
    with _temp_asset("map.png", texels) as tmp:
        _with_asset_dir(tmp, lambda: sc.add_element(
            _sphere(tscene.Lambertian.from_texture(tscene.ImageTexture("map.png"))),
            "earth"))
        assert bool(torch.isfinite(_with_asset_dir(tmp, lambda: _render(sc))).all())
        _with_asset_dir(tmp, lambda: trender.render_image_persistent(
            sc.build(device="cpu"), sc.scene_cam.params(device="cpu"), 32, 18, 1, 2, 0,
            device="cpu", schedule="mega"))


def _spherical_sky(sc):
    """A spherical sky loads from an LDR asset too (through PIL) and renders
    on the pixel schedule; the megakernel, asked by name, does not take it."""
    texels = np.random.default_rng(1).integers(0, 256, (4, 8, 3), dtype=np.uint8)
    with _temp_asset("garden.jpg", texels) as tmp:
        _with_asset_dir(tmp, lambda: sc.load_spherical_skybox("garden.jpg"))
    assert bool(torch.isfinite(_render(sc)).all())
    trender.render_image_persistent(
        sc.build(device="cpu"), sc.scene_cam.params(device="cpu"), 32, 18, 1, 2, 0,
        device="cpu", schedule="mega")


def _timeline(sc):
    """A keyframe inside the shutter window needs exact-time motion."""
    sc.translate_y(1.0, 1.0 / 96.0, "lerp", "local", "ball")
    assert sc.build(device="cpu").motion_exact
    _render(sc)


def _animator(sc):
    """Moving spheres render forward and record (K8); a moving table above
    the brute kernel's animated rows needs the chunk-cull branch (K6)."""
    sc.translate_point((1.0, 0.0, 0.0), 1.0, "lerp", "local", "ball")
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    assert sd.animated and integrator.megakernel_supported(sd, cp)
    from dataclasses import replace

    from crucible_tpu_torch.models import replay
    from crucible_tpu_torch.ops.kernels import megakernel as mk

    replay.trace_record_mega(sd, cp, 32, 18, torch.arange(4), torch.zeros(4), 0, 2)
    big = replace(sd, sph_center=torch.zeros((mk.MAX_ROWS_ANIMATED + 1, 3)))
    replay.trace_record_mega(big, cp, 32, 18, torch.arange(4), torch.zeros(4), 0, 2)


def _big_moving(sc):
    """``sc`` with CULL_MIN_ROWS + 1 coincident spheres added, the first of
    them rising over frame 0's shutter: a big moving table, which
    Scene.build gives the chunk-cull tables (K6 walks their swept tree)."""
    for k in range(trender.CULL_MIN_ROWS + 1):
        sc.add_element(_sphere(), f"s{k}")
    sc.translate_y(0.3, 1.0 / 48.0, "lerp", "local", "s0")
    return sc.build(device="cpu"), sc.scene_cam.params(device="cpu")


def _too_many_spheres(sc):
    """A big moving table renders through the swept-tree walk (K6,
    test_big_moving_table_renders_through_the_cluster_walk); beside a BVH
    mesh it takes K8's brute search while that holds it
    (tests/test_torch_cull.py), and above MAX_ROWS_ANIMATED rows it is a
    template combination not instantiated (K7 beside K6, ROADMAP A11)."""
    from dataclasses import replace

    from crucible_tpu_torch.ops.kernels import megakernel as mk

    sd, cp = _big_moving(sc)
    arrays, static = bridge.scene_data_to_arrays(sd)
    sd = bridge.scene_data_from_arrays(arrays, device="cpu",
                                       **dict(static, num_tris=70, use_bvh=True))
    sd = replace(sd, sph_center=torch.zeros((mk.MAX_ROWS_ANIMATED + 1, 3)))
    assert sd.animated and sd.sph_cbounds is not None
    trender.render_image_persistent(sd, cp, 32, 18, 1, 2, 0, device="cpu", schedule="mega")


def test_big_moving_table_renders_through_the_cluster_walk():
    """CULL_MIN_ROWS + 1 coincident spheres, one moving: auto walks the
    clusters, and every exact tie goes to the lowest original row, as the
    brute search gives it."""
    from crucible_tpu_torch.ops.kernels import megakernel as mk

    sd, cp = _big_moving(tdemo.smoke_scene(width=32))
    assert sd.animated and sd.sph_cbounds is not None and sd.sph_nodes is None
    mk.CULL_COUNTS.update(nodes=0, rows=0, roots=0)
    img = trender.render_image_persistent(sd, cp, 32, 18, 1, 2, 0, device="cpu")
    assert mk.CULL_COUNTS["nodes"] > 0 and torch.isfinite(img).all()
    assert torch.equal(img, trender.render_image_persistent(sd, cp, 32, 18, 1, 2, 0,
                                                            device="cpu", cull=False))


def _bridged_triangles(sc):
    """A mesh without a BVH (at most 64 triangles) takes the pixel schedule;
    the megakernel's triangle stage (K7) walks BVH meshes only."""
    arrays, static = bridge.scene_data_to_arrays(sc.build(device="cpu"))
    sd = bridge.scene_data_from_arrays(arrays, device="cpu", **dict(static, num_tris=6))
    cp = sc.scene_cam.params(device="cpu")
    assert not integrator.megakernel_supported(sd, cp)
    trender.render_image_persistent(sd, cp, 32, 18, 1, 2, 0, device="cpu", schedule="mega")


@pytest.mark.parametrize(
    "use",
    [
        _triangle,
        _image_texture,
        _timeline,
        _animator,
        _obj_asset,
        _spherical_sky,
        lambda sc: _movie(sc),
        _too_many_spheres,
        _bridged_triangles,
        # 'record' runs on both devices (tests/test_torch_record_schedule.py);
        # the JAX package's 'queue' schedule is not ported.
        lambda sc: trender.render_image_persistent(
            sc.build(device="cpu"), sc.scene_cam.params(device="cpu"), 32, 18, 1, 1, 0,
            device="cpu", schedule="queue"),
    ],
    ids=["triangle", "image_texture", "timeline", "animator", "obj_asset",
         "spherical_sky", "movie", "structure_tables", "bridged_mesh", "schedule"],
)
def test_unported_features_raise(use):
    with pytest.raises(NotImplementedError):
        use(tdemo.smoke_scene(width=32))


def test_scene_on_another_device_is_refused():
    sc = tdemo.smoke_scene(width=32)
    with pytest.raises(ValueError, match="not meta"):
        trender.render_image_data(
            sc.build(device="cpu"), sc.scene_cam.params(device="cpu"), 32, 18, 1, 1, 0,
            device="meta",
        )


def test_to_u8_and_film_writers(tmp_path):
    from PIL import Image

    img = trender.render_image(tdemo.smoke_scene(width=32), 2, 4, device="cpu")
    u8 = trender.to_u8(img)
    assert u8.dtype == np.uint8 and u8.shape == (18, 32, 3)
    timage.write_png(tmp_path / "a.png", u8)
    with Image.open(tmp_path / "a.png") as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), u8)
    timage.write_ppm(tmp_path / "a.ppm", u8)
    tokens = (tmp_path / "a.ppm").read_text().split()
    assert tokens[:4] == ["P3", "32", "18", "255"]
    np.testing.assert_array_equal(np.array(tokens[4:], np.uint8).reshape(u8.shape), u8)


def test_write_image_follows_the_suffix(tmp_path, monkeypatch):
    """Fault C10: ``.jpg`` is a JPEG, ``.png`` a PNG, ``.ppm`` the JAX
    package's P3 text byte for byte; without PIL only ``.ppm`` and ``.png``
    are written."""
    from PIL import Image

    from crucible_tpu.io import image as jimage

    u8 = np.random.default_rng(0).integers(0, 256, (9, 16, 3), dtype=np.uint8)
    for suffix, fmt in ((".jpg", "JPEG"), (".png", "PNG")):
        timage.write_image(tmp_path / f"a{suffix}", u8)
        with Image.open(tmp_path / f"a{suffix}") as im:
            assert im.format == fmt and im.size == (16, 9)
    with Image.open(tmp_path / "a.png") as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), u8)
    timage.write_image(tmp_path / "a.ppm", u8)
    jimage.write_ppm(tmp_path / "b.ppm", u8)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()
    with pytest.raises(ValueError):
        timage.write_image(tmp_path / "a.nosuchformat", u8)

    monkeypatch.setitem(sys.modules, "PIL", None)  # PIL does not import
    timage.write_image(tmp_path / "c.png", u8)
    assert (tmp_path / "c.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="without PIL"):
        timage.write_image(tmp_path / "c.jpg", u8)


def test_assets_resolve_in_the_jax_order(tmp_path, monkeypatch):
    """Fault C9: ``ASSET_DIR`` first, then ``assets/`` in the current
    directory and its parents, then the repository's ``assets/``, as the
    JAX resolver searches."""
    from crucible_tpu.io import assets as jassets
    from crucible_tpu_torch.io import assets as tassets

    env, up, repo = tmp_path / "env", tmp_path / "up" / "assets", tmp_path / "repo"
    for folder, names in ((env, "a"), (up, "ab"), (repo, "abc")):
        folder.mkdir(parents=True)
        for name in names:
            (folder / f"{name}.obj").write_text(str(folder))
    cwd = tmp_path / "up" / "x" / "y"
    cwd.mkdir(parents=True)
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(tassets, "ASSETS_DIR", repo)
    monkeypatch.setenv("ASSET_DIR", str(env))
    for name, where in (("a", env), ("b", up), ("c", repo)):
        assert tassets.build_asset_path(f"{name}.obj") == where / f"{name}.obj"
    for name in ("a", "b"):  # the JAX package's own assets/ is not patched
        assert jassets.build_asset_path(f"{name}.obj") == tassets.build_asset_path(f"{name}.obj")
    monkeypatch.delenv("ASSET_DIR")
    assert tassets.build_asset_path("a.obj") == up / "a.obj"
    assert jassets.build_asset_path("a.obj") == up / "a.obj"
    with pytest.raises(FileNotFoundError):
        tassets.build_asset_path("d.obj")


def test_importing_and_rendering_leaves_jax_out():
    code = (
        "import sys, crucible_tpu_torch\n"
        "from crucible_tpu_torch.models import demo, render\n"
        "img = render.render_image(demo.smoke_scene(width=16), 1, 2, device='cpu')\n"
        "assert img.shape == (9, 16, 3)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'crucible_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|crucible_tpu)\b", re.M)
    sources = sorted((REPO / "crucible_tpu_torch").rglob("*.py"))
    assert sources
    for path in sources + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
