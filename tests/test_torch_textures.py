"""Image textures and nested checkers of crucible_tpu_torch against the JAX
package: ``textures.value`` on random tables, LDR decode, and the lowering
of the earth and nested-checker worlds. The earth map (``earthmap.jpg``)
is not in the repository, so a generated stand-in is written into the
test's directory, which both packages' asset resolvers search first."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu.io import assets as jassets
from crucible_tpu.io import image as jimage
from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import textures as jtex
from crucible_tpu_torch import bridge
from crucible_tpu_torch.io import assets as tassets
from crucible_tpu_torch.io import image as timage
from crucible_tpu_torch.io.procedural import generate_earth_texture
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import textures as ttex
from crucible_tpu_torch.ops import gather as tgather
from tests.test_torch_scene import jax_scene_arrays
from tests.torch_threads import one_torch_thread  # noqa: F401

Image = pytest.importorskip("PIL.Image")


@pytest.fixture
def earth_asset(tmp_path, monkeypatch):
    """A generated 128x64 ``earthmap.jpg`` in ``tmp_path``, which both
    packages' resolvers search first (``ASSET_DIR``; the port's
    ``ASSETS_DIR`` points there too) -> its path."""
    path = tmp_path / "earthmap.jpg"
    Image.fromarray(generate_earth_texture(64)).save(path)
    monkeypatch.setenv("ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(tassets, "ASSETS_DIR", tmp_path)
    return path


def with_images(arrays, sd):
    """A JAX SceneData's bridge arrays with its texture images added."""
    if sd.tex.images:
        arrays["tex_images"] = tuple(np.asarray(im) for im in sd.tex.images)
    return arrays


def _random_table(g, nest):
    """(numpy columns, images) of a table whose checkers nest ``nest``
    levels: 6 leaves (solids and rows of two images), then a level of
    checkers whose children lie in the levels below, each level holding at
    least one checker of the level under it."""
    images = [g.random((5, 7, 3)).astype(np.float32), g.random((3, 4, 3)).astype(np.float32)]
    kind = [ttex.SOLID, ttex.IMAGE, ttex.SOLID, ttex.IMAGE, ttex.IMAGE, ttex.SOLID]
    image_id = [0, 0, 0, 1, 0, 0]
    even, odd = [0] * 6, [0] * 6
    below = list(range(6))
    for level in range(nest):
        first = len(kind)
        for j in range(4):
            kind.append(ttex.CHECKER)
            image_id.append(0)
            # The first checker of a level takes one child from the level
            # just below, so the chain is exactly `level + 1` deep.
            e = below[-1] if j == 0 else int(g.choice(below))
            even.append(e)
            odd.append(int(g.choice(below)))
        below = below + list(range(first, len(kind)))
    t = len(kind)
    cols = dict(
        kind=np.asarray(kind, np.int32),
        color=g.random((t, 3)).astype(np.float32),
        inv_scale=g.uniform(0.3, 4.0, t).astype(np.float32),
        even=np.asarray(even, np.int32),
        odd=np.asarray(odd, np.int32),
        image_id=np.asarray(image_id, np.int32),
    )
    return cols, images


@pytest.mark.parametrize("nest", [1, 2, 3])
def test_value_equals_jax_with_images_and_nesting(nest):
    g = np.random.default_rng(10 + nest)
    cols, images = _random_table(g, nest)
    jtable = jtex.TextureTable(**{k: jnp.asarray(v) for k, v in cols.items()},
                               images=tuple(jnp.asarray(im) for im in images), max_nest=nest)
    ttable = ttex.TextureTable(**{k: torch.from_numpy(v) for k, v in cols.items()},
                               images=tuple(torch.from_numpy(im) for im in images),
                               max_nest=nest)
    r = 4000
    tid = g.integers(0, len(cols["kind"]), r).astype(np.int32)
    p = (g.normal(size=(r, 3)) * 3).astype(np.float32)
    # uv past [0, 1] too: the lookup clamps.
    uv = g.uniform(-0.1, 1.1, (2, r)).astype(np.float32)
    want = np.asarray(jtex.value(jtable, jnp.asarray(tid), jnp.asarray(uv[0]),
                                 jnp.asarray(uv[1]), jnp.asarray(p)))
    got = ttex.value(ttable, torch.from_numpy(tid), torch.from_numpy(uv[0]),
                     torch.from_numpy(uv[1]), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    # Every kind of leaf is reached through the checkers.
    assert (got == images[0].reshape(-1, 3)[:, None]).all(-1).any()
    assert (got == images[1].reshape(-1, 3)[:, None]).all(-1).any()


def test_texel_gradient_is_an_index_add():
    """The texel gather's backward adds each lane's cotangent into its texel."""
    img = torch.zeros((2, 3, 3), requires_grad=True)
    u = torch.tensor([0.1, 0.1, 0.9, 0.5])
    v = torch.tensor([0.9, 0.9, 0.1, 0.2])
    out = ttex.image_lookup(img, u, v)
    out.sum().backward()
    want = torch.zeros((2, 3))
    want[0, 0], want[1, 2], want[1, 1] = 2.0, 1.0, 1.0
    assert torch.equal(img.grad, want[..., None].expand(2, 3, 3))


@pytest.mark.parametrize("shape", [(7,), (7, 3), (5, 2, 3)])
def test_gather_backward_is_the_index_add(shape):
    """ops.gather's sorted segment sum (the backward of every texel and row
    gather on a GPU) gives index_add's sums, here bit for bit (the CPU adds
    each segment in order): repeated ids, an id never gathered, no ids."""
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, shape[0] - 1, (999,), generator=gen)
    g = torch.randn((999,) + shape[1:], generator=gen)
    want = torch.zeros(shape).index_add_(0, ids, g)
    assert torch.equal(tgather.segment_sum(g, ids, shape[0]), want)
    src = torch.randn(shape, generator=gen, requires_grad=True)
    out = tgather._Rows.apply(src, ids)
    assert torch.equal(out, src.detach()[ids])
    (out * g).sum().backward()
    assert torch.equal(src.grad, want)
    empty = tgather.segment_sum(g[:0], ids[:0], shape[0])
    assert torch.equal(empty, torch.zeros(shape))


@pytest.mark.parametrize("suffix", [".png", ".jpg"])
def test_ldr_decode_equals_jax(tmp_path, monkeypatch, suffix):
    texels = np.random.default_rng(2).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    Image.fromarray(texels).save(tmp_path / f"map{suffix}")
    monkeypatch.setenv("ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(tassets, "ASSETS_DIR", tmp_path)
    got = timage.load_image(f"map{suffix}")
    want = jimage.load_image(f"map{suffix}")
    assert got.dtype == want.dtype == np.float32 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timage.load_image_path(tmp_path / f"map{suffix}"), want)
    if suffix == ".png":  # lossless: byte / 255, no gamma
        np.testing.assert_array_equal(got, texels.astype(np.float32) / 255.0)
    assert jassets.build_asset_path(f"map{suffix}") == tassets.build_asset_path(f"map{suffix}")


def test_read_ppm_equals_jax(tmp_path):
    u8 = np.random.default_rng(3).integers(0, 256, (4, 5, 3), dtype=np.uint8)
    timage.write_ppm(tmp_path / "a.ppm", u8)
    np.testing.assert_array_equal(timage.read_ppm(tmp_path / "a.ppm"), u8)
    np.testing.assert_array_equal(jimage.read_ppm(tmp_path / "a.ppm"), u8)


@pytest.mark.parametrize("world", ["earth", "nested_checkers"])
def test_lowering_equals_jax(world, earth_asset):
    js, ts = getattr(jdemo, world)(width=32), getattr(tdemo, world)(width=32)
    jsd = js.build()
    want, want_static = jax_scene_arrays(jsd)
    want = with_images(want, jsd)
    sd = ts.build(device="cpu")
    got, got_static = bridge.scene_data_to_arrays(sd)
    assert got.keys() == want.keys() and got_static == want_static
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    if world == "earth":
        assert len(sd.tex.images) == 1 and sd.tex.images[0].shape == (64, 128, 3)
    else:
        assert sd.tex.max_nest == 3 and not sd.tex.images
    # The bridge carries the images both ways.
    back = bridge.scene_data_from_arrays(want, device="cpu", **want_static)
    assert len(back.tex.images) == len(jsd.tex.images) and back.tex.max_nest == jsd.tex.max_nest
    for a, b in zip(back.tex.images, jsd.tex.images):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tdemo.WORLDS[4] is tdemo.earth and tdemo.WORLDS[7] is tdemo.nested_checkers
    assert sorted(tdemo.WORLDS) == sorted(jdemo.WORLDS)


def test_earth_without_its_map_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(tassets, "ASSETS_DIR", tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="earthmap.jpg"):
        tdemo.earth(width=32).build(device="cpu")
