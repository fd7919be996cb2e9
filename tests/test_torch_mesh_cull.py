"""A mesh beside a big sphere table (ROADMAP A11): the megakernel's
triangle stage after a tree walk, K5's (a static table, ``walk_tri``) or
K6's (a moving one, with K7 moving: ``cull_tri``), in their plain
versions on the CPU. Both pairs against the brute search with the same
triangle stage (K1 + K7, K8 + K7 moving) bit for bit, forward and record,
and against the JAX megakernel (Pallas in interpret mode: its leaf-128
sphere BVH or its chunk-cull clusters, then its triangle stage) at fault
C6's bounds; the routes (a mesh no longer changes the sphere search) and
the gradient. The scenes: sphere_stress n1936 with a 144-triangle torus,
and bouncing stress n1936 with the torus rising
(``tests/torch_mesh_scenes.torus_beside_stress``), 24 wide. The card's
tests are in ``tests/test_torch_mesh_cull_card.py``."""

import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import render as jrender
from crucible_tpu.models import replay as jrep
from crucible_tpu.models import scene as jscene
from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.torch_mesh_scenes import torus_beside_stress
from tests.torch_threads import one_torch_thread  # noqa: F401

WIDTH, NU, NV = 24, 12, 6
SPP, DEPTH, SEED = 2, 4, 0


@functools.cache
def _scenes(moving: bool):
    """(JAX scene, port scene, its SceneData, its CameraParams)."""
    js = torus_beside_stress(jdemo, jscene, WIDTH, nu=NU, nv=NV, moving=moving)
    ts = torus_beside_stress(tdemo, tscene, WIDTH, nu=NU, nv=NV, moving=moving)
    sd, cp = ts.build(device="cpu"), ts.scene_cam.params(device="cpu")
    assert sd.num_tris == 2 * NU * NV and sd.use_bvh and sd.sph_swept_nodes is not None
    assert sd.animated == moving and tint.mesh_moves(sd) == moving
    return js, ts, sd, cp


def _clear(*counts):
    for c in counts:
        c.update(dict.fromkeys(c, 0))


def _size(ts):
    return ts.scene_cam.image_width, ts.scene_cam.image_height


@functools.cache
def _forward(moving: bool):
    """(port image through auto, the port's brute image, the JAX image)."""
    js, ts, sd, cp = _scenes(moving)
    w, h = _size(ts)
    walk_counts = tmk.CULL_COUNTS if moving else tmk.WALK_COUNTS
    _clear(walk_counts, tmk.TRI_COUNTS)
    got = trender.render_image_persistent(sd, cp, w, h, SPP, DEPTH, SEED, device="cpu")
    assert walk_counts["nodes"] > 0 and tmk.TRI_COUNTS["nodes"] > 0  # both walks ran
    brute = trender.render_image_persistent(sd, cp, w, h, SPP, DEPTH, SEED, device="cpu",
                                            cull=False)
    want = np.asarray(jrender.render_image_persistent(
        js.build(), js.scene_cam.params(), w, h, SPP, DEPTH, SEED, schedule="mega", cull=True))
    return got, brute, want


@pytest.mark.parametrize("moving", [False, True], ids=["k5_k7", "k6_k7_moving"])
def test_pair_forward_equals_the_brute_search(moving):
    got, brute, _ = _forward(moving)
    assert got.shape == (13, WIDTH, 3) and torch.isfinite(got).all()
    assert torch.equal(got, brute)


def _lanes(w, h):
    p = w * h
    return (np.tile(np.arange(p), SPP), np.repeat(np.arange(SPP), p))


@functools.cache
def _records(moving: bool):
    """(port fused records and radiance through the pair, the brute ones,
    the JAX record kernel's in interpret mode)."""
    js, ts, sd, cp = _scenes(moving)
    w, h = _size(ts)
    pix, smp = _lanes(w, h)
    args = (w, h, torch.from_numpy(pix), torch.from_numpy(smp), SEED, DEPTH)
    walk_counts = tmk.CULL_COUNTS if moving else tmk.WALK_COUNTS
    _clear(walk_counts)
    got = trep.trace_record_mega(sd, cp, *args, radiance=True)
    assert walk_counts["nodes"] > 0
    brute = trep.trace_record_mega(replace(sd, sph_perm=None, sph_cbounds=None), cp, *args,
                                   radiance=True)
    import jax.numpy as jnp

    want = jrep.trace_record_mega(
        js.build(), js.scene_cam.params(), w, h, jnp.asarray(pix, jnp.uint32),
        jnp.asarray(smp, jnp.uint32), jnp.uint32(SEED), DEPTH, interpret=True,
        radiance=True)
    return got, brute, tuple(np.asarray(x) for x in want)


@pytest.mark.parametrize("moving", [False, True], ids=["k5_k7", "k6_k7_moving"])
def test_pair_records_equal_the_brute_search(moving):
    (rec, rad), (b_rec, b_rad), _ = _records(moving)
    assert torch.equal(rec, b_rec) and torch.equal(rad, b_rad)
    tri = (rec & tmk.F_TRI) > 0
    assert tri.any() and ((rec & tmk.F_HIT) > 0).sum() > tri.sum()
    # The sphere winners' words carry original ids, some past book1's 488.
    assert int(trep.rec_winner_id(torch.where(tri, 0, rec)).max()) >= 488


@pytest.mark.parametrize("moving", [False, True], ids=["k5_k7", "k6_k7_moving"])
def test_pair_records_match_jax(moving):
    """Fault C6's bound on whole lanes: the port's and the JAX package's
    words agree on > 0.97 of them (10 and 5 of 624 differ, the static
    scene's 10 all sphere lanes that differ as much without the torus).
    Where a lane's words agree its radiance agrees within C6's float
    bounds (a checker's parity, which no word records, can still flip)."""
    (rec, rad), _, (jrec, jrad) = _records(moving)
    rec, rad = rec.numpy(), rad.numpy()
    same = (rec == jrec).all(axis=0)
    assert same.mean() > 0.97
    assert ((rec[:, same] & tmk.F_TRI) > 0).any()  # triangle winners among them
    assert np.isclose(rad, jrad, rtol=1e-3, atol=1e-3).mean() > 0.97
    assert np.isclose(rad[same], jrad[same], rtol=1e-3, atol=1e-3).mean() > 0.99
    assert abs(rad[same].mean() - jrad[same].mean()) <= 2e-3


@pytest.mark.parametrize("moving", [False, True], ids=["k5_k7", "k6_k7_moving"])
def test_pair_forward_matches_jax(moving):
    """The forward images (the port's through auto: the pair; the JAX
    package's megakernel with its sphere BVH or clusters and its triangle
    stage) at C6's float bounds on the pixels whose paths the two packages'
    records decide alike (all but the 5-10 pixels of the lanes that
    test_pair_records_match_jax counts)."""
    got, _, want = _forward(moving)
    (rec, _), _, (jrec, _) = _records(moving)
    w, h = _size(_scenes(moving)[1])
    alike = (rec.numpy() == jrec).all(axis=0).reshape(SPP, h * w).all(axis=0).reshape(h, w)
    assert alike.mean() > 1 - SPP * (1 - 0.97)  # at most SPP lanes of 0.03 a pixel
    got, want = got.numpy()[alike], want[alike]
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).mean() > 0.99
    assert abs(got.mean() - want.mean()) <= 2e-3


@pytest.mark.parametrize("moving", [False, True], ids=["k5_k7", "k6_k7_moving"])
def test_wrapper_takes_the_pair_in_both_modes(moving):
    """``run_megakernel`` and ``run_megakernel_record`` (the CPU twins)
    take a tree with a mesh, with and without K8's camera flag, and give the
    brute search's sums and words over the original table."""
    _, ts, sd, cp = _scenes(moving)
    w, h = _size(ts)
    brute, _ = tint.mega_inputs(sd, cp, 8, 4, 1, 3, SEED)
    brute.update(zip(("tri_nodes", "tris", "mats", "tri_meta"), tint.make_tri_tables(sd)))
    walk = dict(brute, table=tint.permute_table(brute["table"], sd.sph_swept_perm),
                swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
    for cam in (False, True):
        flags = dict(animated=moving, cam_animated=cam)
        assert torch.equal(tmk.run_megakernel(**walk, **flags), tmk.run_megakernel(**brute, **flags))
        got = tmk.run_megakernel_record(**walk, max_depth=3, radiance=True, **flags)
        want = tmk.run_megakernel_record(**brute, max_depth=3, radiance=True, **flags)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tmk._variant(object(), object(), moving, False) == ("cull_tri" if moving
                                                                else "walk_tri")


def test_a_mesh_does_not_change_the_sphere_route():
    """Above CULL_MIN_ROWS a table takes its walk whether a mesh is there or
    not: the megakernel takes both scenes, auto renders them on 'mega', and
    the record route walks the tree."""
    for moving in (False, True):
        _, _, sd, cp = _scenes(moving)
        assert tint.megakernel_unsupported_reason(sd, cp) is None
        assert tint.megakernel_record_unsupported_reason(sd, cp) is None
        assert trender.auto_schedule(sd, cp, "cuda") == "mega"
        assert trep.resolve_record_mode("auto", sd, cp) == "mega"
        assert not hasattr(tint, "brute_beside_mesh")


@pytest.mark.parametrize("moving", [False, True], ids=["k5_k7", "k6_k7_moving"])
def test_pair_gradient_equals_the_brute_search(moving):
    """The gradient step over the pair's records (the eager replay: a mesh)
    equals the brute search's bit for bit, and is finite."""
    _, ts, sd, cp = _scenes(moving)
    w, h = _size(ts)
    kw = dict(width=w, height=h, spp=1, max_depth=3)
    args = (torch.zeros((w * h, 3)), torch.arange(w * h), SEED)
    params = G.extract_params(sd, cp)
    loss, g = G.loss_and_grad(params, sd, cp, *args, **kw)
    b_loss, b_g = G.loss_and_grad(params, replace(sd, sph_perm=None, sph_cbounds=None), cp,
                                  *args, **kw)
    assert torch.isfinite(loss) and torch.equal(loss, b_loss)
    for key in ("mat_emission", "tex_color", "mat_fuzz"):
        assert torch.isfinite(g[key]).all() and torch.equal(g[key], b_g[key])


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_staged_record_of_a_mesh_beside_a_tree(moving):
    """``record_mode='staged'`` takes the scene too (K10 over the table in
    chunks, the mesh's BVH walk), and its words match the pair's record at
    ``tests/test_replay.py:280-290``'s bounds: the essential bits on > 0.99
    of entries, ids and flags on > 0.99 of the rows both record as hits."""
    _, ts, sd, cp = _scenes(moving)
    w, h = _size(ts)
    pix, smp = (torch.from_numpy(x) for x in _lanes(w, h))
    staged = trep.record_pass("staged", sd, cp, w, h, pix, smp, SEED, DEPTH)
    mega = trep.trace_record_mega(sd, cp, w, h, pix, smp, SEED, DEPTH)
    ess = tmk.F_ALIVE | tmk.F_HIT | tmk.F_SCAT
    assert ((staged & ess) == (mega & ess)).float().mean() > 0.99
    both = ((staged & mega) & tmk.F_HIT) > 0
    assert ((staged >> 8)[both] == (mega >> 8)[both]).float().mean() > 0.99
    assert ((staged & 255)[both] == (mega & 255)[both]).float().mean() > 0.99
    assert ((staged & tmk.F_TRI) > 0).any()
