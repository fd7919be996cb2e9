"""K7's triangle walk in the megakernel's flat loop (the DFS skip links, as
the TPU kernel and the plain version walk them): a constructed exact tie
between duplicated triangles in two leaves, the higher row's leaf entered
first, which the DFS walk breaks by DFS order; and the routes to the flat
triangle stage and the static tree walk. Imports no JAX; the card's tests
of the same are in ``tests/test_torch_mesh_card.py``, which imports
:func:`tie_scene`.
"""

from dataclasses import replace

import pytest
import torch

from crucible_tpu_torch.models import camera as tcam
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import scene as tscene
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests import torch_mesh_scenes as meshes
from tests.torch_threads import one_torch_thread  # noqa: F401


def tie_scene(moving=False):
    """The fan's scene (ground sphere, camera) with its mesh replaced by
    two copies of one large triangle facing the camera, each in a leaf of
    its own: leaf 1 (row 0) is the triangle's tight box, leaf 2 (row 1) the
    same box grown toward the camera, so a walk in entry order would meet
    row 1 first. Every ray that hits the triangle meets both rows at the
    same t, an exact tie, which the DFS walk breaks by taking row 0, the
    first in DFS order. ``moving``: the scene is animated (the mesh has zero
    shutter deltas), so the tables are K7 moving's. -> (scene data,
    camera, width, height), on the CPU."""
    sc = meshes.fan(tscene, 32)
    if moving:
        sc.translate_y(0.0, 1.0 / 48.0, "lerp", "local", "ground")
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    look_from, look_at = cp.look_from.double(), cp.look_at.double()
    n = look_from - look_at
    n = n / n.norm()
    u = torch.linalg.cross(torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64), n)
    u = u / u.norm()
    v = torch.linalg.cross(n, u)
    c = look_at + 0.5 * n
    tri = torch.stack([c - 4.0 * u - 3.0 * v, c + 4.0 * u - 3.0 * v, c + 4.0 * v]).float()
    v0, v1, v2 = (tri[j].repeat(2, 1) for j in range(3))
    lo, hi = tri.amin(0), tri.amax(0)
    grown_hi = hi + (n.float() * 2.0).clamp_min(0.0)
    grown_lo = lo + (n.float() * 2.0).clamp_max(0.0)
    i32 = torch.int32
    mesh = dict(
        tri_v0=v0, tri_v1=v1, tri_v2=v2, tri_mat=torch.zeros(2, dtype=i32),
        tri_active=torch.ones(2, dtype=torch.bool),
        bvh_min=torch.stack([torch.minimum(lo, grown_lo), lo, grown_lo]),
        bvh_max=torch.stack([torch.maximum(hi, grown_hi), hi, grown_hi]),
        bvh_first=torch.tensor([0, 0, 1], dtype=i32), bvh_count=torch.tensor([0, 1, 1], dtype=i32),
        bvh_miss=torch.tensor([3, 2, 3], dtype=i32), num_tris=2, use_bvh=True,
    )
    if moving:
        zero = torch.zeros((2, 3))
        mesh.update(tri_v0_d=zero, tri_v1_d=zero, tri_v2_d=zero)
    return replace(sd, **mesh), cp, sc.scene_cam.image_width, sc.scene_cam.image_height


@pytest.mark.parametrize("moving", [False, True], ids=["woop", "moving"])
def test_an_exact_tie_across_leaves_goes_to_the_dfs_winner(moving):
    """Duplicated coplanar triangles in two leaves, the higher row's leaf
    entered first: the plain walk and the megakernel's plain version (its
    records) take row 0, the first in DFS order."""
    sd, cp, w, h = tie_scene(moving=moving)
    assert tint.mesh_moves(sd) == moving
    nodes, tris, mats, meta = tint.make_tri_tables(sd)
    p = w * h
    o, d, wt = tcam.generate_rays(cp, w, h, torch.arange(p), torch.zeros(p, dtype=torch.int64),
                                  0)
    big = torch.full((p,), tmk.BIG)
    kw = dict(w=wt if moving else None)
    t, idx = tmk.tri_closest_reference(o, d, big, nodes, meta, tris, **kw)
    hit = t < tmk.BIG
    assert float(hit.float().mean()) > 0.5 and not idx.any()
    inputs, _ = tint.mega_inputs(sd, cp, w, h, 1, 4, 0)
    tri = dict(tri_nodes=nodes, tris=tris, mats=mats, tri_meta=meta)
    rec = tmk.run_megakernel_record(**inputs, **tri, max_depth=4, animated=moving)[1]
    words = rec[(rec & tmk.F_TRI) > 0]
    assert words.numel() > p // 2 and not (words // tmk.REC_ID_SCALE).any()


def test_routes_reach_the_flat_tree_and_triangle_instantiations(monkeypatch):
    """A static big table's render passes the scene's tree (K5: the launch
    counts as "walk"), a mesh's its triangle tables beside the brute search
    (K7: "tri"), and neither a tree and a mesh together."""
    seen = []
    real = tmk.run_megakernel

    def spy(*args, **kwargs):
        seen.append({k: v for k, v in kwargs.items() if v is not None})
        return real(*args, **kwargs)

    monkeypatch.setattr(tmk, "run_megakernel", spy)
    stress = tdemo.sphere_stress(width=16, copies=4)
    trender.render_image(stress, samples=1, max_depth=2, device="cpu")
    sd = stress.build(device="cpu")
    assert seen[-1]["swept_nodes"] is sd.sph_swept_nodes and "tri_nodes" not in seen[-1]
    assert tmk._variant(object(), None, False, False) == "walk"
    assert tmk._variant(object(), None, False, True) == "motion_walk"
    assert tmk._variant(object(), None, True, False) == "cull"
    trender.render_image(meshes.torus_teapot(tscene, 16), samples=1, max_depth=2,
                         device="cpu")
    assert "tri_nodes" in seen[-1] and "swept_nodes" not in seen[-1]
    assert tmk._variant(None, object(), False, False) == "tri"
    assert tmk._variant(None, object(), True, False) == "tri_motion"
