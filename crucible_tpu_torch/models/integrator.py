"""Path integrator: the wavefront bounce, the staged schedules and the
persistent megakernel schedule.

Port of ``crucible_tpu/models/integrator.py`` for sphere scenes, static
or moving on the linear shutter, and triangle meshes, static or moving:

- the staged wavefront: :func:`intersect_scene` (closest hits through
  ``ops/intersect.hit_spheres``, kernel K10, or for moving spheres the
  plain ``hit_spheres_moving``; a mesh's through ``hit_triangles`` up to
  ``scene.BVH_MIN_TRIS`` triangles, else the BVH walk
  ``ops/traverse.bvh_hit_triangles``), :func:`bounce_step`,
  :func:`trace` (with ``differentiable=True`` the checkpointed bounce loop
  that the direct-AD gradient runs) and :func:`render_rays`;
- the ``pixel`` schedule :func:`trace_persistent`, whose fused bounce
  :func:`bounce_step_fused` takes the winner's attributes from K9;
- the ``mega`` schedule :func:`trace_persistent_mega` (K1, or K5 walking
  the tree of a big static scene, K6 that of a big moving one; K8, their
  motion variants, for moving spheres or an animated camera; K7, the
  triangle-BVH stage after either search, for a BVH mesh, K7 moving for a
  moving one) with its
  inputs (the (N, 32) sphere attribute table, permuted into the tree's leaf
  order for a walk; the camera
  vector; a mesh's tables, :func:`make_tri_tables`) and the megakernel
  predicates.

Moving spheres and animated cameras draw each path's shutter fraction w
from the STREAM_TIME hash of its (pixel, sample), which the camera's ray
generation draws too, so a path's rays share one shutter instant.
Exact-time motion (a keyframe strictly inside the shutter window) takes
the staged bounce's exact branch: every sphere, and a ``tri_exact`` mesh's
vertices, evaluated from their timeline tracks at each ray's absolute time
(:func:`exact_sphere_winner`, :func:`exact_tri_vertices`), the (R, N, K)
evaluation in lane chunks of :func:`exact_lanes`; the megakernels and the
fused bounce refuse it, as the JAX package's do. The radiance recursion of the original renderer
unrolls into an iterative product over a flat batch of rays: on a miss
L += throughput * sky, on a hit L += throughput * emission, and on a
scatter throughput *= attenuation. Discrete decisions (hits, winners,
material branches, random numbers) are detached samples; continuous
quantities stay on the autograd tape.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from crucible_tpu_torch.models import materials as mat_mod
from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models import textures as tex_mod
from crucible_tpu_torch.models import timeline as tl_mod
from crucible_tpu_torch.models.camera import CameraParams, generate_rays
from crucible_tpu_torch.models.scene import SceneData
from crucible_tpu_torch.ops import intersect
from crucible_tpu_torch.ops.traverse import bvh_hit_triangles
from crucible_tpu_torch.ops.kernels import megakernel as mk
from crucible_tpu_torch.ops.kernels import sphere_shade
from crucible_tpu_torch.utils import rng as crng
from crucible_tpu_torch.utils import vec

T_MIN = mk.T_MIN  # shadow-acne epsilon
BIG = mk.BIG


# Bytes that one lane chunk of the exact branch's per-ray tables may take:
# the (R, N, K) track evaluation of every sphere (and of a brute mesh's
# vertices) at each ray's time. The JAX package caps its wavefront at 2^16
# lanes for the TPU compiler's memory estimate; the port derives its
# chunk from this budget, the rows and the segments (exact_lanes).
EXACT_BUDGET_BYTES = 4 << 30
# Bytes a (lane, sphere row) pair takes at the peak of one chunk: the
# centers' components and the search's (L, N) terms (EXACT_ROW_BYTES;
# chip_smoke.py main path 26c measures bouncing book1's, one translate
# segment and fixed radii: 60 B on an H100), each translate segment's ramp
# and terms (EXACT_SEGMENT_BYTES), eval_scale's (L, N, K, 3) gathers where
# a radius is keyed (EXACT_SCALE_BYTES); and a (lane, vertex row) pair of a
# brute mesh's (L, 3M) evaluation and Möller–Trumbore (EXACT_VERTEX_BYTES,
# and EXACT_SEGMENT_BYTES a segment).
EXACT_ROW_BYTES = 48
EXACT_SEGMENT_BYTES = 16
EXACT_SCALE_BYTES = 128
EXACT_VERTEX_BYTES = 256


def _check_staged(sd: SceneData) -> None:
    """Raise, naming what is missing, for what the staged path lacks."""
    if sd.num_tris > 0 and sd.tri_v0 is None:
        raise ValueError(f"the scene counts {sd.num_tris} triangles but carries no "
                         "triangle arrays (tri_v0, ...)")
    if sd.motion_exact and sd.sph_tr_t0 is None:
        raise ValueError("the scene says motion_exact but carries no exact-time sphere "
                         "tracks (sph_tr_*, sph_sc_*): lower it with Scene.build")
    if sd.motion_exact and sd.motion_t0 is None:
        raise ValueError("the scene says motion_exact but carries no shutter window "
                         "(motion_t0, motion_t1)")
    if sd.tri_exact and sd.tri_tr_t0 is None:
        raise ValueError("the scene says tri_exact but carries no exact-time vertex "
                         "tracks (tri_tr_*, tri_sc_*): lower it with Scene.build")


def exact_lanes(sd: SceneData) -> int:
    """Lanes of one chunk of the exact branch (:func:`intersect_scene`) for
    a motion_exact scene: ``EXACT_BUDGET_BYTES`` over what a lane's per-ray
    tables take (its sphere rows and a brute mesh's 3M vertex rows: the
    ``EXACT_*_BYTES`` constants), a multiple of 512, at least 512. Lanes
    are independent, so the chunking changes no bit of the result. A scene
    without exact time: no cap (the largest int64)."""
    if not sd.motion_exact or sd.sph_tr_t0 is None:
        return 1 << 62
    per_lane = sd.sph_tr_t0.shape[0] * (
        EXACT_ROW_BYTES + EXACT_SEGMENT_BYTES * sd.sph_tr_t0.shape[1]
        + (EXACT_SCALE_BYTES if sd.sph_sc_t0.shape[1] > 1 else 0))
    if sd.tri_exact and sd.num_tris > 0 and not sd.use_bvh and sd.tri_tr_t0 is not None:
        per_lane += sd.tri_tr_t0.shape[0] * (
            EXACT_VERTEX_BYTES + EXACT_SEGMENT_BYTES * (sd.tri_tr_t0.shape[1]
                                                       + sd.tri_sc_t0.shape[1]))
    return max(512, EXACT_BUDGET_BYTES // per_lane // 512 * 512)


def exact_chunks(sd: SceneData, r: int) -> list:
    """The lane slices of R lanes in chunks of :func:`exact_lanes`."""
    step = exact_lanes(sd)
    return [slice(lo, min(r, lo + step)) for lo in range(0, r, step)] or [slice(0, 0)]


def exact_time(sd: SceneData, w):
    """Each path's absolute time in a motion_exact scene's shutter window:
    motion_t0 + w * (motion_t1 - motion_t0)."""
    return sd.motion_t0 + w * (sd.motion_t1 - sd.motion_t0)


def exact_sphere_winner(sd: SceneData, i_s, t_ray):
    """The spheres ``i_s`` (R,) at the times ``t_ray`` (R,) -> (center (R,
    3), radius (R,)): their rows' tracks gathered and evaluated per lane,
    O(R K) (the record's and the replay's counterpart of the exact branch's
    (R, N) evaluation)."""
    i_s = i_s.long()

    def rows(x):
        return torch.index_select(x, 0, i_s)

    c_w = tl_mod.eval_translate_rows(rows(sd.sph_tr_t0), rows(sd.sph_tr_t1),
                                     rows(sd.sph_tr_delta), rows(sd.sph_tr_init), t_ray)
    r_w = tl_mod.eval_scale_rows(rows(sd.sph_sc_t0), rows(sd.sph_sc_t1), rows(sd.sph_sc_from),
                                 rows(sd.sph_sc_to), t_ray)[..., 0]
    return c_w, r_w


def exact_tri_vertices(sd: SceneData, pid, t_ray):
    """The vertices of triangles ``pid`` (any shape; leaf order for a BVH
    mesh) at the times ``t_ray`` (broadcast against ``pid``) -> (a, b, c),
    each pid.shape + (3,): each vertex's track rows (vertex-major, row vi *
    M + k) gathered and evaluated as scale(t) * translate(t), O(candidates
    x K), never (R, M)."""
    shape = pid.shape
    pid = pid.reshape(-1).long()
    t = torch.broadcast_to(t_ray, shape).reshape(-1)
    m_rows = sd.tri_v0.shape[0]
    out = []
    for vi in range(3):
        rows = pid + vi * m_rows

        def g(x):
            return torch.index_select(x, 0, rows)

        pos = tl_mod.eval_translate_rows(g(sd.tri_tr_t0), g(sd.tri_tr_t1), g(sd.tri_tr_delta),
                                         g(sd.tri_tr_init), t)
        scl = tl_mod.eval_scale_rows(g(sd.tri_sc_t0), g(sd.tri_sc_t1), g(sd.tri_sc_from),
                                     g(sd.tri_sc_to), t)
        out.append((scl * pos).reshape(shape + (3,)))
    return tuple(out)


def _exact_centers(sd: SceneData, t):
    """Every sphere's center at the times ``t`` (L,) -> its components cx,
    cy, cz, each (L, N): ``timeline.eval_translate``'s sum (init plus the
    segments' ramped deltas, in segment order) without its (L, N, K, 3)
    product."""
    tt = t[:, None]
    acc = None
    for k in range(sd.sph_tr_t0.shape[1]):
        r = tl_mod._ramp(tt, sd.sph_tr_t0[:, k], sd.sph_tr_t1[:, k])
        terms = [r * sd.sph_tr_delta[:, k, i] for i in range(3)]
        acc = terms if acc is None else [a + b for a, b in zip(acc, terms)]
    return [sd.sph_tr_init[:, i] + a for i, a in enumerate(acc)]


def _exact_search(sd: SceneData, o, d, t_ray):
    """The exact branch's searches of every sphere, and of a brute
    ``tri_exact`` mesh's triangles, evaluated at each ray's time, in lane
    chunks of :func:`exact_lanes` -> ((t, idx) of the spheres, outside
    autograd (:func:`intersect_scene` puts t on the tape through the
    winners), and (t, idx, hit) of the triangles or None)."""
    brute_tris = sd.tri_exact and sd.num_tris > 0 and not sd.use_bvh
    act = sd.sph_active.to(torch.bool)[None]
    sph, tri = [], []
    for sl in exact_chunks(sd, o.shape[0]):
        t = t_ray[sl]
        if sd.sph_sc_t0.shape[1] == 1:
            # Only the init segments (no radius keyed): eval_scale gives
            # their from-value at every time past -0.1, bit for bit.
            radii = sd.sph_sc_from[None, :, 0, 0]
        else:
            radii = tl_mod.eval_scale(sd.sph_sc_t0, sd.sph_sc_t1, sd.sph_sc_from,
                                      sd.sph_sc_to, t)[..., 0]  # (L, N)
        sph.append(intersect.per_ray_closest(o[sl], d[sl], *_exact_centers(sd, t), radii, act,
                                             T_MIN))
        if brute_tris:
            # Every vertex at the ray's time: scale(t) * translate(t), (L, 3M, 3).
            verts = tl_mod.eval_scale(sd.tri_sc_t0, sd.tri_sc_t1, sd.tri_sc_from,
                                      sd.tri_sc_to, t) * tl_mod.eval_translate(
                sd.tri_tr_t0, sd.tri_tr_t1, sd.tri_tr_delta, sd.tri_tr_init, t)
            m_rows = sd.tri_v0.shape[0]
            tri.append(intersect.hit_triangles(
                o[sl], d[sl], verts[:, :m_rows], verts[:, m_rows:2 * m_rows],
                verts[:, 2 * m_rows:], sd.tri_active, T_MIN))
    cat = [torch.cat(x) for x in zip(*sph)]
    return cat, ([torch.cat(x) for x in zip(*tri)] if brute_tris else None)


def _motion_deltas(sd: SceneData):
    """(center deltas (N, 3), radius deltas (N,)): the scene's, or zeros
    where it has none."""
    if sd.sph_center_d is not None:
        return sd.sph_center_d, sd.sph_radius_d
    return torch.zeros_like(sd.sph_center), torch.zeros_like(sd.sph_radius)


def mesh_moves(sd: SceneData) -> bool:
    """Whether the scene's mesh moves: every mesh of an animated scene
    (the lowering gives it shutter deltas, zeros where a triangle has no
    keyframes). Such a mesh is tested at each ray's shutter fraction and
    its triangle tables take the moving (M, 32) layout."""
    return bool(sd.animated) and sd.tri_v0_d is not None


def shutter_fraction(pixel_ids, sample_ids, seed):
    """Each path's shutter fraction w in [0, 1): the first uniform of its
    STREAM_TIME hash, as the camera draws it."""
    return crng.uniform1(pixel_ids, sample_ids, crng.STREAM_TIME, seed)


def intersect_scene(sd: SceneData, o, d, w=None):
    """Closest hit against the scene's spheres and triangles; an animated
    scene's spheres and meshes at the rays' shutter fractions ``w`` (R,)
    (a moving mesh's vertices lerped per candidate, the winner's lerped
    again for its normal, as the JAX package does). A triangle
    wins only where it is strictly nearer than the nearest sphere; its
    normal is the geometric one, its uv (0, 0).

    A motion_exact scene takes the exact branch: every sphere (and a
    ``tri_exact`` mesh's vertices: a brute mesh's all, a BVH mesh's per
    leaf candidate through the walk's ``vertex_fn``) at each ray's absolute
    time ``exact_time(sd, w)``, the winner's again for its normal
    (:func:`exact_sphere_winner`, :func:`exact_tri_vertices`).

    Returns a dict of per-ray tensors: hit (bool), t, point (R, 3), normal
    (R, 3) the unit normal flipped against d, front (bool), u, v, mat
    (int64), i_sph and i_tri (the winning rows) and is_tri."""
    _check_staged(sd)
    exact = sd.animated and sd.motion_exact
    tri_hits = None
    if exact:
        if w is None:
            raise ValueError("an animated scene needs per-ray shutter fractions w")
        t_ray = exact_time(sd, w)
        (t, i_s), tri_hits = _exact_search(sd, o, d, t_ray)
        hit = t < BIG
        c_w, r_w = exact_sphere_winner(sd, i_s, t_ray)
        t = intersect.winner_t(o, d, t, hit, c_w, r_w)
    elif sd.animated:
        if w is None:
            raise ValueError("an animated scene needs per-ray shutter fractions w")
        cd, rd = _motion_deltas(sd)
        t, i_s, hit = intersect.hit_spheres_moving(
            o, d, w, sd.sph_center, cd, sd.sph_radius, rd, sd.sph_active, T_MIN
        )
    else:
        t, i_s, hit = intersect.hit_spheres(
            o, d, sd.sph_center, sd.sph_radius, sd.sph_active, T_MIN
        )
    i_s = i_s.to(torch.int64)
    # A moving mesh: every vertex at the ray's shutter fraction.
    tri_exact = exact and sd.tri_exact
    moving = mesh_moves(sd) and not tri_exact
    motion = dict(v0d=sd.tri_v0_d, v1d=sd.tri_v1_d, v2d=sd.tri_v2_d, w=w) if moving else {}
    if tri_exact and sd.use_bvh:
        motion = dict(vertex_fn=lambda lanes, rows: exact_tri_vertices(
            sd, rows, t_ray[lanes][:, None]))
    if sd.num_tris > 0:
        if tri_hits is not None:
            t_t, i_t, hit_t = tri_hits
        elif sd.use_bvh:
            t_t, i_t, hit_t = bvh_hit_triangles(
                o, d, sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.bvh_min, sd.bvh_max,
                sd.bvh_first, sd.bvh_count, sd.bvh_miss, T_MIN, BIG, sd.bvh_leaf_size,
                **motion,
            )
        else:
            t_t, i_t, hit_t = intersect.hit_triangles(
                o, d, sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.tri_active, T_MIN, **motion
            )
        i_t = i_t.to(torch.int64)
        is_tri = hit_t & (t_t < t)  # strict: a sphere wins an exact tie
        hit = hit | is_tri
        t = torch.where(is_tri, t_t, t)
    # Miss lanes carry t = BIG; the shading point uses t = 1 there so that
    # masked-out lanes stay finite (0 * inf would NaN their gradients).
    t_shade = torch.where(hit, t, 1.0)
    point = o + t_shade[:, None] * d
    if not exact:  # the exact branch has its winners' spheres already
        c_w = torch.index_select(sd.sph_center, 0, i_s)
        r_w = torch.index_select(sd.sph_radius, 0, i_s)
        if sd.animated:
            c_w = c_w + w[:, None] * torch.index_select(cd, 0, i_s)
            r_w = r_w + w * torch.index_select(rd, 0, i_s)
    n_out = (point - c_w) / torch.clamp_min(r_w, 1e-20)[:, None]
    u, v = intersect.sphere_uv(n_out)
    mat = torch.index_select(sd.sph_mat, 0, i_s).to(torch.int64)
    out = dict(i_sph=i_s)
    if sd.num_tris > 0:
        if tri_exact:
            verts = exact_tri_vertices(sd, i_t, t_ray)
        else:
            verts = [torch.index_select(x, 0, i_t) for x in (sd.tri_v0, sd.tri_v1, sd.tri_v2)]
        if moving:  # the winner's vertices at the ray's shutter fraction
            verts = [v + w[:, None] * torch.index_select(vd, 0, i_t)
                     for v, vd in zip(verts, (sd.tri_v0_d, sd.tri_v1_d, sd.tri_v2_d))]
        n_tri = intersect.triangle_normal(*verts)
        n_out = torch.where(is_tri[:, None], n_tri, n_out)
        mat = torch.where(is_tri, torch.index_select(sd.tri_mat, 0, i_t).to(torch.int64), mat)
        u = torch.where(is_tri, 0.0, u)  # triangle uv is (0, 0), as in the original
        v = torch.where(is_tri, 0.0, v)
        out.update(i_tri=i_t, is_tri=is_tri)
    front = vec.dot(d, n_out) < 0.0
    normal = torch.where(front[:, None], n_out, -n_out)
    return dict(hit=hit, t=t, point=point, normal=normal, front=front, u=u, v=v,
                mat=mat, **out)


def _bounce_uniforms(pixel_ids, sample_ids, bounce, seed):
    """The bounce's three uniforms: direction u1, u2 and the decision."""
    if isinstance(bounce, torch.Tensor):
        bounce = bounce.to(torch.int64)
    return crng.uniform3(pixel_ids, sample_ids, crng.STREAM_BOUNCE_BASE + bounce, seed)


def bounce_step(sd: SceneData, o, d, pixel_ids, sample_ids, bounce, seed,
                return_decisions: bool = False):
    """One wavefront bounce: intersect, shade, sample the next direction.

    ``bounce`` is an int (lockstep loop) or an (R,) tensor (each lane at
    its own depth). An animated scene is intersected at each path's
    shutter fraction (:func:`shutter_fraction`). Returns a dict: contrib (R, 3), the radiance before the
    throughput weighting (sky on a miss, emission on a hit); hit,
    scattered (R,) bool; new_o, new_d, atten (R, 3). With
    ``return_decisions`` also decisions (dict of the dielectric's reflect
    choice and the Lambertian degeneracy), front, i_sph, and i_tri and
    is_tri (the winning triangle and whether it won; zeros and False
    without a mesh).
    """
    w = shutter_fraction(pixel_ids, sample_ids, seed) if sd.animated else None
    h = intersect_scene(sd, o, d, w)
    hit, mat = h["hit"], h["mat"]
    sky = sky_mod.radiance(sd.sky_kind, sd.sky_image, d)
    emission = torch.index_select(sd.mat_emission, 0, mat)
    contrib = torch.where(hit[:, None], emission, sky)
    albedo = tex_mod.value(sd.tex, torch.index_select(sd.mat_tex, 0, mat),
                           h["u"], h["v"], h["point"])
    u1, u2, u_dec = _bounce_uniforms(pixel_ids, sample_ids, bounce, seed)
    new_d, atten, scattered, refl, degen = mat_mod.scatter(
        torch.index_select(sd.mat_type, 0, mat),
        torch.index_select(sd.mat_fuzz, 0, mat),
        torch.index_select(sd.mat_ior, 0, mat),
        torch.index_select(sd.mat_prob, 0, mat),
        albedo, d, h["normal"], h["front"], u1, u2, u_dec,
    )
    out = dict(contrib=contrib, hit=hit, scattered=scattered, new_o=h["point"],
               new_d=new_d, atten=atten)
    if return_decisions:
        out.update(decisions=dict(reflect=refl, degenerate=degen),
                   front=h["front"], i_sph=h["i_sph"],
                   i_tri=h.get("i_tri", torch.zeros_like(h["i_sph"])),
                   is_tri=h.get("is_tri", torch.zeros_like(hit)))
    return out


def _trace_bounce(sd, pixel_ids, sample_ids, seed, bounce, o, d, thr, rad, alive):
    """One bounce of :func:`trace`'s lockstep loop -> the next carry."""
    s = bounce_step(sd, o, d, pixel_ids, sample_ids, bounce, seed)
    rad = rad + torch.where(alive[:, None], thr * s["contrib"], 0.0)
    alive = alive & s["hit"] & s["scattered"]
    keep = alive[:, None]
    thr = torch.where(keep, thr * s["atten"], thr)
    o = torch.where(keep, s["new_o"], o)
    d = torch.where(keep, s["new_d"], d)
    return o, d, thr, rad, alive


def trace(sd: SceneData, o, d, pixel_ids, sample_ids, seed, max_depth: int,
          differentiable: bool = False):
    """Integrate radiance for a wavefront of primary rays -> (R, 3).

    Lockstep bounce loop. ``differentiable=False`` loops while any ray is
    alive (at most ``max_depth`` bounces); ``differentiable=True`` runs all
    ``max_depth`` bounces, each under ``torch.utils.checkpoint``, so that
    the backward pass holds one bounce's intermediates at a time (it
    recomputes each bounce's forward). The two give identical results.
    """
    r = o.shape[0]
    thr = torch.ones((r, 3), dtype=torch.float32, device=o.device)
    rad = torch.zeros((r, 3), dtype=torch.float32, device=o.device)
    alive = torch.ones((r,), dtype=torch.bool, device=o.device)
    carry = (o, d, thr, rad, alive)
    args = (sd, pixel_ids, sample_ids, seed)
    for bounce in range(max_depth):
        if differentiable:
            carry = checkpoint(_trace_bounce, *args, bounce, *carry,
                               use_reentrant=False, preserve_rng_state=False)
        elif bool(carry[4].any()):
            carry = _trace_bounce(*args, bounce, *carry)
        else:
            break
    return carry[3]


def render_rays(sd: SceneData, cp: CameraParams, width: int, height: int,
                pixel_ids, sample_ids, seed, max_depth: int,
                differentiable: bool = False):
    """Primary-ray generation + path tracing for (pixel, sample) pairs ->
    radiance (R, 3)."""
    o, d, _ = generate_rays(cp, width, height, pixel_ids, sample_ids, seed)
    return trace(sd, o, d, pixel_ids, sample_ids, seed, max_depth,
                 differentiable=differentiable)


def make_sphere_table(sd: SceneData) -> torch.Tensor:
    """Per-sphere attribute table (N, 32) float32 in the layout of the JAX
    package (``crucible_tpu/ops/pallas/sphere_shade.py``):

      0-2 center, 3 radius, 4 |c|^2 - r^2, 5 active, 6 material type,
      7 fuzz, 8 ior, 9 scatter prob, 10-12 emission, 13 texture kind,
      14-16 solid color, 17 checker 1/scale, 18-20 even color,
      21-23 odd color, 24-26 center delta, 27 radius delta, 28 s1 =
      c.cd - r rd, 29 s2 = |cd|^2 - rd^2, 30 texture id, 31 row id.

    The motion columns 24-29 are zeros for a static scene."""
    n = sd.sph_center.shape[0]
    mat = sd.sph_mat.long()
    tid = sd.mat_tex[mat].long()
    even_id = sd.tex.even[tid].long()
    odd_id = sd.tex.odd[tid].long()
    c = sd.sph_center
    r = sd.sph_radius
    emission = sd.mat_emission[mat]
    color = sd.tex.color[tid]
    even = sd.tex.color[even_id]
    odd = sd.tex.color[odd_id]
    cd, rd = _motion_deltas(sd)
    cols = [
        c[:, 0], c[:, 1], c[:, 2],
        r,
        c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r,
        sd.sph_active.to(torch.float32),
        sd.mat_type[mat].to(torch.float32),
        sd.mat_fuzz[mat],
        sd.mat_ior[mat],
        sd.mat_prob[mat],
        emission[:, 0], emission[:, 1], emission[:, 2],
        sd.tex.kind[tid].to(torch.float32),
        color[:, 0], color[:, 1], color[:, 2],
        sd.tex.inv_scale[tid],
        even[:, 0], even[:, 1], even[:, 2],
        odd[:, 0], odd[:, 1], odd[:, 2],
        cd[:, 0], cd[:, 1], cd[:, 2],
        rd,
        c[:, 0] * cd[:, 0] + c[:, 1] * cd[:, 1] + c[:, 2] * cd[:, 2] - r * rd,
        cd[:, 0] * cd[:, 0] + cd[:, 1] * cd[:, 1] + cd[:, 2] * cd[:, 2] - rd * rd,
        tid.to(torch.float32),
        torch.arange(n, dtype=torch.float32, device=c.device),
    ]
    return torch.stack(cols, dim=1)


def make_tri_tables(sd: SceneData):
    """The megakernel's triangle inputs (K7) from a BVH mesh -> (tri_nodes
    (K, 6) float32, tris (M, 16) or, for a moving mesh, (M, 32) float32,
    mats (NM, 24) float32, tri_meta (K, 3) int32).

    - ``tri_nodes``: node box min (0-2) and max (3-5);
    - ``tri_meta``: [first, count, miss] per node (first indexes ``tris``);
    - ``tris``, one row per triangle in leaf order. A static mesh's rows
      are the JAX package's Woop layout: columns 0-11 the affine map of
      world space onto the unit triangle (rows a0, a1, a2 of
      [e1 e2 nu]^-1 with nu = e1 x e2 unnormalized, and b = -(a_i . v0)),
      12-14 the unit normal, 15 the material id; a degenerate triangle
      (|nu|^2 <= 1e-30) gets a zero map, which the kernel's d'_z guard
      rejects. A moving mesh's (:func:`mesh_moves`: every mesh of an
      animated scene) are its Möller–Trumbore layout: v0 (0-2), e1 = v1 -
      v0 (3-5), e2 = v2 - v0 (6-8), the unit normal at shutter open
      (9-11), the material id (12), zeros (13-15), then the shutter deltas
      v0d (16-18), e1d = v1d - v0d (19-21), e2d = v2d - v0d (22-24) and
      zeros (25-31);
    - ``mats``: one row per material, sphere-table columns 6-23 (type,
      fuzz, ior, prob, emission, texture kind, color, 1/scale, even and odd
      colors), the texture id in 18, zeros after it. It is differentiable
      in the texture colors, emission and fuzz (the eager replay reads it).

    The TPU kernel's zero-row padding, node windows' guard rows and the
    float copies of the node metadata are not carried: the CUDA kernel
    loops to each leaf's count. Every product and sum is its own torch
    operation in the JAX package's association, so the card and the CPU
    build the same bits."""
    v0, v1, v2 = sd.tri_v0, sd.tri_v1, sd.tri_v2
    e1, e2 = v1 - v0, v2 - v0
    if mesh_moves(sd):
        zeros = torch.zeros((v0.shape[0], 3), dtype=torch.float32, device=v0.device)
        tris = torch.cat([v0, e1, e2, intersect.triangle_normal(v0, v1, v2),
                          sd.tri_mat.to(torch.float32)[:, None], zeros, sd.tri_v0_d,
                          sd.tri_v1_d - sd.tri_v0_d, sd.tri_v2_d - sd.tri_v0_d, zeros,
                          zeros, zeros[:, :1]], dim=1)
        return _tri_tables(sd, tris)

    def cross(a, b):  # a x b, component by component
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    c1, c2 = e1.unbind(1), e2.unbind(1)
    nu = cross(c1, c2)
    det = dot(nu, nu)
    good = torch.abs(det) > 1e-30
    inv = 1.0 / torch.where(good, det, 1.0)
    ok = good.to(torch.float32)
    a0 = tuple(x * inv * ok for x in cross(c2, nu))
    a1 = tuple(x * inv * ok for x in cross(nu, c1))
    a2 = tuple(x * inv * ok for x in nu)
    p = v0.unbind(1)
    b = (-dot(a0, p), -dot(a1, p), -dot(a2, p))
    n = intersect.triangle_normal(v0, v1, v2)
    tris = torch.stack([*a0, *a1, *a2, *b, *n.unbind(1), sd.tri_mat.to(torch.float32)], dim=1)
    return _tri_tables(sd, tris)


def _tri_tables(sd: SceneData, tris):
    """:func:`make_tri_tables`' result around its ``tris``."""
    tri_nodes = torch.cat([sd.bvh_min, sd.bvh_max], dim=1)
    tri_meta = torch.stack([sd.bvh_first, sd.bvh_count, sd.bvh_miss], dim=1).to(torch.int32)

    tid = sd.mat_tex.long()
    even_id, odd_id = sd.tex.even[tid].long(), sd.tex.odd[tid].long()
    f32 = torch.float32
    mats = torch.cat([
        sd.mat_type.to(f32)[:, None], sd.mat_fuzz[:, None], sd.mat_ior[:, None],
        sd.mat_prob[:, None], sd.mat_emission, sd.tex.kind[tid].to(f32)[:, None],
        torch.index_select(sd.tex.color, 0, tid), sd.tex.inv_scale[tid][:, None],
        torch.index_select(sd.tex.color, 0, even_id), torch.index_select(sd.tex.color, 0, odd_id),
        tid.to(f32)[:, None], torch.zeros((tid.shape[0], 5), dtype=f32, device=tid.device),
    ], dim=1)
    return (tri_nodes.contiguous(), tris.contiguous(), mats.contiguous(),
            tri_meta.contiguous())


def _mesh_unsupported_reason(sd: SceneData, cp: CameraParams):
    """None where the megakernel's triangle stage takes the scene's mesh (or
    there is none), else what it lacks. K7 walks a BVH mesh after the
    sphere search, whichever it is (the brute search, K5's tree walk or
    K6's swept-tree walk): a static mesh, or a moving one (every mesh of an
    animated scene, K7 moving), seen by a static or an animated camera."""
    if sd.num_tris == 0:
        return None
    checks = (
        (sd.use_bvh,
         "a triangle mesh without a BVH (at most 64 triangles: the megakernel's "
         "triangle stage, K7, walks a BVH, in record mode too; such meshes take the "
         "pixel schedule, as in the JAX package)"),
        (not sd.tri_exact, "exact-time motion of a mesh, a keyframe inside the shutter "
                           "(the staged bounce's exact branch takes it, as in the JAX "
                           "package)"),
    )
    return next((what for ok, what in checks if not ok), None)


def megakernel_supported(sd: SceneData, cp: CameraParams) -> bool:
    """The port's megakernel renders sphere scenes, static or moving on the
    linear shutter, and BVH meshes, static or moving on the linear shutter
    (K7 and K7 moving), beside any sphere table, with solid /
    checker-of-solid textures under the default sky, seen by a static or
    linearly animated camera. :func:`megakernel_unsupported_reason` names
    what is missing."""
    return megakernel_unsupported_reason(sd, cp) is None


def megakernel_unsupported_reason(sd: SceneData, cp: CameraParams):
    """None if the megakernel renders this scene, else the missing feature."""
    checks = (
        (len(sd.tex.images) == 0, "image textures"),
        (sd.tex.max_nest <= 1, "nested checker textures"),
        (sd.sky_kind == sky_mod.DEFAULT, "the spherical sky"),
        (not sd.motion_exact and not cp.motion_exact, "exact-time motion"),
    )
    return next((what for ok, what in checks if not ok), _mesh_unsupported_reason(sd, cp))


def megakernel_record_supported(sd: SceneData, cp: CameraParams) -> bool:
    """The port's subset of the JAX record-mode predicate
    (``crucible_tpu/models/integrator.py:705-735``): sphere scenes, static
    or moving on the linear shutter, seen by a static or linearly animated
    camera (K8's record mode for motion), with at most ``mk.MAX_ROWS``
    table rows or with the sphere-BVH tables (``sd.sph_perm``) that the
    walk takes instead (K5); a moving table with the chunk-cull tables
    (``sd.sph_cbounds`` and the swept tree, K6), or without them at most
    ``mk.MAX_ROWS_ANIMATED`` rows for the brute search; and BVH meshes,
    static or moving, beside any of these (K7, K7 moving). The
    record's decisions read no albedo or sky, so textures and the sky do
    not limit it."""
    return megakernel_record_unsupported_reason(sd, cp) is None


def megakernel_record_unsupported_reason(sd: SceneData, cp: CameraParams):
    """None if the record megakernel takes this scene, else what it lacks."""
    n = int(sd.sph_center.shape[0])
    if sd.animated:
        rows_ok = sd.sph_cbounds is not None or (
            n <= mk.MAX_ROWS_ANIMATED and sd.sph_perm is None)
        rows_what = (
            f"more than {mk.MAX_ROWS_ANIMATED} moving sphere rows without the "
            "chunk-cull tables (sph_cbounds, and the swept tree that K6 walks), or "
            "moving spheres with the sphere-BVH tables, whose boxes do not follow them"
        )
    else:
        rows_ok = n <= mk.MAX_ROWS or sd.sph_perm is not None
        rows_what = f"more than {mk.MAX_ROWS} sphere rows without the sphere-BVH tables"
    checks = (
        (not sd.motion_exact and not cp.motion_exact,
         "exact-time motion, a keyframe inside the shutter (the staged record takes it, "
         "as in the JAX package)"),
        (rows_ok, rows_what),
    )
    return next((what for ok, what in checks if not ok), _mesh_unsupported_reason(sd, cp))


def swept_tree(sd: SceneData):
    """The tree the megakernel walks -> (perm, nodes, meta), else None: a
    static scene's that carries the sphere-BVH tables (``sd.sph_perm``, K5)
    or an animated scene's that carries the chunk-cull tables
    (``sd.sph_cbounds``, K6). ``Scene.build`` and the bridge make the tree
    (``sph_swept_*``) wherever they make those tables; those tables without
    it raise ``ValueError``. The route reads the JAX lowering's tables, as
    the JAX package's does, so a scene takes K5 or K6 where the JAX package
    takes its sphere-BVH or chunk-cull branch, and a scene stripped of them
    takes the brute search (as the JAX parity tests strip it)."""
    if (sd.sph_cbounds if sd.animated else sd.sph_perm) is None:
        return None
    if sd.sph_swept_nodes is None:
        raise ValueError(
            f"this {'animated' if sd.animated else 'static'} scene carries the "
            f"{'chunk-cull clusters (sph_cbounds)' if sd.animated else 'sphere BVH (sph_perm)'}"
            " but not the swept tree that the megakernel walks (sph_swept_perm, "
            "sph_swept_nodes, sph_swept_meta): lower it with Scene.build or "
            "bridge.scene_data_from_arrays"
        )
    return sd.sph_swept_perm, sd.sph_swept_nodes, sd.sph_swept_meta


def permute_table(table: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The sphere table in BVH leaf order: zero rows appended up to
    len(perm) (the ids >= N that ``perm`` ends with), then rows taken in
    ``perm`` order. Column 31 keeps each row's original id."""
    n_pad = perm.shape[0]
    if n_pad > table.shape[0]:
        table = torch.nn.functional.pad(table, (0, 0, 0, n_pad - table.shape[0]))
    return torch.index_select(table, 0, perm.long()).contiguous()


def mega_cam_vector(cp: CameraParams, width: int, height: int) -> torch.Tensor:
    """Camera-constant vector (1, 48) for the megakernel: the static-camera
    specialization of ``camera.generate_rays`` (same formulas and eps;
    layout at ``megakernel.CAM_SIZE``)."""
    lf, la = cp.look_from, cp.look_at
    w_b = vec.unit(lf - la, eps=1e-12)
    u_b = vec.unit(vec.cross(cp.vup, w_b), eps=1e-12)
    v_b = vec.cross(w_b, u_b)
    h = torch.tan(cp.vfov_rad / 2.0)
    viewport_h = 2.0 * h * cp.focus_dist
    viewport_w = viewport_h * (width / height)
    du = viewport_w * u_b / width
    dv = viewport_h * (-v_b) / height
    pixel00 = (
        lf - cp.focus_dist * w_b - 0.5 * (width - 1) * du - 0.5 * (height - 1) * dv
    )
    defr = cp.focus_dist * torch.tan(cp.defocus_angle_rad / 2.0)
    defr = torch.where(cp.defocus_angle_rad > 0.0, defr, 0.0)
    f32 = dict(dtype=torch.float32, device=lf.device)
    return torch.cat(
        [
            pixel00, du, dv, lf, u_b, v_b, defr[None],
            # Animated-camera slots 19-37 (megakernel.py layout).
            la, cp.look_from_d, cp.look_at_d, cp.vup,
            viewport_h[None], viewport_w[None], cp.focus_dist[None],
            torch.tensor([width, height], **f32),
            torch.tensor([0.5 * (width - 1), 0.5 * (height - 1)], **f32),
            torch.zeros((10,), **f32),
        ]
    ).to(torch.float32).reshape(1, mk.CAM_SIZE)


def mega_inputs(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed: int,
    sample_start: int = 0,
    row0: int = 0,
    band_height: int | None = None,
):
    """The megakernel's inputs for a render of samples
    ``sample_start``..``spp - 1`` of the image rows [row0, row0 +
    band_height) (the whole image by default), and the un-swizzle.

    Returns (inputs, lane_of): ``inputs`` holds ``smem``, ``pix``,
    ``sample0``, ``cam`` and ``table`` for ``megakernel.run_megakernel``;
    ``lane_of`` (width*band_height,) maps each pixel of the band, in row
    order from row0, to its lane.

    Lanes are laid out in 32x16 pixel blocks of ``megakernel.TILE`` lanes,
    so that neighbouring lanes trace neighbouring pixels; a lane traces its
    pixel's samples from ``sample0 = sample_start`` to ``smem[0] = spp``,
    and lanes past the band's or the image's edge carry ``sample0 =
    2**30`` and never issue. ``width`` and ``height`` stay the whole
    image's: the camera and the pixel ids a band's lanes carry (the random
    streams' keys) are the whole image's, so a band's pixels are summed as
    the whole image's are (``parallel.render``).
    """
    if not 0 <= sample_start < spp:
        raise ValueError(f"sample_start {sample_start} must lie in [0, spp = {spp})")
    if band_height is None:
        band_height = height
    if row0 < 0 or band_height < 1:
        raise ValueError(f"a band needs row0 >= 0 and band_height >= 1, got {row0}, "
                         f"{band_height}")
    dev = sd.sph_center.device
    bw, bh = 32, mk.TILE // 32
    gx = (width + bw - 1) // bw
    gy = (band_height + bh - 1) // bh
    r = gx * gy * mk.TILE
    lane = torch.arange(r, dtype=torch.int64, device=dev)
    tile, q = lane // mk.TILE, lane % mk.TILE
    px = (tile % gx) * bw + q % bw
    py = (tile // gx) * bh + q // bw + row0  # the image's row
    valid = (px < width) & (py < row0 + band_height) & (py < height)
    pix = (
        torch.clamp_max(py, height - 1) * width + torch.clamp_max(px, width - 1)
    ).to(torch.int32).reshape(1, r)
    sample0 = torch.where(valid, sample_start, 2**30).to(torch.int32).reshape(1, r)
    p = torch.arange(width * band_height, dtype=torch.int64, device=dev)
    ppx, ppy = p % width, p // width
    lane_of = ((ppy // bh) * gx + ppx // bw) * mk.TILE + (ppy % bh) * bw + ppx % bw

    smem = torch.tensor(
        [mk.as_i32(spp), mk.as_i32(seed), width, max_depth, 0, 0, 0, 0],
        dtype=torch.int32,
        device=dev,
    )
    inputs = dict(
        smem=smem,
        pix=pix,
        sample0=sample0,
        cam=mega_cam_vector(cp, width, height),
        table=make_sphere_table(sd),
    )
    return inputs, lane_of


def trace_persistent_mega(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed: int,
    perm=None,
    sphere_nodes=None,
    sphere_meta=None,
    sample_start: int = 0,
    row0: int = 0,
    band_height: int | None = None,
) -> torch.Tensor:
    """Whole render in one megakernel call -> per-pixel radiance SUM
    (width*height, 3) over samples ``sample_start``..spp-1 (a chunk of a
    render with progress; its sums add the chunks' in another float32
    order than one call). ``row0`` / ``band_height``: only the rows [row0,
    row0 + band_height) of the width x height image -> (width*band_height,
    3), rows past the image's last zero (:func:`mega_inputs`); each sum is
    the whole image's for that pixel, bit for bit (``parallel.render``).

    ``perm`` (N_pad,) int32 with ``sphere_nodes`` (K, 16) float32 and
    ``sphere_meta`` (3 * (K + 16),) int32 are ``mk.swept_tables``' outputs
    (:func:`swept_tree`): the table is then padded and permuted into the
    tree's leaf order and the kernel walks the tree (K5 for a static table,
    K6 for a moving one). Without them it tests every row (K1, K8). The
    sums are the same, bit for bit. A BVH mesh's tables
    (:func:`make_tri_tables`) go to the kernel's triangle stage (K7, or K7
    moving for a moving mesh's (M, 32) rows). Every random number is
    pcg4d(pixel, sample, stream, seed), so the per-pixel sums do not depend
    on the lane order (see :func:`mega_inputs`).
    """
    if (perm is None) != (sphere_nodes is None) or (sphere_nodes is None) != (
            sphere_meta is None):
        raise ValueError("perm, sphere_nodes and sphere_meta go together")
    inputs, lane_of = mega_inputs(sd, cp, width, height, spp, max_depth, seed, sample_start,
                                  row0, band_height)
    if perm is not None:
        inputs["table"] = permute_table(inputs["table"], perm)
        inputs.update(swept_nodes=sphere_nodes, swept_meta=sphere_meta)
    if sd.num_tris > 0:
        inputs.update(zip(("tri_nodes", "tris", "mats", "tri_meta"), make_tri_tables(sd)))
    acc = mk.run_megakernel(**inputs, animated=bool(sd.animated),
                            cam_animated=bool(cp.animated))
    return acc.t()[lane_of]


def fused_supported(sd: SceneData) -> bool:
    """The fused gather-free bounce applies to sphere-only scenes whose
    textures are solid / checker-of-solid (the table bakes one level of
    checker colors, and uv is not computed), static or moving on the
    linear shutter. The spherical sky is fine: it is sampled outside the
    kernel. Exact per-ray-time motion stays on the staged bounce."""
    return (
        sd.num_tris == 0
        and len(sd.tex.images) == 0
        and sd.tex.max_nest <= 1
        and not sd.motion_exact
    )


def bounce_step_fused(sd: SceneData, table, o, d, pixel_ids, sample_ids, bounce, seed):
    """Gather-free bounce for sphere scenes: K9 (``hit_spheres_fetch``)
    returns the winner's shading attributes with its hit, so everything
    after it is elementwise (no sphere-uv either: uv feeds only image
    textures, absent here). An animated scene's spheres move to each path's
    shutter fraction; a static scene passes w = 0. Returns
    :func:`bounce_step`'s dict."""
    _check_staged(sd)
    if sd.animated:
        w = shutter_fraction(pixel_ids, sample_ids, seed)
    else:
        w = torch.zeros((o.shape[0],), dtype=torch.float32, device=o.device)
    out = sphere_shade.hit_spheres_fetch(o.contiguous(), d.contiguous(), w, table, T_MIN)
    t = out[0]
    hit = t < BIG
    center = out[2:5].t() + w[:, None] * out[24:27].t()
    radius = out[5] + w * out[27]
    point = o + torch.where(hit, t, 1.0)[:, None] * d
    n_out = (point - center) / torch.clamp_min(radius, 1e-20)[:, None]
    front = vec.dot(d, n_out) < 0.0
    normal = torch.where(front[:, None], n_out, -n_out)

    sky = sky_mod.radiance(sd.sky_kind, sd.sky_image, d)
    contrib = torch.where(hit[:, None], out[10:13].t(), sky)

    # Texture: solid or 3-D checker of solids.
    is_even = tex_mod.checker_is_even(out[17], point)
    checker = torch.where(is_even[:, None], out[18:21].t(), out[21:24].t())
    albedo = torch.where((out[13] == tex_mod.CHECKER)[:, None], checker, out[14:17].t())

    u1, u2, u_dec = _bounce_uniforms(pixel_ids, sample_ids, bounce, seed)
    new_d, atten, scattered, _, _ = mat_mod.scatter(
        out[6], out[7], out[8], out[9], albedo, d, normal, front, u1, u2, u_dec,
    )
    return dict(contrib=contrib, hit=hit, scattered=scattered, new_o=point,
                new_d=new_d, atten=atten)


def trace_persistent(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed,
    lanes: int = 0,
    sample_start: int = 0,
) -> torch.Tensor:
    """Persistent-wavefront path tracer with lane-local sample regeneration
    (the ``pixel`` schedule) -> per-pixel radiance SUM (width*height, 3)
    over samples ``sample_start``..spp-1.

    Every lane is bound to one pixel and walks that pixel's samples in
    turn: when its path dies (sky, absorption, depth) it starts the pixel's
    next sample, so each lane accumulates privately and the framebuffer is
    the accumulator. ``lanes`` is a TARGET lane count: the pixel grid is
    replicated into G = ceil(lanes / pixels) sample groups (at most the
    samples to trace); lane (g, p) traces pixel p's samples sample_start +
    g, sample_start + g + G, ... and the groups reduce
    with one reshape-sum at the end. Pixels are padded to a multiple of 512
    lanes; padding lanes start exhausted. Because every random number is a
    hash of (pixel, sample, bounce), the image is that of :func:`trace` over
    the same sample set, up to float32 summation order.

    Each step runs the fused bounce (K9) where :func:`fused_supported`
    holds, else :func:`bounce_step` (K10).
    """
    if not 0 <= sample_start < spp:
        raise ValueError(f"sample_start {sample_start} must lie in [0, spp = {spp})")
    num_pixels = width * height
    groups = min(int(spp) - sample_start,
                 max(1, (max(lanes, 1) + num_pixels - 1) // num_pixels))
    p_pad = ((num_pixels + 511) // 512) * 512
    r = groups * p_pad
    dev = sd.sph_center.device

    lane = torch.arange(r, dtype=torch.int64, device=dev)
    pix = torch.clamp_max(lane % p_pad, num_pixels - 1)
    pad = (lane % p_pad) >= num_pixels
    sample_i = torch.where(pad, int(spp), sample_start + lane // p_pad)
    alive = torch.zeros((r,), dtype=torch.bool, device=dev)
    bounce = torch.zeros((r,), dtype=torch.int64, device=dev)
    o = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    d = torch.ones((r, 3), dtype=torch.float32, device=dev)
    thr = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)

    fused = fused_supported(sd)
    table = make_sphere_table(sd).contiguous() if fused else None
    while bool((alive | (sample_i < spp)).any()):
        # --- lane-local regeneration: this lane's next sample ---------------
        issue = ~alive & (sample_i < spp)
        no, nd, _ = generate_rays(cp, width, height, pix, sample_i, seed)
        o = torch.where(issue[:, None], no, o)
        d = torch.where(issue[:, None], nd, d)
        thr = torch.where(issue[:, None], 1.0, thr)
        bounce = torch.where(issue, 0, bounce)
        alive = alive | issue
        # The sample id of the path in flight (issued now or earlier).
        smp = torch.where(alive & ~issue, sample_i - groups, sample_i)
        sample_i = torch.where(issue, sample_i + groups, sample_i)

        # --- one bounce for every lane ----------------------------------------
        if fused:
            s = bounce_step_fused(sd, table, o, d, pix, smp, bounce, seed)
        else:
            s = bounce_step(sd, o, d, pix, smp, bounce, seed)
        acc = acc + torch.where(alive[:, None], thr * s["contrib"], 0.0)

        cont = alive & s["hit"] & s["scattered"] & (bounce + 1 < max_depth)
        thr = torch.where(cont[:, None], thr * s["atten"], thr)
        o = torch.where(cont[:, None], s["new_o"], o)
        d = torch.where(cont[:, None], s["new_d"], d)
        bounce = bounce + 1
        alive = cont
    return acc.reshape(groups, p_pad, 3).sum(dim=0)[:num_pixels]
