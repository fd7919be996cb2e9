"""Record/replay differentiable path tracing — the gradient path.

Port of the unsplit part of ``crucible_tpu/models/replay.py``:

1. :func:`trace_record_mega` — the fast, non-differentiable forward: the
   record-mode megakernel (K2; K5, the sphere-BVH walk, on static scenes
   with ``sd.sph_perm``; K6, the cluster walk, on animated ones with
   ``sd.sph_cbounds``; K8, their motion variants, for moving spheres and
   animated cameras; K7, the triangle stage, for a BVH mesh, K7 moving for
   a moving one) traces
   one (pixel, sample) path per lane and stores, per bounce, one packed
   int32 word: the winner's id and the discrete outcomes (alive / hit /
   triangle / scattered / front / reflect / degenerate / far root). With
   ``radiance=True`` the same loop also sums each path's radiance (the
   fused mode).
2. :func:`trace_replay` — the differentiable replay of those words, which
   re-derives every continuous quantity with the decisions frozen: through
   the replay kernels (``ops/kernels/replay_kernel.py``: forward K4,
   backward K3) where they take the scene (:func:`_use_replay_kernel`),
   else eagerly, one checkpointed bounce per record row (the JAX package's
   jnp replay: moving spheres, tables above the kernels' rows, the
   spherical sky, triangle meshes, static or moving).

:func:`render_rays_replay` chains camera rays, record and replay. Integers
carry no gradient, so the gradient is the replay's detached-sampling
estimator. Not ported yet (each raises ``NotImplementedError``): the staged
record (``trace_record`` over ``integrator.bounce_step``), the eager
replay's image textures, nested checkers and exact-time motion, and the
lane-narrowed replays of deep budgets
(``record_two_level`` / ``replay_bucketed_2l``).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from crucible_tpu_torch.models import integrator
from crucible_tpu_torch.models import materials as mat_mod
from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models import textures as tex_mod
from crucible_tpu_torch.models.camera import CameraParams, generate_rays
from crucible_tpu_torch.models.scene import SceneData
from crucible_tpu_torch.ops import intersect
from crucible_tpu_torch.ops.kernels import megakernel as mk
from crucible_tpu_torch.ops.kernels import replay_kernel as rk
from crucible_tpu_torch.ops.kernels.megakernel import (  # the record layout
    F_ALIVE, F_DEGEN, F_FRONT, F_HIT, F_REFL, F_ROOT1, F_SCAT, F_TRI, REC_ID_SCALE,
)
from crucible_tpu_torch.utils import rng as crng
from crucible_tpu_torch.utils import vec

# Packed word: bits 0..7 the flag byte (F_* bits, defined beside the
# kernel that writes them), bits 8..30 the winner id when F_HIT (0
# otherwise). Ids stay below 2^23, so words are non-negative.
REC_MAX_IDS = 1 << 23

# Budgets above this replay lane-narrowed in the JAX package (not ported).
GRAD_SPLIT_MIN_DEPTH = 12


def _check_record_capacity(sd: SceneData) -> None:
    n_sph = int(sd.sph_center.shape[0])  # padded table rows (the id space)
    if sd.num_tris >= REC_MAX_IDS or n_sph >= REC_MAX_IDS:
        raise ValueError(
            f"scene exceeds the packed-record id capacity (2^23): "
            f"{sd.num_tris} triangles / {n_sph} sphere rows — the record/"
            f"replay gradient path cannot represent winner ids this large"
        )


def pack_record(win_id: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Packed words from (R,) winner ids (already masked to hit rows) and
    (R,) int32 flag words."""
    return win_id.to(torch.int32) * REC_ID_SCALE + flags


def rec_winner_id(rec: torch.Tensor) -> torch.Tensor:
    """Winner id of packed records (any shape)."""
    return torch.bitwise_right_shift(rec, 8)


def replay_supported(sd: SceneData) -> bool:
    """True for every scene: the replay kernels take what
    :func:`_use_replay_kernel` accepts and the eager replay the rest (it
    raises, naming the queue item, on what is not ported yet)."""
    return True


def _use_replay_kernel(sd: SceneData) -> bool:
    """The routing predicate of the replay kernels (K4, K3): sphere-only
    static scenes with solid / checker textures under the default sky, up
    to ``rk.MAX_TABLE_ROWS`` rows."""
    return rk.supported(sd, int(sd.sph_center.shape[0]))


def _check_eager(sd: SceneData) -> None:
    """Raise for what the eager replay does not take yet."""
    if len(sd.tex.images) or sd.tex.max_nest > 1:
        raise NotImplementedError(
            "the replay of image textures and nested checkers is not ported to "
            "crucible_tpu_torch yet (ROADMAP A5)")
    if sd.motion_exact or sd.tri_exact:
        raise NotImplementedError(
            "the replay of exact-time motion (a keyframe inside the shutter) is "
            "not ported to crucible_tpu_torch yet (ROADMAP A7)")


def trace_record_mega(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    pixel_ids: torch.Tensor,
    sample_ids: torch.Tensor,
    seed,
    max_depth: int,
    radiance: bool = False,
    accum_from: int = 0,
):
    """Record pass through the megakernel in record mode (K2; K5 where the
    scene has the sphere-BVH tables, ``sd.sph_nodes``; K6 where it has the
    cluster tables, ``sd.sph_cbounds``; K8 for moving spheres or an
    animated camera, each path at its shutter fraction; K7 for a BVH mesh,
    K7 moving for a moving one, whose winners' words hold their leaf-order
    ids).

    One lane per (pixel, sample) path; the kernel regenerates the primary
    rays from the pcg4d streams. Sample id ``2**30`` marks a padding lane,
    which never issues. Returns packed records (max_depth, R) int32; with
    ``radiance=True`` returns (rec, rad (R, 3)), the paths' radiance from
    bounce ``accum_from`` on, summed by the same loop. A walk runs over
    the table permuted by ``sd.sph_perm`` and records the winners'
    original ids, so the records are the brute kernel's, bit for bit, and
    the eager replay reads them as it reads the brute kernel's. Beside a
    mesh a moving table the brute search holds takes it, cluster tables
    or not (``integrator.brute_beside_mesh``).
    """
    _check_record_capacity(sd)
    missing = integrator.megakernel_record_unsupported_reason(sd, cp)
    if missing is not None:
        raise NotImplementedError(
            f"the record megakernel of crucible_tpu_torch does not take {missing}"
        )
    with torch.no_grad():
        r = pixel_ids.shape[0]
        dev = sd.sph_center.device

        def lanes(ids):
            return ids.to(device=dev, dtype=torch.int32).reshape(1, r).contiguous()

        smem = torch.tensor(
            [0, mk.as_i32(int(seed)), width, max_depth, accum_from, 0, 0, 0],
            dtype=torch.int32,
            device=dev,
        )
        table = integrator.make_sphere_table(sd).contiguous()
        cbounds = sd.sph_cbounds
        if integrator.brute_beside_mesh(sd):  # K8 brute beside K7 moving
            cbounds = None
        elif sd.sph_perm is not None:
            table = integrator.permute_table(table, sd.sph_perm)
        tri = {}
        if sd.num_tris > 0:
            tri = dict(zip(("tri_nodes", "tris", "mats", "tri_meta"),
                           integrator.make_tri_tables(sd)))
        acc, rec = mk.run_megakernel_record(
            smem,
            lanes(pixel_ids),
            lanes(sample_ids),
            integrator.mega_cam_vector(cp, width, height),
            table,
            **tri,
            cbounds=cbounds,
            sph_nodes=sd.sph_nodes,
            sph_meta=sd.sph_meta,
            max_depth=int(max_depth),
            radiance=radiance,
            animated=bool(sd.animated),
            cam_animated=bool(cp.animated),
        )
    if radiance:
        return rec, acc.t()
    return rec


def trace_replay(
    sd: SceneData,
    o: torch.Tensor,
    d: torch.Tensor,
    pixel_ids: torch.Tensor,
    sample_ids: torch.Tensor,
    seed,
    max_depth: int,
    rec: torch.Tensor,
    early_exit: bool = False,
    bounce0: int = 0,
    thr_in: torch.Tensor | None = None,
    return_carry: bool = False,
    accum_from: int = 0,
    thr_mask: torch.Tensor | None = None,
    rad_given: torch.Tensor | None = None,
):
    """Differentiable replay of the first ``max_depth`` record rows ->
    radiance (R, 3).

    The replay kernels (K4 forward, K3 backward) take the calls that the
    JAX package sends to its kernel: a whole-path replay (no
    ``early_exit``, no ``return_carry``, ``bounce0`` 0, a throughput that
    starts at ones or at ``thr_mask``) of a scene :func:`_use_replay_kernel`
    accepts. Every other call replays eagerly (:func:`_replay_eager`).

    ``early_exit=True`` walks only the rows that hold a live lane.
    ``bounce0`` is the absolute bounce of row 0 (a row slice of a longer
    record keeps its random streams), ``thr_in`` (R, 3) the throughput to
    start from, and ``return_carry=True`` also returns the carry (o, d,
    thr) after the last row. Rows below ``accum_from`` update the carry but
    add no radiance; ``thr_mask`` (R,) bool starts the throughput at that
    0/1 mask (``thr_in``, where given, is its float form); ``rad_given``
    (R, 3) is a forward radiance already summed for these records (the
    fused record pass), which then stands as the kernels' primal. Gradients
    reach the scene's tensors through ``make_sphere_table`` (and the sky
    image) and the rays' through ``o`` and ``d``.
    """
    rec = rec[:max_depth]
    if (
        not early_exit
        and not return_carry
        and bounce0 == 0
        and (thr_in is None or thr_mask is not None)
        and _use_replay_kernel(sd)
    ):
        return rk.trace_replay_mega(
            integrator.make_sphere_table(sd), o, d, pixel_ids, sample_ids, seed, rec,
            accum_from=accum_from, valid=thr_mask, rad_given=rad_given,
        )
    _check_eager(sd)
    if thr_in is None:
        thr_in = torch.ones_like(o) if thr_mask is None else (
            torch.where(thr_mask[:, None], 1.0, torch.zeros_like(o)))
    return _replay_eager(sd, integrator.make_sphere_table(sd), o, d, pixel_ids, sample_ids,
                         seed, rec, early_exit=early_exit, bounce0=bounce0, thr_in=thr_in,
                         return_carry=return_carry, accum_from=accum_from)


# Table columns the eager replay fetches for a winner
# (integrator.make_sphere_table layout): the replay kernels' channels, and
# for moving spheres the center and radius deltas. Nothing else is fetched,
# so the backward's index_add stays this narrow.
EAGER_COLS = rk.USED
MOTION_COLS = (24, 25, 26, 27)


def _replay_row(sub, sky_image, o_c, d_c, thr, word, w, pixel_ids, sample_ids, mesh, *,
                pos, sky_kind, seed, bounce, accumulate):
    """One replayed bounce (the step of the JAX package's jnp replay,
    ``crucible_tpu/models/replay.py:426-586``) -> (o, d, thr, the radiance
    it adds). ``sub`` (N, K) holds the table columns ``pos`` maps to their
    place; ``w`` (R,) the paths' shutter fractions, or None for a static
    scene; ``mesh`` None, or a mesh's (tri_v0, tri_v1, tri_v2, tri_mat,
    mats, its shutter deltas (tri_v0_d, tri_v1_d, tri_v2_d) or None)
    (leaf order; ``integrator.make_tri_tables``' mats)."""
    dec = rk._decode(word)
    hit, cont, front = dec["hit"], dec["cont"], dec["front"]
    idx = dec["idx"].long()
    is_tri = (word & F_TRI) > 0

    # The winner's row: an indexed load, whose backward is an index_add
    # (fault C8), not the TPU's one-hot product.
    srow = torch.index_select(sub, 0, torch.where(is_tri, 0, idx) if mesh else idx)

    def attr(c):
        return srow[:, pos[c]]

    def attr3(c):
        return srow[:, pos[c]:pos[c] + 3]

    c_w, r_w = attr3(0), attr(3)
    if w is not None:  # the winner at the path's shutter fraction
        c_w = c_w + w[:, None] * attr3(24)
        r_w = r_w + w * attr(27)

    # Hit t as the recorded root of the winner's quadratic.
    a_q = (d_c * d_c).sum(-1)
    oc = c_w - o_c
    h_q = (d_c * oc).sum(-1)
    c_q = (oc * oc).sum(-1) - r_w * r_w
    disc = h_q * h_q - a_q * c_q
    ok = disc > 0.0
    sqrtd = torch.where(ok, torch.sqrt(torch.where(ok, disc, 1.0)), 0.0)
    t_hit = (h_q + torch.where(dec["root1"], sqrtd, -sqrtd)) / a_q

    if mesh:
        # A triangle winner: its t by Möller–Trumbore from the leaf-order
        # vertices (a moving mesh's lerped to the path's shutter fraction),
        # its geometric normal, and its material's row of mats (column c - 6
        # holds table column c), each an indexed load.
        tv0, tv1, tv2, tri_mat, mats, deltas = mesh
        ti = torch.where(is_tri, idx, 0)
        v0, v1, v2 = (torch.index_select(v, 0, ti) for v in (tv0, tv1, tv2))
        if deltas is not None:
            v0, v1, v2 = (v + w[:, None] * torch.index_select(vd, 0, ti)
                          for v, vd in zip((v0, v1, v2), deltas))
        e1, e2 = v1 - v0, v2 - v0
        det = (e1 * vec.cross(d_c, e2)).sum(-1)
        inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1.0)
        t_tri = (e2 * vec.cross(o_c - v0, e1)).sum(-1) * inv_det
        mrow = torch.index_select(mats, 0, torch.index_select(tri_mat, 0, ti).long())
        t_hit = torch.where(is_tri, t_tri, t_hit)
        sattr, sattr3 = attr, attr3

        def attr(c):
            return torch.where(is_tri, mrow[:, c - 6], sattr(c))

        def attr3(c):
            return torch.where(is_tri[:, None], mrow[:, c - 6:c - 3], sattr3(c))

    t_shade = torch.where(hit, t_hit, 1.0)
    point = o_c + t_shade[:, None] * d_c
    n_out = (point - c_w) / torch.clamp_min(r_w, 1e-20)[:, None]
    if mesh:
        n_out = torch.where(is_tri[:, None], intersect.triangle_normal(v0, v1, v2), n_out)
    normal = torch.where(front[:, None], n_out, -n_out)

    # Radiance: the sky on a miss, emission on a hit.
    sky = sky_mod.radiance(sky_kind, sky_image, d_c)
    contrib = torch.where(hit[:, None], attr3(10), sky)
    live = dec["alive"] if accumulate else torch.zeros_like(hit)
    add = torch.where(live[:, None], thr * contrib, 0.0)

    # Albedo: solid or one-level checker, from the fetched row.
    is_even = tex_mod.checker_is_even(attr(17), point)
    checker = torch.where(is_even[:, None], attr3(18), attr3(21))
    albedo = torch.where((attr(13) == tex_mod.CHECKER)[:, None], checker, attr3(14))

    # Scatter with the recorded decisions.
    u1, u2, u_dec = crng.uniform3(pixel_ids, sample_ids, crng.STREAM_BOUNCE_BASE + bounce, seed)
    new_d, atten, _, _, _ = mat_mod.scatter(
        attr(6), attr(7), attr(8), attr(9), albedo, d_c, normal, front, u1, u2, u_dec,
        forced_reflect=dec["refl"], forced_degenerate=dec["degen"],
    )
    keep = cont[:, None]
    return (torch.where(keep, point, o_c), torch.where(keep, new_d, d_c),
            torch.where(keep, thr * atten, thr), add)


def _replay_eager(sd, table, o, d, pixel_ids, sample_ids, seed, rec, *, early_exit,
                  bounce0, thr_in, return_carry, accum_from):
    """The eager replay over ``table`` (N, 32), the scene's
    ``make_sphere_table``: one :func:`_replay_row` per record row, each
    under ``torch.utils.checkpoint`` where autograd records, so that the
    backward holds one row's intermediates at a time and the carries (o, d,
    thr) of each row (it recomputes the row's forward). The sky comes from
    ``sd``."""
    cols = EAGER_COLS + (MOTION_COLS if sd.animated else ())
    sub = torch.index_select(table, 1, torch.tensor(cols, device=table.device))
    pos = {c: i for i, c in enumerate(cols)}
    w = integrator.shutter_fraction(pixel_ids, sample_ids, seed) if sd.animated else None
    mesh = None
    if sd.num_tris > 0:
        deltas = ((sd.tri_v0_d, sd.tri_v1_d, sd.tri_v2_d) if integrator.mesh_moves(sd)
                  else None)
        mesh = (sd.tri_v0, sd.tri_v1, sd.tri_v2, sd.tri_mat, integrator.make_tri_tables(sd)[2],
                deltas)
    rows = rec.shape[0]
    if early_exit:  # alive rows form a prefix: stop after the last live one
        rows = int(((rec & F_ALIVE) > 0).any(dim=1).sum())
    o_c, d_c, thr = o, d, thr_in
    rad = torch.zeros_like(o)
    for b in range(rows):
        bounce = bounce0 + b
        row = functools.partial(_replay_row, pos=pos, sky_kind=sd.sky_kind, seed=seed,
                                bounce=bounce, accumulate=bounce >= accum_from)
        args = (sub, sd.sky_image, o_c, d_c, thr, rec[b], w, pixel_ids, sample_ids, mesh)
        if torch.is_grad_enabled():
            o_c, d_c, thr, add = checkpoint(row, *args, use_reentrant=False,
                                            preserve_rng_state=False)
        else:
            o_c, d_c, thr, add = row(*args)
        rad = rad + add
    if return_carry:
        return rad, (o_c, d_c, thr)
    return rad


def render_rays_replay(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    pixel_ids: torch.Tensor,
    sample_ids: torch.Tensor,
    seed,
    max_depth: int,
    record_mode: str = "auto",
    rec: torch.Tensor | None = None,
    split: bool | None = None,
) -> torch.Tensor:
    """Primary rays + record + differentiable replay -> radiance (R, 3).

    ``record_mode``: 'mega' (the record megakernel) or 'auto' (the same,
    where the scene allows it); 'staged' is not ported. ``rec``: packed
    records precomputed for these exact (pixel, sample, seed) lanes — the
    frozen-decision pattern (``grad.record_decisions``); the record pass is
    skipped and the replay's forward gives the primal. Otherwise, where the
    replay kernels take the scene, the fused record pass gives the primal
    and only the backward kernel runs in the replay; elsewhere the record
    pass writes the words alone and the eager replay gives the primal.
    ``split``: None replays unsplit up to ``GRAD_SPLIT_MIN_DEPTH`` and
    raises above it; False replays unsplit at any depth; True raises (the
    lane-narrowed replays are not ported).
    """
    if record_mode == "staged":
        raise NotImplementedError(
            "the staged record (trace_record over integrator.bounce_step) "
            "is not ported to crucible_tpu_torch yet"
        )
    if record_mode not in ("auto", "mega"):
        raise ValueError(f"unknown record_mode {record_mode!r}")
    if split is None:
        split = max_depth > GRAD_SPLIT_MIN_DEPTH
    if split:
        raise NotImplementedError(
            f"depth {max_depth} > {GRAD_SPLIT_MIN_DEPTH} needs the lane-narrowed "
            "replay (record_two_level / replay_bucketed_2l), which is not "
            "ported to crucible_tpu_torch yet (ROADMAP A3); pass split=False "
            "to replay unsplit"
        )
    fused = rec is None and _use_replay_kernel(sd)
    o, d, _ = generate_rays(cp, width, height, pixel_ids, sample_ids, seed)
    rad_mega = None
    if rec is None:
        args = (sd, cp, width, height, pixel_ids, sample_ids, seed, max_depth)
        if fused:
            rec, rad_mega = trace_record_mega(*args, radiance=True)
        else:
            rec = trace_record_mega(*args)
    return trace_replay(
        sd, o, d, pixel_ids, sample_ids, seed, max_depth, rec, rad_given=rad_mega
    )
