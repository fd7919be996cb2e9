"""Record/replay differentiable path tracing — the gradient path.

Port of ``crucible_tpu/models/replay.py``'s gradient path:

1. :func:`trace_record_mega` — the fast, non-differentiable forward: the
   record-mode megakernel (K2; K5, the tree walk, on static scenes with
   ``sd.sph_perm``; K6, the swept-tree walk, on animated ones with
   the chunk-cull tables, ``sd.sph_cbounds``; K8, their motion variants,
   for moving spheres and
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
   backward K3, or K4-legacy under ``CRUCIBLE_REPLAY_BLOCKED=0``) where
   they take the scene (:func:`_use_replay_kernel`), else eagerly, one
   checkpointed bounce per record row (the JAX package's jnp replay:
   moving spheres, tables above the kernels' rows, the spherical sky,
   triangle meshes, static or moving).
3. Deep budgets (``max_depth > GRAD_SPLIT_MIN_DEPTH``): lanes are
   partitioned by their recorded path depth into buckets
   (``GRAD_BUCKET_SPEC``), each replayed only as deep and as wide as its
   lanes need. :func:`record_two_level` records the head rows at full
   width and re-records only the survivors, narrow, to ``max_depth``;
   :func:`replay_bucketed_2l` replays over that record and
   :func:`replay_bucketed` over a precomputed full record (frozen
   decisions). A bucket re-walks its lanes' head rows from regenerated
   primary rays with radiance off below ``accum_from``, so only integer
   ids cross the compaction. Every static capacity that overflows poisons
   the radiance with NaN (``grad.loss_and_grad_recovering`` widens it).

:func:`render_rays_replay` chains camera rays, record and replay. Integers
carry no gradient, so the gradient is the replay's detached-sampling
estimator. :func:`render_record_replay` is the forward ``record`` schedule:
the record kernel's decisions, shaded by the eager replay, which evaluates
image textures and checkers nested to any depth (``textures.value``) that
the megakernel's shading does not take. Not ported yet (each raises
``NotImplementedError``): the staged record (``trace_record`` over
``integrator.bounce_step``) and the eager replay's exact-time motion. Not
ported by design (ROADMAP "Do not port"): the head/tail carry-handoff
``replay_split`` and its switch ``CRUCIBLE_GRAD_DEEP_IMPL=split``, which
raises.
"""

from __future__ import annotations

import functools
import os
import time

import torch
from torch.utils.checkpoint import checkpoint

from crucible_tpu_torch.models import integrator
from crucible_tpu_torch.models import materials as mat_mod
from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models import textures as tex_mod
from crucible_tpu_torch.models.camera import CameraParams, generate_rays
from crucible_tpu_torch.models.scene import SceneData
from crucible_tpu_torch.ops import gather, intersect
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

# Budgets above this replay depth-bucketed (split); at or below, unsplit.
GRAD_SPLIT_MIN_DEPTH = 12
# Depth buckets of the deep replay, (depth limit, width divisor): bucket 0
# is the full-width head, a limit of 0 stretches to max_depth. The JAX
# package's shipped spec (its sweep on book1 1080p 4 spp d50).
GRAD_BUCKET_SPEC = ((6, 1), (16, 16), (0, 32))
# Narrow re-record capacity of the two-level record: r // 12 lanes.
RECORD_DEEP_DIV = 12
# The narrow capacity's floor, in lanes.
MIN_NARROW = 512


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
    """Record pass through the megakernel in record mode (K2; K5 where a
    static scene has the sphere-BVH tables, ``sd.sph_perm``, and K6 where an
    animated one has the chunk-cull tables, ``sd.sph_cbounds``, each
    walking the scene's tree, ``integrator.swept_tree``; K8 for moving
    spheres or an animated camera, each path at its shutter fraction; K7
    for a BVH mesh, K7 moving for a moving one, whose winners' words hold
    their leaf-order ids).

    One lane per (pixel, sample) path; the kernel regenerates the primary
    rays from the pcg4d streams. Sample id ``2**30`` marks a padding lane,
    which never issues. Returns packed records (max_depth, R) int32; with
    ``radiance=True`` returns (rec, rad (R, 3)), the paths' radiance from
    bounce ``accum_from`` on, summed by the same loop. A walk runs over
    the table permuted by the tree's permutation and records the winners'
    original ids, so the records
    are the brute kernel's, bit for bit, and the eager replay reads them as
    it reads the brute kernel's. Beside a mesh a moving table the brute
    search holds takes it, chunk-cull tables or not
    (``integrator.brute_beside_mesh``).
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
        walk = {}
        if integrator.brute_beside_mesh(sd):  # K8 brute beside K7 moving
            pass
        elif (tree := integrator.swept_tree(sd)) is not None:
            table = integrator.permute_table(table, tree[0])
            walk = dict(swept_nodes=tree[1], swept_meta=tree[2])
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
            **walk,
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
TEX_ID_COL = 30


def _full_textures(sd: SceneData) -> bool:
    """Whether the replay evaluates ``textures.value`` at the winner (image
    textures, or checkers nested deeper than the table's baked level)
    instead of reading the albedo from the winner's row."""
    return bool(sd.tex.images) or sd.tex.max_nest > 1


def _replay_row(sub, sky_image, o_c, d_c, thr, word, w, pixel_ids, sample_ids, mesh, *,
                pos, sky_kind, seed, bounce, accumulate, tex=None):
    """One replayed bounce (the step of the JAX package's jnp replay,
    ``crucible_tpu/models/replay.py:426-586``) -> (o, d, thr, the radiance
    it adds). ``sub`` (N, K) holds the table columns ``pos`` maps to their
    place; ``w`` (R,) the paths' shutter fractions, or None for a static
    scene; ``mesh`` None, or a mesh's (tri_v0, tri_v1, tri_v2, tri_mat,
    mats, its shutter deltas (tri_v0_d, tri_v1_d, tri_v2_d) or None)
    (leaf order; ``integrator.make_tri_tables``' mats); ``tex`` None, or
    the texture table that ``textures.value`` evaluates at the winner (its
    texture id from table column 30, or ``mats`` column 18 for a triangle;
    a sphere's uv from its outward normal, a triangle's (0, 0))."""
    dec = rk._decode(word)
    hit, cont, front = dec["hit"], dec["cont"], dec["front"]
    idx = dec["idx"].long()
    is_tri = (word & F_TRI) > 0

    # The winner's row: an indexed load, whose backward is an index_add
    # (fault C8), not the TPU's one-hot product; on a GPU one in a fixed
    # order (ops.gather).
    srow = gather.rows(sub, torch.where(is_tri, 0, idx) if mesh else idx)

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
        v0, v1, v2 = (gather.rows(v, ti) for v in (tv0, tv1, tv2))
        if deltas is not None:
            v0, v1, v2 = (v + w[:, None] * gather.rows(vd, ti)
                          for v, vd in zip((v0, v1, v2), deltas))
        e1, e2 = v1 - v0, v2 - v0
        det = (e1 * vec.cross(d_c, e2)).sum(-1)
        inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1.0)
        t_tri = (e2 * vec.cross(o_c - v0, e1)).sum(-1) * inv_det
        mrow = gather.rows(mats, torch.index_select(tri_mat, 0, ti).long())
        t_hit = torch.where(is_tri, t_tri, t_hit)
        sattr, sattr3 = attr, attr3

        def attr(c):
            return torch.where(is_tri, mrow[:, c - 6], sattr(c))

        def attr3(c):
            return torch.where(is_tri[:, None], mrow[:, c - 6:c - 3], sattr3(c))

    t_shade = torch.where(hit, t_hit, 1.0)
    point = o_c + t_shade[:, None] * d_c
    n_sph = (point - c_w) / torch.clamp_min(r_w, 1e-20)[:, None]
    n_out = n_sph
    if mesh:
        n_out = torch.where(is_tri[:, None], intersect.triangle_normal(v0, v1, v2), n_out)
    normal = torch.where(front[:, None], n_out, -n_out)

    # Radiance: the sky on a miss, emission on a hit.
    sky = sky_mod.radiance(sky_kind, sky_image, d_c)
    contrib = torch.where(hit[:, None], attr3(10), sky)
    live = dec["alive"] if accumulate else torch.zeros_like(hit)
    add = torch.where(live[:, None], thr * contrib, 0.0)

    if tex is not None:
        # The whole table: nested checkers level by level, then the leaf's
        # color or texel, gathered with index_select (the texel gradient).
        tid = srow[:, pos[TEX_ID_COL]]
        u_s, v_s = intersect.sphere_uv(n_sph)
        if mesh:
            tid = torch.where(is_tri, mrow[:, 18], tid)
            u_s = torch.where(is_tri, 0.0, u_s)
            v_s = torch.where(is_tri, 0.0, v_s)
        albedo = tex_mod.value(tex, tid.to(torch.int32), u_s, v_s, point)
    else:
        # Solid or one-level checker, from the fetched row.
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
    tex = sd.tex if _full_textures(sd) else None
    cols = (EAGER_COLS + (MOTION_COLS if sd.animated else ())
            + ((TEX_ID_COL,) if tex is not None else ()))
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
                                bounce=bounce, accumulate=bounce >= accum_from, tex=tex)
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


def _bucket_spec(max_depth: int, spec=None):
    """(limits, divisors) of the depth buckets against ``max_depth``:
    limits clipped, buckets left empty dropped, the last stretched to
    ``max_depth``. ``spec`` None reads ``CRUCIBLE_GRAD_BUCKETS``
    ("8:1,16:8,0:32"), else ``GRAD_BUCKET_SPEC``."""
    if spec is None:
        env = os.environ.get("CRUCIBLE_GRAD_BUCKETS")
        if env:
            spec = tuple(
                (int(a), int(b)) for a, b in (part.split(":") for part in env.split(","))
            )
        else:
            spec = GRAD_BUCKET_SPEC
    lims, divs = [], []
    for lim, dv in spec:
        lim = max_depth if lim <= 0 else min(lim, max_depth)
        if lims and lim <= lims[-1]:
            continue
        lims.append(lim)
        divs.append(dv)
    lims[-1] = max_depth
    return lims, divs


def _capacity(r: int, div: int, cap: int | None = None) -> int:
    """Lanes of a narrowed pass: r // div, at least ``MIN_NARROW``, at most
    ``cap`` (default r)."""
    return int(min(r if cap is None else cap, max(MIN_NARROW, r // div)))


def _compact(flag: torch.Tensor, cap: int):
    """Stream compaction without a host sync: the first ``cap`` set entries
    of ``flag`` (R,) bool, in order -> (idx (cap,) int64 their positions,
    valid (cap,) bool the slots filled). Unfilled slots hold 0. The scatter
    writes the dropped entries into a slot ``cap`` past the end, which is
    then cut off (the JAX ``mode="drop"``)."""
    rank = torch.cumsum(flag.to(torch.int32), 0) - 1
    keep = flag & (rank < cap)
    slot = torch.where(keep, rank, cap).long()
    src = torch.arange(flag.shape[0], device=flag.device)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=flag.device).scatter_(0, slot, src)
    valid = torch.arange(cap, device=flag.device) < flag.sum()
    return idx[:cap], valid


def _poison(rad: torch.Tensor, overflow: torch.Tensor) -> torch.Tensor:
    """NaN everywhere where the device scalar ``overflow`` holds: a static
    capacity was exceeded (loud, never a silently biased radiance)."""
    return torch.where(overflow, torch.full_like(rad, float("nan")), rad)


def record_two_level(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    pixel_ids: torch.Tensor,
    sample_ids: torch.Tensor,
    seed,
    max_depth: int,
    head: int,
    div: int | None = None,
    record_mode: str = "auto",
    head_radiance: bool = False,
):
    """Two-level decision record: ``head`` rows at full width, then a narrow
    re-record of only the lanes that continue past them, to ``max_depth``.

    Decisions are a pure function of (pixel, sample, seed), so the re-record
    retraces the survivors' paths from bounce 0 bit for bit, and the deep
    rows cost 1/div of full width. The survivors are compacted into
    ``r_n = min(r, max(512, r // div))`` slots; unfilled slots get the
    padding sample id 2**30, which the record kernel never issues.

    Returns (rec_h (head, R), rec_n (max_depth, r_n), idx_n (r_n,) lane
    ids, valid_n (r_n,) filled slots, n_deep the survivors' count, a device
    scalar); with ``head_radiance`` also rad_h (R, 3), the head rows'
    radiance fused into the head record, and rad_n (r_n, 3), the
    survivors' radiance from row ``head`` on, fused into the re-record.
    Overflow (n_deep > r_n) is the caller's to poison. ``div``: the
    argument, else ``CRUCIBLE_RECORD_DEEP_DIV``, else ``RECORD_DEEP_DIV``.
    ``record_mode``: 'auto' and 'mega' take the record megakernel; 'staged'
    is not ported.
    """
    if record_mode not in ("auto", "mega"):
        raise NotImplementedError(
            f"record_mode {record_mode!r}: the staged record is not ported to "
            "crucible_tpu_torch yet"
        )
    r = pixel_ids.shape[0]
    if div is None:
        env_div = os.environ.get("CRUCIBLE_RECORD_DEEP_DIV")
        div = int(env_div) if env_div is not None else RECORD_DEEP_DIV
    rec_pass = functools.partial(trace_record_mega, sd, cp, width, height)
    if head_radiance:
        rec_h, rad_h = rec_pass(pixel_ids, sample_ids, seed, head, radiance=True)
    else:
        rec_h = rec_pass(pixel_ids, sample_ids, seed, head)
    cont = (rec_h[head - 1] & F_SCAT) > 0  # continued past the head rows
    n_deep = cont.sum()
    r_n = _capacity(r, div)
    idx_n, valid_n = _compact(cont, r_n)
    pix_n = torch.where(valid_n, pixel_ids[idx_n], 0).to(pixel_ids.dtype)
    smp_n = torch.where(valid_n, sample_ids[idx_n], mk.NO_SAMPLE).to(sample_ids.dtype)
    if head_radiance:
        rec_n, rad_n = rec_pass(pix_n, smp_n, seed, max_depth, radiance=True,
                                accum_from=head)
        return rec_h, rec_n, idx_n, valid_n, n_deep, rad_h, rad_n
    rec_n = rec_pass(pix_n, smp_n, seed, max_depth)
    return rec_h, rec_n, idx_n, valid_n, n_deep


def _replay_bucket(sd, cp, width, height, pixel_ids, sample_ids, seed, depth, rec,
                   lanes, slots, valid, accum_from, rad, rad_given=None):
    """One narrowed bucket pass: regenerate the primary rays of ``lanes``
    (their pixel and sample ids gathered), replay the record columns
    ``slots`` of ``rec`` to ``depth`` with radiance from ``accum_from`` on
    and the throughput starting at ``valid``, and add the result into
    ``rad`` at ``lanes`` -> the new ``rad``."""
    pix_b = pixel_ids[lanes]
    smp_b = sample_ids[lanes]
    # Regenerated rays are the head's bit for bit (pure pcg4d streams), and
    # camera gradients flow through them as through the head's.
    o_b, d_b, _ = generate_rays(cp, width, height, pix_b, smp_b, seed)
    thr0 = torch.where(valid[:, None], torch.ones_like(o_b), 0.0)
    rad_b = trace_replay(
        sd, o_b, d_b, pix_b, smp_b, seed, depth, rec[:depth].index_select(1, slots),
        thr_in=thr0, accum_from=accum_from, thr_mask=valid, rad_given=rad_given,
    )
    return rad.index_add(0, lanes, torch.where(valid[:, None], rad_b, 0.0))


def replay_bucketed(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    o: torch.Tensor,
    d: torch.Tensor,
    pixel_ids: torch.Tensor,
    sample_ids: torch.Tensor,
    seed,
    max_depth: int,
    rec: torch.Tensor,
    *,
    spec=None,
) -> torch.Tensor:
    """Depth-bucketed differentiable replay of a full record (max_depth, R)
    -> radiance (R, 3): the path of precomputed records (frozen decisions).

    Bucket 0 replays rows [0, d0) of every lane at full width; bucket j
    compacts the lanes whose depth lies in (d(j-1), dj] into r // div_j
    slots, which re-walk rows [0, dj) from their regenerated primary rays with radiance from d0 on. Per lane the partial
    sums concatenate in row order, so values equal the unsplit replay's up
    to f32 association and gradients equal them (the same frozen decisions
    and continuous operations). Lanes beyond a bucket's capacity poison
    the radiance with NaN.
    """
    lims, divs = _bucket_spec(max_depth, spec)
    r = o.shape[0]
    d0 = lims[0]
    rad = trace_replay(sd, o, d, pixel_ids, sample_ids, seed, d0, rec[:d0])
    if len(lims) == 1:
        return rad
    depth_lane = ((rec & F_ALIVE) > 0).sum(0)
    for j in range(1, len(lims)):
        in_b = (depth_lane > lims[j - 1]) & (depth_lane <= lims[j])
        r_b = _capacity(r, divs[j])
        idx, valid = _compact(in_b, r_b)
        rad = _replay_bucket(sd, cp, width, height, pixel_ids, sample_ids, seed,
                             lims[j], rec, idx, idx, valid, d0, rad)
        rad = _poison(rad, in_b.sum() > r_b)
    return rad


def replay_bucketed_2l(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    o: torch.Tensor,
    d: torch.Tensor,
    pixel_ids: torch.Tensor,
    sample_ids: torch.Tensor,
    seed,
    max_depth: int,
    rec_h: torch.Tensor,
    rec_n: torch.Tensor,
    idx_n: torch.Tensor,
    valid_n: torch.Tensor,
    n_deep: torch.Tensor,
    *,
    spec=None,
    rad_head: torch.Tensor | None = None,
    rad_narrow: torch.Tensor | None = None,
) -> torch.Tensor:
    """Depth-bucketed replay over a two-level record (:func:`record_two_level`)
    -> radiance (R, 3): :func:`replay_bucketed`'s estimator, with bucket 0
    on the full-width head record and every deeper bucket compacted from
    the narrow record's slots. ``rad_head`` / ``rad_narrow``: the fused
    radiances of the two record passes; then bucket 0's primal is
    ``rad_head`` and each bucket's a gather of ``rad_narrow``, so only the
    backward kernel runs. Overflow of a bucket, or of the narrow record
    (``n_deep > r_n``), poisons the radiance with NaN.
    """
    lims, divs = _bucket_spec(max_depth, spec)
    head = rec_h.shape[0]
    if lims[0] != head:
        raise ValueError(f"the head record has {head} rows, the spec's head bucket {lims[0]}")
    r = o.shape[0]
    rad = trace_replay(sd, o, d, pixel_ids, sample_ids, seed, head, rec_h, rad_given=rad_head)
    if len(lims) == 1:
        return rad
    r_n = rec_n.shape[1]
    depth_n = ((rec_n & F_ALIVE) > 0).sum(0)
    for j in range(1, len(lims)):
        in_b = valid_n & (depth_n > lims[j - 1]) & (depth_n <= lims[j])
        r_b = _capacity(r, divs[j], r_n)
        slots, valid = _compact(in_b, r_b)
        given = None
        if rad_narrow is not None:
            # The re-record summed rows >= head per survivor (rows past a
            # lane's depth are dead): the bucket's primal is a gather.
            given = torch.where(valid[:, None], rad_narrow.index_select(0, slots), 0.0)
        rad = _replay_bucket(sd, cp, width, height, pixel_ids, sample_ids, seed,
                             lims[j], rec_n, idx_n[slots], slots, valid, head, rad,
                             rad_given=given)
        rad = _poison(rad, in_b.sum() > r_b)
    # Narrow-record overflow: deep lanes beyond r_n were never re-recorded.
    return _poison(rad, n_deep > r_n)


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
    spec=None,
    record_div: int | None = None,
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

    ``split``: None reads ``CRUCIBLE_GRAD_SPLIT`` (0 / off / false, else
    on), else splits above ``GRAD_SPLIT_MIN_DEPTH``; False replays unsplit
    at any depth (the escape hatch for scenes whose survivors exceed the
    capacities). A split call records two-level and replays
    :func:`replay_bucketed_2l`, or with ``rec`` given (or
    ``CRUCIBLE_GRAD_2L=0``) replays :func:`replay_bucketed` over a full
    record. ``spec`` / ``record_div``: the bucket spec and the narrow
    record's divisor, which win over their environment knobs (the rungs
    of ``grad.loss_and_grad_recovering``).
    """
    if record_mode == "staged":
        raise NotImplementedError(
            "the staged record (trace_record over integrator.bounce_step) "
            "is not ported to crucible_tpu_torch yet"
        )
    if record_mode not in ("auto", "mega"):
        raise ValueError(f"unknown record_mode {record_mode!r}")
    if split is None:
        env = os.environ.get("CRUCIBLE_GRAD_SPLIT")
        if env is not None:
            split = env.lower() not in ("0", "off", "false")
        else:
            split = max_depth > GRAD_SPLIT_MIN_DEPTH
    if split and os.environ.get("CRUCIBLE_GRAD_DEEP_IMPL") == "split":
        raise NotImplementedError(
            "CRUCIBLE_GRAD_DEEP_IMPL=split: the head/tail replay_split is not "
            "ported to crucible_tpu_torch (ROADMAP, Do not port); the depth "
            "buckets compute the same radiance"
        )
    fused = rec is None and _use_replay_kernel(sd)
    o, d, _ = generate_rays(cp, width, height, pixel_ids, sample_ids, seed)
    args = (sd, cp, width, height, pixel_ids, sample_ids, seed, max_depth)
    two_level = os.environ.get("CRUCIBLE_GRAD_2L", "1") not in ("0", "off", "false")
    if split and rec is None and two_level:
        lims, _ = _bucket_spec(max_depth, spec)
        out = record_two_level(*args, head=lims[0], div=record_div,
                               record_mode=record_mode, head_radiance=fused)
        rad_h = rad_n = None
        if fused:
            *out, rad_h, rad_n = out
        return replay_bucketed_2l(sd, cp, width, height, o, d, pixel_ids, sample_ids,
                                  seed, max_depth, *out, spec=spec, rad_head=rad_h,
                                  rad_narrow=rad_n)
    rad_mega = None
    if rec is None:
        if fused and not split:
            rec, rad_mega = trace_record_mega(*args, radiance=True)
        else:
            rec = trace_record_mega(*args)
    if split:
        return replay_bucketed(sd, cp, width, height, o, d, pixel_ids, sample_ids, seed,
                               max_depth, rec, spec=spec)
    return trace_replay(
        sd, o, d, pixel_ids, sample_ids, seed, max_depth, rec, rad_given=rad_mega
    )


# Bytes the record schedule lets one sample chunk's decision words take.
REC_BUDGET_BYTES = 1 << 28
# While a dict, the record schedule adds each phase's seconds to it
# ("record": the record megakernel, "replay": the eager replay), with a
# device sync on each side of a phase; None times nothing.
PHASE_SECONDS = None


def _phase(name, dev, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, timed into ``PHASE_SECONDS[name]`` while that
    is a dict."""
    if PHASE_SECONDS is None:
        return fn(*args, **kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.perf_counter() - t0
    return out


def _record_replay_chunk(sd, cp, width, height, sample0, spp, seed, chunk_spp, max_depth):
    """One sample chunk of the record schedule -> per-pixel radiance sums
    (P, 3) of samples [sample0, sample0 + chunk_spp). Lanes past ``spp``
    (the ragged tail) record as padding lanes (sample id ``mk.NO_SAMPLE``,
    2**30: never issued, flags 0), so the replay adds nothing for them."""
    p = width * height
    dev = sd.sph_center.device
    pix = torch.arange(p, dtype=torch.int64, device=dev).repeat(chunk_spp)
    smp = torch.arange(sample0, sample0 + chunk_spp, dtype=torch.int64,
                       device=dev).repeat_interleave(p)
    o, d, _ = generate_rays(cp, width, height, pix, smp, seed)
    smp_rec = torch.where(smp < spp, smp, mk.NO_SAMPLE)
    rec = _phase("record", dev, trace_record_mega, sd, cp, width, height, pix, smp_rec,
                 seed, max_depth)
    rad = _phase("replay", dev, trace_replay, sd, o, d, pix, smp, seed, max_depth, rec,
                 early_exit=True)
    return rad.reshape(chunk_spp, p, 3).sum(dim=0)


def render_record_replay(
    sd: SceneData,
    cp: CameraParams,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed,
    rec_budget_bytes: int = REC_BUDGET_BYTES,
    progress=None,
) -> torch.Tensor:
    """The ``record`` schedule's forward render -> per-pixel radiance SUMS
    (P, 3) over ``spp`` samples (divide by spp): the record megakernel (K2,
    or K5-K8 where the scene routes there) writes each path's decisions,
    which read no albedo or sky, and the eager replay shades them unsplit,
    walking only the rows that hold a live lane. It takes image textures
    and nested checkers, which the megakernel's shading does not.

    Samples go in chunks of ``chunk_spp = max(1, min(spp, rec_budget_bytes
    // (4 max_depth P)))``, so one chunk's record words (4 bytes a bounce
    and a lane) stay within ``rec_budget_bytes``; every chunk has that many
    samples, the ragged tail's extra lanes masked. ``progress``: None, or a
    callable ``f(samples_done, samples_total, seconds)`` called after each
    chunk (one host sync a chunk). Runs under ``torch.no_grad()``."""
    p = width * height
    chunk_spp = int(max(1, min(spp, rec_budget_bytes // (4 * max_depth * p))))
    fb = None
    t0 = time.time()
    with torch.no_grad():
        for s0 in range(0, spp, chunk_spp):
            out = _record_replay_chunk(sd, cp, width, height, s0, spp, seed, chunk_spp,
                                       max_depth)
            fb = out if fb is None else fb + out
            if progress is not None:
                if fb.is_cuda:
                    torch.cuda.synchronize(fb.device)
                progress(min(s0 + chunk_spp, spp), spp, time.time() - t0)
    return fb
