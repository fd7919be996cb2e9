"""Record/replay differentiable path tracing — the gradient path.

Port of the unsplit part of ``crucible_tpu/models/replay.py``:

1. :func:`trace_record_mega` — the fast, non-differentiable forward: the
   record-mode megakernel (K2; K5, the sphere-BVH walk, on scenes with
   ``sd.sph_perm``) traces one (pixel, sample) path per lane and
   stores, per bounce, one packed int32 word: the winner's id and the
   discrete outcomes (alive / hit / scattered / front / reflect /
   degenerate / far root). With ``radiance=True`` the same loop also sums
   each path's radiance (the fused mode).
2. :func:`trace_replay` — the differentiable replay of those words
   (``ops/kernels/replay_kernel.py``: forward K4, backward K3), which
   re-derives every continuous quantity with the decisions frozen.

:func:`render_rays_replay` chains camera rays, record and replay. Integers
carry no gradient, so the gradient is the replay's detached-sampling
estimator. Not ported yet (each raises ``NotImplementedError``): the staged
record (``trace_record`` over ``integrator.bounce_step``), the jnp replay
for scenes outside the replay kernels (the spherical sky, tables above 2048
rows), and the lane-narrowed replays of deep budgets (``record_two_level``
/ ``replay_bucketed_2l``).
"""

from __future__ import annotations

import torch

from crucible_tpu_torch.models import integrator
from crucible_tpu_torch.models.camera import CameraParams, generate_rays
from crucible_tpu_torch.models.scene import SceneData
from crucible_tpu_torch.ops.kernels import megakernel as mk
from crucible_tpu_torch.ops.kernels import replay_kernel as rk
from crucible_tpu_torch.ops.kernels.megakernel import (  # the record layout
    F_ALIVE, F_DEGEN, F_FRONT, F_HIT, F_REFL, F_ROOT1, F_SCAT, F_TRI, REC_ID_SCALE,
)

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
    """True where the port's replay runs: the replay kernels' scenes."""
    return rk.supported(sd, int(sd.sph_center.shape[0]))


def _check_replay_supported(sd: SceneData) -> None:
    if not replay_supported(sd):
        raise NotImplementedError(
            "this scene is outside the replay kernels (sphere-only static "
            f"scenes, solid/checker textures, default sky, <= "
            f"{rk.MAX_TABLE_ROWS} rows); the jnp-style replay that covers "
            "the rest is not ported to crucible_tpu_torch yet"
        )


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
    scene has the sphere-BVH tables, ``sd.sph_perm``).

    One lane per (pixel, sample) path; the kernel regenerates the primary
    rays from the pcg4d streams. Sample id ``2**30`` marks a padding lane,
    which never issues. Returns packed records (max_depth, R) int32; with
    ``radiance=True`` returns (rec, rad (R, 3)), the paths' radiance from
    bounce ``accum_from`` on, summed by the same loop. The walk runs over
    the table permuted by ``sd.sph_perm`` and records the winners'
    original ids, so the records are the brute kernel's, bit for bit.
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
        if sd.sph_perm is not None:
            table = integrator.permute_table(table, sd.sph_perm)
        acc, rec = mk.run_megakernel_record(
            smem,
            lanes(pixel_ids),
            lanes(sample_ids),
            integrator.mega_cam_vector(cp, width, height),
            table,
            sph_nodes=sd.sph_nodes,
            sph_meta=sd.sph_meta,
            max_depth=int(max_depth),
            radiance=radiance,
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
    accum_from: int = 0,
    thr_mask: torch.Tensor | None = None,
    rad_given: torch.Tensor | None = None,
) -> torch.Tensor:
    """Differentiable replay of the first ``max_depth`` record rows ->
    radiance (R, 3), through the replay kernels (K4 forward, K3 backward).

    Rows below ``accum_from`` update the path carry but add no radiance;
    ``thr_mask`` (R,) bool starts the throughput at that 0/1 mask;
    ``rad_given`` (R, 3) is a forward radiance already summed for these
    records (the fused record pass), which then stands as the primal.
    Gradients reach the scene's tensors through ``make_sphere_table`` and
    the rays' through ``o`` and ``d``.
    """
    _check_replay_supported(sd)
    return rk.trace_replay_mega(
        integrator.make_sphere_table(sd),
        o,
        d,
        pixel_ids,
        sample_ids,
        seed,
        rec[:max_depth],
        accum_from=accum_from,
        valid=thr_mask,
        rad_given=rad_given,
    )


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
    skipped and the replay's forward kernel gives the primal. Otherwise the
    fused record pass gives the primal and only the backward kernel runs in
    the replay. ``split``: None replays unsplit up to
    ``GRAD_SPLIT_MIN_DEPTH`` and raises above it; False replays unsplit at
    any depth; True raises (the lane-narrowed replays are not ported).
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
            "ported to crucible_tpu_torch yet; pass split=False to replay "
            "unsplit"
        )
    _check_replay_supported(sd)
    o, d, _ = generate_rays(cp, width, height, pixel_ids, sample_ids, seed)
    rad_mega = None
    if rec is None:
        rec, rad_mega = trace_record_mega(
            sd, cp, width, height, pixel_ids, sample_ids, seed, max_depth,
            radiance=True,
        )
    return trace_replay(
        sd, o, d, pixel_ids, sample_ids, seed, max_depth, rec, rad_given=rad_mega
    )
