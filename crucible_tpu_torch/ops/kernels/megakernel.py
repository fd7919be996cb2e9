"""Persistent path-tracing megakernel for sphere scenes: forward and record.

Port of ``crucible_tpu/ops/pallas/megakernel.py`` for its brute-sphere,
static-camera, non-animated branch, in both modes:

- :func:`run_megakernel` (K1, forward): given the lanes' pixel ids and
  first samples, the camera vector and the (N, 32) sphere table, it traces
  every lane's samples ``sample0..spp-1`` to the end and returns the
  per-lane radiance sums (3, R).
- :func:`run_megakernel_record` (K2, record): each lane traces its one
  (pixel, sample0) path and returns its packed decision words (D, R) int32
  (``models/replay.py`` layout) and, in the fused mode, that path's
  radiance (3, R).

For CUDA tensors each wrapper launches the hand-written kernel of
``csrc/megakernel.cu`` (one thread per lane; see the note there) or raises;
for CPU tensors it runs its eager twin (:func:`run_megakernel_reference`,
:func:`run_megakernel_record_reference`): all lanes in lockstep with
per-lane sample regeneration, as the TPU kernel runs them, the brute
(lanes x N) quadratic in lane chunks, and shading from the ported
materials / textures / skybox / sampling code. ``LAUNCHES`` and
``LAUNCHES_RECORD`` count kernel launches (not twin calls).

Layouts: ``smem`` (8,) int32 ``[spp, seed, width, max_depth, accum_from,
0...]`` (spp and seed are uint32 bit patterns; accum_from is read in record
mode only); ``pix`` and ``sample0`` (1, R) int32 (padding lanes carry
``sample0 = 2**30`` and never issue); ``cam`` (1, 48) float32 (static slots
0-18, layout below); ``table`` (N, 32) float32 in the
``integrator.make_sphere_table`` layout.
"""

from __future__ import annotations

import ctypes

import torch

from crucible_tpu_torch.models import materials as mat_mod
from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models import textures as tex_mod
from crucible_tpu_torch.ops import sampling
from crucible_tpu_torch.ops.kernels import build, sphere_hit
from crucible_tpu_torch.ops.kernels.sphere_hit import BIG, T_MIN  # noqa: F401
from crucible_tpu_torch.utils import rng as crng

# Lanes per pixel block of the swizzled lane order (32 x 16 pixels). The
# GPU kernel does not need it; it keeps the lane order of the TPU kernel,
# so that a warp covers 32 neighbouring pixels.
TILE = 512
C_IN = 32  # sphere attribute table columns (make_sphere_table layout)

# Camera constant vector layout (1, 48) float32. Static-camera slots:
#  0-2 pixel00, 3-5 du, 6-8 dv, 9-11 look_from, 12-14 basis u, 15-17 basis v,
#  18 defocus_radius. Slots 19-37 carry the animated-camera extras (not
#  ported), 38-47 are padding.
CAM_SIZE = 48

# The kernel stages five float32 columns per row in shared memory, of which
# a Hopper block can use 227 KB (232,448 bytes).
SHARED_MEM_BYTES = 232448
SMEM_COLS = 5
MAX_ROWS = SHARED_MEM_BYTES // (SMEM_COLS * 4)

# sample0 of a padding lane: it never issues.
NO_SAMPLE = 2**30

# Record word: winner id * REC_ID_SCALE + a flag byte of these bits (the
# layout of models/replay.py, which takes them from here).
REC_ID_SCALE = 256
F_ALIVE = 1  # lane had an in-flight path entering this bounce
F_HIT = 2  # the path hit a primitive (else: sky)
F_TRI = 4  # winner is a triangle (else: sphere)
F_SCAT = 8  # path continued (hit & material scattered)
F_FRONT = 16  # front-face flag
F_REFL = 32  # dielectric chose reflection over refraction
F_DEGEN = 64  # Lambertian scatter direction was degenerate
F_ROOT1 = 128  # sphere hit used the far quadratic root

# Launches of the CUDA kernels since the last reset (twin calls excluded):
# K1 (forward) and K2 (record).
LAUNCHES = 0
LAUNCHES_RECORD = 0


def as_i32(v: int) -> int:
    """A uint32 bit pattern (spp, seed) as the int32 that ``smem`` holds."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"the megakernel's {what} branch is not ported to crucible_tpu_torch yet"
    )


def run_megakernel(
    smem,
    pix,
    sample0,
    cam,
    table,
    cbounds=None,
    sph_nodes=None,
    sph_meta=None,
    tri_nodes=None,
    tris=None,
    mats=None,
    tri_meta=None,
    *,
    animated: bool,
    cam_animated: bool = False,
):
    """Dispatch the persistent megakernel -> per-lane radiance sums (3, R).

    CUDA tensors launch the CUDA kernel; CPU tensors run the eager
    reference. The chunk-cull, sphere-BVH, triangle and animation branches
    of the TPU kernel raise ``NotImplementedError``.
    """
    if cbounds is not None:
        raise _unported("chunk-cull")
    if sph_nodes is not None or sph_meta is not None:
        raise _unported("sphere-BVH")
    if any(x is not None for x in (tri_nodes, tris, mats, tri_meta)):
        raise _unported("triangle-BVH")
    if animated:
        raise _unported("animated-sphere")
    if cam_animated:
        raise _unported("animated-camera")
    _check_inputs(smem, pix, sample0, cam, table)
    if table.device.type == "cpu":
        return run_megakernel_reference(smem, pix, sample0, cam, table)
    return _launch(smem, pix, sample0, cam, table)


def _check_inputs(smem, pix, sample0, cam, table):
    build.check_tensors(table.device, (
        ("smem", smem, torch.int32, (8,)),
        ("pix", pix, torch.int32, None),
        ("sample0", sample0, torch.int32, None),
        ("cam", cam, torch.float32, (1, CAM_SIZE)),
        ("table", table, torch.float32, None),
    ))
    if pix.dim() != 2 or pix.shape[0] != 1 or sample0.shape != pix.shape:
        raise ValueError(
            f"pix and sample0 must both be (1, R), got {tuple(pix.shape)} "
            f"and {tuple(sample0.shape)}"
        )
    if table.dim() != 2 or table.shape[1] != C_IN:
        raise ValueError(f"table must be (N, {C_IN}), got {tuple(table.shape)}")


def _check_rows(n: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(
            f"{n} sphere rows exceed the {MAX_ROWS} rows whose intersection "
            f"columns fit in a block's {SHARED_MEM_BYTES} bytes of shared "
            f"memory; bigger scenes need the sphere-BVH kernel"
        )


def _launch(smem, pix, sample0, cam, table):
    global LAUNCHES
    n = table.shape[0]
    _check_rows(n)
    lib = build.load("megakernel")
    r = pix.shape[1]
    out = torch.empty((3, r), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.crucible_megakernel_forward(
            smem.data_ptr(), pix.data_ptr(), sample0.data_ptr(),
            cam.data_ptr(), table.data_ptr(), n, r,
            ctypes.c_float(T_MIN), out.data_ptr(), stream,
        )
    build.check(lib, err, "megakernel")
    LAUNCHES += 1
    return out


def run_megakernel_record(smem, pix, sample0, cam, table, *, max_depth: int, radiance: bool = False):
    """Record-mode megakernel (K2) -> (acc (3, R) float32, rec (max_depth, R) int32).

    Each lane traces the one path (pixel, sample0); row ``it`` of ``rec`` is
    its packed decision word at bounce ``it`` (zero after the path ends).
    ``acc`` is that path's radiance from bounce ``smem[4]`` on when
    ``radiance`` (the fused mode), else zeros; the records are the same in
    both modes. ``smem[3]`` is overridden by ``max_depth``, which sizes the
    records. CUDA tensors launch the kernel; CPU tensors run the twin.
    """
    _check_inputs(smem, pix, sample0, cam, table)
    if max_depth < 1:
        raise ValueError(f"max_depth must be positive, got {max_depth}")
    if table.device.type == "cpu":
        return run_megakernel_record_reference(
            smem, pix, sample0, cam, table, max_depth=max_depth, radiance=radiance
        )
    smem = smem.clone()
    smem[3] = int(max_depth)
    return _launch_record(smem, pix, sample0, cam, table, max_depth, radiance)


def _launch_record(smem, pix, sample0, cam, table, max_depth, radiance):
    global LAUNCHES_RECORD
    n = table.shape[0]
    _check_rows(n)
    lib = build.load("megakernel")
    r = pix.shape[1]
    acc = torch.empty((3, r), dtype=torch.float32, device=table.device)
    rec = torch.empty((max_depth, r), dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.crucible_megakernel_record(
            smem.data_ptr(), pix.data_ptr(), sample0.data_ptr(),
            cam.data_ptr(), table.data_ptr(), n, r,
            ctypes.c_float(T_MIN), int(bool(radiance)),
            acc.data_ptr(), rec.data_ptr(), stream,
        )
    build.check(lib, err, "record megakernel")
    LAUNCHES_RECORD += 1
    return acc, rec


def run_megakernel_record_reference(smem, pix, sample0, cam, table, *, max_depth: int, radiance: bool = False):
    """Eager-torch version of the record kernel: same inputs and outputs
    as :func:`run_megakernel_record`."""
    smem = smem.clone()
    smem[3] = int(max_depth)
    return _reference_loop(
        smem, pix, sample0, cam, table, rec_depth=int(max_depth), radiance=radiance
    )


# ---------------------------------------------------------------------------
# Eager reference
# ---------------------------------------------------------------------------


def run_megakernel_reference(smem, pix, sample0, cam, table):
    """Eager-torch version of the kernel: same inputs, same (3, R) output.

    Lanes advance in lockstep, as on the TPU: each step issues a new sample
    to every idle lane that has samples left, then traces one bounce of
    every live lane. Per lane this is the kernel's nested loop, so each
    lane's sum is the kernel's up to float rounding.
    """
    acc, _ = _reference_loop(smem, pix, sample0, cam, table, rec_depth=0, radiance=True)
    return acc


def _reference_loop(smem, pix, sample0, cam, table, *, rec_depth: int, radiance: bool):
    """The lockstep loop of both eager versions -> (acc (3, R), rec).

    ``rec_depth`` 0 is forward mode (``rec`` is None). Otherwise record
    mode: each lane issues its ``sample0`` only, and row ``it`` of ``rec``
    (rec_depth, R) holds the lane's decision word at bounce ``it``;
    ``radiance`` then says whether to accumulate it, from bounce smem[4] on.
    """
    spp, seed, width, max_depth = (int(v) for v in smem[:4].tolist())
    accum_from = int(smem[4]) if rec_depth else 0
    dev = table.device
    pix = pix[0].to(torch.int64)
    r = pix.shape[0]
    fi = (pix % width).to(torch.float32)
    fj = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    c = cam[0]
    p00, du, dv = c[0:3], c[3:6], c[6:9]
    lf, ub, vb, defr = c[9:12], c[12:15], c[15:18], c[18]

    sample_i = sample0[0].to(torch.int64).clone()
    # Forward mode issues samples up to spp; record mode sample0 alone
    # (padding lanes carry 2**30 and never issue).
    limit = torch.clamp_max(sample_i + 1, NO_SAMPLE) if rec_depth else spp
    alive = torch.zeros(r, dtype=torch.bool, device=dev)
    bounce = torch.zeros(r, dtype=torch.int64, device=dev)
    o = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    d = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    thr = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    rec = torch.zeros((rec_depth, r), dtype=torch.int32, device=dev) if rec_depth else None
    it = 0

    while True:
        issue = ~alive & (sample_i < limit)
        live = torch.nonzero(alive | issue).squeeze(1)
        if live.numel() == 0:
            break
        iss = issue[live]
        # An issued lane traces sample_i; a continuing lane sample_i - 1.
        smp = sample_i[live] - (~iss).to(torch.int64)
        p = pix[live]

        # --- primary rays for the issued lanes --------------------------
        ux, uy, ud1, ud2 = crng.uniform4(p, smp, crng.STREAM_PIXEL_JITTER, seed)
        off = sampling.square_offset(ux, uy)
        pos = (
            p00
            + (fi[live] + off[:, 0])[:, None] * du
            + (fj[live] + off[:, 1])[:, None] * dv
        )
        disk = sampling.in_unit_disk(ud1, ud2)
        new_o = lf + (disk[:, 0] * defr)[:, None] * ub + (disk[:, 1] * defr)[:, None] * vb
        o_l = torch.where(iss[:, None], new_o, o[live])
        d_l = torch.where(iss[:, None], pos - new_o, d[live])
        thr_l = torch.where(iss[:, None], 1.0, thr[live])
        b_l = torch.where(iss, 0, bounce[live])

        # --- closest hit; the winner's row only where there is one --------
        # The brute search is K10's (the kernel shares its search routine).
        t, idx, hit = sphere_hit.hit_spheres_reference(
            o_l, d_l, table[:, 0:3], table[:, 4], table[:, 5], T_MIN
        )
        idx = idx.long()
        row = torch.zeros((live.numel(), C_IN), dtype=torch.float32, device=dev)
        on = torch.nonzero(hit).squeeze(1)
        row[on] = table[idx[on]]

        t_sh = torch.where(hit, t, 1.0)
        hp = o_l + t_sh[:, None] * d_l
        inv_r = 1.0 / torch.clamp_min(row[:, 3], 1e-20)
        nrm = (hp - row[:, 0:3]) * inv_r[:, None]
        front = d_l[:, 0] * nrm[:, 0] + d_l[:, 1] * nrm[:, 1] + d_l[:, 2] * nrm[:, 2] < 0.0
        nrm = nrm * torch.where(front, 1.0, -1.0)[:, None]

        # --- sky on a miss, emission on a hit ------------------------------
        if radiance:
            sky = sky_mod.default_gradient(d_l)
            add = thr_l * torch.where(hit[:, None], row[:, 10:13], sky)
            if accum_from > 0:  # adding 0.0 rounds like the kernel's skip
                add = torch.where((b_l >= accum_from)[:, None], add, 0.0)
            acc[live] = acc[live] + add

        # --- albedo: solid or checker of solids ----------------------------
        is_even = tex_mod.checker_is_even(row[:, 17], hp)
        is_checker = (row[:, 13] == tex_mod.CHECKER)[:, None]
        albedo = torch.where(
            is_checker,
            torch.where(is_even[:, None], row[:, 18:21], row[:, 21:24]),
            row[:, 14:17],
        )

        # --- scatter -------------------------------------------------------
        u1, u2, u_dec, _ = crng.uniform4(p, smp, crng.STREAM_BOUNCE_BASE + b_l, seed)
        new_d, atten, scattered, refl, degen = mat_mod.scatter(
            row[:, 6], row[:, 7], row[:, 8], row[:, 9], albedo, d_l, nrm, front,
            u1, u2, u_dec,
        )
        cont = hit & scattered & (b_l + 1 < max_depth)
        if rec_depth:
            # Per-winner quadratic, as the replay re-solves it: which root.
            a_q = d_l[:, 0] * d_l[:, 0] + d_l[:, 1] * d_l[:, 1] + d_l[:, 2] * d_l[:, 2]
            oc = row[:, 0:3] - o_l
            r_h = d_l[:, 0] * oc[:, 0] + d_l[:, 1] * oc[:, 1] + d_l[:, 2] * oc[:, 2]
            r_c = oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2] - row[:, 3] * row[:, 3]
            r_disc = torch.clamp_min(r_h * r_h - a_q * r_c, 0.0)
            root1 = ~((r_h - torch.sqrt(r_disc)) * (1.0 / a_q) > T_MIN)
            flags = (
                F_ALIVE | F_HIT
                | torch.where(scattered, F_SCAT, 0) | torch.where(front, F_FRONT, 0)
                | torch.where(refl, F_REFL, 0) | torch.where(degen, F_DEGEN, 0)
                | torch.where(root1, F_ROOT1, 0)
            )
            # A miss keeps the alive bit alone (megakernel.py l.1498).
            rec[it, live] = torch.where(hit, idx * REC_ID_SCALE + flags, F_ALIVE).to(torch.int32)
        cont3 = cont[:, None]
        if radiance:
            thr[live] = torch.where(cont3, thr_l * atten, thr_l)
        o[live] = torch.where(cont3, hp, o_l)
        d[live] = torch.where(cont3, new_d, d_l)
        bounce[live] = b_l + 1
        alive[live] = cont
        sample_i[live] = sample_i[live] + iss.to(torch.int64)
        it += 1
    return acc.t().contiguous(), rec
