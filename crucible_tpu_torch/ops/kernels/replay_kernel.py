"""Differentiable replay of recorded path decisions: forward K4, backward K3,
and their channel-major pair K4-legacy.

Port of ``crucible_tpu/ops/pallas/replay_kernel.py``: the lane-blocked
kernels ``_fwd_kernel_blk`` / ``_bwd_kernel_blk`` and the unblocked
``_fwd_kernel`` / ``_bwd_kernel``, and their custom VJPs.
Given the sphere table, the primary rays, the lanes' pixel and sample ids
and the packed decision records of ``models/replay.py``, the replay
re-derives every continuous quantity of each path (hit distance as the
recorded root of the winner's quadratic, normal, albedo, scatter direction)
with every discrete decision frozen, and sums its radiance.

- :func:`replay_forward` (K4) -> radiance (R, 3); :func:`replay_backward`
  (K3) -> cotangents of the table (N, 32), origins and directions (R, 3).
  For CUDA tensors each launches its hand-written kernel of
  ``csrc/replay_kernel.cu`` or raises; for CPU tensors it runs its twin.
- Twins: :func:`bounce` (``_bounce``, one row on a batch of lanes),
  :func:`replay_forward_reference` (an eager walk over the rows, exact row
  gathers) and :func:`replay_backward_reference` (torch autograd through
  that walk).
- :func:`replay_legacy_forward` / :func:`replay_legacy_backward`
  (K4-legacy, the unblocked pair's layouts): the same functions on
  channel-major rays, radiance and cotangents (3, R) and (1, R) id rows,
  with the twins :func:`replay_legacy_forward_reference` /
  :func:`replay_legacy_backward_reference`. The per-lane arithmetic and
  the table-cotangent reduction are K4's and K3's, so the results are
  theirs bit for bit.
- :class:`Replay` (forward K4, backward K3) and :class:`ReplayGiven`
  (forward returns a given radiance, backward K3) mirror the JAX
  ``replay`` / ``replay_given`` custom VJPs, in either layout;
  :func:`trace_replay_mega` is the entry point, with the JAX signature:
  ``blocked=False`` (default: ``CRUCIBLE_REPLAY_BLOCKED``, on) takes
  K4-legacy.
- ``LAUNCHES_FORWARD``, ``LAUNCHES_BACKWARD``, ``LAUNCHES_LEGACY_FORWARD``
  and ``LAUNCHES_LEGACY_BACKWARD`` count kernel launches (not twin calls).

Layouts: ``table`` (N, 32) float32 (``integrator.make_sphere_table``),
``o``/``d`` (R, 3) float32, ``valid``/``pix``/``smp`` (R,) int32 (the
throughput starts at the 0/1 ``valid`` mask), ``rec`` (depth, R) int32,
``seed`` a uint32 as a Python int.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from crucible_tpu_torch.models import materials as mat_mod
from crucible_tpu_torch.models import skybox as sky_mod
from crucible_tpu_torch.models import textures as tex_mod
from crucible_tpu_torch.ops import sampling
from crucible_tpu_torch.ops.kernels import build
from crucible_tpu_torch.ops.kernels import megakernel as mk
from crucible_tpu_torch.utils import rng as crng

C_IN = 32
# Table channels the bounce reads (integrator.make_sphere_table layout).
USED = (
    0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23,
)
NUSE = len(USED)

# Both kernels stage the USED channels in a block's shared memory, rows at a
# stride of 23 floats, which holds up to 2526 rows; the routing limit is the
# JAX kernel's MAX_TABLE_ROWS.
ROW_STRIDE = 23
MAX_TABLE_ROWS = 2048
assert MAX_TABLE_ROWS * ROW_STRIDE * 4 <= mk.SHARED_MEM_BYTES

# Threads per block: K4's persistent warps, K3's eight warps (its shared
# memory layout, and where its table-cotangent partial lives, are the C
# library's: see ``launch_shape``).
FORWARD_BLOCK = 512
BACKWARD_BLOCK = 256
# Launch-shape queries of the C library, by kernel.
_SHAPE_KINDS = {"forward": 0, "backward": 1, "legacy_forward": 2, "legacy_backward": 3}

# Launches of the CUDA kernels since the last reset (twin calls excluded).
LAUNCHES_FORWARD = 0
LAUNCHES_BACKWARD = 0
LAUNCHES_LEGACY_FORWARD = 0
LAUNCHES_LEGACY_BACKWARD = 0


def zero_counts() -> None:
    """Set every launch count to 0."""
    global LAUNCHES_FORWARD, LAUNCHES_BACKWARD
    global LAUNCHES_LEGACY_FORWARD, LAUNCHES_LEGACY_BACKWARD
    LAUNCHES_FORWARD = LAUNCHES_BACKWARD = 0
    LAUNCHES_LEGACY_FORWARD = LAUNCHES_LEGACY_BACKWARD = 0


def _blocked_default() -> bool:
    """The layout ``trace_replay_mega`` takes when not told: the blocked
    pair (K4, K3) unless ``CRUCIBLE_REPLAY_BLOCKED`` is 0 / false / off,
    as in the JAX package."""
    v = os.environ.get("CRUCIBLE_REPLAY_BLOCKED", "1").lower()
    return v not in ("0", "false", "off")


def supported(sd, n_rows: int) -> bool:
    """Can this scene's replay run in the kernels? Sphere-only static scenes
    with solid / checker-of-solid textures under the default sky, and at
    most ``MAX_TABLE_ROWS`` table rows."""
    return (
        sd.num_tris == 0
        and not sd.animated
        and not sd.motion_exact
        and len(sd.tex.images) == 0
        and sd.tex.max_nest <= 1
        and sd.sky_kind == sky_mod.DEFAULT
        and n_rows <= MAX_TABLE_ROWS
    )


def _decode(word: torch.Tensor) -> dict:
    """Packed record words (models/replay.py layout) -> decision dict."""
    return dict(
        idx=torch.bitwise_right_shift(word, 8),  # words are non-negative
        alive=(word & mk.F_ALIVE) > 0,
        hit=(word & mk.F_HIT) > 0,
        cont=(word & mk.F_SCAT) > 0,
        front=(word & mk.F_FRONT) > 0,
        refl=(word & mk.F_REFL) > 0,
        degen=(word & mk.F_DEGEN) > 0,
        root1=(word & mk.F_ROOT1) > 0,
    )


# ---------------------------------------------------------------------------
# Twins
# ---------------------------------------------------------------------------


def bounce(carry, ch, dec, u1, u2, u_dec, accumulate: bool):
    """One replay bounce on a batch of lanes (``_bounce``, l.130-276).

    ``carry`` is (ox, oy, oz, dx, dy, dz, tx, ty, tz), each (L,); ``ch``
    maps a table column of ``USED`` to the winners' values (L,); ``dec`` is
    :func:`_decode`'s dict. Operation for operation the arithmetic of
    ``csrc/replay_kernel.cu``'s ``bounce_fwd``, so that both round alike.
    Returns (carry', (dr, dg, db)); the increments are zeros unless
    ``accumulate``.
    """
    ox, oy, oz, dx, dy, dz, tx, ty, tz = carry
    hit, cont, front = dec["hit"], dec["cont"], dec["front"]

    # Winner quadratic -> recorded root (double-where sqrt: AD-safe).
    cwx, cwy, cwz, rw = ch[0], ch[1], ch[2], ch[3]
    a_q = dx * dx + dy * dy + dz * dz
    ocx, ocy, ocz = cwx - ox, cwy - oy, cwz - oz
    h_q = dx * ocx + dy * ocy + dz * ocz
    c_q = (ocx * ocx + ocy * ocy + ocz * ocz) - rw * rw
    disc = h_q * h_q - a_q * c_q
    pos = disc > 0.0
    sqrtd = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    t_sph = (h_q + torch.where(dec["root1"], sqrtd, -sqrtd)) / a_q

    t_sh = torch.where(hit, t_sph, 1.0)
    hx, hy, hz = ox + t_sh * dx, oy + t_sh * dy, oz + t_sh * dz
    rmax = torch.clamp_min(rw, 1e-20)
    nsx, nsy, nsz = (hx - cwx) / rmax, (hy - cwy) / rmax, (hz - cwz) / rmax
    nx = torch.where(front, nsx, -nsx)
    ny = torch.where(front, nsy, -nsy)
    nz = torch.where(front, nsz, -nsz)

    dlen = torch.clamp_min(torch.sqrt(a_q), 1e-20)
    udx, udy, udz = dx / dlen, dy / dlen, dz / dlen

    if accumulate:
        a_sky = 0.5 * (udy + 1.0)
        one_m = 1.0 - a_sky
        dr = tx * torch.where(hit, ch[10], one_m + a_sky * 0.5)
        dg = ty * torch.where(hit, ch[11], one_m + a_sky * 0.7)
        db = tz * torch.where(hit, ch[12], one_m + a_sky)
    else:
        dr = dg = db = torch.zeros_like(tx)

    # Albedo: solid or checker of solids (floor: no gradient).
    hp = torch.stack([hx, hy, hz], dim=-1).detach()
    is_even = tex_mod.checker_is_even(ch[17].detach(), hp)
    is_checker = ch[13] == tex_mod.CHECKER
    alr = torch.where(is_checker, torch.where(is_even, ch[18], ch[21]), ch[14])
    alg = torch.where(is_checker, torch.where(is_even, ch[19], ch[22]), ch[15])
    alb = torch.where(is_checker, torch.where(is_even, ch[20], ch[23]), ch[16])

    # Scatter with the recorded decisions.
    ru = sampling.unit_vector(u1, u2)
    rux, ruy, ruz = ru[:, 0], ru[:, 1], ru[:, 2]

    degen = dec["degen"]
    lamx = torch.where(degen, nx, nx + rux)
    lamy = torch.where(degen, ny, ny + ruy)
    lamz = torch.where(degen, nz, nz + ruz)
    pmax = torch.clamp_min(ch[9], 1e-8)
    latr, latg, latb = alr / pmax, alg / pmax, alb / pmax

    fuzz = ch[7]
    k = 2.0 * (dx * nx + dy * ny + dz * nz)
    refx, refy, refz = dx - k * nx, dy - k * ny, dz - k * nz
    rlen = torch.clamp_min(torch.sqrt((refx * refx + refy * refy) + refz * refz), 1e-20)
    metx = refx / rlen + fuzz * rux
    mety = refy / rlen + fuzz * ruy
    metz = refz / rlen + fuzz * ruz

    ior = ch[8]
    ri = torch.where(front, 1.0 / ior, ior)
    ud_dot_n = udx * nx + udy * ny + udz * nz
    cos_t = torch.clamp_max(-ud_dot_n, 1.0)
    k2 = 2.0 * ud_dot_n
    drefx, drefy, drefz = udx - k2 * nx, udy - k2 * ny, udz - k2 * nz
    ppx = ri * (udx + cos_t * nx)
    ppy = ri * (udy + cos_t * ny)
    ppz = ri * (udz + cos_t * nz)
    pp_sq = (ppx * ppx + ppy * ppy) + ppz * ppz
    par = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - pp_sq), 1e-12))
    refl = dec["refl"]
    diex = torch.where(refl, drefx, ppx + par * nx)
    diey = torch.where(refl, drefy, ppy + par * ny)
    diez = torch.where(refl, drefz, ppz + par * nz)

    mat = ch[6]
    is_metal = mat == mat_mod.METAL
    is_diel = mat == mat_mod.DIELECTRIC
    ndx = torch.where(is_diel, diex, torch.where(is_metal, metx, lamx))
    ndy = torch.where(is_diel, diey, torch.where(is_metal, mety, lamy))
    ndz = torch.where(is_diel, diez, torch.where(is_metal, metz, lamz))
    atr = torch.where(is_diel, 1.0, torch.where(is_metal, alr, latr))
    atg = torch.where(is_diel, 1.0, torch.where(is_metal, alg, latg))
    atb = torch.where(is_diel, 1.0, torch.where(is_metal, alb, latb))

    new = (
        torch.where(cont, hx, ox), torch.where(cont, hy, oy), torch.where(cont, hz, oz),
        torch.where(cont, ndx, dx), torch.where(cont, ndy, dy), torch.where(cont, ndz, dz),
        torch.where(cont, tx * atr, tx), torch.where(cont, ty * atg, ty),
        torch.where(cont, tz * atb, tz),
    )
    return new, (dr, dg, db)


def _walk(table, o, d, valid, pix, smp, rec, seed, accum_from):
    """The twins' replay: every row on the lanes alive there, winner rows
    gathered by index -> radiance (R, 3). Differentiable w.r.t. table, o
    and d; dead rows are skipped, as in the kernels."""
    thr = (valid > 0).to(o.dtype)
    carry = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], thr, thr, thr)
    rad = [torch.zeros_like(thr) for _ in range(3)]
    for it in range(rec.shape[0]):
        live = torch.nonzero((rec[it] & mk.F_ALIVE) > 0).squeeze(1)
        if live.numel() == 0:
            continue
        dec = _decode(rec[it, live])
        rows = torch.index_select(table, 0, dec["idx"].long())
        ch = {c: rows[:, c] for c in USED}
        u1, u2, u_dec = crng.uniform3(
            pix[live], smp[live], crng.STREAM_BOUNCE_BASE + it, seed
        )
        acc = it >= accum_from
        new, inc = bounce(
            tuple(x[live] for x in carry), ch, dec, u1, u2, u_dec, acc
        )
        carry = tuple(x.index_copy(0, live, y) for x, y in zip(carry, new))
        if acc:
            rad = [a.index_add(0, live, b) for a, b in zip(rad, inc)]
    return torch.stack(rad, dim=1)


def replay_forward_reference(table, o, d, valid, pix, smp, rec, seed, *, accum_from=0):
    """Eager-torch version of the forward kernel: same inputs and output."""
    with torch.no_grad():
        return _walk(table, o, d, valid, pix, smp, rec, seed, accum_from)


def replay_backward_reference(
    table, o, d, valid, pix, smp, rec, seed, g_rad, *, accum_from=0
):
    """Eager-torch version of the backward kernel: torch autograd through
    :func:`_walk` -> (g_table (N, 32), g_o (R, 3), g_d (R, 3))."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (table, o, d)]
        rad = _walk(*leaves, valid, pix, smp, rec, seed, accum_from)
        if not rad.requires_grad:  # no row adds radiance (an empty bucket)
            return tuple(torch.zeros_like(x) for x in leaves)
        grads = torch.autograd.grad(rad, leaves, g_rad, allow_unused=True)
    return tuple(
        torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)
    )


def replay_legacy_forward_reference(table, o3, d3, valid, pix, smp, rec, seed, *,
                                    accum_from=0):
    """Eager-torch version of K4-legacy: :func:`replay_forward_reference`
    on the transposed inputs -> radiance (3, R)."""
    return replay_forward_reference(
        table, o3.t(), d3.t(), valid[0], pix[0], smp[0], rec, seed, accum_from=accum_from
    ).t().contiguous()


def replay_legacy_backward_reference(table, o3, d3, valid, pix, smp, rec, seed, g_rad3, *,
                                     accum_from=0):
    """Eager-torch version of K4-legacy's backward:
    :func:`replay_backward_reference` on the transposed inputs ->
    (g_table (N, 32), g_o (3, R), g_d (3, R))."""
    g_table, g_o, g_d = replay_backward_reference(
        table, o3.t(), d3.t(), valid[0], pix[0], smp[0], rec, seed, g_rad3.t(),
        accum_from=accum_from,
    )
    return g_table, g_o.t().contiguous(), g_d.t().contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(table, o, d, valid, pix, smp, rec, g_rad=None, legacy=False):
    """Raise on what the kernels do not take. ``legacy``: K4-legacy's
    layouts, rays (3, R) and ids (1, R); else rays (R, 3) and ids (R,)."""
    if legacy:
        r = o.shape[1] if o.dim() == 2 else -1
        ray, ids = (3, r), (1, r)
    else:
        r = o.shape[0] if o.dim() == 2 else -1
        ray, ids = (r, 3), (r,)
    expect = [
        ("table", table, torch.float32, None),
        ("o", o, torch.float32, ray),
        ("d", d, torch.float32, ray),
        ("valid", valid, torch.int32, ids),
        ("pix", pix, torch.int32, ids),
        ("smp", smp, torch.int32, ids),
        ("rec", rec, torch.int32, None),
    ]
    if g_rad is not None:
        expect.append(("g_rad", g_rad, torch.float32, ray))
    build.check_tensors(table.device, expect)
    if table.dim() != 2 or table.shape[1] != C_IN:
        raise ValueError(f"table must be (N, {C_IN}), got {tuple(table.shape)}")
    if rec.dim() != 2 or rec.shape[1] != r:
        raise ValueError(f"rec must be (depth, {r}), got {tuple(rec.shape)}")
    if table.device.type == "cuda" and table.shape[0] > MAX_TABLE_ROWS:
        raise ValueError(
            f"{table.shape[0]} table rows exceed the replay kernels' "
            f"{MAX_TABLE_ROWS} (shared memory)"
        )


def _lib():
    return build.load("replay_kernel")


def grid_size(blocks_per_sm: int, sms: int, threads: int, r: int) -> int:
    """Blocks of a persistent launch: as many as stay resident, none more
    than ``r`` lanes need."""
    return min(blocks_per_sm * sms, -(-r // threads))


def backward_scratch(n: int, depth: int, grid: int) -> tuple[int, int]:
    """Floats of K3's scratch for ``grid`` blocks: the carries (depth x 9 a
    resident thread) and the block partials (n x 22 a block)."""
    return depth * 9 * grid * BACKWARD_BLOCK, grid * n * NUSE


@functools.cache
def _shape(kind: int, n: int, device: int) -> tuple:
    """The C library's launch shape, queried once per (kernel, n, card); the
    query also lets the kernels take a block's whole shared memory, so each
    launch is sized from here and itself queries nothing."""
    lib = _lib()
    shape = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        build.check(lib, lib.crucible_replay_shape(kind, n, shape), "replay shape")
    return tuple(shape)


def launch_shape(kernel: str, n: int, r: int, device=None) -> dict:
    """The launch on the current card (or ``device``) of ``kernel``
    ("forward" K4, "backward" K3, "legacy_forward", "legacy_backward") for
    an n-row table and R lanes: grid, resident blocks per SM, SMs, threads
    per block, registers and local (spill) bytes per thread, dynamic shared
    memory per block, and whether K3's partial is in shared memory.
    K4-legacy's backward launches on K3's grid and partial placement."""
    index = None if device is None else torch.device(device).index
    dev = torch.cuda.current_device() if index is None else index
    per_sm, sms, threads, regs, local, smem, sp = _shape(_SHAPE_KINDS[kernel], n, dev)
    grid = grid_size(per_sm, sms, threads, r)
    if kernel == "legacy_backward":
        grid = launch_shape("backward", n, r, dev)["grid"]
    return dict(grid=grid, blocks_per_sm=per_sm, sms=sms,
                threads=threads, registers=regs, spill_bytes=local, smem_bytes=smem,
                shared_partial=bool(sp))


def _launch_forward(legacy, table, o, d, valid, pix, smp, rec, seed, accum_from):
    """Launch K4, or with ``legacy`` K4-legacy on its layouts -> radiance in
    the rays' layout."""
    lib = _lib()
    n, r, depth = table.shape[0], rec.shape[1], rec.shape[0]
    grid = launch_shape("legacy_forward" if legacy else "forward", n, r, table.device)["grid"]
    rad = torch.empty(o.shape, dtype=torch.float32, device=table.device)
    nxt = torch.empty((1,), dtype=torch.int32, device=table.device)  # work counter
    launch = lib.crucible_replay_legacy_forward if legacy else lib.crucible_replay_forward
    with torch.cuda.device(table.device):
        err = launch(
            table.data_ptr(), o.data_ptr(), d.data_ptr(), valid.data_ptr(),
            pix.data_ptr(), smp.data_ptr(), rec.data_ptr(),
            n, r, depth, int(accum_from), mk.as_i32(int(seed)), grid,
            nxt.data_ptr(), rad.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, err, "replay legacy forward" if legacy else "replay forward")
    return rad


def _launch_backward(legacy, table, o, d, valid, pix, smp, rec, seed, g_rad, accum_from):
    """Launch K3, or with ``legacy`` K4-legacy's backward on its layouts ->
    (g_table (N, 32), g_o and g_d in the rays' layout)."""
    lib = _lib()
    n, r, depth = table.shape[0], rec.shape[1], rec.shape[0]
    # Persistent and static: the block count fixes the order in which the
    # table cotangent is summed, so it depends on the card, n and r alone.
    # K4-legacy's backward takes K3's count, so that its table cotangent has
    # K3's bits whatever registers each instantiation was given; and K3's
    # partial placement, which moves no sum.
    shape = launch_shape("backward", n, r, table.device)
    grid = shape["grid"]
    dev = dict(dtype=torch.float32, device=table.device)
    n_ck, n_part = backward_scratch(n, depth, grid)
    ck = torch.empty((n_ck,), **dev)
    part = torch.empty((n_part,), **dev)
    g_table = torch.empty((n, C_IN), **dev)
    g_o = torch.empty(o.shape, **dev)
    g_d = torch.empty(o.shape, **dev)
    launch = lib.crucible_replay_legacy_backward if legacy else lib.crucible_replay_backward
    with torch.cuda.device(table.device):
        err = launch(
            table.data_ptr(), o.data_ptr(), d.data_ptr(), valid.data_ptr(),
            pix.data_ptr(), smp.data_ptr(), rec.data_ptr(), g_rad.data_ptr(),
            n, r, depth, int(accum_from), mk.as_i32(int(seed)), grid,
            int(shape["shared_partial"]), ck.data_ptr(), part.data_ptr(), g_table.data_ptr(),
            g_o.data_ptr(), g_d.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, err, "replay legacy backward" if legacy else "replay backward")
    return g_table, g_o, g_d


def replay_forward(table, o, d, valid, pix, smp, rec, seed, *, accum_from=0):
    """Replay forward (K4) -> radiance (R, 3): rows below ``accum_from``
    update the carry only. CUDA tensors launch the kernel; CPU tensors run
    the twin."""
    global LAUNCHES_FORWARD
    _check_inputs(table, o, d, valid, pix, smp, rec)
    if table.device.type == "cpu":
        return replay_forward_reference(
            table, o, d, valid, pix, smp, rec, seed, accum_from=accum_from
        )
    rad = _launch_forward(False, table, o, d, valid, pix, smp, rec, seed, accum_from)
    LAUNCHES_FORWARD += 1
    return rad


def replay_backward(table, o, d, valid, pix, smp, rec, seed, g_rad, *, accum_from=0):
    """Replay backward (K3) -> (g_table (N, 32), g_o (R, 3), g_d (R, 3)),
    the cotangents of :func:`replay_forward` for the radiance cotangent
    ``g_rad``. The table cotangent is summed in a fixed order: two launches
    on the same inputs give the same bits. CUDA tensors launch the kernel;
    CPU tensors run the twin."""
    global LAUNCHES_BACKWARD
    _check_inputs(table, o, d, valid, pix, smp, rec, g_rad)
    if table.device.type == "cpu":
        return replay_backward_reference(
            table, o, d, valid, pix, smp, rec, seed, g_rad, accum_from=accum_from
        )
    out = _launch_backward(False, table, o, d, valid, pix, smp, rec, seed, g_rad, accum_from)
    LAUNCHES_BACKWARD += 1
    return out


def replay_legacy_forward(table, o3, d3, valid, pix, smp, rec, seed, *, accum_from=0):
    """K4-legacy's forward -> radiance (3, R): :func:`replay_forward` on
    channel-major rays ``o3`` / ``d3`` (3, R) and id rows ``valid`` /
    ``pix`` / ``smp`` (1, R), the layouts of the JAX unblocked pair. CUDA
    tensors launch the kernel; CPU tensors run the twin."""
    global LAUNCHES_LEGACY_FORWARD
    _check_inputs(table, o3, d3, valid, pix, smp, rec, legacy=True)
    if table.device.type == "cpu":
        return replay_legacy_forward_reference(
            table, o3, d3, valid, pix, smp, rec, seed, accum_from=accum_from
        )
    rad = _launch_forward(True, table, o3, d3, valid, pix, smp, rec, seed, accum_from)
    LAUNCHES_LEGACY_FORWARD += 1
    return rad


def replay_legacy_backward(table, o3, d3, valid, pix, smp, rec, seed, g_rad3, *,
                           accum_from=0):
    """K4-legacy's backward -> (g_table (N, 32), g_o (3, R), g_d (3, R)):
    :func:`replay_backward` in :func:`replay_legacy_forward`'s layouts, with
    K3's fixed-order table cotangent. CUDA tensors launch the kernel; CPU
    tensors run the twin."""
    global LAUNCHES_LEGACY_BACKWARD
    _check_inputs(table, o3, d3, valid, pix, smp, rec, g_rad3, legacy=True)
    if table.device.type == "cpu":
        return replay_legacy_backward_reference(
            table, o3, d3, valid, pix, smp, rec, seed, g_rad3, accum_from=accum_from
        )
    out = _launch_backward(True, table, o3, d3, valid, pix, smp, rec, seed, g_rad3, accum_from)
    LAUNCHES_LEGACY_BACKWARD += 1
    return out


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


def _layout(legacy, o, d, valid, pix, smp):
    """The kernel pair's input layouts: the blocked pair's (R, 3) rays and
    (R,) ids as given, or K4-legacy's channel-major (3, R) rays and (1, R)
    id rows."""
    if not legacy:
        return o, d, valid, pix, smp
    r = o.shape[0]
    return (o.t().contiguous(), d.t().contiguous(), valid.reshape(1, r),
            pix.reshape(1, r), smp.reshape(1, r))


def _vjp(ctx, g_rad):
    """(g_table, g_o (R, 3), g_d (R, 3)) of the replay saved in ``ctx``; the
    legacy pair's channel-major cotangents come back (R, 3) and contiguous,
    so what autograd passes on is laid out as the blocked pair's."""
    saved = ctx.saved_tensors
    kw = dict(accum_from=ctx.accum_from)
    if not ctx.legacy:
        return replay_backward(*saved, ctx.seed, g_rad.contiguous(), **kw)
    g_table, g_o3, g_d3 = replay_legacy_backward(*saved, ctx.seed, g_rad.t().contiguous(), **kw)
    return g_table, g_o3.t().contiguous(), g_d3.t().contiguous()


class Replay(torch.autograd.Function):
    """Radiance replayed by K4; its VJP by K3 (the JAX ``replay``). With
    ``legacy``, K4-legacy's pair on its layouts, transposed here so that
    autograd sees (R, 3) tensors either way."""

    @staticmethod
    def forward(ctx, table, o, d, valid, pix, smp, rec, seed, accum_from, legacy):
        args = (table, *_layout(legacy, o, d, valid, pix, smp), rec)
        ctx.save_for_backward(*args)
        ctx.seed, ctx.accum_from, ctx.legacy = seed, accum_from, legacy
        if legacy:
            return replay_legacy_forward(*args, seed, accum_from=accum_from).t().contiguous()
        return replay_forward(*args, seed, accum_from=accum_from)

    @staticmethod
    def backward(ctx, g_rad):
        return (*_vjp(ctx, g_rad), None, None, None, None, None, None, None)


class ReplayGiven(torch.autograd.Function):
    """A radiance computed elsewhere (the fused record pass) as the primal;
    its VJP by K3 (the JAX ``replay_given``), or with ``legacy`` by
    K4-legacy's backward."""

    @staticmethod
    def forward(ctx, table, o, d, valid, pix, smp, rec, seed, accum_from, legacy, rad):
        ctx.save_for_backward(table, *_layout(legacy, o, d, valid, pix, smp), rec)
        ctx.seed, ctx.accum_from, ctx.legacy = seed, accum_from, legacy
        return rad.clone()

    @staticmethod
    def backward(ctx, g_rad):
        return (*_vjp(ctx, g_rad), None, None, None, None, None, None, None, None)


def trace_replay_mega(
    table,
    o,
    d,
    pixel_ids,
    sample_ids,
    seed,
    rec,
    *,
    accum_from: int = 0,
    valid=None,
    rad_given=None,
    blocked=None,
):
    """Differentiable replay -> radiance (R, 3), differentiable w.r.t.
    ``table``, ``o`` and ``d``.

    ``valid`` (R,) bool: the throughput starts at this 0/1 mask (None = all
    lanes live). ``rad_given`` (R, 3): a forward radiance already computed
    for these records (the fused record pass); it becomes the primal and
    only the backward kernel runs. ``blocked``: True takes K4 / K3, False
    K4-legacy on channel-major copies of the rays (the JAX unblocked
    pair's layouts; the same values and (R, 3) results, transposed inside
    the autograd functions); None reads ``CRUCIBLE_REPLAY_BLOCKED``
    (:func:`_blocked_default`).
    """
    if blocked is None:
        blocked = _blocked_default()
    valid_i = (
        torch.ones((o.shape[0],), dtype=torch.int32, device=table.device)
        if valid is None
        else valid.to(torch.int32).contiguous()
    )
    args = (
        table.contiguous(), o.contiguous(), d.contiguous(), valid_i,
        pixel_ids.to(torch.int32).contiguous(), sample_ids.to(torch.int32).contiguous(),
        rec.to(torch.int32).contiguous(), int(seed) & 0xFFFFFFFF, int(accum_from), not blocked,
    )
    if rad_given is not None:
        return ReplayGiven.apply(*args, rad_given.detach())
    return Replay.apply(*args)
