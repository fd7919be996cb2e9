"""Closest sphere hit per ray (K10): the CUDA kernel's wrapper, its launch
count and its plain PyTorch version.

Port of ``crucible_tpu/ops/pallas/sphere_hit.py``. For R rays and an
N-row sphere table (centers, ``csr`` = |c|^2 - r^2 and a 0/1 ``active``
mask), each ray's nearest root accepted in (t_min, BIG), in the Pallas
kernel's expanded quadratic: h = c.d - d.o, c_q = csr - 2 c.o + |o|^2,
roots (h -/+ sqrt(h^2 - a c_q)) * (1/a). The lowest row wins exact ties; a
miss gives t = BIG and idx 0.

:func:`hit_spheres` launches ``csrc/sphere_hit.cu`` for CUDA tensors (or
raises) and runs :func:`hit_spheres_reference` for CPU tensors. The two
round alike, operation for operation. The kernel runs on a persistent grid
(:func:`launch_shape`, queried once per staged table size and card), each
block staging the table's active rows once as 16-byte entries, each thread
carrying four rays. ``LAUNCHES`` counts kernel launches
(not plain-version calls). ``ops/intersect.hit_spheres`` wraps this primal
in its winner-only autograd backward.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from crucible_tpu_torch.ops.kernels import build

# Python floats holding float32 values, so that comparisons agree whether a
# backend compares in float32 or float64. Every kernel wrapper takes them
# from here.
BIG = float(np.float32(3.0e38))
T_MIN = float(np.float32(1.0e-3))

# Rays x rows per step of the plain version.
REFERENCE_CHUNK_ELEMS = 1 << 22

# Launches of the CUDA kernel since the last reset.
LAUNCHES = 0

# Table rows the kernel stages at a time (csrc/common.cuh STAGE_ROWS, K9's
# too); a larger table goes through chunks of this many rows.
STAGE_ROWS = 2048


def hit_spheres(o, d, centers, csr, active, t_min: float = T_MIN):
    """Closest sphere hit -> (t (R,) float32, BIG on a miss; idx (R,) int32,
    0 on a miss; hit (R,) bool).

    o, d: (R, 3) float32; centers (N, 3), csr (N,), active (N,) float32 0/1,
    all contiguous on one device."""
    r = o.shape[0] if o.dim() == 2 else -1
    n = centers.shape[0] if centers.dim() == 2 else -1
    f32 = torch.float32
    build.check_tensors(o.device, (
        ("o", o, f32, (r, 3)), ("d", d, f32, (r, 3)),
        ("centers", centers, f32, (n, 3)), ("csr", csr, f32, (n,)),
        ("active", active, f32, (n,)),
    ))
    if o.device.type == "cpu":
        return hit_spheres_reference(o, d, centers, csr, active, t_min)
    return _launch(o, d, centers, csr, active, t_min)


def staged_entries(n: int) -> int:
    """Shared-memory entries of an n-row table: its first chunk of at most
    ``STAGE_ROWS`` rows, padded to a multiple of 4 (the kernel's
    ``staged_entries``). The launch shape depends on n only through it."""
    return (min(n, STAGE_ROWS) + 3) & ~3


def query_shape(stem: str, entries: int, device: int) -> tuple:
    """The launch shape of the staged search of library ``stem`` (K10's
    ``sphere_hit`` or K9's ``sphere_shade``) for ``entries`` staged entries
    on card ``device``: its ``crucible_<stem>_shape``, which also lets the
    kernel take its dynamic shared memory, so each launch is sized from a
    cached query and queries nothing."""
    lib = build.load(stem)
    shape = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        build.check(lib, getattr(lib, f"crucible_{stem}_shape")(entries, shape), f"{stem} shape")
    return tuple(shape)


@functools.cache
def _shape(entries: int, device: int) -> tuple:
    """K10's launch shape, queried once per (staged entries, card)."""
    return query_shape("sphere_hit", entries, device)


def device_index(device=None) -> int:
    """The index of ``device``, or of the current card where it is None or
    names no index."""
    index = None if device is None else torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def staged_shape(raw: tuple, n: int, r: int, source: str) -> dict:
    """A staged search's launch (K9, K10) for an n-row table and R rays from
    its queried ``raw`` shape: grid (as many blocks as stay resident, none
    more than the rays need at one ray a thread), resident blocks per SM,
    SMs, threads per block, rays a thread, registers and local (spill) bytes
    per thread, dynamic shared memory per block, table rows staged at a
    time and the chunks the table takes."""
    per_sm, sms, threads, regs, local, smem, stage, rpt = raw
    if stage != STAGE_ROWS:
        raise RuntimeError(f"{source} stages {stage} rows, the wrapper {STAGE_ROWS}")
    return dict(grid=min(per_sm * sms, -(-r // threads)), blocks_per_sm=per_sm, sms=sms,
                threads=threads, rays_per_thread=rpt, registers=regs, spill_bytes=local,
                smem_bytes=smem, stage_rows=stage, chunks=-(-n // stage))


def launch_shape(n: int, r: int, device=None) -> dict:
    """K10's launch on the current card (or ``device``) for an n-row table
    and R rays (:func:`staged_shape`)."""
    raw = _shape(staged_entries(n), device_index(device))
    return staged_shape(raw, n, r, "csrc/sphere_hit.cu")


def _launch(o, d, centers, csr, active, t_min):
    global LAUNCHES
    lib = build.load("sphere_hit")
    n, r = centers.shape[0], o.shape[0]
    shape = launch_shape(n, r, device=o.device)
    t = torch.empty((r,), dtype=torch.float32, device=o.device)
    idx = torch.empty((r,), dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        err = lib.crucible_sphere_hit(
            o.data_ptr(), d.data_ptr(), centers.data_ptr(), csr.data_ptr(),
            active.data_ptr(), n, r, ctypes.c_float(t_min), shape["grid"],
            t.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, err, "sphere_hit")
    LAUNCHES += 1
    return t, idx, t < BIG


def hit_spheres_reference(o, d, centers, csr, active, t_min: float = T_MIN):
    """Plain PyTorch version of :func:`hit_spheres`: the (rays x rows)
    quadratic in ray chunks, in the kernel's association, every operation
    rounded on its own. Inputs need not be contiguous."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    a_q = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o_sq = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a_q
    r, n = o.shape[0], centers.shape[0]
    cx, cy, cz = centers[:, 0], centers[:, 1], centers[:, 2]
    on = active > 0.0
    rows = torch.arange(n, device=o.device)
    step = max(1, REFERENCE_CHUNK_ELEMS // max(n, 1))
    ts, idxs = [], []
    for lo in range(0, r, step):
        s = slice(lo, lo + step)
        dc = cx * dx[s] + cy * dy[s] + cz * dz[s]
        oc = cx * ox[s] + cy * oy[s] + cz * oz[s]
        t, idx = nearest_root(dc - d_dot_o[s], csr - 2.0 * oc + o_sq[s],
                              a_q[s], inv_a[s], on, rows, t_min)
        ts.append(t)
        idxs.append(idx)
    t = torch.cat(ts)
    return t, torch.cat(idxs).to(torch.int32), t < BIG


def accepted_roots(h, c_q, a_q, inv_a, on, t_min):
    """Each (ray, row) pair's accepted root from the terms h and c_q:
    disc = h^2 - a c_q, roots (h -/+ sqrt(disc)) * (1/a), the near one
    where it lies in (t_min, BIG), else the far one. ``on`` masks rows
    that may not win. -> (t_all, BIG where no root is accepted; disc)."""
    disc = h * h - a_q * c_q
    sqrtd = torch.sqrt(torch.clamp_min(disc, 0.0))
    root0 = (h - sqrtd) * inv_a
    root1 = (h + sqrtd) * inv_a
    ok0 = (root0 > t_min) & (root0 < BIG)
    ok1 = (root1 > t_min) & (root1 < BIG)
    root = torch.where(ok0, root0, root1)
    valid = (disc >= 0.0) & (ok0 | ok1) & on
    return torch.where(valid, root, BIG), disc


def nearest_root(h, c_q, a_q, inv_a, on, rows, t_min):
    """The search's last steps on (rays, rows) terms h and c_q: the
    accepted roots (:func:`accepted_roots`) and the lowest row at their
    minimum. ``on`` (rows,) bool masks inactive rows. -> (t (rays,), BIG on
    a miss; idx (rays,) int64, 0 on a miss)."""
    t_all, _ = accepted_roots(h, c_q, a_q, inv_a, on, t_min)
    t = t_all.min(dim=1).values
    # A miss (every entry BIG) gives row 0, as the TPU kernel's does.
    idx = torch.where(t_all == t[:, None], rows, rows.shape[0]).min(dim=1).values
    return t, idx
