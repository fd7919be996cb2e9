"""Fused closest sphere hit + winner-attribute fetch (K9): the CUDA kernel's
wrapper, its launch count and its plain PyTorch version.

Port of ``crucible_tpu/ops/pallas/sphere_shade.py``, the kernel of the
staged schedule's fused bounce (``integrator.bounce_step_fused``). Spheres
move on the linear shutter: center c + w cd, radius r + w rd for each ray's
shutter fraction w, with |c(w)|^2 - r(w)^2 = s0 + 2w s1 + w^2 s2 from the
table's per-sphere scalars. Static scenes pass w = 0 and zero deltas.

Input table columns (N, C_IN = 32), ``integrator.make_sphere_table``:
  0-2 center, 3 radius, 4 s0 = |c|^2 - r^2, 5 active, 6 mat_type, 7 fuzz,
  8 ior, 9 prob, 10-12 emission, 13 tex_kind, 14-16 solid color,
  17 checker inv_scale, 18-20 even color, 21-23 odd color, 24-26 center
  delta, 27 radius delta, 28 s1 = c.cd - r rd, 29 s2 = |cd|^2 - rd^2,
  30 texture id, 31 row id.

Output rows (C_OUT = 28, R), rows 0-27 of the TPU kernel's (32, R): 0 t
(BIG on a miss), 1 the winning row as a float (0 on a miss), 2-4 center,
5 radius, 6-23 the shading columns 6-23, 24-26 center delta, 27 radius
delta; rows 2-27 are zero on a miss. The TPU kernel's rows 28-31 are
padding that it never writes and nothing reads, and are left out.

:func:`hit_spheres_fetch` launches ``csrc/sphere_shade.cu`` for CUDA
tensors (or raises) and runs :func:`hit_spheres_fetch_reference` for CPU
tensors; the two round alike. The kernel runs on a persistent grid
(:func:`launch_shape`, queried once per staged table size and card), each
block staging the table's active rows once as K8's 36-byte moving rows and
taking K10's static arithmetic where none of them moves, each thread
carrying four rays. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from crucible_tpu_torch.ops.kernels import build, sphere_hit
from crucible_tpu_torch.ops.kernels.sphere_hit import (
    BIG, REFERENCE_CHUNK_ELEMS, T_MIN, nearest_root, staged_entries,
)

C_IN = 32
C_OUT = 28

# Launches of the CUDA kernel since the last reset.
LAUNCHES = 0

# Staged entries up to which K9 takes one ray a thread on a grid of
# ceil(R / 128) blocks instead of the resident grid's four: a table that
# small is bound by the bytes, and short one-ray threads keep more of them
# in flight (garden's 8 rows at 1080p, NVIDIA H100 80GB HBM3, 700 W:
# 0.108 ms against 0.118 on the resident grid; book1's 488 rows 0.967
# against 0.727; tools/torch_shade_ab.py).
ONE_RAY_ENTRIES = 16


def hit_spheres_fetch(o, d, w, table, t_min: float = T_MIN):
    """Closest sphere hit + the winner's attributes -> (C_OUT, R) float32
    (rows: module docstring). o, d (R, 3), w (R,) and table (N, C_IN), all
    float32, contiguous, on one device."""
    r = o.shape[0] if o.dim() == 2 else -1
    n = table.shape[0] if table.dim() == 2 else -1
    f32 = torch.float32
    build.check_tensors(o.device, (
        ("o", o, f32, (r, 3)), ("d", d, f32, (r, 3)), ("w", w, f32, (r,)),
        ("table", table, f32, (n, C_IN)),
    ))
    if o.device.type == "cpu":
        return hit_spheres_fetch_reference(o, d, w, table, t_min)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (the kernel reads its rows as float4)")
    return _launch(o, d, w, table, t_min)


@functools.cache
def _shape(entries: int, device: int) -> tuple:
    """K9's launch shape, queried once per (staged entries, card)."""
    return sphere_hit.query_shape("sphere_shade", entries, device)


def launch_shape(n: int, r: int, device=None) -> dict:
    """K9's launch on the current card (or ``device``) for an n-row table
    and R rays (``sphere_hit.staged_shape``: grid, blocks an SM, registers,
    spill, shared memory, rows staged at a time, chunks); up to
    ``ONE_RAY_ENTRIES`` staged entries a grid of one ray a thread. Shared
    memory holds 40 bytes a staged entry."""
    entries = staged_entries(n)
    raw = _shape(entries, sphere_hit.device_index(device))
    shape = sphere_hit.staged_shape(raw, n, r, "csrc/sphere_shade.cu")
    if entries <= ONE_RAY_ENTRIES:
        shape.update(grid=-(-r // shape["threads"]), rays_per_thread=1)
    return shape


def _launch(o, d, w, table, t_min):
    global LAUNCHES
    lib = build.load("sphere_shade")
    n, r = table.shape[0], o.shape[0]
    shape = launch_shape(n, r, device=o.device)
    out = torch.empty((C_OUT, r), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = lib.crucible_sphere_shade(
            o.data_ptr(), d.data_ptr(), w.data_ptr(), table.data_ptr(), n, r,
            ctypes.c_float(t_min), shape["grid"], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(lib, err, "sphere_shade")
    LAUNCHES += 1
    return out


def hit_spheres_fetch_reference(o, d, w, table, t_min: float = T_MIN):
    """Plain PyTorch version of :func:`hit_spheres_fetch`: the search of
    :func:`moving_closest_reference`, then the winner's row by an indexed
    read."""
    t, idx = moving_closest_reference(o, d, w, table, t_min)
    r = o.shape[0]
    hit = t < BIG
    out = torch.zeros((C_OUT, r), dtype=torch.float32, device=o.device)
    out[0] = t
    out[1] = idx.to(torch.float32)
    lanes = torch.nonzero(hit).squeeze(1)
    win = torch.index_select(table, 0, idx[lanes])
    out[2:6, lanes] = win[:, 0:4].t()
    out[6:28, lanes] = win[:, 6:28].t()
    return out


def moving_closest_reference(o, d, w, table, t_min: float = T_MIN):
    """The closest hit against the table's spheres moving on the linear
    shutter, at the rays' fractions w: the (rays x rows) quadratic in ray
    chunks, in the kernels' association (K9's, and K8's moving search; the
    motion terms even at w = 0) -> (t (R,), BIG on a miss; idx (R,) int64,
    the lowest row at the minimum, 0 on a miss)."""
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    wv = w[:, None]
    a_q = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o_sq = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a_q
    two_w = 2.0 * wv
    w_sq = wv * wv
    r, n = o.shape[0], table.shape[0]
    cx, cy, cz, s0, on = table[:, 0], table[:, 1], table[:, 2], table[:, 4], table[:, 5] > 0.0
    cdx, cdy, cdz, s1, s2 = table[:, 24], table[:, 25], table[:, 26], table[:, 28], table[:, 29]
    rows = torch.arange(n, device=o.device)
    step = max(1, REFERENCE_CHUNK_ELEMS // max(n, 1))
    ts, idxs = [], []
    for lo in range(0, r, step):
        s = slice(lo, lo + step)
        dc_a = cx * dx[s] + cy * dy[s] + cz * dz[s]
        dc_d = cdx * dx[s] + cdy * dy[s] + cdz * dz[s]
        oc_a = cx * ox[s] + cy * oy[s] + cz * oz[s]
        oc_d = cdx * ox[s] + cdy * oy[s] + cdz * oz[s]
        dc = dc_a + wv[s] * dc_d
        oc = oc_a + wv[s] * oc_d
        csr = s0 + two_w[s] * s1 + w_sq[s] * s2
        t, idx = nearest_root(dc - d_dot_o[s], csr - 2.0 * oc + o_sq[s],
                              a_q[s], inv_a[s], on, rows, t_min)
        ts.append(t)
        idxs.append(idx)
    return torch.cat(ts), torch.cat(idxs)
