"""Batched closest-hit sphere intersection with an O(R) backward (port of
the sphere part of ``crucible_tpu/ops/intersect.py``).

The primal is K10 (``ops/kernels/sphere_hit.py``): the CUDA kernel for
CUDA tensors, its plain version for CPU tensors. The backward differentiates
the hit distance as an IMPLICIT function of the winning sphere's quadratic
f(t) = |o + t d - c|^2 - r^2 = 0: dt/dtheta = -(df/dtheta) / (df/dt), so it
touches only the R winners instead of an (R, N) candidate matrix. Winners
and hit flags are discrete and carry no gradient.

:func:`hit_spheres_moving` is the closest hit against linearly moving
spheres, in plain torch with the same winner-only backward: the semantic
reference of the motion branches of K8 and K9, and the staged bounce's
search for animated scenes (direct AD on a moving scene runs it).
"""

from __future__ import annotations

import math

import torch

from crucible_tpu_torch.ops.kernels import sphere_hit
from crucible_tpu_torch.utils.vec import dot, safe_arccos, safe_arctan2

BIG = sphere_hit.BIG


class _ClosestHit(torch.autograd.Function):
    """(o, d, centers, radii, active_f, t_min) -> (t, idx, hit)."""

    @staticmethod
    def forward(ctx, o, d, centers, radii, active_f, t_min):
        c0, c1, c2 = centers[:, 0], centers[:, 1], centers[:, 2]
        csr = c0 * c0 + c1 * c1 + c2 * c2 - radii * radii
        t, idx, hit = sphere_hit.hit_spheres(
            o.contiguous(), d.contiguous(), centers.contiguous(),
            csr.contiguous(), active_f.contiguous(), t_min,
        )
        ctx.mark_non_differentiable(idx, hit)
        ctx.save_for_backward(o, d, centers, radii, t, idx, hit)
        return t, idx, hit

    @staticmethod
    def backward(ctx, t_bar, _idx_bar, _hit_bar):
        o, d, centers, radii, t, idx, hit = ctx.saved_tensors
        idx = idx.to(torch.int64)
        c_w = torch.index_select(centers, 0, idx)
        # Miss lanes carry t = BIG; BIG * |d| overflows to inf and 0 * inf
        # would NaN the masked-out products below, so mask t first.
        t_safe = torch.where(hit, t, 1.0)
        nvec = o + t_safe[:, None] * d - c_w  # hit point minus center
        den = (d * nvec).sum(-1)  # (df/dt) / 2 at the root
        # Tangent hits (den ~ 0) have a diverging derivative: no gradient.
        steep = torch.abs(den) > 1e-12
        g = torch.where(hit & steep, t_bar / torch.where(steep, den, 1.0), 0.0)
        need_o, need_d, need_c, need_r = ctx.needs_input_grad[:4]
        go = -g[:, None] * nvec if need_o else None
        gd = -(g * t_safe)[:, None] * nvec if need_d else None
        gc = gr = None
        if need_c:
            gc_rows = torch.where(hit[:, None], g[:, None] * nvec, 0.0)
            gc = torch.zeros_like(centers).index_add_(0, idx, gc_rows)
        if need_r:
            gr_rows = torch.where(hit, g * torch.index_select(radii, 0, idx), 0.0)
            gr = torch.zeros_like(radii).index_add_(0, idx, gr_rows)
        return go, gd, gc, gr, None, None


def hit_spheres(o, d, centers, radii, active, t_min):
    """Closest sphere hit per ray, differentiable in o, d, centers and radii.

    Args:
      o, d: (R, 3) float32 ray origins / directions (d need not be unit).
      centers: (N, 3); radii: (N,); active: (N,) bool or 0/1, False for
        hidden and padding rows.
      t_min: float, the exclusive lower bound of accepted roots; roots are
        accepted below BIG (the JAX callers' t_max is infinite).

    Returns (t (R,), BIG on a miss; idx (R,) int32, 0 on a miss; hit (R,)).
    """
    if centers.dim() != 2:
        raise NotImplementedError(
            "per-ray sphere tables (exact-time motion) are not ported to "
            "crucible_tpu_torch yet"
        )
    active_f = torch.as_tensor(active, device=centers.device).to(torch.float32)
    return _ClosestHit.apply(o, d, centers, radii, active_f, float(t_min))


def _moving_closest(o, d, w, ca, cd, ra, rd, act, t_min):
    """The (R, N) search of :func:`hit_spheres_moving` -> (t, idx int64)."""
    wc = w[:, None]

    def dots(v, c):  # (R, N) v . c_k
        return v[:, 0:1] * c[:, 0] + v[:, 1:2] * c[:, 1] + v[:, 2:3] * c[:, 2]

    d_dot_c = dots(d, ca) + wc * dots(d, cd)
    o_dot_c = dots(o, ca) + wc * dots(o, cd)
    c_sq = dot(ca, ca)[None, :] + 2.0 * wc * dot(ca, cd)[None, :] + (wc * wc) * dot(cd, cd)[None, :]
    r_sq = (ra * ra)[None, :] + 2.0 * wc * (ra * rd)[None, :] + (wc * wc) * (rd * rd)[None, :]
    a = dot(d, d)[:, None]
    h = d_dot_c - dot(d, o)[:, None]
    c = c_sq - 2.0 * o_dot_c + dot(o, o)[:, None] - r_sq
    disc = h * h - a * c
    pos = disc > 0.0
    sqrtd = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    root0 = (h - sqrtd) / a
    root1 = (h + sqrtd) / a
    ok0 = (root0 > t_min) & (root0 < math.inf)
    ok1 = (root1 > t_min) & (root1 < math.inf)
    root = torch.where(ok0, root0, root1)
    t_all = torch.where(pos & (ok0 | ok1) & act[None, :], root, BIG)
    return t_all.min(dim=1)


class _MovingHit(torch.autograd.Function):
    """(o, d, w, ca, cd, ra, rd, act, t_min) -> (t, idx, hit), with the
    winner-only backward of the JAX package's ``_moving_hit``
    (``crucible_tpu/ops/intersect.py:224-264``)."""

    @staticmethod
    def forward(ctx, o, d, w, ca, cd, ra, rd, act, t_min):
        with torch.no_grad():
            t, idx = _moving_closest(o, d, w, ca, cd, ra, rd, act, t_min)
        hit = t < BIG
        idx = idx.to(torch.int32)
        ctx.mark_non_differentiable(idx, hit)
        ctx.save_for_backward(o, d, w, ca, cd, ra, rd, t, idx, hit)
        return t, idx, hit

    @staticmethod
    def backward(ctx, t_bar, _idx_bar, _hit_bar):
        o, d, w, ca, cd, ra, rd, t, idx, hit = ctx.saved_tensors
        idx = idx.to(torch.int64)
        wc = w[:, None]
        c_w = torch.index_select(ca, 0, idx) + wc * torch.index_select(cd, 0, idx)
        r_w = torch.index_select(ra, 0, idx) + w * torch.index_select(rd, 0, idx)
        # Miss lanes carry t = BIG: mask it before it meets d (see _ClosestHit).
        t_safe = torch.where(hit, t, 1.0)
        nvec = o + t_safe[:, None] * d - c_w
        den = (d * nvec).sum(-1)
        steep = torch.abs(den) > 1e-12
        g = torch.where(hit & steep, t_bar / torch.where(steep, den, 1.0), 0.0)
        need = ctx.needs_input_grad
        go = -g[:, None] * nvec if need[0] else None
        gd = -(g * t_safe)[:, None] * nvec if need[1] else None
        # w is a random sample: detached (its derivative would move the
        # shutter instant, which the detached-sampling estimator excludes).
        gw = torch.zeros_like(w) if need[2] else None
        gc_rows = torch.where(hit[:, None], g[:, None] * nvec, 0.0)
        gr_rows = torch.where(hit, g * r_w, 0.0)

        def scatter(like, rows, on):  # index_add, not an indexed put (C8)
            return torch.zeros_like(like).index_add_(0, idx, rows) if on else None

        return (go, gd, gw, scatter(ca, gc_rows, need[3]), scatter(cd, wc * gc_rows, need[4]),
                scatter(ra, gr_rows, need[5]), scatter(rd, w * gr_rows, need[6]), None, None)


def hit_spheres_moving(o, d, w, ca, cd, ra, rd, active, t_min):
    """Closest hit against linearly moving spheres: at the per-ray shutter
    fraction w in [0, 1], sphere k has center ca_k + w cd_k and radius
    ra_k + w rd_k.

    The (R, N) terms expand as the JAX package expands them, so that no
    (R, N, 3) tensor is formed: d.c(w) = d.ca + w (d.cd), |c(w)|^2 =
    |ca|^2 + 2w (ca.cd) + w^2 |cd|^2 and r(w)^2 = ra^2 + 2w (ra rd) +
    w^2 rd^2; a root needs a positive discriminant. The search runs
    outside autograd; the backward touches the R winners only (the hit
    distance as an implicit function of the winner's quadratic, as
    :func:`hit_spheres`), the motion leaves with an extra factor w, and w,
    a random sample, gets a zero gradient.

    Args: o, d (R, 3); w (R,); ca, cd (N, 3); ra, rd (N,); active (N,)
    bool or 0/1; t_min the exclusive lower bound of accepted roots (the
    upper one is infinite).
    Returns (t (R,), BIG on a miss; idx (R,) int32, 0 on a miss; hit (R,)).
    """
    act = torch.as_tensor(active, device=ca.device).to(torch.float32) > 0.0
    return _MovingHit.apply(o, d, w, ca, cd, ra, rd, act, float(t_min))


def sphere_uv(n):
    """(u, v) texture coordinates from the unit outward normal:
    theta = acos(-y), phi = atan2(-z, x) + pi; u = phi / 2pi, v = theta / pi."""
    theta = safe_arccos(-n[..., 1])
    phi = safe_arctan2(-n[..., 2], n[..., 0]) + math.pi
    return phi / (2.0 * math.pi), theta / math.pi
