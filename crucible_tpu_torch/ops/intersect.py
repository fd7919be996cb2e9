"""Batched closest-hit sphere intersection with an O(R) backward (port of
the sphere part of ``crucible_tpu/ops/intersect.py``).

The primal is K10 (``ops/kernels/sphere_hit.py``): the CUDA kernel for
CUDA tensors, its plain version for CPU tensors. The backward differentiates
the hit distance as an IMPLICIT function of the winning sphere's quadratic
f(t) = |o + t d - c|^2 - r^2 = 0: dt/dtheta = -(df/dtheta) / (df/dt), so it
touches only the R winners instead of an (R, N) candidate matrix. Winners
and hit flags are discrete and carry no gradient. Per-ray tables, each
sphere at each ray's own time (exact-time motion), take a plain (R, N)
search with the same backward.

:func:`hit_spheres_moving` is the closest hit against linearly moving
spheres, in plain torch with the same winner-only backward: the semantic
reference of the motion branches of K8 and K9, and the staged bounce's
search for animated scenes (direct AD on a moving scene runs it).

Triangles: :func:`hit_triangles`, the brute (R, M) Möller–Trumbore search
of small meshes (shared or per-ray vertices), differentiable through the
winner's own t;
:func:`triangle_normal`; and :func:`hit_aabbs`, the batched slab test. The
BVH walk over big meshes is ``ops/traverse.py``.
"""

from __future__ import annotations

import math

import torch

from crucible_tpu_torch.ops.kernels import sphere_hit
from crucible_tpu_torch.utils.vec import dot, safe_arccos, safe_arctan2

BIG = sphere_hit.BIG
MT_EPS = 1e-8  # Möller–Trumbore determinant guard (parallel ray and plane)


def per_ray_closest(o, d, cx, cy, cz, radii, act, t_min):
    """The (R, N) closest-hit search of per-ray tables, given as their
    centers' components cx, cy, cz (R, N) and radii (R, N) or (1, N), with
    ``act`` (R, N) or (1, N) bool -> (t (R,), BIG on a miss; idx (R,)
    int64, the lowest row at the minimum). The JAX package's per-ray form:
    d.c and o.c summed per component, a root needs a discriminant >= 0,
    the near root preferred. No autograd (see :func:`winner_t`)."""
    with torch.no_grad():
        d_dot_c = d[:, 0:1] * cx + d[:, 1:2] * cy + d[:, 2:3] * cz
        o_dot_c = o[:, 0:1] * cx + o[:, 1:2] * cy + o[:, 2:3] * cz
        c_sq = cx * cx + cy * cy + cz * cz
        a = dot(d, d)[:, None]
        h = d_dot_c - dot(d, o)[:, None]
        c = c_sq - 2.0 * o_dot_c + dot(o, o)[:, None] - radii * radii
        disc = h * h - a * c
        pos = disc > 0.0
        sqrtd = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
        root0 = (h - sqrtd) / a
        root1 = (h + sqrtd) / a
        ok0 = (root0 > t_min) & (root0 < math.inf)
        ok1 = (root1 > t_min) & (root1 < math.inf)
        root = torch.where(ok0, root0, root1)
        t_all = torch.where((disc >= 0.0) & (ok0 | ok1) & act, root, BIG)
        return t_all.min(dim=1)


class _WinnerT(torch.autograd.Function):
    """(o, d, c_w, r_w, t, hit) -> t, each ray's hit distance on its
    winning sphere (center c_w (R, 3), radius r_w (R,)), with the implicit
    backward on that sphere's quadratic (module docstring): the cotangents
    of o, d, c_w and r_w."""

    @staticmethod
    def forward(ctx, o, d, c_w, r_w, t, hit):
        ctx.save_for_backward(o, d, c_w, r_w, t, hit)
        return t.clone()

    @staticmethod
    def backward(ctx, t_bar):
        o, d, c_w, r_w, t, hit = ctx.saved_tensors
        return (*_winner_cotangents(o, d, c_w, r_w, t, hit, t_bar, ctx.needs_input_grad),
                None, None)


def _winner_cotangents(o, d, c_w, r_w, t, hit, t_bar, need):
    """The cotangents of o, d, c_w and r_w (None where ``need`` says no)
    of hit distances t on the winners' quadratics (module docstring)."""
    # Miss lanes carry t = BIG; BIG * |d| overflows to inf and 0 * inf
    # would NaN the masked-out products below, so mask t first.
    t_safe = torch.where(hit, t, 1.0)
    nvec = o + t_safe[:, None] * d - c_w  # hit point minus center
    den = (d * nvec).sum(-1)  # (df/dt) / 2 at the root
    # Tangent hits (den ~ 0) have a diverging derivative: no gradient.
    steep = torch.abs(den) > 1e-12
    g = torch.where(hit & steep, t_bar / torch.where(steep, den, 1.0), 0.0)
    go = -g[:, None] * nvec if need[0] else None
    gd = -(g * t_safe)[:, None] * nvec if need[1] else None
    gc = torch.where(hit[:, None], g[:, None] * nvec, 0.0) if need[2] else None
    gr = torch.where(hit, g * r_w, 0.0) if need[3] else None
    return go, gd, gc, gr


def winner_t(o, d, t, hit, c_w, r_w):
    """The hit distances ``t`` (R,) of a search made outside autograd, on
    the tape: differentiable in o, d and the winners' centers c_w (R, 3)
    and radii r_w (R,) (each ray's distance as an implicit function of
    its winner's quadratic). Every sphere search here returns its t so;
    a table's cotangent comes from the gather of its winners' rows
    (``index_select``, whose backward is an ``index_add``)."""
    return _WinnerT.apply(o, d, c_w, r_w, t, hit)


def hit_spheres(o, d, centers, radii, active, t_min):
    """Closest sphere hit per ray, differentiable in o, d, centers and radii.

    Args:
      o, d: (R, 3) float32 ray origins / directions (d need not be unit).
      centers: (N, 3), or (R, N, 3) per-ray tables (exact-time motion: every
        sphere at each ray's own time); radii: (N,) or (R, N); active: (N,)
        or (R, N) bool or 0/1, False for hidden and padding rows.
      t_min: float, the exclusive lower bound of accepted roots; roots are
        accepted below BIG (the JAX callers' t_max is infinite).

    Returns (t (R,), BIG on a miss; idx (R,) int32, 0 on a miss, the lowest
    row among equal t; hit (R,)). A shared table goes to K10; per-ray
    tables are searched in plain torch (no kernel computes them, in the
    JAX package either), with the same winner-only backward, so the caller
    keeps (R, N) small (``integrator.exact_lanes``)."""
    if centers.dim() == 3:
        act = torch.as_tensor(active, device=centers.device).to(torch.float32) > 0.0
        radii = torch.broadcast_to(radii, centers.shape[:2])
        t, idx = per_ray_closest(o, d, *centers.unbind(-1), radii,
                                 act if act.dim() == 2 else act[None], float(t_min))
        # The winners' rows, gathered on the tape (their backward scatters
        # at (ray, winner)).
        c_w = torch.gather(centers, 1, idx[:, None, None].expand(-1, 1, 3))[:, 0]
        r_w = torch.gather(radii, 1, idx[:, None])[:, 0]
        hit = t < BIG
        return winner_t(o, d, t, hit, c_w, r_w), idx.to(torch.int32), hit
    active_f = torch.as_tensor(active, device=centers.device).to(torch.float32)
    with torch.no_grad():
        c0, c1, c2 = centers[:, 0], centers[:, 1], centers[:, 2]
        csr = c0 * c0 + c1 * c1 + c2 * c2 - radii * radii
        t, idx, hit = sphere_hit.hit_spheres(
            o.contiguous(), d.contiguous(), centers.contiguous(), csr.contiguous(),
            active_f.contiguous(), float(t_min))
    rows = idx.to(torch.int64)
    return (winner_t(o, d, t, hit, torch.index_select(centers, 0, rows),
                     torch.index_select(radii, 0, rows)), idx, hit)


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
        need = ctx.needs_input_grad
        go, gd, gc_rows, gr_rows = _winner_cotangents(o, d, c_w, r_w, t, hit, t_bar,
                                                      (need[0], need[1], True, True))
        # w is a random sample: detached (its derivative would move the
        # shutter instant, which the detached-sampling estimator excludes).
        gw = torch.zeros_like(w) if need[2] else None

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


def _cross(a, b):
    """Component-wise a x b over the last axis, each term rounded on its
    own (the same bits on every device)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def mt_hit(o, d, a, b, c, t_min, t_max):
    """Möller–Trumbore of rays (o, d) against triangles (a, b, c), all
    broadcast over leading axes (last axis 3) -> (t, valid). A hit needs
    |det| > MT_EPS, barycentrics u, v >= 0 with u + v <= 1, and t in
    (t_min, t_max)."""
    e1 = b - a
    e2 = c - a
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    det_ok = torch.abs(det) > MT_EPS
    inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - a
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    valid = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return t, valid


def hit_triangles(o, d, v0, v1, v2, active, t_min, t_max=math.inf, v0d=None, v1d=None,
                  v2d=None, w=None):
    """Closest triangle hit per ray, by Möller–Trumbore against every row.

    Args:
      o, d: (R, 3); v0, v1, v2: (M, 3); active: (M,) bool, False for
        padding rows; t_min, t_max: the open interval of accepted t.
      v0d, v1d, v2d, w: optional linear shutter motion: vertex + w * delta
        with per-ray w (R,), which forms (R, M, 3) tensors, so keep M small
        (the BVH walk, ``ops/traverse.py``, lerps per leaf instead).
      v0, v1, v2 may instead be (R, M, 3) per-ray vertices (exact-time
        motion: every vertex at each ray's own time), without deltas.

    Returns (t (R,), BIG on a miss; idx (R,) int32, the lowest row among
    equal nearest t, 0 on a miss; hit (R,)). The (R, M) search runs outside
    autograd; t is then the winner's own Möller–Trumbore t, on the tape, so
    the gradient reaches o, d and the winners' vertices without saving an
    (R, M) tensor (the JAX package differentiates the same value).
    """
    per_ray = v0.dim() == 3
    if per_ray and v0d is not None:
        raise ValueError("per-ray triangle vertices take no shutter deltas")
    moving = v0d is not None

    def at(v, vd, rows=None):  # the vertices, lerped to each ray's w
        if per_ray:
            return v if rows is None else torch.gather(
                v, 1, rows[:, None, None].expand(-1, 1, 3))[:, 0]
        if rows is None:
            return v[None] if not moving else v[None] + w[:, None, None] * vd[None]
        v = torch.index_select(v, 0, rows)
        return v if not moving else v + w[:, None] * torch.index_select(vd, 0, rows)

    act = torch.as_tensor(active, device=v0.device).to(torch.bool)
    with torch.no_grad():
        t_all, valid = mt_hit(o.detach()[:, None, :], d.detach()[:, None, :],
                              at(v0, v0d), at(v1, v1d), at(v2, v2d), t_min, t_max)
        t_all = torch.where(valid & act[None, :] if act.dim() == 1 else valid & act, t_all, BIG)
        t_best, idx = t_all.min(dim=1)
    hit = t_best < BIG
    t_win, _ = mt_hit(o, d, at(v0, v0d, idx), at(v1, v1d, idx), at(v2, v2d, idx),
                      -math.inf, math.inf)
    return torch.where(hit, t_win, BIG), idx.to(torch.int32), hit


def triangle_normal(v0, v1, v2):
    """Unit geometric normal (v1 - v0) x (v2 - v0), its length floored at
    1e-20."""
    n = _cross(v1 - v0, v2 - v0)
    return n / torch.clamp_min(torch.sqrt(_dot(n, n)), 1e-20)[..., None]


def hit_aabbs(o, d, box_min, box_max, t_min, t_max):
    """Batched slab test of R rays against K boxes -> (R, K) bool: the
    entry max(t_min, the slabs' nearest exits' max) strictly before the
    exit min(t_max, ...). Zero direction components become +-1e-30, so an
    axis-aligned ray starting on a slab plane gives no 0 * inf."""
    d_safe = torch.where(torch.abs(d) < 1e-30, torch.where(d >= 0, 1e-30, -1e-30), d)
    inv_d = 1.0 / d_safe
    t0 = (box_min[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (box_max[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    enter = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), t_min)
    exit_ = torch.clamp_max(torch.maximum(t0, t1).amin(dim=-1), t_max)
    return enter < exit_
