"""The benchmark's plain reference: a Monte Carlo path tracer of spheres in
plain PyTorch, with its gradient in the texture colors.

It computes what "Ray Tracing in One Weekend" and "The Next Week" define,
with the counter-based random numbers of the measured program, so that the
same scene, camera, pixels, samples and seed give the same paths:

- every random number is a PCG4D hash of (pixel, sample, stream, seed)
  (Jarzynski & Olano, JCGT 2020): stream 0 the shutter fraction, stream 1
  the pixel jitter and the defocus disk, stream 3 + b bounce b's scatter;
- the camera of the books (vertical field of view, a defocus disk, a
  jitter of +-0.5 pixel), rays cast unnormalized from the disk point;
- the closest sphere hit by brute force over every row, the near root
  where it lies in (1e-3, 3e38), else the far one; ties to the lowest row;
  a sphere moving on the linear shutter is tested at the path's fraction;
- Lambertian (normal plus a uniform unit vector, the normal where that is
  degenerate), metal (mirror plus fuzz, absorbed below the surface) and
  dielectric (Schlick's reflectance against a uniform, else Snell);
- solid colors and the 3-D checker; the white-to-blue sky on a miss.

The arithmetic is written term by term in one association (the sphere's
quadratic from |c|^2 - r^2, c.d and c.o), so that the reference and a
kernel that rounds each operation alike agree to the last bit on most
paths. Nothing here imports the measured program: the scene arrives as
plain arrays (:class:`Tables`), the camera as numbers; :func:`prepare`
takes both from a configuration and its scene's arrays.

Everything runs in lockstep over the paths, one bounce at a time, the live
paths compacted after each bounce and the (paths x rows) search in chunks.
``dtype`` sets the precision of every floating-point operation (float32 as
the configurations state; bfloat16 is the benchmark's control).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MASK = 0xFFFFFFFF
T_MIN = float(np.float32(1.0e-3))
BIG = float(np.float32(3.0e38))
STREAM_TIME = 0
STREAM_PIXEL_JITTER = 1
STREAM_BOUNCE_BASE = 3
LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
TWO_PI = 2.0 * math.pi
# (paths x rows) elements of one step of the brute search.
CHUNK_ELEMS = 1 << 25


# ---------------------------------------------------------------------------
# Random numbers
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values held in int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * ((b >> 16) & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg4d(a, b, c, d):
    """PCG4D: four uint32 counters (int64 tensors or ints) -> four uint32
    words held in int64."""
    dev = next(t.device for t in (a, b, c, d) if isinstance(t, torch.Tensor))
    x, y, z, w = torch.broadcast_tensors(
        *(torch.as_tensor(v, device=dev).to(torch.int64) & MASK for v in (a, b, c, d)))
    x = (_mul32(x, 1664525) + 1013904223) & MASK
    y = (_mul32(y, 1664525) + 1013904223) & MASK
    z = (_mul32(z, 1664525) + 1013904223) & MASK
    w = (_mul32(w, 1664525) + 1013904223) & MASK
    x = (x + _mul32(y, w)) & MASK
    y = (y + _mul32(z, x)) & MASK
    z = (z + _mul32(x, y)) & MASK
    w = (w + _mul32(y, z)) & MASK
    x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), w ^ (w >> 16)
    x = (x + _mul32(y, w)) & MASK
    y = (y + _mul32(z, x)) & MASK
    z = (z + _mul32(x, y)) & MASK
    w = (w + _mul32(y, z)) & MASK
    return x, y, z, w


def uniform4(pix, smp, stream, seed, dtype=torch.float32):
    """Four uniforms in [0, 1) from the top 24 bits of each word."""
    return tuple(((u >> 8).to(torch.float32) * (2.0 ** -24)).to(dtype)
                 for u in pcg4d(pix, smp, stream, seed))


# ---------------------------------------------------------------------------
# Scene and camera
# ---------------------------------------------------------------------------


@dataclass
class Tables:
    """A scene as tensors. Spheres: ``center`` (N, 3), ``radius`` (N,),
    ``center_d`` (N, 3) shutter-close minus shutter-open or None, ``mat``
    (N,) int64 (LAMBERTIAN, METAL, DIELECTRIC), ``fuzz``, ``ior`` (N,),
    ``tex`` (N,) int64 texture row. Textures: ``color`` (T, 3) (a solid's
    albedo, the parameter a fit moves), ``checker`` (T,) bool, ``inv_scale``
    (T,), ``even`` / ``odd`` (T,) int64 rows of a checker's two colors."""

    center: torch.Tensor
    radius: torch.Tensor
    center_d: torch.Tensor | None
    mat: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor
    tex: torch.Tensor
    color: torch.Tensor
    checker: torch.Tensor
    inv_scale: torch.Tensor
    even: torch.Tensor
    odd: torch.Tensor


def tables(desc: dict, device, dtype=torch.float32) -> Tables:
    """:class:`Tables` from a scene description of numpy arrays (the keys
    of ``benchmark/scenes``' ``describe``)."""
    def f(key):
        return torch.as_tensor(np.asarray(desc[key], np.float32), device=device).to(dtype)

    def i(key):
        return torch.as_tensor(np.asarray(desc[key], np.int64), device=device)

    moving = desc.get("center_d") is not None and np.any(desc["center_d"] != 0)
    # A moving sphere goes from its centre at shutter open to the one at
    # shutter close, a rise given in float32: the delta is taken between
    # the two centres in float32.
    rise = np.asarray(desc["center_d"], np.float32).astype(np.float64)
    close = (np.asarray(desc["center"], np.float64) + rise).astype(np.float32)
    center_d = torch.as_tensor(close - np.asarray(desc["center"], np.float32),
                               device=device).to(dtype)
    return Tables(center=f("center"), radius=f("radius"),
                  center_d=center_d if moving else None, mat=i("mat"), fuzz=f("fuzz"),
                  ior=f("ior"), tex=i("tex"), color=f("tex_color"),
                  checker=torch.as_tensor(np.asarray(desc["tex_checker"], bool), device=device),
                  inv_scale=f("tex_inv_scale"), even=i("tex_even"), odd=i("tex_odd"))


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _unit(a, eps):
    return a / torch.clamp_min(torch.sqrt(_dot(a, a)), eps)[..., None]


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def camera(cam: dict, width: int, height: int, device, dtype=torch.float32) -> dict:
    """The camera's frame: ``p00`` (the first pixel's centre), ``du``,
    ``dv`` (a pixel's steps), ``lf`` (the eye), ``u``, ``v`` (the lens
    axes) and ``defr`` (the defocus disk's radius)."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)

    lf, la, vup = t(cam["lookfrom"]), t(cam["lookat"]), t(cam.get("vup", (0.0, 1.0, 0.0)))
    focus = t(cam["focus_dist"])
    w = _unit(lf - la, 1e-12)
    u = _unit(_cross(vup, w), 1e-12)
    v = _cross(w, u)
    h = torch.tan(t(math.radians(cam["vfov"])) / 2.0)
    vh = 2.0 * h * focus
    vw = vh * (width / height)
    du = vw * u / width
    dv = vh * (-v) / height
    p00 = lf - focus * w - 0.5 * (width - 1) * du - 0.5 * (height - 1) * dv
    defr = focus * torch.tan(t(math.radians(cam["defocus_angle"])) / 2.0)
    return dict(p00=p00, du=du, dv=dv, lf=lf, u=u, v=v, defr=defr)


# ---------------------------------------------------------------------------
# The closest hit
# ---------------------------------------------------------------------------


def closest(o, d, w, tb: Tables):
    """Closest sphere along each ray (the rows moving to the ray's shutter
    fraction ``w`` where the scene moves) -> (t, BIG on a miss; idx, the
    lowest row at the minimum; hit)."""
    c, r = tb.center, tb.radius
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    s0 = cx * cx + cy * cy + cz * cz - r * r
    if tb.center_d is not None:
        cd = tb.center_d
        cdx, cdy, cdz = cd[:, 0], cd[:, 1], cd[:, 2]
        s1 = cx * cdx + cy * cdy + cz * cdz - r * 0.0
        s2 = cdx * cdx + cdy * cdy + cdz * cdz
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    a_q = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o_sq = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a_q
    n = c.shape[0]
    rows = torch.arange(n, device=o.device)
    step = max(1, CHUNK_ELEMS // max(n, 1))
    ts, idxs = [], []
    for lo in range(0, o.shape[0], step):
        s = slice(lo, lo + step)
        dc = cx * dx[s] + cy * dy[s] + cz * dz[s]
        oc = cx * ox[s] + cy * oy[s] + cz * oz[s]
        csr = s0
        if tb.center_d is not None:
            wv = w[s, None]
            dc = dc + wv * (cdx * dx[s] + cdy * dy[s] + cdz * dz[s])
            oc = oc + wv * (cdx * ox[s] + cdy * oy[s] + cdz * oz[s])
            csr = s0 + (2.0 * wv) * s1 + (wv * wv) * s2
        h = dc - d_dot_o[s]
        c_q = csr - 2.0 * oc + o_sq[s]
        disc = h * h - a_q[s] * c_q
        sqrtd = torch.sqrt(torch.clamp_min(disc, 0.0))
        root0 = (h - sqrtd) * inv_a[s]
        root1 = (h + sqrtd) * inv_a[s]
        ok0 = (root0 > T_MIN) & (root0 < BIG)
        ok1 = (root1 > T_MIN) & (root1 < BIG)
        t_all = torch.where((disc >= 0.0) & (ok0 | ok1), torch.where(ok0, root0, root1), BIG)
        t = t_all.min(dim=1).values
        ts.append(t)
        idxs.append(torch.where(t_all == t[:, None], rows, n).min(dim=1).values)
        del dc, oc, h, c_q, disc, sqrtd, root0, root1, ok0, ok1, t_all
    t = torch.cat(ts)
    hit = t < BIG
    return t, torch.where(hit, torch.cat(idxs), 0), hit


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------


def _unit_vector(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _reflect(v, n):
    return v - 2.0 * _dot(v, n)[:, None] * n


def _schlick(cosine, ri):
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    om = 1.0 - cosine
    om2 = om * om
    return r0 + (1.0 - r0) * om2 * om2 * om


def sky(d):
    """The books' sky: white to (0.5, 0.7, 1.0) by the direction's height."""
    a = 0.5 * (_unit(d, 1e-20)[:, 1] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - a)[:, None] * torch.ones_like(blue) + a[:, None] * blue


def albedo(tb: Tables, color, tid, p):
    """A texture row's color at the hit point ``p``: a solid's own, or the
    checker's even or odd child by the parity of floor(p / scale)."""
    xyz = torch.floor(tb.inv_scale[tid][:, None] * p).to(torch.int32)
    even = (xyz[:, 0] + xyz[:, 1] + xyz[:, 2]) % 2 == 0
    leaf = torch.where(tb.checker[tid], torch.where(even, tb.even[tid], tb.odd[tid]), tid)
    return color[leaf]


def scatter(mat, fuzz, ior, alb, d, n, front, u1, u2, u_dec):
    """-> (direction, attenuation, scattered) of each hit."""
    rnd = _unit_vector(u1, u2)
    lam = n + rnd
    degenerate = torch.all(torch.abs(lam) < 1e-8, dim=-1)
    lam = torch.where(degenerate[:, None], n, lam)
    met = _unit(_reflect(d, n), 1e-20) + fuzz[:, None] * rnd
    met_alive = _dot(met, n) > 0.0
    ud = _unit(d, 1e-20)
    ri = torch.where(front, 1.0 / torch.clamp_min(ior, 1e-8), ior)
    cos_t = torch.clamp_max(_dot(-ud, n), 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1.0e-12))
    refl = (ri * sin_t > 1.0) | (_schlick(cos_t, ri) > u_dec)
    perp = ri[:, None] * (ud + cos_t[:, None] * n)
    par = -torch.sqrt(torch.clamp_min(torch.abs(1.0 - _dot(perp, perp)), 1e-12))[:, None] * n
    die = torch.where(refl[:, None], _reflect(ud, n), perp + par)
    is_met, is_die = mat == METAL, mat == DIELECTRIC
    out = torch.where(is_die[:, None], die, torch.where(is_met[:, None], met, lam))
    att = torch.where(is_die[:, None], torch.ones_like(alb), alb)
    return out, att, is_die | (is_met & met_alive) | (mat == LAMBERTIAN)


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------


def trace(tb: Tables, cam: dict, width: int, pix, smp, seed: int, max_depth: int, *,
          color=None, counts: dict | None = None):
    """Radiance (R, 3) of the paths (pixel ``pix``, sample ``smp``) of the
    render ``seed``; differentiable in ``color`` (the texture colors; the
    scene's own by default). ``counts`` gains "searches" (closest-hit
    searches, one a path a bounce) and "continued" (bounces that scatter on)."""
    color = tb.color if color is None else color
    dt, dev = tb.center.dtype, tb.center.device
    pix, smp = pix.to(torch.int64), smp.to(torch.int64)
    fi = (pix % width).to(torch.float32).to(dt)
    fj = torch.div(pix, width, rounding_mode="floor").to(torch.float32).to(dt)
    moving = tb.center_d is not None
    w = uniform4(pix, smp, STREAM_TIME, seed, dt)[0] if moving else None
    ux, uy, ud1, ud2 = uniform4(pix, smp, STREAM_PIXEL_JITTER, seed, dt)
    pos = (cam["p00"] + (fi + (ux - 0.5))[:, None] * cam["du"]
           + (fj + (uy - 0.5))[:, None] * cam["dv"])
    rad, phi = torch.sqrt(ud1), TWO_PI * ud2
    o = (cam["lf"] + (rad * torch.cos(phi) * cam["defr"])[:, None] * cam["u"]
         + (rad * torch.sin(phi) * cam["defr"])[:, None] * cam["v"])
    d = pos - o
    live = torch.arange(pix.shape[0], device=dev)
    thr = torch.ones((pix.shape[0], 3), dtype=dt, device=dev)
    acc = torch.zeros((pix.shape[0], 3), dtype=dt, device=dev)
    for b in range(max_depth):
        if live.numel() == 0:
            break
        w_l = w[live] if moving else None
        with torch.no_grad():
            t, idx, hit = closest(o, d, w_l, tb)
        miss = torch.nonzero(~hit).squeeze(1)
        acc = acc.index_add(0, live[miss], thr[miss] * sky(d[miss]))
        on = torch.nonzero(hit).squeeze(1)
        if counts is not None:
            counts["searches"] = counts.get("searches", 0) + int(live.numel())
        lv, o, d, thr, t, idx = live[on], o[on], d[on], thr[on], t[on], idx[on]
        hp = o + t[:, None] * d
        w_c = tb.center[idx]
        if moving:
            w_c = w_c + w_l[on][:, None] * tb.center_d[idx]
        nrm = (hp - w_c) * (1.0 / torch.clamp_min(tb.radius[idx], 1e-20))[:, None]
        front = _dot(d, nrm) < 0.0
        nrm = nrm * torch.where(front, 1.0, -1.0)[:, None].to(dt)
        alb = albedo(tb, color, tb.tex[idx], hp)
        u1, u2, u_dec, _ = uniform4(pix[lv], smp[lv], STREAM_BOUNCE_BASE + b, seed, dt)
        mat = tb.mat[idx]
        new_d, att, scattered = scatter(mat, tb.fuzz[idx], tb.ior[idx], alb, d, nrm, front,
                                        u1, u2, u_dec)
        keep = torch.nonzero(scattered).squeeze(1) if b + 1 < max_depth else lv[:0]
        if counts is not None:
            counts["continued"] = counts.get("continued", 0) + int(keep.numel())
        live, o, d, thr = lv[keep], hp[keep], new_d[keep], (thr * att)[keep]
    return acc


@dataclass
class Prepared:
    """A scene and camera ready for :func:`render_pixels` and
    :func:`loss_and_grad`: the tables, the camera's frame and the image's
    width."""

    tables: Tables
    cam: dict
    width: int


def prepare(cfg: dict, desc: dict, width: int, height: int, device,
            dtype=torch.float32) -> Prepared:
    """The scene of ``desc`` (the arrays of ``benchmark/scenes/rtiow_spheres.py``)
    under the camera of the configuration ``cfg`` at ``width`` x ``height``,
    every floating-point value in ``dtype``."""
    return Prepared(tables(desc, device, dtype),
                    camera(cfg["camera"], width, height, device, dtype), width)


def leaf(prep: Prepared, name: str) -> torch.Tensor:
    """The scene's own value of the fitted parameter ``name``; only the
    texture colors (``tex_color``) are fitted here."""
    if name != "tex_color":
        raise KeyError(f"the reference fits tex_color only, not {name!r}")
    return prep.tables.color


def render_pixels(prep: Prepared, pixels, spp: int, seed: int, max_depth: int, *,
                  sample0: int = 0, block: int = 1 << 19,
                  counts: dict | None = None) -> torch.Tensor:
    """Mean radiance (P, 3) of ``pixels`` over samples sample0..sample0+spp-1,
    in blocks of about ``block`` paths."""
    per = max(1, block // spp)
    out = []
    for lo in range(0, pixels.shape[0], per):
        px = pixels[lo:lo + per].to(torch.int64)
        pix = px.repeat_interleave(spp)
        smp = torch.arange(sample0, sample0 + spp, device=px.device).repeat(px.shape[0])
        r = trace(prep.tables, prep.cam, prep.width, pix, smp, seed, max_depth, counts=counts)
        out.append(r.reshape(px.shape[0], spp, 3).sum(dim=1) / spp)
    return torch.cat(out)


def loss_and_grad(prep: Prepared, leaves: dict, target, spp: int, seed: int, max_depth: int,
                  *, sample0: int = 0, block: int = 1 << 20, counts: dict | None = None):
    """The L2 loss of the render (every pixel's mean over ``spp`` samples
    from ``sample0``) against ``target`` (P, 3), and its gradient in the
    fitted parameters ``leaves`` ({"tex_color": (T, 3)}), in blocks of
    about ``block`` paths. -> (loss, {name: gradient}) as float32."""
    (name, color), = leaves.items()
    leaf(prep, name)
    pixels = torch.arange(target.shape[0], device=target.device)
    var = color.detach().requires_grad_(True)
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    grad = torch.zeros(color.shape, dtype=torch.float32, device=color.device)
    per = max(1, block // spp)
    denom = float(pixels.shape[0] * 3)
    for lo in range(0, pixels.shape[0], per):
        px = pixels[lo:lo + per].to(torch.int64)
        pix = px.repeat(spp)
        smp = torch.arange(sample0, sample0 + spp, device=px.device).repeat_interleave(px.shape[0])
        with torch.enable_grad():
            r = trace(prep.tables, prep.cam, prep.width, pix, smp, seed, max_depth, color=var,
                      counts=counts)
            img = r.reshape(spp, px.shape[0], 3).mean(dim=0)
            sse = ((img - target[px].to(img.dtype)) ** 2).sum()
            (g,) = torch.autograd.grad(sse / denom, var, allow_unused=True)
        total += sse.detach().to(torch.float64)
        if g is not None:
            grad += g.to(torch.float32)
    return (total / denom).to(torch.float32), {name: grad}
