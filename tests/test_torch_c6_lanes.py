"""Fault C6, lane by lane. On bouncing stress (sphere_stress n1936 moved as
bouncing book1 moves book1: 24 x 13 pixels, 2 spp, depth 4, seeds 0-3) the
port's own records and the JAX package's (its chunk-cull record kernel in
interpret mode) disagree on 5-9 of the 624 lanes a seed. For each such lane
this finds the first row where the two records differ and shows that a
change of at most ULPS ulps in one sphere's quadratic, in the port's own
arithmetic, turns the port's decision there into the JAX package's.

The record pass solves each sphere's quadratic in expanded form:
h = d.c - d.o and c_q = (|c|^2 - r^2) - 2 o.c + |o|^2 (at the path's
shutter fraction), disc = h^2 - a c_q. Near a tangent, a self-intersection
(a root just past T_MIN) or the ground (r = 1000) these cancel, so their
last bits decide; XLA on the CPU contracts multiply-adds and rounds them
otherwise (C6). The model below is the record pass's arithmetic for one
lane (``sphere_shade.moving_closest_reference``'s search, the winner's
normal, ``materials.scatter``'s decisions and direction, the root flag) from
its primary ray: it reproduces the port's record words bit for bit, and then
the JAX package's word at the first differing row once one candidate
sphere's h, c_q or disc at one row on the way (the row's winner, or at the
differing row also the JAX package's winner) is moved by ULPS ulps of the
magnitude of the terms it is summed from, the rows before it unchanged. A
lane that needs more is a port fault, not C6.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import materials as mat_mod
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from crucible_tpu_torch.utils import rng as crng
from tests import test_torch_cull as cull
from tests.torch_threads import one_torch_thread  # noqa: F401

T_MIN = float(np.float32(1e-3))
BIG = float(np.float32(3e38))
DEPTH, SPP = 4, 2
ULPS = 2  # the largest change, in ulps of a term's operands, a flip may need
# Signs of the change to (c_q, h, disc).
SIGNS = [s for s in itertools.product((-1, 0, 1), repeat=3) if any(s)]


def _ulp(x) -> float:
    return float(np.spacing(np.float32(abs(float(x)))))


@functools.cache
def _case(seed):
    """(port records, JAX records, primary rays (o, d), shutter fractions
    w, the record pass's table, pixel ids, sample ids) on bouncing stress."""
    js = cull._jax_scene()
    w, h = js.scene_cam.image_width, js.scene_cam.image_height
    p = w * h
    jrec = np.asarray(cull.jrep.trace_record_mega(
        js.build(), js.scene_cam.params(), w, h, jnp.tile(jnp.arange(p, dtype=jnp.int32), SPP),
        jnp.repeat(jnp.arange(SPP, dtype=jnp.int32), p), jnp.uint32(seed), DEPTH,
        interpret=True))
    _, sd, cp = cull._port_scene()
    calls = []
    real = tmk.cull_closest_reference

    def spy(o, d, table, *args, w=None, **kwargs):
        calls.append((o.clone(), d.clone(), w.clone(), table))
        return real(o, d, table, *args, w=w, **kwargs)

    tmk.cull_closest_reference = spy
    try:
        own = G.record_decisions(sd, cp, torch.arange(p), seed, width=w, height=h, spp=SPP,
                                 max_depth=DEPTH).numpy()
    finally:
        tmk.cull_closest_reference = real
    assert len(calls) == DEPTH  # one search a row, by K6's plain walk
    o0, d0, w0, table = calls[0]  # row 0: every lane, in lane order
    return own, jrec, o0, d0, w0, table, np.tile(np.arange(p), SPP), np.repeat(np.arange(SPP), p)


def _step(o, d, w, tab, u, j=None, e=(0, 0, 0)):
    """One row of one lane's record pass -> (word, o', d'): the closest hit
    among the table's moving spheres with row j's (c_q, h, disc) moved by
    e ulps of their terms' magnitudes, then the winner's normal and the
    scatter, in the port's record arithmetic."""
    dx, dy, dz = d[0], d[1], d[2]
    ox, oy, oz = o[0], o[1], o[2]
    a_q = dx * dx + dy * dy + dz * dz
    d_dot_o = dx * ox + dy * oy + dz * oz
    o_sq = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a_q
    cx, cy, cz, s0, on = tab[:, 0], tab[:, 1], tab[:, 2], tab[:, 4], tab[:, 5] > 0
    cdx, cdy, cdz, s1, s2 = tab[:, 24], tab[:, 25], tab[:, 26], tab[:, 28], tab[:, 29]
    dc = (cx * dx + cy * dy + cz * dz) + w * (cdx * dx + cdy * dy + cdz * dz)
    oc = (cx * ox + cy * oy + cz * oz) + w * (cdx * ox + cdy * oy + cdz * oz)
    csr = s0 + (2.0 * w) * s1 + (w * w) * s2
    hh = dc - d_dot_o
    cq = csr - 2.0 * oc + o_sq
    if j is not None:
        hh, cq = hh.clone(), cq.clone()
        cq[j] += e[0] * _ulp(max(abs(float(csr[j])), abs(float(2.0 * oc[j])), float(o_sq)))
        hh[j] += e[1] * _ulp(max(abs(float(dc[j])), abs(float(d_dot_o))))
    disc = hh * hh - a_q * cq
    if j is not None:
        disc = disc.clone()
        disc[j] += e[2] * _ulp(max(float(hh[j] * hh[j]), abs(float(a_q * cq[j]))))
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    r0, r1 = (hh - sq) * inv_a, (hh + sq) * inv_a
    ok0 = (r0 > T_MIN) & (r0 < BIG)
    ok1 = (r1 > T_MIN) & (r1 < BIG)
    t_all = torch.where((disc >= 0) & (ok0 | ok1) & on, torch.where(ok0, r0, r1),
                        torch.full_like(r0, BIG))
    t = t_all.min()
    if not bool(t < BIG):
        return tmk.F_ALIVE, None, None
    ids = tab[:, 31].long()
    row = tab[int(torch.where(t_all == t, ids, 1 << 30).argmin())]  # ties: lowest id
    hp = o + t * d
    wc = row[0:3] + w * row[24:27]
    wr = row[3] + w * row[27]
    nrm = (hp - wc) * (1.0 / torch.clamp_min(wr, 1e-20))
    front = (d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2]) < 0.0
    nrm = nrm * (1.0 if bool(front) else -1.0)
    new_d, _, scat, refl, degen = mat_mod.scatter(
        row[6:7], row[7:8], row[8:9], row[9:10], row[14:17][None], d[None], nrm[None],
        front[None], *u)
    # The recorded root, re-solved as the replay solves it.
    ocr = wc - o
    r_h = d[0] * ocr[0] + d[1] * ocr[1] + d[2] * ocr[2]
    r_c = ocr[0] * ocr[0] + ocr[1] * ocr[1] + ocr[2] * ocr[2] - wr * wr
    r_disc = torch.clamp_min(r_h * r_h - a_q * r_c, 0.0)
    root1 = not bool((r_h - torch.sqrt(r_disc)) * (1.0 / a_q) > T_MIN)
    flags = (tmk.F_ALIVE | tmk.F_HIT | (tmk.F_SCAT if bool(scat[0]) else 0)
             | (tmk.F_FRONT if bool(front) else 0) | (tmk.F_REFL if bool(refl[0]) else 0)
             | (tmk.F_DEGEN if bool(degen[0]) else 0) | (tmk.F_ROOT1 if root1 else 0))
    return int(row[31]) * tmk.REC_ID_SCALE + flags, hp, new_d[0]


def _differing(seed):
    own, jrec = _case(seed)[:2]
    return [int(x) for x in np.nonzero((own != jrec).any(axis=0))[0]]


def _flip(seed, lane):
    """-> (first differing row k, the smallest change that gives the JAX
    word there: (ulps, row m, table row j, signs), or None within ULPS)."""
    own, jrec, o0, d0, w0, tab, pix, smp = _case(seed)
    k = int(np.nonzero(own[:, lane] != jrec[:, lane])[0][0])
    us = [crng.uniform4(torch.tensor([int(pix[lane])]), torch.tensor([int(smp[lane])]),
                        crng.STREAM_BOUNCE_BASE + m, seed)[:3] for m in range(k + 1)]

    def chain(m=None, j=None, e=(0, 0, 0)):
        o, d = o0[lane], d0[lane]
        for row in range(k + 1):
            word, o, d = _step(o, d, w0[lane], tab, us[row], *((j, e) if row == m else ()))
            if row < k and word != int(own[row, lane]):
                return None  # the change moved an earlier decision
        return word

    # The model is the record pass: it gives the port's words unchanged.
    assert chain() == int(own[k, lane]), (seed, lane, k)
    ids = tab[:, 31].long()
    cands = []
    for m in range(k + 1):
        for word in [int(own[m, lane])] + ([int(jrec[k, lane])] if m == k else []):
            if word & tmk.F_HIT:
                cands.append((m, int(torch.nonzero(ids == (word >> 8))[0, 0])))
    for mag in range(1, ULPS + 1):
        for m, j in cands:
            for s in SIGNS:
                if chain(m, j, tuple(mag * x for x in s)) == int(jrec[k, lane]):
                    return k, (mag, m, j, s)
    return k, None


@pytest.mark.parametrize("seed", range(4))
def test_differing_lanes_flip_within_ulps_of_the_quadratic(seed):
    lanes = _differing(seed)
    assert 1 <= len(lanes) <= 12, lanes  # 5-9 of 624 lanes (C6)
    for lane in lanes:
        k, found = _flip(seed, lane)
        assert found is not None, f"seed {seed} lane {lane}: row {k} not within {ULPS} ulps"
