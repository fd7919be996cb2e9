"""Keyframe timeline animation as data: authoring commands -> flat tracks.

Port of ``crucible_tpu/models/timeline.py``. A timeline is host-side data
(:class:`TransformTimeline`) lowered with numpy to padded tracks; the
renderers read its linear-shutter lowering (``Scene.build``, positions at
shutter open and close) and the torch evaluators below evaluate tracks at
per-ray times.

Semantics (the original renderer's ``combine_and_compute``):

- value(t) = Scale(t) applied to Translate(t) applied to the origin.
- Translate is the sum of per-keyframe deltas, each ramped by the clamped
  proportion of its validity interval (LERP: [previous end, keyframe];
  NERP: the degenerate [keyframe, keyframe], a step).
- Scale is the single most recent transform with start <= t,
  interpolating from the previous same-axis endpoint to the keyframe
  value; axes that transform does not touch evaluate to identity.
- World-space keys store delta = target - previous endpoint; local keys
  store the delta itself.
- A sphere's radius rides the scale track (component 0).

Two documented fixes are kept: ``scale_y`` is a plain axis scale (the
original writes its factor into a shear slot), and ``scale_point`` is one
vector-valued keyframe per axis (the original pushes three sibling
transforms of which most-recent-wins keeps only Z).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

NERP = "nerp"
LERP = "lerp"
WORLD = "world"
LOCAL = "local"

_INIT_TIME = -0.1  # init transforms are seeded at t = -0.1

AXIS_X, AXIS_Y, AXIS_Z = 0, 1, 2
AXIS_ALL = -1  # uniform / vector-valued keys


@dataclass
class _TranslateKey:
    axis: int  # AXIS_X/Y/Z or AXIS_ALL (vector key)
    value: np.ndarray  # (3,) target (world) or delta (local); only `axis` lanes used
    keyframe: float
    interp: str
    space: str


@dataclass
class _ScaleKey:
    axis: int  # AXIS_X/Y/Z or AXIS_ALL (uniform / radius)
    value: float
    keyframe: float
    interp: str


@dataclass
class TransformTimeline:
    """Host-side authoring record for one animated entity. ``init_scale``
    doubles as the sphere radius for sphere timelines."""

    init_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    init_scale: float = 1.0
    translate_keys: List[_TranslateKey] = field(default_factory=list)
    scale_keys: List[_ScaleKey] = field(default_factory=list)
    # Memoized lowered tracks: lowering does not depend on the frame, only
    # the evaluation times do.
    _lowered: Optional[dict] = field(default=None, repr=False, compare=False)

    def _dirty(self):
        self._lowered = None

    def _cache(self, key, fn):
        if self._lowered is None:
            self._lowered = {}
        if key not in self._lowered:
            self._lowered[key] = fn()
        return self._lowered[key]

    # --- authoring ---------------------------------------------------------
    def _add_translate(self, axis: int, value, keyframe: float, interp: str, space: str):
        assert keyframe >= 0.0, "keyframes cannot be negative"
        self._dirty()
        v = np.zeros(3, np.float64)
        if axis == AXIS_ALL:
            v[:] = value
        else:
            v[axis] = value
        self.translate_keys.append(_TranslateKey(axis, v, float(keyframe), interp, space))

    def translate_x(self, x, keyframe, interp=LERP, space=LOCAL):
        self._add_translate(AXIS_X, x, keyframe, interp, space)

    def translate_y(self, y, keyframe, interp=LERP, space=LOCAL):
        self._add_translate(AXIS_Y, y, keyframe, interp, space)

    def translate_z(self, z, keyframe, interp=LERP, space=LOCAL):
        self._add_translate(AXIS_Z, z, keyframe, interp, space)

    def translate_point(self, p, keyframe, interp=LERP, space=LOCAL):
        """Vector keyframe: one key over all three axes."""
        self._add_translate(AXIS_ALL, np.asarray(p, np.float64), keyframe, interp, space)

    def _add_scale(self, axis: int, f, keyframe, interp):
        self._dirty()
        self.scale_keys.append(_ScaleKey(axis, float(f), float(keyframe), interp))

    def scale_x(self, f, keyframe, interp=LERP):
        self._add_scale(AXIS_X, f, keyframe, interp)

    def scale_y(self, f, keyframe, interp=LERP):
        self._add_scale(AXIS_Y, f, keyframe, interp)

    def scale_z(self, f, keyframe, interp=LERP):
        self._add_scale(AXIS_Z, f, keyframe, interp)

    def scale_uniform(self, f, keyframe, interp=LERP):
        self._add_scale(AXIS_ALL, f, keyframe, interp)

    # `scale_r` for spheres is `scale_uniform` on the radius track.
    scale_r = scale_uniform

    @property
    def animated(self) -> bool:
        return bool(self.translate_keys or self.scale_keys)

    # --- lowering ----------------------------------------------------------
    def lower_translate(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (t0 (K,), t1 (K,), delta (K, 3)) float32 ramp segments:
        position(t) = init_pos + sum_k delta_k * ramp(t; t0_k, t1_k). Keys
        chain per axis (LERP interval [previous end of its axes, keyframe]);
        vector keys chain all three axes."""
        return self._cache("tr", self._lower_translate)

    def _lower_translate(self):
        keys = sorted(self.translate_keys, key=lambda k: k.keyframe)
        abs_pos = np.asarray(self.init_pos, np.float64).copy()
        prev_end = {AXIS_X: _INIT_TIME, AXIS_Y: _INIT_TIME, AXIS_Z: _INIT_TIME}
        t0s, t1s, deltas = [], [], []
        for k in keys:
            axes = [AXIS_X, AXIS_Y, AXIS_Z] if k.axis == AXIS_ALL else [k.axis]
            if k.space == WORLD:
                delta = np.zeros(3)
                for ax in axes:
                    delta[ax] = k.value[ax] - abs_pos[ax]
            else:
                delta = np.array([k.value[ax] if ax in axes else 0.0 for ax in range(3)])
            t0s.append(max(prev_end[ax] for ax in axes) if k.interp == LERP else k.keyframe)
            t1s.append(k.keyframe)
            deltas.append(delta)
            abs_pos += delta
            for ax in axes:
                prev_end[ax] = k.keyframe
        if not t0s:
            return (np.zeros((0,), np.float32), np.zeros((0,), np.float32),
                    np.zeros((0, 3), np.float32))
        return (np.asarray(t0s, np.float32), np.asarray(t1s, np.float32),
                np.asarray(deltas, np.float32))

    def lower_scale(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """-> (t0 (K,), t1 (K,), from (K, 3), to (K, 3)) float32 segments:
        scale(t) = lerp(from_k, to_k, ramp) for the last segment k with
        t0_k <= t. The first segment is the init one (init_scale on every
        axis, at t = -0.1); untouched axes of a key carry 1.0."""
        return self._cache("sc", self._lower_scale)

    def _lower_scale(self):
        keys = sorted(self.scale_keys, key=lambda k: k.keyframe)
        prev_val = {AXIS_X: self.init_scale, AXIS_Y: self.init_scale, AXIS_Z: self.init_scale}
        prev_end = {AXIS_X: _INIT_TIME, AXIS_Y: _INIT_TIME, AXIS_Z: _INIT_TIME}
        t0s, t1s = [_INIT_TIME], [_INIT_TIME]
        froms = [np.full(3, self.init_scale)]
        tos = [np.full(3, self.init_scale)]
        for k in keys:
            axes = [AXIS_X, AXIS_Y, AXIS_Z] if k.axis == AXIS_ALL else [k.axis]
            f, t = np.ones(3), np.ones(3)
            for ax in axes:
                f[ax] = prev_val[ax]
                t[ax] = k.value
            t0s.append(max(prev_end[ax] for ax in axes) if k.interp == LERP else k.keyframe)
            t1s.append(k.keyframe)
            froms.append(f)
            tos.append(t)
            for ax in axes:
                prev_val[ax] = k.value
                prev_end[ax] = k.keyframe
        return (np.asarray(t0s, np.float32), np.asarray(t1s, np.float32),
                np.asarray(froms, np.float32), np.asarray(tos, np.float32))

    def boundary_times(self) -> np.ndarray:
        """Every segment boundary time (t0 and t1 of each lowered segment,
        init sentinels excluded), sorted and unique: the instants where the
        piecewise-linear trajectory changes slope. ``Scene.build`` looks for
        one strictly inside a frame's shutter window, where the linear
        lowering departs from per-ray evaluation."""
        return self._cache("bt", self._boundary_times)

    def _boundary_times(self):
        ts = []
        for arrs in (self.lower_translate()[:2], self.lower_scale()[:2]):
            for a in arrs:
                ts.extend(float(x) for x in a if x > _INIT_TIME)
        return np.unique(np.asarray(ts, np.float64))

    # --- host-side scalar evaluation (numpy) --------------------------------
    def position_at(self, t: float) -> np.ndarray:
        """The translate track at time t -> (3,) float64: init plus the sum
        of ramped deltas."""
        t0, t1, delta = self.lower_translate()
        pos = np.asarray(self.init_pos, np.float64).copy()
        for a, b, dv in zip(t0, t1, delta):
            span = b - a
            r = np.clip((t - a) / span, 0.0, 1.0) if span > 0 else (1.0 if t >= a else 0.0)
            pos += dv * r
        return pos

    def scale_at(self, t: float) -> np.ndarray:
        """The scale track at time t -> (3,) (most recent segment wins).
        Component 0 doubles as the sphere radius."""
        t0, t1, f, g = self.lower_scale()
        k = 0
        for i, a in enumerate(t0):
            if t >= a:
                k = i
        span = t1[k] - t0[k]
        r = np.clip((t - t0[k]) / span, 0.0, 1.0) if span > 0 else (1.0 if t >= t0[k] else 0.0)
        return f[k] + (g[k] - f[k]) * r


# --------------------------------------------------------------------------
# Vectorized evaluation on tensors
# --------------------------------------------------------------------------


def _ramp(t, t0, t1):
    """clamp((t - t0) / (t1 - t0), 0, 1), a degenerate interval being a
    step at t0."""
    span = t1 - t0
    lin = (t - t0) / torch.where(span > 0, span, torch.ones_like(span))
    step = torch.where(t >= t0, 1.0, 0.0)
    return torch.clamp(torch.where(span > 0, lin, step), 0.0, 1.0)


def _times(t, t0):
    """t as a float32 tensor shaped to broadcast against (..., K) tracks:
    (R,) times gain one axis per track axis."""
    t = torch.as_tensor(t, dtype=torch.float32, device=t0.device)
    if t.dim() and t0.dim() >= 1:
        return t.reshape(t.shape + (1,) * t0.dim())
    return t


def eval_translate(t0, t1, delta, init_pos, t):
    """Translate tracks t0, t1 (..., K), delta (..., K, 3), init_pos
    (..., 3) at time(s) t: a scalar, or (R,) against the tracks ->
    (R, ..., 3)."""
    r = _ramp(_times(t, t0), t0, t1)
    return init_pos + torch.sum(r[..., None] * delta, dim=-2)


def eval_scale(t0, t1, sc_from, sc_to, t):
    """Scale tracks (..., K) at time(s) t: the most recent segment (the
    largest k with t0_k <= t; tracks are start-sorted) lerped by its ramp
    -> (..., 3), with (R,) times leading."""
    t = torch.as_tensor(t, dtype=torch.float32, device=t0.device)
    tt = _times(t, t0)
    mask = tt >= t0  # the init segment at -0.1 is always active
    k_star = torch.clamp_min(mask.sum(dim=-1) - 1, 0)
    f = torch.gather(torch.broadcast_to(sc_from, mask.shape + (3,)), -2,
                     k_star[..., None, None].expand(k_star.shape + (1, 3)))[..., 0, :]
    g = torch.gather(torch.broadcast_to(sc_to, mask.shape + (3,)), -2,
                     k_star[..., None, None].expand(k_star.shape + (1, 3)))[..., 0, :]
    s0 = torch.gather(torch.broadcast_to(t0, mask.shape), -1, k_star[..., None])[..., 0]
    s1 = torch.gather(torch.broadcast_to(t1, mask.shape), -1, k_star[..., None])[..., 0]
    tr = t.reshape(t.shape + (1,) * (s0.dim() - t.dim())) if t.dim() else t
    return f + (g - f) * _ramp(tr, s0, s1)[..., None]


def eval_translate_rows(t0, t1, delta, init_pos, t):
    """Row-aligned translate evaluation: t0, t1 (R, K), delta (R, K, 3),
    init_pos (R, 3), t (R,): row i's track at row i's time -> (R, 3)."""
    r = _ramp(t[:, None], t0, t1)
    return init_pos + torch.sum(r[..., None] * delta, dim=-2)


def eval_scale_rows(t0, t1, sc_from, sc_to, t):
    """Row-aligned scale evaluation (the most recent segment per row) ->
    (R, 3); the alignment of :func:`eval_translate_rows`."""
    mask = t[:, None] >= t0
    k_star = torch.clamp_min(mask.sum(dim=-1) - 1, 0)
    idx3 = k_star[:, None, None].expand(-1, 1, 3)
    f = torch.gather(sc_from, 1, idx3)[:, 0]
    g = torch.gather(sc_to, 1, idx3)[:, 0]
    s0 = torch.gather(t0, 1, k_star[:, None])[:, 0]
    s1 = torch.gather(t1, 1, k_star[:, None])[:, 0]
    return f + (g - f) * _ramp(t, s0, s1)[:, None]


def eval_translate_np(t0, t1, delta, init_pos, t: float):
    """Numpy translate evaluation at one scalar time: (N, K) padded tracks
    -> (N, 3) float64."""
    t0 = np.asarray(t0, np.float64)
    t1 = np.asarray(t1, np.float64)
    span = t1 - t0
    lin = (t - t0) / np.where(span > 0, span, 1.0)
    step = (t >= t0).astype(np.float64)
    r = np.clip(np.where(span > 0, lin, step), 0.0, 1.0)
    return np.asarray(init_pos, np.float64) + (
        r[..., None] * np.asarray(delta, np.float64)
    ).sum(axis=-2)


def eval_scale_np(t0, t1, sc_from, sc_to, t: float):
    """Numpy scale evaluation (most recent segment) at one scalar time:
    (N, K) padded tracks -> (N, 3) float64."""
    t0 = np.asarray(t0, np.float64)
    t1 = np.asarray(t1, np.float64)
    mask = t >= t0  # padding segments start at +inf: never selected
    k = np.maximum(mask.sum(axis=-1) - 1, 0)
    rows = np.arange(t0.shape[0])
    s0 = t0[rows, k]
    s1 = t1[rows, k]
    span = s1 - s0
    lin = (t - s0) / np.where(span > 0, span, 1.0)
    step = (t >= s0).astype(np.float64)
    r = np.clip(np.where(span > 0, lin, step), 0.0, 1.0)
    f = np.asarray(sc_from, np.float64)[rows, k]
    g = np.asarray(sc_to, np.float64)[rows, k]
    return f + (g - f) * r[:, None]


def pad_tracks(tracks, max_k: Optional[int] = None):
    """Stack lowered translate tracks [(t0 (K_i,), t1, delta (K_i, 3))] into
    (t0 (N, K), t1 (N, K), delta (N, K, 3)) float32; padding segments have
    zero deltas and contribute nothing."""
    n = len(tracks)
    k = max_k if max_k is not None else max((len(tr[0]) for tr in tracks), default=0)
    k = max(k, 1)
    t0 = np.zeros((n, k), np.float32)
    t1 = np.zeros((n, k), np.float32)
    delta = np.zeros((n, k, 3), np.float32)
    for i, (a, b, d) in enumerate(tracks):
        t0[i, : len(a)] = a
        t1[i, : len(a)] = b
        delta[i, : len(a)] = d
    return t0, t1, delta


def pad_scale_tracks(tracks, max_k: Optional[int] = None):
    """Stack lowered scale tracks; padding segments start at +inf, so they
    are never selected."""
    n = len(tracks)
    k = max_k if max_k is not None else max((len(tr[0]) for tr in tracks), default=1)
    k = max(k, 1)
    t0 = np.full((n, k), np.inf, np.float32)
    t1 = np.full((n, k), np.inf, np.float32)
    f = np.ones((n, k, 3), np.float32)
    g = np.ones((n, k, 3), np.float32)
    for i, (a, b, fr, to) in enumerate(tracks):
        t0[i, : len(a)] = a
        t1[i, : len(a)] = b
        f[i, : len(a)] = fr
        g[i, : len(a)] = to
    return t0, t1, f, g
