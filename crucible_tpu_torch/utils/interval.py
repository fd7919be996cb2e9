"""Interval arithmetic as (min, max) pairs — batched, functional.

Port of ``crucible_tpu/utils/interval.py``: an interval is any
broadcastable pair of tensors (or floats); the helpers are free functions.
"""

from __future__ import annotations

import math

import torch

EMPTY = (math.inf, -math.inf)  # contains nothing
UNIVERSE = (-math.inf, math.inf)  # contains everything


def contains(lo, hi, x):
    """min <= x <= max."""
    return (lo <= x) & (x <= hi)


def surrounds(lo, hi, x):
    """min < x < max — used for ray-t acceptance."""
    return (lo < x) & (x < hi)


def clamp(lo, hi, x):
    """Clamp x into [lo, hi]."""
    return torch.clamp(x, lo, hi)


def proportion(lo, hi, x):
    """Normalized position of x inside [lo, hi]; a degenerate interval maps
    points at or after it to 1.0 and points before it to 0.0."""
    span = hi - lo
    safe = torch.where(span > 0, span, torch.ones_like(span))
    step = torch.where(x >= lo, torch.ones_like(x), torch.zeros_like(x))
    return torch.where(span > 0, (x - lo) / safe, step)


def size(lo, hi):
    return hi - lo


def expand(lo, hi, delta):
    """Symmetric expansion by delta/2 each side (AABB padding)."""
    pad = delta / 2.0
    return lo - pad, hi + pad
