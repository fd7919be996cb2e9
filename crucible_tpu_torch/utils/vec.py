"""Batched 3-vector math on torch tensors (component axis last).

Port of ``crucible_tpu/utils/vec.py``. Every function broadcasts over
leading batch axes. Sums over the component axis are written out as
``x + y + z`` so that they round in the same order as the kernel's.
"""

from __future__ import annotations

import math

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis (drops the component axis)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product (component axis last)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(a))


def unit(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize over the last axis; ``eps`` floors the length so that a
    degenerate vector gives zeros rather than NaNs."""
    n = length(a)[..., None]
    if eps:
        n = torch.clamp_min(n, eps)
    return a / n


def near_zero(a: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """True where all components are below eps in magnitude."""
    return torch.all(torch.abs(a) < eps, dim=-1)


def safe_arccos(x: torch.Tensor) -> torch.Tensor:
    """arccos whose boundary values come from constants (finite gradients
    at |x| >= 1)."""
    inside = torch.abs(x) < 1.0
    x_safe = torch.where(inside, x, torch.zeros_like(x))
    boundary = torch.where(
        x >= 1.0, torch.zeros_like(x), torch.full_like(x, math.pi)
    )
    return torch.where(inside, torch.arccos(x_safe), boundary)


def safe_arcsin(x: torch.Tensor) -> torch.Tensor:
    """arcsin with finite gradients at |x| >= 1 (see safe_arccos)."""
    inside = torch.abs(x) < 1.0
    x_safe = torch.where(inside, x, torch.zeros_like(x))
    boundary = torch.where(
        x >= 1.0, torch.full_like(x, math.pi / 2.0), torch.full_like(x, -math.pi / 2.0)
    )
    return torch.where(inside, torch.arcsin(x_safe), boundary)


def safe_arctan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """arctan2 whose gradient is zeroed (not NaN) at the (0, 0) pole."""
    pole = (torch.abs(x) < 1e-20) & (torch.abs(y) < 1e-20)
    x_safe = torch.where(pole, torch.ones_like(x), x)
    y_safe = torch.where(pole, torch.zeros_like(y), y)
    return torch.arctan2(y_safe, x_safe)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of v about unit normal n."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat) -> torch.Tensor:
    """Snell refraction of unit vector uv about unit normal n.
    ``etai_over_etat`` broadcasts over batch axes."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    eta = torch.as_tensor(etai_over_etat, dtype=uv.dtype, device=uv.device)
    r_out_perp = eta[..., None] * (uv + cos_theta[..., None] * n)
    # abs + tiny floor: keeps d(sqrt) finite at total internal reflection.
    r_out_parallel = (
        -torch.sqrt(torch.clamp_min(torch.abs(1.0 - length_squared(r_out_perp)), 1e-12))[
            ..., None
        ]
        * n
    )
    return r_out_perp + r_out_parallel
