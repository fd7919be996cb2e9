"""Closed-form geometric samplers (port of ``crucible_tpu/ops/sampling.py``).

Exact maps from uniforms, in place of the rejection loops of the original
Rust renderer.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def unit_vector(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from two uniforms -> (..., 3)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def on_hemisphere(u1: torch.Tensor, u2: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the hemisphere around ``normal`` -> (..., 3):
    :func:`unit_vector`, negated where it points below the surface."""
    v = unit_vector(u1, u2)
    flip = torch.sum(v * normal, dim=-1, keepdim=True) < 0.0
    return torch.where(flip, -v, v)


def in_unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk -> (..., 2)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_offset(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Antialiasing jitter in [-0.5, 0.5)^2 -> (..., 2)."""
    return torch.stack([u1 - 0.5, u2 - 0.5], dim=-1)
