"""Skybox: the default white-blue gradient or a spherical (equirect) image
(port of ``crucible_tpu/models/skybox.py``). HDR skies keep their full
float range."""

from __future__ import annotations

import math

import torch

from crucible_tpu_torch.models.textures import image_lookup
from crucible_tpu_torch.utils import vec

DEFAULT = 0
SPHERICAL = 1


def default_gradient(d: torch.Tensor) -> torch.Tensor:
    """White -> (0.5, 0.7, 1.0) vertical lerp on the unit direction."""
    ud = vec.unit(d, eps=1e-20)
    a = 0.5 * (ud[..., 1] + 1.0)
    white = torch.ones((3,), dtype=d.dtype, device=d.device)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - a)[..., None] * white + a[..., None] * blue


def spherical(image: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Equirectangular lookup: theta = atan2(x, z), phi = asin(y);
    u = theta/2pi + 0.5, v = phi/pi + 0.5, then the clamp + v-flip image
    mapping of textures. image (H, W, 3), d (R, 3) -> (R, 3)."""
    ud = vec.unit(d, eps=1e-20)
    theta = vec.safe_arctan2(ud[..., 0], ud[..., 2])
    phi = vec.safe_arcsin(ud[..., 1])
    u = theta / (2.0 * math.pi) + 0.5
    v = phi / math.pi + 0.5
    return image_lookup(image, u, v)


def radiance(kind: int, image, d: torch.Tensor) -> torch.Tensor:
    """Miss-shader radiance for sky ``kind``; ``image`` is the spherical
    sky's (H, W, 3) image (unused by the default sky)."""
    if kind == SPHERICAL:
        if image is None:
            raise ValueError("the spherical sky needs its image")
        return spherical(image, d)
    return default_gradient(d)
