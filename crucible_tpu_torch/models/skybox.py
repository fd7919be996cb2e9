"""Skybox: the default white-blue gradient (port of
``crucible_tpu/models/skybox.py``). The spherical image sky raises
``NotImplementedError``."""

from __future__ import annotations

import torch

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


def radiance(kind: int, image, d: torch.Tensor) -> torch.Tensor:
    """Miss-shader radiance for sky ``kind``."""
    del image  # only the spherical sky reads an image
    if kind != DEFAULT:
        raise NotImplementedError(
            "the spherical (equirect) sky is not ported to crucible_tpu_torch yet"
        )
    return default_gradient(d)
