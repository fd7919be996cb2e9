"""SoA texture table: solid colors and 3-D checkers of solids.

Port of ``crucible_tpu/models/textures.py`` for the texture kinds the port
renders. A texture is a row of the table; IMAGE textures and checkers
nested more than one level deep raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

SOLID = 0
CHECKER = 1
IMAGE = 2


@dataclass
class TextureTable:
    """Parallel tensors over texture ids (T rows)."""

    kind: torch.Tensor  # (T,) int32 in {SOLID, CHECKER, IMAGE}
    color: torch.Tensor  # (T, 3) solid albedo
    inv_scale: torch.Tensor  # (T,) checker 1/scale
    even: torch.Tensor  # (T,) int32 child id (checker)
    odd: torch.Tensor  # (T,) int32 child id (checker)
    image_id: torch.Tensor  # (T,) int32 index into `images`
    images: Tuple[torch.Tensor, ...] = ()  # image textures: not ported
    # Deepest checker-of-checker chain in the table. 1 = checkers of leaves.
    max_nest: int = 1


def checker_is_even(inv_scale: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Checker parity: floor(inv_scale * p) to int32, summed over axes,
    even -> the ``even`` child. inv_scale (R,), p (R, 3) -> (R,) bool."""
    xyz = torch.floor(inv_scale[:, None] * p).to(torch.int32)
    return (xyz[:, 0] + xyz[:, 1] + xyz[:, 2]) % 2 == 0


def value(tex: TextureTable, tid, u, v, p) -> torch.Tensor:
    """Texture color for a batch: tid (R,), u/v (R,), p (R,3) -> (R,3)."""
    del u, v  # only image textures read uv
    if tex.images or tex.max_nest > 1:
        raise NotImplementedError(
            "image textures and nested checkers are not ported to "
            "crucible_tpu_torch yet"
        )
    tid = torch.as_tensor(tid, device=tex.kind.device).long()
    is_even = checker_is_even(tex.inv_scale[tid], p)
    child = torch.where(is_even, tex.even[tid], tex.odd[tid]).long()
    resolved = torch.where(tex.kind[tid] == CHECKER, child, tid)
    return tex.color[resolved]
