"""SoA texture table: solid colors and 3-D checkers of solids.

Port of ``crucible_tpu/models/textures.py`` for the texture kinds the port
renders. A texture is a row of the table; IMAGE textures and checkers
nested more than one level deep raise ``NotImplementedError``.
:func:`image_lookup` is the nearest-texel fetch that the spherical sky
reads through.
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


def image_lookup(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor lookup with clamp + v flip: clamp u, v to [0, 1],
    v := 1 - v, texel (floor(u W), floor(v H)) clamped to the last one.
    img (H, W, 3), u/v (R,) -> (R, 3), differentiable w.r.t. every texel."""
    h, w = img.shape[0], img.shape[1]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    i = torch.clamp(torch.floor(uu * w).to(torch.int32), 0, w - 1)
    j = torch.clamp(torch.floor(vv * h).to(torch.int32), 0, h - 1)
    return torch.index_select(img.reshape(-1, 3), 0, (j * w + i).to(torch.int64))


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
    # index_select, not tex.color[resolved]: on a GPU the backward of
    # advanced indexing sorts the millions of indices into a few hundred
    # rows and accumulates them serially (on an H100, 6.3 s of a 7.1 s
    # direct-AD step of book1 at 1080p, 4 spp, depth 8); index_select's
    # backward is an index_add.
    return torch.index_select(tex.color, 0, resolved)
