"""SoA texture table: solid colors, 3-D checkers (nested to any depth) and
nearest-neighbor images.

Port of ``crucible_tpu/models/textures.py``. A texture is a row of the
table; :func:`value` evaluates it over a batch with masked selects. A
checker's children may be any texture, other checkers included: the table
records the deepest chain (``max_nest``), and :func:`value` resolves that
many levels, each with its own ``inv_scale`` parity, before it reads the
leaf (a solid color or an image).

Texel gradients: every gather of a float tensor is an ``index_select``
(``ops.gather.rows``), whose backward is an ``index_add`` (on a GPU a
sorted segment sum, which adds in a fixed order; the backward of advanced
indexing sorts the millions of indices into a few hundred rows and
accumulates them serially: on an H100, 6.3 s of a 7.1 s direct-AD step of
book1 at 1080p, 4 spp, depth 8). So radiance is differentiable w.r.t.
every texel of ``images`` and every color of the table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from crucible_tpu_torch.ops import gather

SOLID = 0
CHECKER = 1
IMAGE = 2

# While a list, image_lookup appends each lookup's flat texel ids (int64,
# on the CPU) to it; None records nothing.
TEXEL_IDS = None


@dataclass
class TextureTable:
    """Parallel tensors over texture ids (T rows) and the scene's images."""

    kind: torch.Tensor  # (T,) int32 in {SOLID, CHECKER, IMAGE}
    color: torch.Tensor  # (T, 3) solid albedo
    inv_scale: torch.Tensor  # (T,) checker 1/scale
    even: torch.Tensor  # (T,) int32 child id (checker)
    odd: torch.Tensor  # (T,) int32 child id (checker)
    image_id: torch.Tensor  # (T,) int32 index into `images`
    images: Tuple[torch.Tensor, ...] = ()  # each (H, W, 3) float32 texels
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
    ids = (j * w + i).to(torch.int64)
    if TEXEL_IDS is not None:
        TEXEL_IDS.append(ids.cpu())
    return gather.rows(img.reshape(-1, 3), ids)


def checker_is_even(inv_scale: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Checker parity: floor(inv_scale * p) to int32, summed over axes,
    even -> the ``even`` child. inv_scale (R,), p (R, 3) -> (R,) bool."""
    xyz = torch.floor(inv_scale[:, None] * p).to(torch.int32)
    return (xyz[:, 0] + xyz[:, 1] + xyz[:, 2]) % 2 == 0


def value(tex: TextureTable, tid, u, v, p) -> torch.Tensor:
    """Texture color for a batch: tid (R,), u/v (R,), p (R,3) -> (R,3).

    ``max_nest`` rounds each step a checker row to the child its parity
    picks (a leaf stays); then the leaf's solid color, or for an image row
    its texel at (u, v)."""
    resolved = torch.as_tensor(tid, device=tex.kind.device).long()
    for _ in range(tex.max_nest):
        is_even = checker_is_even(gather.rows(tex.inv_scale, resolved), p)
        child = torch.where(is_even, tex.even[resolved], tex.odd[resolved]).long()
        resolved = torch.where(tex.kind[resolved] == CHECKER, child, resolved)
    out = gather.rows(tex.color, resolved)
    if tex.images:
        is_image = tex.kind[resolved] == IMAGE
        img_of = tex.image_id[resolved]
        for k, img in enumerate(tex.images):
            mask = is_image & (img_of == k)
            out = torch.where(mask[:, None], image_lookup(img, u, v), out)
    return out
