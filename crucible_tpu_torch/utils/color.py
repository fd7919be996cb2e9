"""Film / color pipeline: HDR accumulation -> gamma -> quantized bytes.

Port of ``crucible_tpu/utils/color.py``: radiance accumulates unclamped and
is clamped only here, at film output.
"""

from __future__ import annotations

import torch


def linear_to_gamma(c: torch.Tensor) -> torch.Tensor:
    """Gamma 2.0 encode: sqrt of linear values, negatives -> 0."""
    return torch.sqrt(torch.clamp_min(c, 0.0))


def to_bytes(c: torch.Tensor) -> torch.Tensor:
    """Linear radiance image -> uint8 via clamp, gamma, 255*c truncation."""
    g = linear_to_gamma(torch.clamp(c, 0.0, 1.0))
    return torch.clamp(torch.floor(255.0 * g), 0.0, 255.0).to(torch.uint8)
