"""Counter-based RNG: the PCG4D hash of ``(pixel, sample, stream, seed)``.

Port of ``crucible_tpu/utils/rng.py``, bit for bit: every random number of
a render is a pure function of its counters (Jarzynski & Olano, "Hash
Functions for GPU Rendering", JCGT 2020), so the port draws exactly the
numbers the JAX package draws and no ``torch.Generator`` is involved.

PyTorch's uint32 arithmetic is incomplete, so the eager hash runs in int64
holding uint32 values. A product of two such values can exceed int64, so
:func:`_mul32` splits one factor into 16-bit halves and keeps every partial
product below 2**48; each add and multiply is masked back to 32 bits. The
CUDA kernel uses native ``uint32_t`` arithmetic, which wraps the same way.

Stream ids (per bounce ``b``, ``STREAMS_PER_BOUNCE`` hashes each):
  0: shutter time   1: pixel jitter + defocus disk   3 + b: bounce ``b``
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PCG_MULT = 1664525
_PCG_ADD = 1013904223

STREAM_TIME = 0
STREAM_PIXEL_JITTER = 1
STREAM_BOUNCE_BASE = 3
STREAMS_PER_BOUNCE = 1  # one hash per bounce: dir u1/u2 + decision


def _as_u32(a, device) -> torch.Tensor:
    """Any integer tensor or Python int -> int64 tensor of its uint32 bits."""
    return torch.as_tensor(a, device=device).to(torch.int64) & _MASK


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 values held in int64, overflow-free."""
    lo = a * (b & 0xFFFF)
    hi = ((a * ((b >> 16) & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg4d(a, b, c, d):
    """PCG4D hash: four uint32 counters -> four well-mixed uint32 words.

    Inputs broadcast (tensors of any integer dtype, or Python ints, read as
    their low 32 bits). Returns four int64 tensors holding uint32 values.
    """
    device = next(
        (t.device for t in (a, b, c, d) if isinstance(t, torch.Tensor)), None
    )
    x, y, z, w = torch.broadcast_tensors(
        *(_as_u32(v, device) for v in (a, b, c, d))
    )

    x = (_mul32(x, _PCG_MULT) + _PCG_ADD) & _MASK
    y = (_mul32(y, _PCG_MULT) + _PCG_ADD) & _MASK
    z = (_mul32(z, _PCG_MULT) + _PCG_ADD) & _MASK
    w = (_mul32(w, _PCG_MULT) + _PCG_ADD) & _MASK

    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return x, y, z, w


def _to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in [0, 1) from the top 24 bits (exact)."""
    return (u >> 8).to(torch.float32) * (2.0**-24)


def uniform4(pixel_id, sample_id, stream_id, seed):
    """Four independent uniforms in [0,1) per counter tuple. Shapes broadcast."""
    x, y, z, w = pcg4d(pixel_id, sample_id, stream_id, seed)
    return (_to_unit_float(x), _to_unit_float(y), _to_unit_float(z), _to_unit_float(w))


def uniform1(pixel_id, sample_id, stream_id, seed):
    return uniform4(pixel_id, sample_id, stream_id, seed)[0]


def uniform2(pixel_id, sample_id, stream_id, seed):
    u = uniform4(pixel_id, sample_id, stream_id, seed)
    return u[0], u[1]


def uniform3(pixel_id, sample_id, stream_id, seed):
    u = uniform4(pixel_id, sample_id, stream_id, seed)
    return u[0], u[1], u[2]
