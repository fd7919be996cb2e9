"""Radiance RGBE (.hdr) codec in numpy (port of ``crucible_tpu/io/hdr.py``).

Files decode to full float radiance, not the original renderer's rgb8.

Format: "#?RADIANCE"/"#?RGBE" header, ``-Y H +X W`` resolution line, then
per-scanline RGBE bytes either flat or new-style RLE (two-byte marker
0x02 0x02 + 4 component-planar RLE streams).
"""

from __future__ import annotations

import numpy as np


def _decode_rle_scanline(data: bytes, pos: int, width: int) -> tuple[np.ndarray, int]:
    """Decode one new-style RLE scanline -> (width, 4) uint8, new position."""
    out = np.zeros((4, width), dtype=np.uint8)
    for comp in range(4):
        x = 0
        while x < width:
            count = data[pos]
            pos += 1
            if count > 128:  # run
                run_len = count - 128
                out[comp, x : x + run_len] = data[pos]
                pos += 1
                x += run_len
            else:  # literal
                out[comp, x : x + count] = np.frombuffer(
                    data[pos : pos + count], dtype=np.uint8
                )
                pos += count
                x += count
    return out.T, pos


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32 linear radiance."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 128 - 8)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8 RGBE."""
    rgb = np.maximum(rgb, 0.0).astype(np.float32)
    maxc = rgb.max(axis=-1)
    mant, exp = np.frexp(maxc)
    scale = np.where(maxc > 1e-32, mant * 256.0 / np.where(maxc > 0, maxc, 1.0), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    return out


def read_hdr(path) -> np.ndarray:
    """Decode a Radiance .hdr file -> (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()

    # Header: lines until blank, then the resolution line.
    pos = 0
    first = data[: data.index(b"\n")]
    if not (first.startswith(b"#?RADIANCE") or first.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res_line = data[pos:nl].split()
    pos = nl + 1
    if len(res_line) != 4 or res_line[0] != b"-Y" or res_line[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res_line!r}")
    height, width = int(res_line[1]), int(res_line[3])

    rows = []
    for _ in range(height):
        if (
            width >= 8
            and width < 32768
            and pos + 4 <= len(data)
            and data[pos] == 2
            and data[pos + 1] == 2
            and ((data[pos + 2] << 8) | data[pos + 3]) == width
        ):
            pos += 4
            row, pos = _decode_rle_scanline(data, pos, width)
        else:  # flat RGBE
            row = np.frombuffer(data[pos : pos + 4 * width], dtype=np.uint8).reshape(
                width, 4
            )
            pos += 4 * width
        rows.append(row)
    return rgbe_to_float(np.stack(rows))


def hdr_header(height: int, width: int) -> bytes:
    """The header :func:`write_hdr` writes; flat RGBE pixels follow it."""
    return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {height} +X {width}\n".encode()


def hdr_bytes(rgb: np.ndarray) -> bytes:
    """The bytes :func:`write_hdr` writes for (H, W, 3) float32 radiance."""
    return hdr_header(*rgb.shape[:2]) + float_to_rgbe(rgb).tobytes()


def write_hdr(path, rgb: np.ndarray) -> None:
    """Write (H, W, 3) float32 as a flat (non-RLE) Radiance .hdr file."""
    with open(path, "wb") as f:
        f.write(hdr_bytes(rgb))
