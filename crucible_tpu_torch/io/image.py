"""Image decode (HDR only) and film output: ASCII P3 PPM and PNG (port of
``crucible_tpu/io/image.py``).

:func:`write_image` picks the format by the suffix, as the JAX package's
does: ``.ppm`` as P3 text, anything else through PIL where PIL imports.
Without PIL it writes ``.png`` itself (the standard library's ``zlib``,
8-bit RGB, no filtering) and refuses other suffixes. Decoding LDR formats
(the JAX package's PIL route, for image textures) is not ported.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from crucible_tpu_torch.io import hdr as hdr_io
from crucible_tpu_torch.io.assets import build_asset_path


def load_image(filename: str) -> np.ndarray:
    """Load an asset image -> (H, W, 3) float32 linear radiance. ``.hdr``
    files only; other formats raise ``NotImplementedError``."""
    if Path(filename).suffix.lower() != ".hdr":
        raise NotImplementedError(
            f"decoding {filename!r}: only .hdr images are ported to "
            "crucible_tpu_torch yet"
        )
    return hdr_io.read_hdr(build_asset_path(filename))


def write_ppm(path, img_u8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as ASCII P3 PPM."""
    img_u8 = np.asarray(img_u8, dtype=np.uint8)
    h, w = img_u8.shape[:2]
    flat = img_u8.reshape(-1, 3)
    # One "r g b" triple per line.
    body = "\n".join(f"{r} {g} {b}" for r, g, b in flat)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n{body}\n")


def write_image(path, img_u8: np.ndarray) -> None:
    """Write by extension: ``.ppm`` as P3 text, anything else through PIL,
    which picks the format by the suffix (``.png``, ``.jpg``, ...). Without
    PIL, ``.png`` is written by :func:`write_png` and any other suffix
    raises ``ValueError``."""
    suffix = Path(path).suffix.lower()
    if suffix == ".ppm":
        write_ppm(path, img_u8)
        return
    try:
        from PIL import Image
    except ImportError:
        if suffix != ".png":
            raise ValueError(
                f"cannot write {str(path)!r}: without PIL only .ppm and .png are written"
            ) from None
        write_png(path, img_u8)
        return
    Image.fromarray(np.ascontiguousarray(img_u8, dtype=np.uint8), mode="RGB").save(path)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path, img_u8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as an 8-bit RGB PNG."""
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    h, w = img_u8.shape[:2]
    # Each scanline is prefixed with filter type 0 (none).
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img_u8.reshape(h, w * 3)], axis=1
    ).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", header))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))
