"""Image decode and film output: ASCII P3 PPM and PNG (port of
``crucible_tpu/io/image.py``).

:func:`load_image` decodes ``.hdr`` with the port's RGBE codec and every
other format (``.jpg``, ``.png``, ...) through PIL to byte/255 with no
gamma, as the JAX package does; without PIL an LDR decode raises
``ImportError``. :func:`write_image` picks the format by the suffix, as the
JAX package's does: ``.ppm`` as P3 text, anything else through PIL where
PIL imports. Without PIL it writes ``.png`` itself (the standard library's
``zlib``, 8-bit RGB, no filtering) and refuses other suffixes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from crucible_tpu_torch.io import hdr as hdr_io
from crucible_tpu_torch.io.assets import build_asset_path


def load_image(filename: str) -> np.ndarray:
    """Load an asset image (:mod:`crucible_tpu_torch.io.assets` resolves
    the name) -> (H, W, 3) float32: :func:`load_image_path`."""
    return load_image_path(build_asset_path(filename))


def load_image_path(path) -> np.ndarray:
    """Decode an image file -> (H, W, 3) float32. ``.hdr`` decodes to full
    float radiance; any other format through PIL to RGB bytes / 255, with no
    gamma linearization (the original's image scaling)."""
    path = Path(path)
    if path.suffix.lower() == ".hdr":
        return hdr_io.read_hdr(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {str(path)!r} needs PIL (Pillow), which does not import here; "
            "only .hdr images decode without it"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def read_ppm(path) -> np.ndarray:
    """Read an ASCII P3 PPM -> (H, W, 3) uint8."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"{str(path)!r}: only ASCII P3 PPM is read")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"{str(path)!r}: maxval {maxval}, not 255")
    pix = np.array(tokens[4:4 + 3 * w * h], dtype=np.int64)
    return pix.reshape(h, w, 3).astype(np.uint8)


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
