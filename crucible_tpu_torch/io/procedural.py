"""Procedurally generated substitute assets (port of
``crucible_tpu/io/procedural.py``).

The garden demo needs ``garden.hdr``, which no asset set ships; a plausible
garden-like equirect HDR (sky gradient + sun disk + ground bounce) is
synthesized into the repository's ``assets/`` instead. The numpy code is the
JAX package's, so both packages write the same bytes to the same path.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np

from crucible_tpu_torch.io import hdr as hdr_io
from crucible_tpu_torch.io.assets import ASSETS_DIR


def generate_garden_hdr(height: int = 512) -> np.ndarray:
    """Equirect (H, 2H, 3) float32 radiance map: blue sky, warm sun disk at
    ~45 deg elevation, green grassy lower hemisphere with horizon haze."""
    h, w = height, 2 * height
    v = (np.arange(h) + 0.5) / h  # 0 top .. 1 bottom
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    # Direction from equirect (the inverse of the skybox mapping):
    phi = (vv - 0.5) * -np.pi  # +pi/2 at top
    theta = (uu - 0.5) * 2.0 * np.pi
    y = np.sin(phi)
    x = np.cos(phi) * np.sin(theta)
    z = np.cos(phi) * np.cos(theta)

    sky_t = np.clip(y, 0.0, 1.0)
    sky = (
        (1.0 - sky_t)[..., None] * np.array([0.9, 0.95, 1.05], np.float32)
        + sky_t[..., None] * np.array([0.25, 0.45, 0.95], np.float32)
    ) * 1.2

    sun_dir = np.array([0.5, np.sqrt(0.5), 0.5], np.float32)
    sun_dir /= np.linalg.norm(sun_dir)
    cos_sun = x * sun_dir[0] + y * sun_dir[1] + z * sun_dir[2]
    sun = np.clip((cos_sun - 0.9995) / 0.0005, 0.0, 1.0)[..., None] * np.array(
        [500.0, 450.0, 380.0], np.float32
    )
    halo = np.clip(cos_sun, 0.0, 1.0) ** 64
    sky = sky + halo[..., None] * np.array([1.5, 1.2, 0.8], np.float32)

    grass_t = np.clip(-y, 0.0, 1.0)
    # Low-frequency mottling so reflections aren't flat.
    mottle = 0.15 * np.sin(8.0 * theta) * np.sin(5.0 * phi) + 0.1 * np.sin(23.0 * theta)
    ground = (
        (0.9 + mottle)[..., None]
        * (
            (1.0 - grass_t)[..., None] * np.array([0.45, 0.42, 0.35], np.float32)
            + grass_t[..., None] * np.array([0.12, 0.35, 0.1], np.float32)
        )
        * 0.8
    )

    above = (y >= 0.0)[..., None]
    return np.where(above, sky + sun, ground).astype(np.float32)


def ensure_garden_hdr() -> Path:
    """Generate ``assets/garden.hdr`` unless a complete one is there; return
    its path.

    The file is written under a temporary name and renamed into place, so
    that processes generating it at the same time never read half a file;
    a file of the wrong size (another writer's partial file) is replaced.
    """
    path = ASSETS_DIR / "garden.hdr"
    h = 512  # generate_garden_hdr's default height; the map is (h, 2h)
    if path.is_file() and path.stat().st_size == len(hdr_io.hdr_header(h, 2 * h)) + 8 * h * h:
        return path
    data = hdr_io.hdr_bytes(generate_garden_hdr(h))
    ASSETS_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".hdr", dir=ASSETS_DIR)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path
