"""Asset path resolution (port of ``crucible_tpu/io/assets.py``).

Assets resolve inside the repository's own ``assets/`` only (procedurally
generated substitutes such as ``garden.hdr`` are written there); nothing
outside the checkout is searched.
"""

from __future__ import annotations

from pathlib import Path

ASSETS_DIR = Path(__file__).resolve().parents[2] / "assets"


def build_asset_path(filename: str) -> Path:
    """Resolve an asset filename to an existing path or raise FileNotFoundError."""
    path = ASSETS_DIR / filename
    if path.is_file():
        return path
    raise FileNotFoundError(
        f"Asset {filename!r} not found in the repository's assets/ ({ASSETS_DIR})."
    )
