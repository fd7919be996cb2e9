"""Asset path resolution (port of ``crucible_tpu/io/assets.py``).

An asset resolves, in this order, in the ``ASSET_DIR`` environment
variable's directory, in ``assets/`` of the current directory and of up to
6 of its parents, then in the repository's own ``assets/`` (``ASSETS_DIR``,
where procedurally generated substitutes such as ``garden.hdr`` are
written), as the JAX package's resolver searches. Its last fallback, a
reference checkout outside the repository, is not searched.
"""

from __future__ import annotations

import os
from pathlib import Path

ASSETS_DIR = Path(__file__).resolve().parents[2] / "assets"
_MAX_PARENT_PROBES = 6


def build_asset_path(filename: str) -> Path:
    """Resolve an asset filename to an existing path or raise FileNotFoundError."""
    candidates = []
    env_dir = os.environ.get("ASSET_DIR")
    if env_dir:
        candidates.append(Path(env_dir) / filename)
    here = Path.cwd()
    for _ in range(_MAX_PARENT_PROBES + 1):
        candidates.append(here / "assets" / filename)
        if here.parent == here:
            break
        here = here.parent
    candidates.append(ASSETS_DIR / filename)
    for path in candidates:
        if path.is_file():
            return path
    raise FileNotFoundError(
        f"Asset {filename!r} not found. Searched ASSET_DIR, ./assets up to "
        f"{_MAX_PARENT_PROBES} parents and the repository's assets/ ({ASSETS_DIR})."
    )
