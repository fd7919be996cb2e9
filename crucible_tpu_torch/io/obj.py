"""Minimal Wavefront OBJ loader (``v``/``f`` records, triangles only).

Port of ``crucible_tpu/io/obj.py``: only ``v`` and ``f`` records are read
(anything else raises unless ``strict=False``), faces must be triangles
with 1-based vertex indices (negative ones count from the end; ``v/vt/vn``
forms keep the vertex index), and a uniform ``scale`` then ``shift`` is
applied to every vertex at load time. Files resolve through
``io/assets.build_asset_path`` (``ASSET_DIR``, ``./assets`` up to 6
parents, then the repository's ``assets/``).
"""

from __future__ import annotations

import numpy as np

from crucible_tpu_torch.io.assets import build_asset_path


def load_obj(filename: str, scale: float = 1.0, shift=(0.0, 0.0, 0.0), strict: bool = True):
    """Parse an OBJ asset -> (verts (V, 3) float32 scaled and shifted,
    faces (F, 3) int32 0-based)."""
    path = build_asset_path(filename)
    if path.suffix != ".obj":
        raise ValueError("Expected an obj file.")
    return parse_obj_text(path.read_text(), scale=scale, shift=shift, strict=strict)


def parse_obj_text(text: str, scale: float = 1.0, shift=(0.0, 0.0, 0.0), strict: bool = True):
    """:func:`load_obj` on the text of an OBJ file."""
    verts, faces = [], []
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "v":
            if len(parts) != 4:
                raise ValueError("Invalid number of coordinates for a vertex")
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "f":
            if len(parts) != 4:
                raise ValueError(
                    "The asset loader only supports triangulated meshes; "
                    "triangulate the model and try again"
                )
            faces.append([int(p.split("/")[0]) for p in parts[1:]])
        elif strict:
            raise ValueError(f"Unsupported OBJ record {tag!r}")

    v = np.asarray(verts, dtype=np.float32) * np.float32(scale) + np.asarray(
        shift, dtype=np.float32
    )
    f = np.asarray(faces, dtype=np.int64)
    f = np.where(f > 0, f - 1, len(v) + f).astype(np.int32)
    return v, f
