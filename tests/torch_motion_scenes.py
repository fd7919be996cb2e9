"""Scenes in motion for the motion tests, built through the public API of
either package (both take the same calls): imports neither.

``bouncing_book1`` is the bouncing-spheres motion-blur scene of Shirley's
"Ray Tracing: The Next Week" (section 2) on book1's final scene: every
Lambertian small sphere rises by a random height over the first 1/48 s,
and the camera's position rises by 0.5 over the same time. Frame 0's
shutter [0, 1/48] then holds no keyframe strictly inside it, so the motion
is linear there. ``chip_smoke.py`` builds the same scene.
"""

from __future__ import annotations

import numpy as np

LERP, LOCAL = "lerp", "local"  # the timeline constants of both packages


def bouncing_book1(demo, width: int):
    """book1 in motion, from ``demo`` (either package's models.demo)."""
    sc = demo.book1_end_scene(width=width)
    rng = np.random.default_rng(11)
    k = 0
    while sc.id_vendor.alias_lookup(f"small{k}") is not None:
        el = next(e for e in sc.elements if e.id == sc.id_vendor.alias_lookup(f"small{k}")[0])
        if type(el.material).__name__ == "Lambertian":
            sc.translate_y(float(rng.uniform(0.0, 0.5)), 1.0 / 48.0, LERP, LOCAL, f"small{k}")
        k += 1
    sc.cam_translate_y(0.5, 1.0 / 48.0, LERP, LOCAL, "from")
    return sc
