"""Scenes in motion for the motion tests, built through the public API of
either package (both take the same calls): imports neither.

``bouncing_book1`` is the bouncing-spheres motion-blur scene of Shirley's
"Ray Tracing: The Next Week" (section 2) on book1's final scene: every
Lambertian small sphere rises by a random height over the first 1/48 s,
and the camera's position rises by 0.5 over the same time. Frame 0's
shutter [0, 1/48] then holds no keyframe strictly inside it, so the motion
is linear there; with ``keyframe=1/96`` the key falls strictly inside that
shutter (exact-time motion), and ``spheres=False`` keys the camera alone.
``bouncing_stress`` does the same to ``sphere_stress``'s
tiled field (book1's ``small{k}`` and the copies' ``stress{k}``), whose
big tables the megakernel walks in clusters (K6). ``chip_smoke.py`` builds
the same scenes.
"""

from __future__ import annotations

import numpy as np

LERP, LOCAL = "lerp", "local"  # the timeline constants of both packages


def bouncing_book1(demo, width: int, keyframe: float = 1.0 / 48.0, spheres: bool = True):
    """book1 in motion, from ``demo`` (either package's models.demo): its
    spheres and camera keyed at ``keyframe``, or the camera alone where
    ``spheres`` is False."""
    return _bounce(demo.book1_end_scene(width=width), ("small",) if spheres else (), keyframe)


def bouncing_stress(demo, width: int, copies: int):
    """``demo.sphere_stress(width, copies)`` in motion as ``bouncing_book1``
    moves book1: copies=4 has 1,936 table rows (1,558 of them moving),
    copies=16 7,744."""
    return _bounce(demo.sphere_stress(width=width, copies=copies), ("small", "stress"))


def _bounce(sc, prefixes, keyframe: float = 1.0 / 48.0):
    """Raise every Lambertian sphere named ``<prefix><k>`` by U(0, 0.5)
    (numpy seed 11, in order) up to ``keyframe`` (1/48 s), and the camera's
    position by 0.5."""
    rng = np.random.default_rng(11)
    for prefix in prefixes:
        k = 0
        while sc.id_vendor.alias_lookup(f"{prefix}{k}") is not None:
            alias = f"{prefix}{k}"
            el = next(e for e in sc.elements if e.id == sc.id_vendor.alias_lookup(alias)[0])
            if type(el.material).__name__ == "Lambertian":
                sc.translate_y(float(rng.uniform(0.0, 0.5)), keyframe, LERP, LOCAL, alias)
            k += 1
    sc.cam_translate_y(0.5, keyframe, LERP, LOCAL, "from")
    return sc
