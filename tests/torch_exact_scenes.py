"""Scenes with a keyframe strictly inside frame 0's shutter (exact-time
motion), built through the public API of either package (both take the
same calls): imports neither. They are the JAX package's own exact-time
cases (``tests/test_timeline.py``, ``TestExactMidShutter``), each with the
time of its key, at which an emissive primitive appears in front of the
whole view (the "oracle": a ray shows the emission where its absolute time
is past the key, else the sky). Frame 0's shutter at 24 fps and 180
degrees is [0, 1/48).
"""

from __future__ import annotations

NERP, LERP, WORLD, LOCAL = "nerp", "lerp", "world", "local"


def _base(S, width):
    return S.Scene(aspect_ratio=1.0, image_width=width)


def flash(S, width: int = 8):
    """An emissive sphere NERP-teleports at t = 0.01 from outside the
    frustum to around the camera -> (scene, key time, emission)."""
    emission = (1.0, 0.5, 0.25)
    sc = _base(S, width)
    sc.add_element(S.Sphere((100.0, 0.0, 0.0), 50.0, S.Emissive(emission)), "flash")
    sc.translate_point((0.0, 0.0, -3.0), 0.01, NERP, WORLD, "flash")
    return sc, 0.01, emission


def radius_nerp(S, width: int = 8):
    """A sphere's radius jumps from 0.001 to 50 (around the camera) at
    t = 0.012."""
    emission = (0.2, 0.9, 0.4)
    sc = _base(S, width)
    sc.add_element(S.Sphere((0.0, 0.0, -3.0), 0.001, S.Emissive(emission)), "grow")
    sc.scale_r(50.0, 0.012, NERP, "grow")
    return sc, 0.012, emission


def triangle_wall(S, width: int = 8):
    """One huge triangle behind the camera (a brute mesh) NERP-shifts in
    front of it at t = 0.008."""
    emission = (0.8, 0.1, 0.6)
    sc = _base(S, width)
    sc.add_element(S.Triangle((-1000.0, -1000.0, 5.0), (1000.0, -1000.0, 5.0),
                              (0.0, 2000.0, 5.0), S.Emissive(emission)), "wall")
    sc.translate_point((0.0, 0.0, -10.0), 0.008, NERP, LOCAL, "wall")
    return sc, 0.008, emission


def grid_wall(S, sc, emission, n=10, ext=300.0, z=5.0, y_off=0.0):
    """2 n^2 emissive triangles forming a wall at z (a BVH mesh for n = 10)
    -> their aliases."""
    aliases = []
    for i in range(n):
        for j in range(n):
            x0, x1 = -ext + 2 * ext * i / n, -ext + 2 * ext * (i + 1) / n
            y0 = y_off - ext + 2 * ext * j / n
            y1 = y_off - ext + 2 * ext * (j + 1) / n
            for tag, tri in (("a", ((x0, y0, z), (x1, y0, z), (x1, y1, z))),
                             ("b", ((x0, y0, z), (x1, y1, z), (x0, y1, z)))):
                al = f"t{i}_{j}{tag}"
                sc.add_element(S.Triangle(*tri, S.Emissive(emission)), al)
                aliases.append(al)
    return aliases


def bvh_wall(S, width: int = 8):
    """The 200-triangle wall behind the camera NERP-shifts in front of it at
    t = 0.008: the BVH walk's per-candidate vertex hook."""
    emission = (0.8, 0.1, 0.6)
    sc = _base(S, width)
    for al in grid_wall(S, sc, emission):
        sc.translate_point((0.0, 0.0, -10.0), 0.008, NERP, LOCAL, al)
    return sc, 0.008, emission


def kink_wall(S, width: int = 8):
    """The wall parked below the frustum rises 400 by t = 0.01 and sinks
    back by 0.02 (a LERP kink inside the shutter): visible only near the
    kink, so boxes over the shutter's ends alone would miss it. No oracle:
    its BVH and brute lowerings are held against each other."""
    emission = (0.3, 0.7, 0.5)
    sc = _base(S, width)
    for al in grid_wall(S, sc, emission, z=-5.0, y_off=-700.0):
        sc.translate_y(400.0, 0.01, LERP, LOCAL, al)
        sc.translate_y(-400.0, 0.02, LERP, LOCAL, al)
    return sc, None, emission


def camera_teleport(S, width: int = 8):
    """The camera NERP-teleports from the origin to (0, 5, 0) at t = 0.015
    in an empty scene: its rays' origins step per ray (the oracle is on the
    origins) -> (scene, key time, the position after the key)."""
    sc = _base(S, width)
    sc.cam_translate_point((0.0, 5.0, 0.0), 0.015, NERP, WORLD, "from")
    return sc, 0.015, (0.0, 5.0, 0.0)


CASES = {
    "flash": flash,
    "radius_nerp": radius_nerp,
    "triangle_wall": triangle_wall,
    "bvh_wall": bvh_wall,
    "kink_wall": kink_wall,
    "camera_teleport": camera_teleport,
}
