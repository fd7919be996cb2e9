"""Triangle-mesh scenes for the mesh tests, built through the public API of
either package (pass its ``models.scene`` module; both take the same
calls): imports neither.

- ``fan``: the 80-triangle fan over a ground sphere of
  ``tests/test_integrator.py:320-361`` (a BVH mesh; ``count=40`` its first
  40 triangles, a mesh without a BVH); ``add_fan`` adds its triangles to
  another scene;
- ``floor_ball``: the 72-triangle grid floor under a metal ball of
  ``tests/test_oracle.py:207-234`` (a BVH mesh), with the oracle's objects;
- ``box``: a 12-triangle cube over a ground sphere (a brute mesh);
- ``torus_teapot``: the teapot scene of ``demo.load_teapot`` (camera,
  metal, checker ground) with a procedural torus of the teapot's 6,320
  triangles in place of ``teapot.obj``. ``chip_smoke.py`` builds the same
  scene.

Moving meshes (linear in their shutter windows unless said otherwise):

- ``moving_fan``: the fan, each triangle translated by 0.5 along x over
  the first second, at frame 6 (``tests/test_replay.py:210-220``'s
  animation); ``camera=True`` adds a camera rising by 0.5 over that second,
  ``mid_shutter=True`` puts the keyframe inside frame 6's shutter instead
  (exact-time motion);
- ``fan_beside_moving_sphere``: the static fan beside a rising ball (a
  static mesh in an animated scene);
- ``fan_rising_camera``: the static fan seen by the rising camera (a
  static scene, an animated camera);
- ``moving_box``: the box translated as the fan (a brute moving mesh);
- ``moving_torus_teapot``: torus_teapot as a movie (16:9, 24 fps, 180
  degrees, 5 s) with ``demo.moving_teapot``'s animation on every triangle:
  translated by (0, 5, 0) over 2.5 s, scaled to 0.5 by 3 s, at frame 30
  (shutter [1.25, 1.2708] s). ``chip_smoke.py`` builds the same scene.

A mesh beside a big sphere table:

- ``torus_beside_stress``: ``demo.sphere_stress`` (``copies`` 4: 1,936
  rows, above ``CULL_MIN_ROWS``, so the megakernel walks its tree) with a
  torus of ``2 nu nv`` triangles around book1's glass sphere; ``moving``:
  bouncing stress (``tests/torch_motion_scenes.py``) with every triangle
  rising by 0.5 over frame 0's shutter as its spheres do, a moving mesh
  beside a moving table. ``chip_smoke.py`` builds the same scenes (with
  torus_teapot's 6,320-triangle torus).
"""

from __future__ import annotations

import math


def fan(scene, width: int = 48, count: int = 80):
    sc = scene.Scene.new_image(1.0, width)
    cam = sc.scene_cam
    cam.look_from((0.0, 1.5, 4.0))
    cam.look_at((0.0, 0.3, 0.0))
    cam.set_vfov(45.0)
    sc.add_element(
        scene.Sphere((0.0, -100.0, 0.0), 100.0, scene.Lambertian.from_color((0.6, 0.6, 0.2))),
        "ground",
    )
    return add_fan(scene, sc, count)


def add_fan(scene, sc, count: int = 80):
    """Add the fan's first ``count`` of 80 metal triangles ``tri0``.. around
    the origin to ``sc`` (at most ``scene.BVH_MIN_TRIS`` = 64 of them: a
    mesh without a BVH)."""
    for i in range(count):
        a0 = 2 * math.pi * i / 80
        a1 = 2 * math.pi * (i + 1) / 80
        z0 = 0.3 + 0.1 * math.sin(5 * a0)
        sc.add_element(
            scene.Triangle(
                (0.8 * math.cos(a0), z0, 0.8 * math.sin(a0)),
                (1.2 * math.cos(a1), 0.35, 1.2 * math.sin(a1)),
                (0.0, 0.5, 0.0),
                scene.Metal((0.8, 0.7, 0.6), 0.2),
            ),
            f"tri{i}",
        )
    return sc


FLOOR_CAM = dict(look_from=(0.0, 3.0, 6.0), look_at=(0.0, 0.0, 0.0), vfov_deg=35.0)


def floor_ball(scene, width: int = 12):
    """-> (scene, the floor's triangles [(v0, v1, v2)], the ball (center,
    radius)), the floor Lambertian (0.6, 0.5, 0.2), the ball Metal((0.8,
    0.8, 0.9), 0)."""
    sc = scene.Scene.new_image(1.5, width)
    cam = sc.scene_cam
    cam.look_from(FLOOR_CAM["look_from"])
    cam.look_at(FLOOR_CAM["look_at"])
    cam.set_vfov(FLOOR_CAM["vfov_deg"])
    cam.set_focus_dist(10.0)
    floor_mat = scene.Lambertian.from_color((0.6, 0.5, 0.2))
    tris = []
    for gx in range(6):
        for gz in range(6):
            x0, z0 = -3.0 + gx, -3.0 + gz
            for tri in (((x0, 0.0, z0), (x0 + 1, 0.0, z0), (x0 + 1, 0.0, z0 + 1)),
                        ((x0, 0.0, z0), (x0 + 1, 0.0, z0 + 1), (x0, 0.0, z0 + 1))):
                sc.add_element(scene.Triangle(*tri, floor_mat), f"t{len(tris)}")
                tris.append(tri)
    sc.add_element(scene.Sphere((0.0, 1.0, 0.0), 1.0, scene.Metal((0.8, 0.8, 0.9), 0.0)),
                   "ball")
    return sc, tris, ((0.0, 1.0, 0.0), 1.0)


def box(scene, width: int = 32):
    """A unit cube of 12 triangles (a brute mesh) on a ground sphere."""
    sc = scene.Scene.new_image(16.0 / 9.0, width)
    cam = sc.scene_cam
    cam.look_from((2.5, 2.0, 3.5))
    cam.look_at((0.0, 0.4, 0.0))
    cam.set_vfov(40.0)
    sc.add_element(
        scene.Sphere((0.0, -100.0, 0.0), 100.0, scene.Lambertian.from_color((0.5, 0.6, 0.5))),
        "ground",
    )
    p = [(x, y, z) for x in (-0.5, 0.5) for y in (0.0, 1.0) for z in (-0.5, 0.5)]
    faces = ((0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3))
    mat = scene.Lambertian.from_color((0.7, 0.3, 0.2))
    for k, (a, b, c) in enumerate(faces):
        sc.add_element(scene.Triangle(p[a], p[b], p[c], mat), f"box{k}")
    return sc


# The torus: axis vertical, centred at (0, 0.61, 0), major radius 1.5,
# minor radius 0.6, 79 x 40 quads of two triangles: 6,320 triangles.
TORUS_U, TORUS_V = 79, 40


def torus_teapot(scene, width: int = 400, movie: bool = False):
    """``movie``: a 5 s movie at ``demo.moving_teapot``'s 50 spp, depth 5."""
    if movie:
        sc = scene.Scene.new_movie(16.0 / 9.0, width, 24.0, 180.0, 5.0)
    else:
        sc = scene.Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(50 if movie else 200)
    cam.set_max_depth(5 if movie else 50)
    cam.look_from((13.0, 10.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    add_torus(scene, sc)
    checker = scene.CheckerTexture.from_colors(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    sc.add_element(
        scene.Sphere((0.0, -1000.0, 0.0), 1000.0, scene.Lambertian.from_texture(checker)),
        "ground",
    )
    return sc


def add_torus(scene, sc, nu: int = TORUS_U, nv: int = TORUS_V, scale: float = 1.0,
              center=(0.0, 0.0, 0.0)):
    """Add the torus's 2 ``nu`` ``nv`` metal triangles ``tri0``.. to ``sc``:
    axis vertical, centred at ``center`` + (0, 0.61, 0) ``scale``, major
    radius 1.5 ``scale``, minor radius 0.6 ``scale``, ``nu`` x ``nv`` quads
    of two triangles (torus_teapot's 79 x 40 by default)."""
    def point(i, j):
        th, ph = 2 * math.pi * i / nu, 2 * math.pi * j / nv
        rr = scale * (1.5 + 0.6 * math.cos(ph))
        return (center[0] + rr * math.cos(th), center[1] + scale * (0.61 + 0.6 * math.sin(ph)),
                center[2] + rr * math.sin(th))

    metal = scene.Metal((0.8, 0.3, 0.5), 0.05)
    k = 0
    for i in range(nu):
        for j in range(nv):
            a, b = point(i, j), point(i + 1, j)
            c, d = point(i + 1, j + 1), point(i, j + 1)
            for tri in ((a, b, c), (a, c, d)):
                sc.add_element(scene.Triangle(*tri, metal), f"tri{k}")
                k += 1
    return sc


LERP, LOCAL, WORLD = "lerp", "local", "world"  # the timeline constants of both packages


def moving_fan(scene, width: int = 48, camera: bool = False, mid_shutter: bool = False,
               count: int = 80):
    sc = fan(scene, width, count)
    keyframe = 0.26 if mid_shutter else 1.0  # frame 6's shutter is [0.25, 0.2708]
    for i in range(count):
        sc.translate_x(0.5, keyframe, LERP, WORLD, f"tri{i}")
    if camera:
        sc.cam_translate_y(0.5, 1.0, LERP, LOCAL, "from")
    sc.scene_cam.frame = 6
    return sc


def fan_beside_moving_sphere(scene, width: int = 48):
    sc = fan(scene, width)
    sc.add_element(scene.Sphere((0.0, 0.9, 0.0), 0.25, scene.Lambertian.from_color(
        (0.2, 0.4, 0.8))), "ball")
    sc.translate_y(0.3, 1.0, LERP, LOCAL, "ball")
    sc.scene_cam.frame = 6
    return sc


def fan_rising_camera(scene, width: int = 48):
    sc = fan(scene, width)
    sc.cam_translate_y(0.5, 1.0, LERP, LOCAL, "from")
    sc.scene_cam.frame = 6
    return sc


def moving_box(scene, width: int = 32):
    sc = box(scene, width)
    for k in range(12):
        sc.translate_x(0.5, 1.0, LERP, WORLD, f"box{k}")
    sc.scene_cam.frame = 6
    return sc


def moving_torus_teapot(scene, width: int = 400, frame: int = 30):
    sc = torus_teapot(scene, width, movie=True)
    for k in range(TORUS_U * TORUS_V * 2):
        sc.translate_point((0.0, 5.0, 0.0), 2.5, LERP, LOCAL, f"tri{k}")
        sc.scale_all_uniform(0.5, 3.0, LERP, f"tri{k}")
    sc.scene_cam.frame = frame
    return sc


def torus_beside_stress(demo, scene, width: int, copies: int = 4, nu: int = 24, nv: int = 12,
                        moving: bool = False):
    """``demo.sphere_stress(width, copies)`` with ``add_torus(nu, nv)`` at
    the origin; ``moving``: ``bouncing_stress`` with each triangle
    translated by (0, 0.5, 0) over the first 1/48 s (linear in frame 0's
    shutter). ``demo`` and ``scene`` are one package's modules."""
    from tests.torch_motion_scenes import bouncing_stress

    sc = (bouncing_stress(demo, width, copies) if moving
          else demo.sphere_stress(width=width, copies=copies))
    add_torus(scene, sc, nu, nv)
    if moving:
        for k in range(2 * nu * nv):
            sc.translate_y(0.5, 1.0 / 48.0, LERP, LOCAL, f"tri{k}")
    return sc
