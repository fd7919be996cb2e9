"""Demo scenes (port of ``crucible_tpu/models/demo.py``: book1, its tiled
stress scene, the checkered and smoke scenes, the teapot on its checker
ground, the garden under its procedural HDR sky, and the movies:
``first_movie``, a keyframed camera walk around the garden's ball, and
``moving_teapot``, the teapot rising and shrinking, which needs
``teapot.obj``, an asset this repository lacks). ``WORLDS`` and
``MOVIE_WORLDS`` number them as the JAX package does (the earth and
nested-checker worlds, 4 and 7, need image textures and nested checkers,
not ported).

Scene generation takes an explicit seed and draws from numpy in the same
order as the JAX package, so both packages build identical tables.
"""

from __future__ import annotations

import numpy as np

from crucible_tpu_torch.io.procedural import ensure_garden_hdr
from crucible_tpu_torch.models.scene import (
    CheckerTexture,
    Dielectric,
    Lambertian,
    Metal,
    Scene,
    Sphere,
)
from crucible_tpu_torch.models.timeline import LERP, LOCAL, WORLD

_CHECKER_GROUND = CheckerTexture.from_colors(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))


def book1_end_scene(width: int = 400, seed: int = 7) -> Scene:
    """"Ray Tracing in One Weekend" final scene (~480 random small spheres +
    3 unit spheres + checker ground): 16:9, 500 spp, depth 50, vfov 20,
    defocus 0.6deg/10.0, lambertian/metal/glass chosen at 0.8/0.15/0.05."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(500)
    cam.set_max_depth(50)
    cam.look_from((13.0, 2.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    sc.add_element(
        Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian.from_texture(_CHECKER_GROUND)),
        "ground",
    )

    rng = np.random.default_rng(seed)
    counter = 0
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.random()
            center = (
                a + 0.9 * rng.random(),
                0.2,
                b + 0.9 * rng.random(),
            )
            if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) > 0.9:
                if choose_mat < 0.8:
                    albedo = tuple(rng.random(3) * rng.random(3))
                    material = Lambertian.from_color(albedo)
                elif choose_mat < 0.95:
                    albedo = tuple(rng.uniform(0.5, 1.0, 3))
                    material = Metal(albedo, float(rng.uniform(0.0, 0.5)))
                else:
                    material = Dielectric(1.5)
                sc.add_element(Sphere(center, 0.2, material), f"small{counter}")
                counter += 1

    sc.add_element(Sphere((0.0, 1.0, 0.0), 1.0, Dielectric(1.5)), "large_dielectric")
    sc.add_element(
        Sphere((-4.0, 1.0, 0.0), 1.0, Lambertian.from_color((0.4, 0.2, 0.1))),
        "large_lambertian",
    )
    sc.add_element(
        Sphere((4.0, 1.0, 0.0), 1.0, Metal((0.7, 0.6, 0.5), 0.0)), "large_metal"
    )
    return sc


def checkered_spheres(width: int = 400) -> Scene:
    """Two r=10 checker spheres."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(500)
    cam.set_max_depth(50)
    cam.look_from((13.0, 2.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    mat = Lambertian.from_texture(_CHECKER_GROUND)
    sc.add_element(Sphere((0.0, -10.0, 0.0), 10.0, mat), "bottom_sphere")
    sc.add_element(Sphere((0.0, 10.0, 0.0), 10.0, mat), "top_sphere")
    return sc


def sphere_stress(width: int = 400, copies: int = 4, seed: int = 7) -> Scene:
    """book1's random-sphere field tiled ``copies`` times across a grid —
    the multi-tile sphere-table stress scene. Each extra copy is a fresh
    22x22 random field offset by a 23-unit grid cell (nearest cells first),
    so N ~ 484 * copies rows, most of them far from most rays. Camera and
    quality settings are book1's."""
    sc = book1_end_scene(width=width, seed=seed)
    rng = np.random.default_rng(seed + 1)
    counter = 0
    side = int(np.ceil(np.sqrt(max(copies - 1, 0))))
    offsets = []
    for gx in range(-side, side + 1):
        for gz in range(-side, side + 1):
            if (gx, gz) != (0, 0):
                offsets.append((gx * 23.0, gz * 23.0))
    offsets.sort(key=lambda o: abs(o[0]) + abs(o[1]))
    for dx, dz in offsets[: max(copies - 1, 0)]:
        for a in range(-11, 11):
            for b in range(-11, 11):
                choose_mat = rng.random()
                center = (
                    dx + a + 0.9 * rng.random(),
                    0.2,
                    dz + b + 0.9 * rng.random(),
                )
                if choose_mat < 0.8:
                    material = Lambertian.from_color(tuple(rng.random(3) * rng.random(3)))
                elif choose_mat < 0.95:
                    material = Metal(
                        tuple(rng.uniform(0.5, 1.0, 3)), float(rng.uniform(0.0, 0.5))
                    )
                else:
                    material = Dielectric(1.5)
                sc.add_element(Sphere(center, 0.2, material), f"stress{counter}")
                counter += 1
    return sc


def load_teapot(width: int = 400) -> Scene:
    """teapot.obj at 0.5 scale under a metal material, on the checker
    ground: 16:9, 200 spp, depth 50, vfov 20, defocus 0.6deg/10.0. The
    mesh is an asset (``assets/teapot.obj``, resolved as ``io/assets``
    says); without it this raises ``FileNotFoundError``."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(200)
    cam.set_max_depth(50)
    cam.look_from((13.0, 10.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    sc.load_asset("teapot.obj", "teapot", 0.5, (0.0, 0.0, 0.0), Metal((0.8, 0.3, 0.5), 0.05))
    sc.add_element(
        Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian.from_texture(_CHECKER_GROUND)),
        "ground",
    )
    return sc


def smoke_scene(width: int = 400) -> Scene:
    """Single Lambertian sphere + ground, 16 spp, depth 8."""
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(16)
    cam.set_max_depth(8)
    cam.look_from((0.0, 0.5, 3.0))
    cam.look_at((0.0, 0.0, -1.0))
    cam.set_vfov(60.0)

    sc.add_element(
        Sphere((0.0, 0.0, -1.0), 0.5, Lambertian.from_color((0.7, 0.3, 0.3))), "ball"
    )
    sc.add_element(
        Sphere((0.0, -100.5, -1.0), 100.0, Lambertian.from_color((0.8, 0.8, 0.0))),
        "ground",
    )
    return sc


def garden_skybox(width: int = 1920) -> Scene:
    """Metal ball under the ``garden.hdr`` spherical sky. No asset set ships
    that file; a procedural substitute is generated into ``assets/`` on
    demand (``io/procedural.py``)."""
    ensure_garden_hdr()
    sc = Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(500)
    cam.set_max_depth(50)
    cam.look_from((0.0, 0.0, -12.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(40.0)

    sc.add_element(Sphere((0.0, 0.0, 0.0), 2.0, Metal((0.8, 0.8, 0.8), 0.05)), "metal_ball")
    sc.load_spherical_skybox("garden.hdr")
    return sc


def first_movie(frame_rate: float = 24.0, duration: float = 15.0) -> Scene:
    """Camera square-walk around a metal ball under the garden sky: 400
    wide, 50 spp, depth 5, the camera keyframed by the timeline animator."""
    ensure_garden_hdr()
    sc = Scene.new_movie(16.0 / 9.0, 400, frame_rate, 180.0, duration)
    cam = sc.scene_cam
    cam.set_samples(50)
    cam.set_max_depth(5)
    cam.look_from((0.0, 0.0, -12.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(40.0)

    sc.add_element(Sphere((0.0, 0.0, 0.0), 2.0, Metal((0.8, 0.8, 0.8), 0.05)), "metal_ball")
    sc.load_spherical_skybox("garden.hdr")

    sc.cam_translate_point((12.0, 0.0, 0.0), 2.5, LERP, WORLD, "from")
    sc.cam_translate_point((0.0, 0.0, 12.0), 5.0, LERP, WORLD, "from")
    sc.cam_translate_point((-12.0, 0.0, 0.0), 7.5, LERP, WORLD, "from")
    sc.cam_translate_point((0.0, 0.0, -12.0), 10.0, LERP, WORLD, "from")
    sc.cam_translate_point((0.0, 5.0, -20.0), 15.0, LERP, WORLD, "from")
    return sc


def moving_teapot(frame_rate: float = 24.0, duration: float = 5.0) -> Scene:
    """The teapot movie: ``load_teapot``'s scene at 400 wide, 50 spp, depth
    5, its mesh translated by (0, 5, 0) over 2.5 s and scaled to 0.5 by 3
    s (the JAX package's substitute for the original demo's ``scale_r`` on
    a mesh, which its animator rejects). The mesh is the ``teapot.obj``
    asset; without it this raises ``FileNotFoundError``."""
    sc = Scene.new_movie(16.0 / 9.0, 400, frame_rate, 180.0, duration)
    cam = sc.scene_cam
    cam.set_samples(50)
    cam.set_max_depth(5)
    cam.look_from((13.0, 10.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    sc.load_asset("teapot.obj", "teapot", 0.5, (0.0, 0.0, 0.0), Metal((0.8, 0.3, 0.5), 0.05))
    sc.add_element(
        Sphere((0.0, -1000.0, 0.0), 1000.0, Lambertian.from_texture(_CHECKER_GROUND)),
        "ground",
    )
    sc.translate_point((0.0, 5.0, 0.0), 2.5, LERP, LOCAL, "teapot")
    sc.scale_all_uniform(0.5, 3.0, LERP, "teapot")
    return sc


WORLDS = {
    1: book1_end_scene,
    2: checkered_spheres,
    3: load_teapot,
    5: garden_skybox,
    6: smoke_scene,
    8: sphere_stress,
}

MOVIE_WORLDS = {
    1: first_movie,
    2: moving_teapot,
}
