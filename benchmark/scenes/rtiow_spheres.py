"""The final scene of "Ray Tracing in One Weekend" (and the bouncing
spheres of "The Next Week", which move its Lambertian small spheres), as
plain arrays drawn from a seed.

A configuration file (``benchmark/configs/<name>.json``) gives the recipe:
the ground, the grid of small spheres with its jitter and keep-out, the
material mix, the three big spheres and, for the bouncing spheres, the
rise of each Lambertian small sphere over the shutter. Every seed gets
the same counts (the same spheres of each material, the same keep-out
cells); the book draws the material of each cell at random. The layout
(where each sphere sits, its material, a metal's fuzz, a sphere's rise)
is drawn once, from the configuration's ``layout_seed``: the book renders
one scene, and a layout drawn from the run's seed would change how much
work a render is (by 3% in the mean path length over six seeds). The
run's seed draws the albedos, which change no path.

:func:`describe` returns the arrays that both sides take:
:func:`program_scene` builds the measured program's scene from them
through its public scene API, and the reference named by ``REFERENCE``
(``benchmark/reference/<REFERENCE>.py``) its tables.
"""

from __future__ import annotations

import numpy as np

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
MATERIALS = ("lambertian", "metal", "dielectric")
# The reference module that renders and fits these scenes.
REFERENCE = "pathtrace"


def _cells(grid: dict) -> list[tuple[int, int]]:
    """The grid cells (a, b) that hold a small sphere: every cell of the
    grid but those whose jitter square can reach into the keep-out disk."""
    (a0, a1), (b0, b1) = grid["a"], grid["b"]
    jit, (kx, _, kz), kr = grid["jitter"], grid["keep_out"]["center"], grid["keep_out"]["radius"]
    out = []
    for a in range(a0, a1):
        for b in range(b0, b1):
            dx = max(kx - (a + jit), a - kx, 0.0)
            dz = max(kz - (b + jit), b - kz, 0.0)
            if dx * dx + dz * dz >= kr * kr:
                out.append((a, b))
    return out


def describe(cfg: dict, seed: int) -> dict:
    """The scene of ``cfg``, its albedos drawn from ``seed`` -> arrays:
    spheres ``center`` (N, 3), ``radius``, ``center_d`` (N, 3, the rise
    from shutter open to close; zeros where nothing moves), ``mat``,
    ``fuzz``, ``ior``, ``tex``; textures ``tex_color`` (T, 3),
    ``tex_checker``, ``tex_inv_scale``, ``tex_even``, ``tex_odd``;
    ``names``, one alias a sphere."""
    layout = np.random.default_rng(cfg["layout_seed"])
    rng = np.random.default_rng(seed)
    grid, mix = cfg["grid"], cfg["materials"]
    cells = _cells(grid)
    counts = {k: int(round(v * len(cells))) for k, v in mix.items()}
    counts["lambertian"] += len(cells) - sum(counts.values())
    kinds = np.array([LAMBERTIAN] * counts["lambertian"] + [METAL] * counts["metal"]
                     + [DIELECTRIC] * counts["dielectric"])
    kinds = layout.permutation(kinds)
    jitter = layout.random((len(cells), 2)) * grid["jitter"]
    met_fuzz = layout.uniform(0.0, 0.5, counts["metal"])
    motion = cfg.get("motion")
    rise = (layout.uniform(*motion["rise"], counts["lambertian"]) if motion
            else np.zeros(counts["lambertian"]))
    lam_color = rng.random((counts["lambertian"], 3)) * rng.random((counts["lambertian"], 3))
    met_color = rng.uniform(0.5, 1.0, (counts["metal"], 3))

    tex_color, tex_checker, tex_inv, tex_even, tex_odd = [], [], [], [], []

    def texture(color=(0.0, 0.0, 0.0), checker=None) -> int:
        if checker is not None:
            even, odd = texture(checker["even"]), texture(checker["odd"])
            tex_checker.append(True)
            tex_inv.append(1.0 / checker["scale"])
            tex_even.append(even)
            tex_odd.append(odd)
        else:
            tex_checker.append(False)
            tex_inv.append(1.0)
            tex_even.append(0)
            tex_odd.append(0)
        tex_color.append(tuple(color))
        return len(tex_color) - 1

    spheres = []  # (name, center, radius, center_d, mat, fuzz, ior, tex)
    g = cfg["ground"]
    ground_tex = (texture(checker=g["texture"]["checker"]) if "checker" in g["texture"]
                  else texture(g["texture"]["solid"]))
    spheres.append(("ground", g["center"], g["radius"], (0.0, 0.0, 0.0), LAMBERTIAN, 0.0, 1.0,
                    ground_tex))
    glass_tex = None
    ior = cfg["glass_ior"]
    i_lam = i_met = 0
    for k, ((a, b), kind) in enumerate(zip(cells, kinds)):
        center = (a + jitter[k, 0], grid["y"], b + jitter[k, 1])
        lift = (0.0, 0.0, 0.0)
        if kind == LAMBERTIAN:
            tex, fuzz = texture(lam_color[i_lam]), 0.0
            lift = (0.0, float(rise[i_lam]), 0.0)
            i_lam += 1
        elif kind == METAL:
            tex, fuzz = texture(met_color[i_met]), float(met_fuzz[i_met])
            i_met += 1
        else:
            if glass_tex is None:
                glass_tex = texture((1.0, 1.0, 1.0))
            tex, fuzz = glass_tex, 0.0
        spheres.append((f"small{k}", center, grid["radius"], lift, int(kind), fuzz, ior, tex))
    for k, big in enumerate(cfg["big"]):
        kind = {"lambertian": LAMBERTIAN, "metal": METAL, "dielectric": DIELECTRIC}[big["material"]]
        if kind == DIELECTRIC:
            if glass_tex is None:
                glass_tex = texture((1.0, 1.0, 1.0))
            tex = glass_tex
        else:
            tex = texture(big["albedo"])
        spheres.append((f"big{k}", big["center"], big["radius"], (0.0, 0.0, 0.0), kind,
                        float(big.get("fuzz", 0.0)), float(big.get("ior", ior)), tex))

    names, centers, radii, deltas, mats, fuzzes, iors, texs = zip(*spheres)
    return dict(
        names=list(names),
        center=np.asarray(centers, np.float64),
        radius=np.asarray(radii, np.float64),
        center_d=np.asarray(deltas, np.float64),
        mat=np.asarray(mats, np.int64),
        fuzz=np.asarray(fuzzes, np.float64),
        ior=np.asarray(iors, np.float64),
        tex=np.asarray(texs, np.int64),
        tex_color=np.asarray(tex_color, np.float64),
        tex_checker=np.asarray(tex_checker, bool),
        tex_inv_scale=np.asarray(tex_inv, np.float64),
        tex_even=np.asarray(tex_even, np.int64),
        tex_odd=np.asarray(tex_odd, np.int64),
    )


def _texture(S, desc, tid):
    if desc["tex_checker"][tid]:
        return S.CheckerTexture(
            float(1.0 / desc["tex_inv_scale"][tid]),
            S.SolidColor(tuple(float(c) for c in desc["tex_color"][desc["tex_even"][tid]])),
            S.SolidColor(tuple(float(c) for c in desc["tex_color"][desc["tex_odd"][tid]])))
    return S.SolidColor(tuple(float(c) for c in desc["tex_color"][tid]))


def program_scene(cfg: dict, desc: dict, width: int):
    """The program's ``Scene`` of a description at ``width`` (the height
    from the configuration's aspect ratio), with the configuration's camera
    and, where spheres move, a rise over the first frame's shutter."""
    from crucible_tpu_torch.models import scene as S

    a, b = cfg["image"]["aspect_ratio"]
    sh = cfg["shutter"]
    sc = S.Scene.new_image(a / b, width, sh["frame_rate"], sh["shutter_angle"])
    cam, c = sc.scene_cam, cfg["camera"]
    cam.look_from(tuple(c["lookfrom"]))
    cam.look_at(tuple(c["lookat"]))
    cam.vup = tuple(float(v) for v in c["vup"])
    cam.set_vfov(c["vfov"])
    cam.set_defocus_angle(c["defocus_angle"])
    cam.set_focus_dist(c["focus_dist"])
    cam.set_samples(cfg["image"]["samples_per_pixel"])
    cam.set_max_depth(cfg["image"]["max_depth"])
    _, t_close = cam.shutter_window()
    for k, name in enumerate(desc["names"]):
        kind = MATERIALS[desc["mat"][k]]
        tid = desc["tex"][k]
        if kind == "lambertian":
            mat = S.Lambertian.from_texture(_texture(S, desc, tid))
        elif kind == "metal":
            mat = S.Metal(tuple(float(c) for c in desc["tex_color"][tid]), float(desc["fuzz"][k]))
        else:
            mat = S.Dielectric(float(desc["ior"][k]))
        sc.add_element(S.Sphere(tuple(float(v) for v in desc["center"][k]),
                                float(desc["radius"][k]), mat), name)
        dx, dy, dz = desc["center_d"][k]
        if dx or dz:
            raise ValueError("these scenes move spheres along y only")
        if dy:
            # The rise ramps over the shutter alone: a zero step at shutter
            # open ends the timeline's initial interval there.
            sc.translate_y(0.0, 0.0, "nerp", "local", name)
            sc.translate_y(float(dy), t_close, "lerp", "local", name)
    return sc
