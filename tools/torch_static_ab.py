#!/usr/bin/env python3
"""Time the megakernel's instantiations of one checkout of crucible_tpu_torch
on the card, for an A/B comparison of two trees.

    python3 tools/torch_static_ab.py [--repo PATH] [--label NAME]
                                     [--save DIR] [--against DIR]

``--repo`` is the root of the checkout whose package is imported (default:
this one); its kernels are built there. Run two trees in turns in one
process list on one card (parent, change, change, parent) and compare
within the call. Times are CUDA-event means over repeated launches at the
shapes ``chip_smoke.py`` and the main paths use:

- K1 (``run_megakernel``, the brute static search): book1 320 wide 8 spp
  depth 50, and 1920x1080 32 spp depth 50;
- K2 (``run_megakernel_record``): book1 1920x1080 4 spp depth 8, fused
  and plain (the gradient step's record), and the deep chunk's two records
  at 1920x1080 4 spp: the head record (depth 6, fused) and the narrow
  re-record of the paths that continue past it (depth 50, fused from
  bounce 6, its survivors compacted into r // 12 slots as
  ``replay.record_two_level`` compacts them);
- K5: sphere_stress 7744 and 1936 rows, 320 wide 8 spp depth 50, and
  7744 rows at 1920x1080 32 spp depth 50; its record (fused) at 1920x1080
  4 spp depth 8, 7744 and 1936 rows; and with K8's rising camera, 1936
  rows, 320 wide 8 spp depth 50 and its record at 320 wide 4 spp depth 8.
  A tree whose static scenes carry no tree of their own (before K5 walked
  one) walks their sphere BVH (``sph_nodes``) instead;
- K8, which shares K1's camera and shading code: book1's table given the
  animated flag;
- K7 on chip_smoke.py's torus_teapot, 320 wide 8 spp and 1920x1080 32 spp
  depth 50, and its record (fused) at 1920x1080 4 spp depth 8; K7 moving
  on its moving twin (chip_smoke.moving_torus_teapot, frame 30) likewise;
- K8's brute search on bouncing book1 (``chip_smoke.bouncing_book1``): each
  flag set (moving spheres, moving camera, both) 320 wide 8 spp depth 50,
  both flags at 1920x1080 32 spp depth 50, and its record (both flags,
  fused) at 1920x1080 4 spp depth 8;
- K6 on bouncing stress (``chip_smoke.bouncing_stress``, moving spheres and
  camera): n7744 and n1936 320 wide 8 spp depth 50, n7744 at 1920x1080 32
  spp depth 50, and its record (fused) at 1920x1080 4 spp depth 8. A tree
  whose scenes carry no swept tree (before K6 walked one) walks the
  clusters (``cbounds``) instead.

``--save DIR`` writes a digest of every timed launch's outputs (the lanes'
radiance sums; records and fused radiance) to DIR; ``--against DIR``
compares this run's digests with a saved run's and exits non-zero where
one differs: both trees must give the same bits.

Prints the card's name and power limit, then one JSON line
``{"label": ..., "card": ..., "ms": {shape: ms}, "against": {shape: equal}}``.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    root = Path(args.repo).resolve()
    if not (root / "crucible_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"no crucible_tpu_torch package under {root}")
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    import chip_smoke
    from crucible_tpu_torch.models import demo, integrator, replay
    from crucible_tpu_torch.models import scene as tscene
    from crucible_tpu_torch.ops.kernels import build, megakernel as mk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    build.load("megakernel")
    dev = torch.device("cuda:0")

    def cuda_ms(fn, reps):
        fn()  # warm
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def walk(x, sd):
        """K5's inputs: ``x`` with the table in the walk's order and the
        static scene's tree or, in a tree before it, its sphere BVH."""
        if getattr(sd, "sph_swept_nodes", None) is not None:
            return dict(x, table=integrator.permute_table(x["table"], sd.sph_swept_perm),
                        swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
        return dict(x, table=integrator.permute_table(x["table"], sd.sph_perm),
                    sph_nodes=sd.sph_nodes, sph_meta=sd.sph_meta)

    def tri(x, sd):
        return dict(x, **dict(zip(("tri_nodes", "tris", "mats", "tri_meta"),
                                  integrator.make_tri_tables(sd))))

    def inputs(sc, spp, walk_tables=False, tri_tables=False):
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        x, _ = integrator.mega_inputs(sd, cp, w, h, spp, 50, 0)
        if walk_tables:
            x = walk(x, sd)
        if tri_tables:
            x = tri(x, sd)
        return x

    def cull(x, sd):
        """K6's inputs: ``x`` with the table in the walk's order and its
        tables, the swept tree or, in a tree before it, the clusters."""
        if getattr(sd, "sph_swept_nodes", None) is not None:
            return dict(x, table=integrator.permute_table(x["table"], sd.sph_swept_perm),
                        swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
        return dict(x, table=integrator.permute_table(x["table"], sd.sph_perm),
                    cbounds=sd.sph_cbounds)

    def record_inputs(width, spp, sc=None):
        """K2's inputs for every pixel of book1 (or ``sc``) at ``spp``
        samples, lanes sample-major as ``grad`` lays them out."""
        sc = sc or demo.book1_end_scene(width=width)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        p = w * h
        return dict(
            smem=torch.tensor([0, 0, w, 8, 0, 0, 0, 0], dtype=torch.int32, device=dev),
            pix=torch.arange(p, device=dev, dtype=torch.int32).repeat(spp)[None],
            sample0=torch.arange(spp, device=dev, dtype=torch.int32).repeat_interleave(p)[None],
            cam=integrator.mega_cam_vector(cp, w, h),
            table=integrator.make_sphere_table(sd).contiguous(),
        )

    ms, against, bad = {}, {}, []

    def digest(out):
        outs = out if isinstance(out, tuple) else (out,)
        return [hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()
                for t in outs]

    def timed(name, fn, reps):
        ms[name] = cuda_ms(fn, reps)
        print(f"  {name}: {ms[name]:.3f} ms", flush=True)
        got = digest(fn())
        if args.save:
            Path(args.save).mkdir(parents=True, exist_ok=True)
            (Path(args.save) / f"{name}.json").write_text(json.dumps(got))
        if args.against:
            against[name] = got == json.loads((Path(args.against) / f"{name}.json").read_text())
            if not against[name]:
                bad.append(name)
                print(f"  {name}: outputs differ from {args.against}", flush=True)

    forward = {
        "k1_book1_320w_8spp": (demo.book1_end_scene(width=320), 8, {}, 5),
        "k1_book1_1080p_32spp": (demo.book1_end_scene(width=1920), 32, {}, 3),
        "k5_n7744_320w_8spp": (demo.sphere_stress(width=320, copies=16), 8,
                               dict(walk_tables=True), 3),
        "k5_n1936_320w_8spp": (demo.sphere_stress(width=320, copies=4), 8,
                               dict(walk_tables=True), 3),
        "k5_n7744_1080p_32spp": (demo.sphere_stress(width=1920, copies=16), 32,
                                 dict(walk_tables=True), 2),
        "k7_torus_teapot_320w_8spp": (chip_smoke.torus_teapot(tscene, 320), 8,
                                      dict(tri_tables=True), 3),
        "k7_torus_teapot_1080p_32spp": (chip_smoke.torus_teapot(tscene, 1920), 32,
                                        dict(tri_tables=True), 2),
    }
    for name, (sc, spp, kw, reps) in forward.items():
        x = inputs(sc, spp, **kw)
        timed(name, lambda: mk.run_megakernel(**x, animated=False), reps)
        if name == "k1_book1_320w_8spp":  # K8's moving search on book1's table
            timed("k8_book1_320w_8spp_animated",
                  lambda: mk.run_megakernel(**x, animated=True), reps)
        del x

    # K5's records, and K5 with K8's rising camera.
    for copies in (16, 4):
        sc = demo.sphere_stress(width=1920, copies=copies)
        x = walk(record_inputs(1920, 4, sc), sc.build(device=dev))
        timed(f"k5_record_n{484 * copies}_1080p_4spp_d8", lambda: mk.run_megakernel_record(
            **x, max_depth=8, radiance=True), 3)
    cam_only = dict(animated=False, cam_animated=True)
    sc = demo.sphere_stress(width=320, copies=4)
    sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
    x = inputs(sc, 8, walk_tables=True)
    timed("k5_camera_n1936_320w_8spp", lambda: mk.run_megakernel(**x, **cam_only), 3)
    x = walk(record_inputs(320, 4, sc), sc.build(device=dev))
    timed("k5_camera_record_n1936_320w_4spp_d8", lambda: mk.run_megakernel_record(
        **x, max_depth=8, radiance=True, **cam_only), 5)

    # K7's record, and K7 moving (moving torus_teapot at frame 30).
    sc = chip_smoke.torus_teapot(tscene, 1920)
    x = tri(record_inputs(1920, 4, sc), sc.build(device=dev))
    timed("k7_record_torus_teapot_1080p_4spp_d8", lambda: mk.run_megakernel_record(
        **x, max_depth=8, radiance=True), 3)
    moving = dict(animated=True, cam_animated=False)
    sc = chip_smoke.moving_torus_teapot(tscene, 320)
    for width, spp, reps in ((320, 8, 3), (1920, 32, 2)):
        sc.scene_cam.image_width = width
        x = inputs(sc, spp, tri_tables=True)
        timed(f"k7_moving_torus_teapot_{width}w_{spp}spp".replace("1920w", "1080p"),
              lambda: mk.run_megakernel(**x, **moving), reps)
    x = tri(record_inputs(1920, 4, sc), sc.build(device=dev))
    timed("k7_moving_record_torus_teapot_1080p_4spp_d8", lambda: mk.run_megakernel_record(
        **x, max_depth=8, radiance=True, **moving), 3)
    del x

    x = record_inputs(1920, 4)
    for radiance in (True, False):
        timed(f"k2_1080p_4spp_d8_{'fused' if radiance else 'plain'}",
              lambda: mk.run_megakernel_record(**x, max_depth=8, radiance=radiance), 5)
    # The deep chunk's records (GRAD_BUCKET_SPEC's head 6, RECORD_DEEP_DIV 12).
    head = 6
    timed("k2_deep_head_d6", lambda: mk.run_megakernel_record(
        **x, max_depth=head, radiance=True), 5)
    rec_h = mk.run_megakernel_record(**x, max_depth=head)[1]
    cont = (rec_h[head - 1] & mk.F_SCAT) > 0
    r = cont.shape[0]
    idx, valid = replay._compact(cont, replay._capacity(r, 12))
    smem_n = x["smem"].clone()
    smem_n[4] = head
    narrow = dict(x, smem=smem_n,
                  pix=torch.where(valid, x["pix"][0, idx], 0).to(torch.int32)[None].contiguous(),
                  sample0=torch.where(valid, x["sample0"][0, idx], mk.NO_SAMPLE)
                  .to(torch.int32)[None].contiguous())
    print(f"  deep chunk: {int(cont.sum())} of {r} paths continue past row {head}, "
          f"{idx.shape[0]} slots")
    timed("k2_deep_narrow_d50", lambda: mk.run_megakernel_record(
        **narrow, max_depth=50, radiance=True), 5)
    del x, narrow, rec_h

    flag_sets = {"animated": dict(animated=True, cam_animated=False),
                 "camera": dict(animated=False, cam_animated=True),
                 "both": dict(animated=True, cam_animated=True)}
    both = flag_sets["both"]
    x = inputs(chip_smoke.bouncing_book1(demo, 320), 8)
    for tag, flags in flag_sets.items():
        timed(f"k8_bouncing_320w_8spp_{tag}", lambda: mk.run_megakernel(**x, **flags), 5)
    x = inputs(chip_smoke.bouncing_book1(demo, 1920), 32)
    timed("k8_bouncing_1080p_32spp_both", lambda: mk.run_megakernel(**x, **both), 3)
    x = record_inputs(1920, 4, chip_smoke.bouncing_book1(demo, 1920))
    timed("k8_record_bouncing_1080p_4spp_d8_both", lambda: mk.run_megakernel_record(
        **x, max_depth=8, radiance=True, **both), 3)

    for name, copies, width, spp, reps in (("k6_n7744_320w_8spp", 16, 320, 8, 3),
                                           ("k6_n1936_320w_8spp", 4, 320, 8, 3),
                                           ("k6_n7744_1080p_32spp", 16, 1920, 32, 2)):
        sc = chip_smoke.bouncing_stress(demo, width, copies)
        x = cull(inputs(sc, spp), sc.build(device=dev))
        timed(name, lambda: mk.run_megakernel(**x, **both), reps)
    sc = chip_smoke.bouncing_stress(demo, 1920, 16)
    x = cull(record_inputs(1920, 4, sc), sc.build(device=dev))
    timed("k6_record_n7744_1080p_4spp_d8", lambda: mk.run_megakernel_record(
        **x, max_depth=8, radiance=True, **both), 3)
    print(json.dumps({"label": args.label, "card": card, "ms": ms, "against": against}))
    if bad:
        raise SystemExit(f"outputs differ from {args.against}: {bad}")


if __name__ == "__main__":
    main()
