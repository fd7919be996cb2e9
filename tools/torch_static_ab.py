#!/usr/bin/env python3
"""Time the megakernel's static instantiations (K1, K5) of one checkout of
crucible_tpu_torch on the card, for an A/B comparison of two trees.

    python3 tools/torch_static_ab.py [--repo PATH] [--label NAME]

``--repo`` is the root of the checkout whose package is imported (default:
this one); its kernels are built there. Run two trees in turns in one
process list on one card (parent, change, change, parent) and compare
within the call. Times are CUDA-event means over repeated launches of
``megakernel.run_megakernel`` at the shapes ``chip_smoke.py`` times:

- K1: book1 320 wide 8 spp depth 50, and 1920x1080 32 spp depth 50;
- K5: sphere_stress 7744 and 1936 rows, 320 wide 8 spp depth 50, and
  7744 rows at 1920x1080 32 spp depth 50.

Prints the card's name and power limit, then one JSON line
``{"label": ..., "ms": {shape: ms}}``. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = Path(args.repo).resolve()
    if not (root / "crucible_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"no crucible_tpu_torch package under {root}")
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    from crucible_tpu_torch.models import demo, integrator
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

    def inputs(sc, spp, walk):
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        x, _ = integrator.mega_inputs(sd, cp, w, h, spp, 50, 0)
        if walk:
            x = dict(x, table=integrator.permute_table(x["table"], sd.sph_perm),
                     sph_nodes=sd.sph_nodes, sph_meta=sd.sph_meta)
        return x

    shapes = {
        "k1_book1_320w_8spp": (demo.book1_end_scene(width=320), 8, False, 5),
        "k1_book1_1080p_32spp": (demo.book1_end_scene(width=1920), 32, False, 3),
        "k5_n7744_320w_8spp": (demo.sphere_stress(width=320, copies=16), 8, True, 3),
        "k5_n1936_320w_8spp": (demo.sphere_stress(width=320, copies=4), 8, True, 3),
        "k5_n7744_1080p_32spp": (demo.sphere_stress(width=1920, copies=16), 32, True, 2),
    }
    ms = {}
    for name, (sc, spp, walk, reps) in shapes.items():
        x = inputs(sc, spp, walk)
        ms[name] = cuda_ms(lambda: mk.run_megakernel(**x, animated=False), reps)
        print(f"  {name}: {ms[name]:.3f} ms", flush=True)
        del x
    print(json.dumps({"label": args.label, "card": card, "ms": ms}))


if __name__ == "__main__":
    main()
