"""Command-line interface of the PyTorch port (port of ``crucible_tpu/cli.py``):

    crucible-tpu-torch --file out --world 1 [--movie --seconds S --rate R]
    python -m crucible_tpu_torch.cli --file out --world 1

with --spp / --depth / --width overrides, --seed and --cpu. The render runs
on the CUDA card unless --cpu names the CPU; without a card and without
--cpu torch's own error stands. ``--threads`` is accepted for the original
renderer's command line and ignored.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="crucible-tpu-torch",
        description="Differentiable Monte Carlo path tracer (PyTorch + CUDA)",
    )
    p.add_argument("--file", required=True, help="output file (extension auto-appended)")
    p.add_argument("--world", type=int, default=1, help="demo world number (invalid -> default with warning)")
    p.add_argument("--threads", type=int, default=None, help="accepted for reference parity; ignored")
    p.add_argument("--movie", action="store_true", help="render a movie world")
    p.add_argument("--seconds", type=float, default=None, help="movie duration (required with --movie)")
    p.add_argument("--rate", type=float, default=None, help="movie frame rate (required with --movie)")
    p.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    p.add_argument("--depth", type=int, default=None, help="override max bounce depth")
    p.add_argument("--width", type=int, default=None, help="override image width")
    p.add_argument("--seed", type=int, default=0, help="render seed")
    p.add_argument("--cpu", action="store_true", help="render on the CPU instead of the CUDA card")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from crucible_tpu_torch.models import demo

    if args.movie:
        if args.seconds is None or args.rate is None:
            print("--movie requires --seconds and --rate", file=sys.stderr)
            return 2
        worlds = demo.MOVIE_WORLDS
        if args.world not in worlds:
            print(f"world {args.world} is invalid, using the default movie", file=sys.stderr)
        fn = worlds.get(args.world, demo.first_movie)
        scene = fn(frame_rate=args.rate, duration=args.seconds)
        if args.width is not None:
            scene.scene_cam.image_width = args.width
    else:
        worlds = demo.WORLDS
        if args.world not in worlds:
            print(f"world {args.world} is invalid, using the default world", file=sys.stderr)
        fn = worlds.get(args.world, demo.book1_end_scene)
        kwargs = {}
        if args.width is not None:
            kwargs["width"] = args.width
        scene = fn(**kwargs)

    scene.seed = args.seed
    if args.spp is not None:
        scene.scene_cam.set_samples(args.spp)
    if args.depth is not None:
        scene.scene_cam.set_max_depth(args.depth)

    scene.render_scene(args.file, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
