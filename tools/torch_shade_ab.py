#!/usr/bin/env python3
"""Time K9, the fused closest sphere hit and fetch, of one checkout of
crucible_tpu_torch on the card, for an A/B comparison of two trees on the
same inputs.

    python3 tools/torch_shade_ab.py [--repo PATH] [--label NAME]
                                    [--save DIR] [--against DIR]
                                    [--shapes NAME,...] [--reps N]

``--repo`` is the root of the checkout whose package is imported (default:
this one); its kernels are built there. Run two trees in turns in one
process list on one card (parent, change, change, parent) and compare
within the call. The shapes:

- ``book1_1080p``: book1's 1920x1080 primary rays of one sample
  (2,073,600) against its 488-row static table at w = 0, the shape of each
  K9 launch of the ``pixel`` schedule at 1080p (main path 26b);
- ``garden_1080p``: garden's 1920x1080 primary rays against its 8-row
  table (one sphere): bound by the bytes;
- ``book1_moving_2e20``: 2^20 random rays over book1's field against its
  table with random center and radius deltas (and their s1, s2 columns),
  each ray a random shutter fraction;
- ``n7744_2e20``: 2^20 random rays against sphere_stress n7744's 7,744-row
  static table, past the rows a block stages at a time.

Times are CUDA-event means over repeated launches (10 above 2M rays, else
20, or ``--reps``), after one warm launch, queued behind a 0.1 s spin of
the card (``torch.cuda._sleep``) so that they run back to back whatever
the host's speed; ``--shapes`` runs only the named shapes. Beside each:
the bound (the larger of the bytes moved once at 3.35 TB/s
and the FP32 operations at 67 TFLOP/s: 17 a (ray, active row) pair up to
the discriminant for a static table, 35 for a moving one, 5 more where the
discriminant is not negative) and the no-FMA floor (the same operations as
single instructions, 128 an SM a clock at the card's largest SM clock),
and the launch shape of a tree whose wrapper reports one
(``launch_shape``). ``--save DIR`` writes SHA-256 digests of every timed
(28, R) output to ``DIR/<shape>.json``; ``--against DIR`` compares with a
saved run's.

Prints the card's name and power limit, then one JSON line
``{"label": ..., "card": ..., "ms": {shape: {...}}, "against": {...}}``.
Needs a CUDA card; exits non-zero without one, or when ``--against`` finds
a digest that differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
HIT_DISC_OPS, SHADE_DISC_OPS, ROOT_OPS = 17, 35, 5
FP32_LANES_PER_SM = 128


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--reps", type=int, default=None)
    args = ap.parse_args()
    wanted = None if args.shapes is None else set(args.shapes.split(","))
    root = Path(args.repo).resolve()
    if not (root / "crucible_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"no crucible_tpu_torch package under {root}")
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    from crucible_tpu_torch.models import demo, integrator
    from crucible_tpu_torch.models.camera import generate_rays
    from crucible_tpu_torch.ops.kernels import build
    from crucible_tpu_torch.ops.kernels import sphere_shade as ss

    card = smi("name,power.limit")
    clock_ghz = float(smi("clocks.max.sm").split()[0]) / 1e3
    print(card, f"(max SM clock {clock_ghz:.3f} GHz)")
    build.load("sphere_shade")
    dev = torch.device("cuda:0")

    def cuda_ms(fn, reps):
        fn()  # warm
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(clock_ghz * 1e8))  # the launches queue behind it
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def random_rays(n, seed):
        """n rays from above book1's ground toward random points on it."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = torch.rand((n, 6), device=dev, generator=gen)
        o = torch.stack([30 * u[:, 0] - 15, 0.5 + 4.5 * u[:, 1], 30 * u[:, 2] - 15], 1)
        target = torch.stack([22 * u[:, 3] - 11, 1.2 * u[:, 4], 22 * u[:, 5] - 11], 1)
        return o.contiguous(), (target - o).contiguous()

    def primary(sc):
        """(table, o, d, w = 0) of one sample's primary rays."""
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        pix = torch.arange(w * h, device=dev)
        o, d, _ = generate_rays(cp, w, h, pix, torch.zeros_like(pix), 0)
        return (o.contiguous(), d.contiguous(), torch.zeros((w * h,), device=dev),
                integrator.make_sphere_table(sd).contiguous())

    def shapes():
        """Yield (name, a function that makes its K9 inputs) a shape at a time."""
        yield "book1_1080p", lambda: primary(demo.book1_end_scene(width=1920))
        yield "garden_1080p", lambda: primary(demo.garden_skybox(width=1920))
        yield "book1_moving_2e20", moving_book1
        yield "n7744_2e20", n7744

    def moving_book1():
        sd = demo.book1_end_scene(width=320).build(device=dev)
        table = integrator.make_sphere_table(sd).contiguous()
        gen = torch.Generator(device=dev).manual_seed(4)
        cd = 0.6 * torch.rand((table.shape[0], 3), device=dev, generator=gen) - 0.3
        rd = 0.1 * torch.rand((table.shape[0],), device=dev, generator=gen) - 0.05
        table[:, 24:27], table[:, 27] = cd, rd
        table[:, 28] = (table[:, 0:3] * cd).sum(1) - table[:, 3] * rd
        table[:, 29] = (cd * cd).sum(1) - rd * rd
        o, d = random_rays(1 << 20, 3)
        return o, d, torch.rand((o.shape[0],), device=dev, generator=gen), table

    def n7744():
        stress = demo.sphere_stress(width=320, copies=16).build(device=dev)
        o, d = random_rays(1 << 20, 5)
        return (o, d, torch.zeros((o.shape[0],), device=dev),
                integrator.make_sphere_table(stress).contiguous())

    def work(o, d, w, table):
        """(pairs, pairs whose discriminant is not negative, moving) over the
        active rows, in the motion form of the quadratic; the dot products
        by a matrix product, so a pair at the edge may count otherwise than
        in K9."""
        rows = table[table[:, 5] > 0]
        c, s0, cd, s1, s2 = rows[:, 0:3], rows[:, 4], rows[:, 24:27], rows[:, 28], rows[:, 29]
        moving = bool((rows[:, 24:27] != 0).any() | (rows[:, 28:30] != 0).any())
        a = (d * d).sum(1, keepdim=True)
        dot_o = (d * o).sum(1, keepdim=True)
        o_sq = (o * o).sum(1, keepdim=True)
        n_ok, step = 0, max(1, (1 << 24) // max(c.shape[0], 1))
        for lo in range(0, o.shape[0], step):
            sl = slice(lo, lo + step)
            wv = w[sl, None]
            h = d[sl] @ c.t() + wv * (d[sl] @ cd.t()) - dot_o[sl]
            oc = o[sl] @ c.t() + wv * (o[sl] @ cd.t())
            c_q = s0 + 2.0 * wv * s1 + wv * wv * s2 - 2.0 * oc + o_sq[sl]
            n_ok += int((h * h - a[sl] * c_q >= 0).sum())
        return o.shape[0] * c.shape[0], n_ok, moving

    def digest(t):
        return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms, against, bad = {}, {}, []
    for name, make in shapes():
        if wanted is not None and name not in wanted:
            continue
        x = make()
        pairs, n_ok, moving = work(*x)
        ops = pairs * (SHADE_DISC_OPS if moving else HIT_DISC_OPS) + n_ok * ROOT_OPS
        r = x[0].shape[0]
        moved = sum(t.numel() * t.element_size() for t in x) + ss.C_OUT * 4 * r
        row = dict(rays=r, rows=x[3].shape[0], active=int((x[3][:, 5] > 0).sum()),
                   moving=moving, disc_nonneg_share=n_ok / max(pairs, 1),
                   bound_ms=1e3 * max(ops / PEAK_FP32, moved / PEAK_BYTES),
                   bound_by="operations" if ops / PEAK_FP32 >= moved / PEAK_BYTES else "bytes",
                   floor_ms=1e3 * ops / (sms * FP32_LANES_PER_SM * clock_ghz * 1e9))
        if hasattr(ss, "launch_shape"):
            row["shape"] = ss.launch_shape(x[3].shape[0], r)
        out = ss.hit_spheres_fetch(*x)
        reps = args.reps or (10 if r > 2_000_000 else 20)
        row["ms"] = cuda_ms(lambda: ss.hit_spheres_fetch(*x), reps)
        row["hit_share"] = (out[0] < ss.BIG).float().mean().item()
        ms[name] = row
        print(f"  {name}: {json.dumps(row)}", flush=True)
        dig = dict(out=digest(out))
        if args.save:
            Path(args.save).mkdir(parents=True, exist_ok=True)
            (Path(args.save) / f"{name}.json").write_text(json.dumps(dig))
        if args.against:
            ref = json.loads((Path(args.against) / f"{name}.json").read_text())
            against[name] = {k: dig[k] == ref[k] for k in dig}
            print(f"  {name} against {args.against}: {json.dumps(against[name])}", flush=True)
            if not all(against[name].values()):
                bad.append(name)
        del x, out
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": card, "ms": ms, "against": against}))
    if bad:
        raise SystemExit(f"outputs differ: {bad}")


if __name__ == "__main__":
    main()
