#!/usr/bin/env python3
"""Time the replay pair (K4, K3) of one checkout of crucible_tpu_torch on the
card, for an A/B comparison of two trees on the same inputs.

    python3 tools/torch_replay_ab.py [--repo PATH] [--label NAME]
                                     [--save DIR] [--against DIR]

``--repo`` is the root of the checkout whose package is imported (default:
this one); its kernels are built there. Run two trees in turns in one
process list on one card (parent, change, change, parent) and compare
within the call. The shapes, each on book1 with K2's records:

- ``320w_d8``: 320 wide, 4 spp, depth 8 (chip_smoke.py's comparison shape);
- ``1080p_d8``: 1920x1080, 4 spp, depth 8 (the gradient step);
- ``n1936_320w_d8``: sphere_stress with 1,936 rows, 320 wide, 4 spp, depth 8
  (K3's partial in global memory);
- the depth-50 chunk's three buckets at 1920x1080, 4 spp, from
  :func:`deep_buckets`: ``deep_d6`` every lane's head rows, ``deep_d16``
  and ``deep_d50`` the compacted slots of the lanes whose paths end in
  (6, 16] and (16, 50], their throughput masked by the filled slots and
  radiance from row 6 on.

Times are CUDA-event means over repeated launches. ``--save DIR`` writes,
for every shape, SHA-256 digests of K4's radiance and of K3's ray
cotangents and K3's table cotangent itself (``DIR/<shape>.pt``);
``--against DIR`` compares this run's with a saved run's: the digests must
agree (bit for bit) and the table cotangents are reported as their largest
difference normalized by the saved one's largest entry. The radiance
cotangent is a fixed normal sample (seed 0).

Prints the card's name and power limit, then one JSON line
``{"label": ..., "card": ..., "ms": {shape: {"k4": ms, "k3": ms}},
"against": {shape: {...}}}``. Needs a CUDA card; exits non-zero without
one, or when ``--against`` finds a digest that differs or a normalized
table-cotangent difference above 2e-4.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def deep_buckets(sd, cp, width, height, pix, smp, seed=0, max_depth=50):
    """The replay kernels' inputs at each bucket of a depth-``max_depth``
    chunk, laid out as ``replay.replay_bucketed_2l`` lays them out on the
    two-level record (``GRAD_BUCKET_SPEC``): bucket 0 every lane's head
    rows; bucket j the compacted slots of the lanes whose paths end in
    (lims[j-1], lims[j]], their primary rays regenerated, their throughput
    masked by the filled slots (``valid``) and radiance from the head's
    last row on. ``pix`` / ``smp``: the chunk's lanes (R,).

    Returns [(name, (table, o, d, valid, pix, smp, rec), accum_from)], name
    ``d<last row>``. Imports the ``crucible_tpu_torch`` already on the path,
    so an A/B run builds both trees' buckets alike.
    """
    import torch

    from crucible_tpu_torch.models import integrator, replay
    from crucible_tpu_torch.models.camera import generate_rays

    pix, smp = pix.to(torch.int32).contiguous(), smp.to(torch.int32).contiguous()
    lims, divs = replay._bucket_spec(max_depth)
    head = lims[0]
    rec_h, rec_n, idx_n, valid_n, _ = replay.record_two_level(
        sd, cp, width, height, pix, smp, seed, max_depth, head=head)
    table = integrator.make_sphere_table(sd).contiguous()
    o, d, _ = generate_rays(cp, width, height, pix, smp, seed)
    buckets = [(f"d{head}", (table, o.contiguous(), d.contiguous(), torch.ones_like(pix),
                             pix, smp, rec_h), 0)]
    depth_n = ((rec_n & replay.F_ALIVE) > 0).sum(0)
    for j in range(1, len(lims)):
        in_b = valid_n & (depth_n > lims[j - 1]) & (depth_n <= lims[j])
        slots, valid = replay._compact(
            in_b, replay._capacity(pix.shape[0], divs[j], rec_n.shape[1]))
        lanes = idx_n[slots]
        pix_b, smp_b = pix[lanes].contiguous(), smp[lanes].contiguous()
        o_b, d_b, _ = generate_rays(cp, width, height, pix_b, smp_b, seed)
        rec_b = rec_n[:lims[j]].index_select(1, slots).contiguous()
        buckets.append((f"d{lims[j]}", (table, o_b.contiguous(), d_b.contiguous(),
                                        valid.to(torch.int32), pix_b, smp_b, rec_b), head))
    return buckets


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
    from crucible_tpu_torch import grad
    from crucible_tpu_torch.models import demo, integrator, replay
    from crucible_tpu_torch.models.camera import generate_rays
    from crucible_tpu_torch.ops.kernels import build
    from crucible_tpu_torch.ops.kernels import replay_kernel as rk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    build.load("replay_kernel")
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

    def book1(make, width, spp, depth):
        """K4's inputs for every pixel of ``make(width=width)`` at ``spp``
        samples, lanes sample-major, with K2's records."""
        sc = make(width=width)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        p = w * h
        pix = torch.arange(p, device=dev, dtype=torch.int32).repeat(spp)
        smp = torch.arange(spp, device=dev, dtype=torch.int32).repeat_interleave(p)
        o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
        rec = replay.trace_record_mega(sd, cp, w, h, pix, smp, 0, depth)
        table = integrator.make_sphere_table(sd).contiguous()
        return table, o.contiguous(), d.contiguous(), torch.ones_like(pix), pix, smp, rec

    def shapes():
        """Yield (name, K4 / K3 inputs, accum_from) one shape at a time."""
        for name, make, width in (
            ("320w_d8", demo.book1_end_scene, 320),
            ("1080p_d8", demo.book1_end_scene, 1920),
            ("n1936_320w_d8", lambda width: demo.sphere_stress(width=width, copies=4), 320),
        ):
            yield name, book1(make, width, 4, 8), 0
        sc = demo.book1_end_scene(width=1920)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        pix, smp = grad._lanes(torch.arange(1920 * 1080, device=dev), 4, 0)
        for name, x, accum_from in deep_buckets(sd, cp, 1920, 1080, pix, smp):
            yield f"deep_{name}", x, accum_from

    def digest(t):
        return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()

    ms, against, bad = {}, {}, []
    for name, x, accum_from in shapes():
        rad = rk.replay_forward(*x, 0, accum_from=accum_from)
        g_rad = torch.randn(rad.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        g_table, g_o, g_d = rk.replay_backward(*x, 0, g_rad, accum_from=accum_from)
        reps = 5 if x[1].shape[0] > 100_000 else 20
        ms[name] = dict(
            lanes=x[1].shape[0], depth=x[6].shape[0], rows=x[0].shape[0],
            k4=cuda_ms(lambda: rk.replay_forward(*x, 0, accum_from=accum_from), reps),
            k3=cuda_ms(lambda: rk.replay_backward(*x, 0, g_rad, accum_from=accum_from), reps),
        )
        print(f"  {name}: {json.dumps(ms[name])}", flush=True)
        out = dict(rad=digest(rad), g_o=digest(g_o), g_d=digest(g_d), g_table=g_table.cpu())
        if args.save:
            Path(args.save).mkdir(parents=True, exist_ok=True)
            torch.save(out, Path(args.save) / f"{name}.pt")
        if args.against:
            ref = torch.load(Path(args.against) / f"{name}.pt")
            scale = max(ref["g_table"].abs().max().item(), 1e-6)
            nd = ((out["g_table"] - ref["g_table"]).abs().max() / scale).item()
            against[name] = dict(**{k: out[k] == ref[k] for k in ("rad", "g_o", "g_d")},
                                 g_table_max_normalized=nd,
                                 g_table_equal=torch.equal(out["g_table"], ref["g_table"]))
            print(f"  {name} against {args.against}: {json.dumps(against[name])}", flush=True)
            if not (all(against[name][k] for k in ("rad", "g_o", "g_d")) and nd <= 2e-4):
                bad.append(name)
        del x, rad, g_rad, g_table, g_o, g_d
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": card, "ms": ms, "against": against}))
    if bad:
        raise SystemExit(f"outputs differ from {args.against}: {bad}")


if __name__ == "__main__":
    main()
