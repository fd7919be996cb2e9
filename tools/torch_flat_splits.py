#!/usr/bin/env python3
"""Splits of K6's design on one card: what the swept tree and the flat
loop each buy, from K6's times (both flags) on bouncing stress n7744 at
320w 8 spp d50, 1920x1080 32 spp d50 and, in record mode, 1920x1080 4 spp
d8, with a digest of each output.

    python3 tools/torch_flat_splits.py --repo . --mode flat
    python3 tools/torch_flat_splits.py --repo out/parent --mode nested

``--mode flat`` (a checkout with the swept tree): the flat loop over the
swept tree, then over the JAX package's 256-row clusters laid out as a
one-level tree (the flat loop over the old clusters); it saves each tree
to out/split. ``--mode nested`` (a checkout from before the swept tree,
whose K6 is the nested loop over the clusters, ``cull_inputs``): that K6
over its clusters, then over the swept tree the ``flat`` run saved, fed
through its cluster input (the tree in the old nested loop). Run ``flat``
first, in the same call. Digests go to out/split/<mode>_<shape>.json.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--mode", required=True, choices=("flat", "nested"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    import chip_smoke
    from crucible_tpu_torch.models import demo, integrator
    from crucible_tpu_torch.ops.kernels import megakernel as mk

    dev = torch.device("cuda:0")
    both = dict(animated=True, cam_animated=True)

    def cuda_ms(fn, reps):
        fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def digest(out, n=16):
        outs = out if isinstance(out, tuple) else (out,)
        return [hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()[:n]
                for t in outs]

    def forward_inputs(sc, spp):
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        x, _ = integrator.mega_inputs(sd, cp, sc.scene_cam.image_width,
                                      sc.scene_cam.image_height, spp, 50, 0)
        return sd, x

    def record_inputs(sc, spp):
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        p = w * h
        return sd, dict(
            smem=torch.tensor([0, 0, w, 8, 0, 0, 0, 0], dtype=torch.int32, device=dev),
            pix=torch.arange(p, device=dev, dtype=torch.int32).repeat(spp)[None],
            sample0=torch.arange(spp, device=dev, dtype=torch.int32).repeat_interleave(p)[None],
            cam=integrator.mega_cam_vector(cp, w, h),
            table=integrator.make_sphere_table(sd).contiguous())

    split = Path("out/split")
    split.mkdir(parents=True, exist_ok=True)

    def clusters_as_tree(sd):
        """The clusters of sd (sph_perm, sph_cbounds) as the leaves of a
        swept tree: a median tree, one cluster a leaf, over the boxes of the
        clusters that hold an active row."""
        from crucible_tpu_torch.ops import bvh

        k = sd.sph_cbounds.shape[0]
        table = integrator.permute_table(integrator.make_sphere_table(sd), sd.sph_perm)
        act = (table[:, 5] > 0).reshape(k, mk.CLUSTER).int()
        count = (act * torch.arange(1, mk.CLUSTER + 1, device=dev, dtype=torch.int32)).amax(1)
        count = count.cpu().numpy()
        live = np.nonzero(count)[0]
        box = sd.sph_cbounds[:, 0:6].cpu().numpy()[live]
        fb = bvh.build_bvh(box[:, 0:3], box[:, 3:6], leaf_size=1, method="median")
        cluster = live[fb.perm[fb.node_first]]  # a leaf's cluster
        leaf = fb.node_count > 0
        nodes = np.zeros((fb.num_nodes, 16), np.float32)
        nodes[:, 0:3], nodes[:, 3:6] = fb.node_min, fb.node_max
        meta = np.stack([np.where(leaf, cluster * mk.CLUSTER, 0),
                         np.where(leaf, count[cluster], 0), fb.node_miss], 1)
        guard = np.tile([0, 0, fb.num_nodes], mk.NODE_WIN)
        meta = np.concatenate([meta.reshape(-1), guard]).astype(np.int32)
        return sd.sph_perm, torch.from_numpy(nodes).to(dev), torch.from_numpy(meta).to(dev)

    results = {}

    def run(name, fn, reps):
        ms = cuda_ms(fn, reps)
        results[name] = dict(ms=ms, digest=digest(fn()))
        (split / f"{args.mode}_{name}.json").write_text(json.dumps(results[name]))
        print(f"{args.mode} {name}: {ms:.3f} ms {results[name]['digest']}", flush=True)

    for shape, make, width, spp, reps in (("fwd_320w_8spp", forward_inputs, 320, 8, 3),
                                          ("fwd_1080p_32spp", forward_inputs, 1920, 32, 1),
                                          ("rec_1080p_4spp_d8", record_inputs, 1920, 4, 3)):
        sd, x = make(chip_smoke.bouncing_stress(demo, width, 16), spp)
        record = shape.startswith("rec")

        def call(y):
            if record:
                return lambda: mk.run_megakernel_record(**y, max_depth=8, radiance=True, **both)
            return lambda: mk.run_megakernel(**y, **both)

        if args.mode == "flat":
            tree = (sd.sph_swept_perm, sd.sph_swept_nodes, sd.sph_swept_meta)
            torch.save([t.cpu() for t in tree], split / f"tree_{width}.pt")
            y = dict(x, table=integrator.permute_table(x["table"], tree[0]),
                     swept_nodes=tree[1], swept_meta=tree[2])
            run(f"swept_{shape}", call(y), reps)
            perm, nodes, meta = clusters_as_tree(sd)
            y = dict(x, table=integrator.permute_table(x["table"], perm),
                     swept_nodes=nodes, swept_meta=meta)
            run(f"clusters_{shape}", call(y), reps)
        else:  # a tree before the swept tree: its nested K6, clusters then the tree
            y = dict(x, table=integrator.permute_table(x["table"], sd.sph_perm),
                     cbounds=sd.sph_cbounds)
            run(f"clusters_{shape}", call(y), reps)
            perm, snodes, smeta = (t.to(dev) for t in torch.load(split / f"tree_{width}.pt"))
            grown = mk.walk_inputs(snodes, smeta)
            real = mk.cull_inputs
            mk.cull_inputs = lambda cbounds, table: grown
            try:
                y = dict(x, table=integrator.permute_table(x["table"], perm),
                         cbounds=torch.zeros((grown[0].shape[0], 8), device=dev))
                run(f"swept_{shape}", call(y), reps)
            finally:
                mk.cull_inputs = real
        del x, y
        torch.cuda.empty_cache()
    print(json.dumps({args.mode: results}))


if __name__ == "__main__":
    main()
