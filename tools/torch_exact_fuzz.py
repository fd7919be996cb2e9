#!/usr/bin/env python3
"""Find the lanes that carry the gap between the card's and the CPU's fuzz
gradient on bouncing book1 keyed inside the shutter (exact-time motion).

    python3 tools/torch_exact_fuzz.py [--width 64] [--top 12] [--device cuda:0]

The check of ``chip_smoke.py``'s main path 26c (``card_vs_cpu``): the
scene at ``--width`` (64: 64x36), 2 spp, depth 8, its records taken on the
card (``grad.record_decisions``) and its primary rays generated there, then
replayed on the card and on the CPU from those same inputs; the loss is
the L2 of each pixel's mean against zero. Three findings, printed as one
JSON line (with ``--out DIR`` also written to ``DIR/exact_fuzz.json``):

1. ``tracks``: the exact-time evaluation on both devices from the same
   inputs, as bits that differ: each path's time (``integrator.exact_time``
   of its shutter fraction), every sphere's center at each lane's time
   (``integrator._exact_centers``, the exact branch's search), and each
   recorded winner's center and radius at its path's time
   (``integrator.exact_sphere_winner``, the record's and the replay's).
2. ``gradient``: d loss / d fuzz on each device by reverse mode, and the
   material whose entry parts the most (normalized by the CPU's largest).
3. ``lanes``: each lane's share of that entry, by forward mode (fuzz a
   dual tensor with the material's unit tangent, under no_grad: each lane's
   radiance tangent, weighted by d loss / d radiance), on both devices; the
   lanes whose shares part the most, the part of the gap they carry, and
   for each its pixel, sample, time, record words (winner row and flag
   byte a bounce) and, a bounce, the winner's discriminant (the replay's
   ``_winner_quadratic``) and the ray direction on both devices.

``--device cpu`` replays both sides on the CPU (a rehearsal: every gap is
zero). Needs a CUDA card otherwise.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
EXACT_KEY = 1.0 / 96.0
SPP, DEPTH, SEED = 2, 8, 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    import torch.autograd.forward_ad as fwAD

    from crucible_tpu_torch import grad
    from crucible_tpu_torch.models import demo, integrator, replay
    from crucible_tpu_torch.models.camera import generate_rays
    from tests.torch_motion_scenes import bouncing_book1

    dev = torch.device(args.device)
    cpu = torch.device("cpu")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch.cuda.is_available() is False")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    else:
        card = "cpu (rehearsal)"
    print(card, flush=True)

    sc = bouncing_book1(demo, args.width, EXACT_KEY)
    sw, sh = sc.scene_cam.image_width, sc.scene_cam.image_height
    p = sw * sh
    sds = {where: sc.build(device=where) for where in (dev, cpu)}
    cp = sc.scene_cam.params(device=dev)
    if not sds[cpu].motion_exact:
        raise SystemExit("bouncing book1 keyed at 1/96 s should be an exact-time scene")
    pixels = torch.arange(p, device=dev)
    rec = grad.record_decisions(sds[dev], cp, pixels, SEED, width=sw, height=sh, spp=SPP,
                                max_depth=DEPTH)
    pl = torch.arange(p, device=dev).repeat(SPP)
    sl = torch.arange(SPP, device=dev).repeat_interleave(p)
    o, d, _ = generate_rays(cp, sw, sh, pl, sl, SEED)
    inputs = {where: tuple(x.to(where) for x in (o, d, pl, sl, rec)) for where in (dev, cpu)}

    def differ(a, b):
        """Entries of a (on dev) and b (CPU) whose bits differ."""
        a = a.detach().cpu().contiguous()
        b = b.detach().contiguous()
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    # --- 1. the exact-time evaluation, bit for bit ---------------------------------
    per = {}
    for where in (dev, cpu):
        sd = sds[where]
        _, _, lp, ls, lrec = inputs[where]
        w = integrator.shutter_fraction(lp, ls, SEED)
        t_ray = integrator.exact_time(sd, w)
        centers = integrator._exact_centers(sd, t_ray)
        win = []
        for b in range(lrec.shape[0]):
            idx = torch.div(lrec[b], 256, rounding_mode="floor").long()
            win.append(integrator.exact_sphere_winner(sd, idx, t_ray))
        per[where] = (w, t_ray, centers, win)
    (w_c, t_c, cen_c, win_c), (w_h, t_h, cen_h, win_h) = per[dev], per[cpu]
    tracks = dict(
        lanes=int(t_h.shape[0]), rows=int(sds[cpu].sph_center.shape[0]),
        w_differ=differ(w_c, w_h), time_differ=differ(t_c, t_h),
        centers_differ=sum(differ(a, b) for a, b in zip(cen_c, cen_h)),
        centers_entries=sum(int(x.numel()) for x in cen_h),
        winner_center_differ=sum(differ(a[0], b[0]) for a, b in zip(win_c, win_h)),
        winner_radius_differ=sum(differ(a[1], b[1]) for a, b in zip(win_c, win_h)),
    )
    print("tracks: " + json.dumps(tracks), flush=True)

    # --- 2. the fuzz gradient by reverse mode ----------------------------------------
    def loss_of(rad):
        return torch.mean(rad.reshape(SPP, -1, 3).mean(dim=0) ** 2)

    grads, rads = {}, {}
    for where in (dev, cpu):
        fuzz = sds[where].mat_fuzz.detach().clone().requires_grad_(True)
        ssd = replace(sds[where], mat_fuzz=fuzz)
        lo, ld, lp, ls, lrec = inputs[where]
        rad = replay.trace_replay(ssd, lo, ld, lp, ls, SEED, DEPTH, lrec)
        (grads[where],) = torch.autograd.grad(loss_of(rad), [fuzz])
        rads[where] = rad.detach()
    g_c, g_h = grads[dev].cpu(), grads[cpu]
    scale = max(float(g_h.abs().max()), 1e-30)
    gap = (g_c - g_h).abs()
    # The entry that parts the most; where none does (a rehearsal), the
    # largest, so that the forward-mode shares still check against it.
    m = int(gap.argmax()) if float(gap.max()) > 0 else int(g_h.abs().argmax())
    gradient = dict(materials=int(g_h.shape[0]), scale=scale,
                    normalized=float(gap.max()) / scale, material=m,
                    card=float(g_c[m]), cpu=float(g_h[m]),
                    radiance_max_diff=float((rads[dev].cpu() - rads[cpu]).abs().max()))
    print("gradient: " + json.dumps(gradient), flush=True)

    # --- 3. each lane's share by forward mode ----------------------------------------
    shares = {}
    for where in (dev, cpu):
        lo, ld, lp, ls, lrec = inputs[where]
        x = rads[where].reshape(SPP, -1, 3).mean(dim=0)
        weight = (2.0 * x / x.numel() / SPP).repeat(SPP, 1)  # d loss / d radiance
        tangent = torch.zeros_like(sds[where].mat_fuzz)
        tangent[m] = 1.0
        with torch.no_grad(), fwAD.dual_level():
            ssd = replace(sds[where], mat_fuzz=fwAD.make_dual(sds[where].mat_fuzz, tangent))
            rad = replay.trace_replay(ssd, lo, ld, lp, ls, SEED, DEPTH, lrec)
            rad_t = fwAD.unpack_dual(rad).tangent
        rad_t = torch.zeros_like(weight) if rad_t is None else rad_t
        shares[where] = (weight * rad_t).sum(dim=1).cpu()
    s_c, s_h = shares[dev], shares[cpu]
    lane_gap = s_c - s_h
    order = torch.argsort(lane_gap.abs(), descending=True)
    total_gap = float(lane_gap.sum())
    top = order[: args.top]
    lanes = dict(forward_sum_card=float(s_c.sum()), forward_sum_cpu=float(s_h.sum()),
                 gap=total_gap, top_share=float(lane_gap[top].sum()) / total_gap
                 if total_gap else 0.0,
                 lanes_over_1pct=int((lane_gap.abs() > 0.01 * abs(total_gap)).sum()), top=[])
    # Each top lane bounce by bounce: the carry before the row (trace_replay
    # of the first b rows with return_carry), the winner's discriminant.
    sub = top.to(dev)
    carries = {where: [] for where in (dev, cpu)}
    for where in (dev, cpu):
        lo, ld, lp, ls = (t[sub.to(where)] for t in inputs[where][:4])
        lrec = inputs[where][4][:, sub.to(where)].contiguous()
        sd = sds[where]
        t_ray = integrator.exact_time(sd, integrator.shutter_fraction(lp, ls, SEED))
        with torch.no_grad():
            for b in range(DEPTH):
                if b == 0:
                    oc, dc = lo, ld
                else:
                    _, (oc, dc, _) = replay.trace_replay(sd, lo, ld, lp, ls, SEED, b, lrec,
                                                         return_carry=True)
                idx = torch.div(lrec[b], 256, rounding_mode="floor").long()
                disc = replay._winner_quadratic(oc, dc, *integrator.exact_sphere_winner(
                    sd, idx, t_ray))[4]
                carries[where].append((disc.cpu(), dc.cpu()))
    rec_h = inputs[cpu][4]
    t_lane = per[cpu][1]
    for j, lane in enumerate(top.tolist()):
        words = rec_h[:, lane].tolist()
        lanes["top"].append(dict(
            lane=lane, pixel=int(inputs[cpu][2][lane]), sample=int(inputs[cpu][3][lane]),
            time=float(t_lane[lane]), card=float(s_c[lane]), cpu=float(s_h[lane]),
            winners=[wd // 256 for wd in words], flags=[wd % 256 for wd in words],
            disc_card=[float(carries[dev][b][0][j]) for b in range(DEPTH)],
            disc_cpu=[float(carries[cpu][b][0][j]) for b in range(DEPTH)],
            dir_max_diff=[float((carries[dev][b][1][j] - carries[cpu][b][1][j]).abs().max())
                          for b in range(DEPTH)],
        ))
    print("lanes: " + json.dumps(lanes), flush=True)
    result = dict(card=card, width=sw, height=sh, spp=SPP, depth=DEPTH, tracks=tracks,
                  gradient=gradient, lanes=lanes)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "exact_fuzz.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
