#!/usr/bin/env python3
"""Time K10, the closest sphere hit, of one checkout of crucible_tpu_torch
on the card, for an A/B comparison of two trees on the same inputs.

    python3 tools/torch_hit_ab.py [--repo PATH] [--label NAME]
                                  [--save DIR] [--against DIR]
                                  [--sass DIR] [--ad-step]

``--repo`` is the root of the checkout whose package is imported (default:
this one); its kernels are built there. Run two trees in turns in one
process list on one card (parent, change, change, parent) and compare
within the call. The shapes:

- ``main``: book1's 1920x1080 4 spp primary rays (8,294,400) against its
  488-row table (the direct-AD step's first bounce);
- ``second``: the same rays after one bounce (the step's second bounce;
  they start on sphere surfaces);
- ``rand_2e20``: 2^20 random rays over book1's field against its table;
- ``320w``: book1's 320x180 4 spp primary rays;
- ``n7744_2e20``: 2^20 random rays against sphere_stress's 7,744-row table,
  which runs past the rows a block stages at a time.

Times are CUDA-event means over repeated launches, after one warm launch.
Beside each: the bound (the larger of the bytes moved once at 3.35 TB/s
and the FP32 operations at 67 TFLOP/s: 17 a (ray, active row) pair up to
the discriminant, 5 more where it is not negative) and the no-FMA floor
(the same operations as single instructions, 128 an SM a clock at the
card's largest SM clock), and the launch shape of a tree whose wrapper
reports one (``launch_shape``). ``--save DIR`` writes
SHA-256 digests of every timed output (t, idx, hit) to ``DIR/<shape>.json``;
``--against DIR`` compares with a saved run's. ``--sass DIR`` writes the
tree's ``cuobjdump -sass`` of the K10 library to ``DIR/sphere_hit.sass``
and prints each kernel's instruction and FFMA counts. ``--ad-step`` also
times the direct-AD gradient step that launches K10 (book1, 1920x1080, 4
spp, depth 8, ``loss_and_grad(method="ad")``): a warm step, then the
median of 3 synchronized steps on the host clock, with K10's launches.

Prints the card's name and power limit, then one JSON line
``{"label": ..., "card": ..., "ms": {shape: {...}}, "against": {...}}``.
Needs a CUDA card; exits non-zero without one, or when ``--against`` finds
a digest that differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
HIT_DISC_OPS, ROOT_OPS = 17, 5
FP32_LANES_PER_SM = 128


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def hot_loop(code: list) -> dict:
    """The instructions one trip of a kernel's search loop issues when no
    discriminant passes its test: the loop is the innermost one (a
    backward branch with none inside) whose body holds the most FMULs; a
    forward branch around a square root
    (MUFU.RSQ) is taken as skipping it. ``code``: [(address, text)].
    -> {"instructions": n, "fp32": n, "ops": {opcode: n}}."""
    at = {a: i for i, (a, _) in enumerate(code)}
    edges = []
    for i, (a, text) in enumerate(code):
        m = re.search(r"BRA (0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < a:
            edges.append((at[int(m.group(1), 16)], i))
    loops = [(sum("FMUL" in t for _, t in code[s:e]), s, e) for s, e in edges
             if not any(s <= s2 and e2 < e for s2, e2 in edges if (s2, e2) != (s, e))]
    if not loops:
        return {}
    _, i, end = max(loops)
    ops = {}
    while i <= end:
        text = code[i][1]
        op = text.split()[1] if text.startswith("@") else text.split()[0]
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        m = re.match(r"@!?P\d BRA (0x[0-9a-f]+)", text)
        if m and i < end and int(m.group(1), 16) > code[i][0]:
            target = at[int(m.group(1), 16)]
            if any("MUFU.RSQ" in t for _, t in code[i:target]):
                i = target
                continue
        i += 1
    fp32 = sum(ops.get(k, 0) for k in ("FMUL", "FADD", "FFMA"))
    return {"instructions": sum(ops.values()), "fp32": fp32, "ops": ops}


def sass_counts(lib: Path, out_dir: Path) -> dict:
    """{kernel: {"instructions": n, "FFMA": n, "hot_loop": ...}} from
    cuobjdump -sass of ``lib``, whose listing goes to
    ``out_dir/sphere_hit.sass``; ``hot_loop`` from :func:`hot_loop`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "sphere_hit.sass").write_text(text)
    code, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            code[name] = []
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            code[name].append((int(m.group(1), 16), m.group(2)))
    return {k: {"instructions": len(v), "FFMA": sum("FFMA" in t for _, t in v),
                "hot_loop": hot_loop(v)} for k, v in code.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--sass", default=None)
    ap.add_argument("--ad-step", action="store_true")
    args = ap.parse_args()
    root = Path(args.repo).resolve()
    if not (root / "crucible_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"no crucible_tpu_torch package under {root}")
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    from crucible_tpu_torch import grad
    from crucible_tpu_torch.models import demo, integrator
    from crucible_tpu_torch.models.camera import generate_rays
    from crucible_tpu_torch.ops.kernels import build
    from crucible_tpu_torch.ops.kernels import sphere_hit as sh

    card = smi("name,power.limit")
    clock_ghz = float(smi("clocks.max.sm").split()[0]) / 1e3
    print(card, f"(max SM clock {clock_ghz:.3f} GHz)")
    build.load("sphere_hit")
    if args.sass:
        libs, _, _ = build.build()
        for kernel, c in sass_counts(libs["sphere_hit"], Path(args.sass)).items():
            print(f"  SASS {kernel}: {c['instructions']} instructions, {c['FFMA']} FFMA; "
                  f"a trip of the search loop with no root: {json.dumps(c['hot_loop'])}")
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

    def k10_args(sd, o, d):
        c, r = sd.sph_center, sd.sph_radius
        csr = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r
        return (o.contiguous(), d.contiguous(), c.contiguous(), csr.contiguous(),
                sd.sph_active.float().contiguous())

    def random_rays(n, seed):
        """n rays from above book1's ground toward random points on it."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = torch.rand((n, 6), device=dev, generator=gen)
        o = torch.stack([30 * u[:, 0] - 15, 0.5 + 4.5 * u[:, 1], 30 * u[:, 2] - 15], 1)
        target = torch.stack([22 * u[:, 3] - 11, 1.2 * u[:, 4], 22 * u[:, 5] - 11], 1)
        return o, target - o

    def primary(sc, spp):
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        pix = torch.arange(w * h, device=dev).repeat(spp)
        smp = torch.arange(spp, device=dev).repeat_interleave(w * h)
        o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
        return sd, pix, smp, o, d

    def shapes():
        """Yield (name, K10 inputs) one shape at a time."""
        sd, pix, smp, o, d = primary(demo.book1_end_scene(width=1920), 4)
        yield "main", k10_args(sd, o, d)
        r = o.shape[0]
        with torch.no_grad():
            o, d, *_ = integrator._trace_bounce(
                sd, pix, smp, 0, 0, o, d, torch.ones((r, 3), device=dev),
                torch.zeros((r, 3), device=dev), torch.ones((r,), dtype=torch.bool, device=dev))
        yield "second", k10_args(sd, o, d)
        del pix, smp, o, d
        yield "rand_2e20", k10_args(sd, *random_rays(1 << 20, 2))
        sd320, _, _, o, d = primary(demo.book1_end_scene(width=320), 4)
        yield "320w", k10_args(sd320, o, d)
        stress = demo.sphere_stress(width=320, copies=16).build(device=dev)
        yield "n7744_2e20", k10_args(stress, *random_rays(1 << 20, 5))

    def work(o, d, centers, csr, active):
        """(pairs, pairs whose discriminant is not negative) over the active
        rows, in the expanded quadratic; the dot products by a matrix
        product, so a pair at the edge may count otherwise than in K10."""
        rows = active > 0
        c, s = centers[rows], csr[rows]
        a = (d * d).sum(1, keepdim=True)
        dot_o = (d * o).sum(1, keepdim=True)
        o_sq = (o * o).sum(1, keepdim=True)
        n_ok, step = 0, max(1, (1 << 24) // max(c.shape[0], 1))
        for lo in range(0, o.shape[0], step):
            sl = slice(lo, lo + step)
            h = d[sl] @ c.t() - dot_o[sl]
            disc = h * h - a[sl] * (s - 2.0 * (o[sl] @ c.t()) + o_sq[sl])
            n_ok += int((disc >= 0).sum())
        return o.shape[0] * c.shape[0], n_ok

    def digest(t):
        return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms, against, bad = {}, {}, []
    for name, x in shapes():
        pairs, n_ok = work(*x)
        ops = pairs * HIT_DISC_OPS + n_ok * ROOT_OPS
        moved = sum(t.numel() * t.element_size() for t in x) + 9 * x[0].shape[0]
        row = dict(rays=x[0].shape[0], rows=x[2].shape[0], active=int((x[4] > 0).sum()),
                   disc_nonneg_share=n_ok / pairs,
                   bound_ms=1e3 * max(ops / PEAK_FP32, moved / PEAK_BYTES),
                   floor_ms=1e3 * ops / (sms * FP32_LANES_PER_SM * clock_ghz * 1e9))
        if hasattr(sh, "launch_shape"):
            row["shape"] = sh.launch_shape(x[2].shape[0], x[0].shape[0])
        t, idx, hit = sh.hit_spheres(*x)
        row["ms"] = cuda_ms(lambda: sh.hit_spheres(*x), 10 if x[0].shape[0] > 2_000_000 else 30)
        ms[name] = row
        print(f"  {name}: {json.dumps(row)}", flush=True)
        out = dict(t=digest(t), idx=digest(idx), hit=digest(hit))
        if args.save:
            Path(args.save).mkdir(parents=True, exist_ok=True)
            (Path(args.save) / f"{name}.json").write_text(json.dumps(out))
        if args.against:
            ref = json.loads((Path(args.against) / f"{name}.json").read_text())
            against[name] = {k: out[k] == ref[k] for k in out}
            print(f"  {name} against {args.against}: {json.dumps(against[name])}", flush=True)
            if not all(against[name].values()):
                bad.append(name)
        del x, t, idx, hit
        torch.cuda.empty_cache()
    if args.ad_step:
        sc = demo.book1_end_scene(width=1920)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        params = grad.extract_params(sd, cp)
        w, h = 1920, 1080
        target, pix = torch.zeros((w * h, 3), device=dev), torch.arange(w * h, device=dev)

        def step():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = grad.loss_and_grad(params, sd, cp, target, pix, 0, width=w, height=h,
                                         spp=4, max_depth=8, method="ad")
            torch.cuda.synchronize()
            return loss.item(), 1e3 * (time.perf_counter() - t0)

        step()
        sh.LAUNCHES = 0
        runs = [step() for _ in range(3)]
        ms["ad_step"] = dict(step_ms=sorted(r[1] for r in runs)[1],
                             steps_ms=[r[1] for r in runs], loss=runs[0][0],
                             k10_launches_per_step=sh.LAUNCHES / 3)
        print(f"  ad_step: {json.dumps(ms['ad_step'])}", flush=True)
    print(json.dumps({"label": args.label, "card": card, "ms": ms, "against": against}))
    if bad:
        raise SystemExit(f"outputs differ: {bad}")


if __name__ == "__main__":
    main()
