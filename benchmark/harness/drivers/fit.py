"""The ``fit`` traffic: the program's frozen-decision fit of scene
parameters to an image, as ``train_demo`` runs it.

Set-up builds the scene at the mix's size (the configuration's scene
module, ``program_scene``), lowers it to the device (``Scene.build``,
timed for ``scene.build_s``), draws the target image from the seed (the
benchmark's, not a render of the program), starts the fitted leaf
(``leaf``, the texture colors) at ``init`` gray, builds Adam over every
leaf and runs the first ``checked_steps`` steps: these are the steps the
check follows from the start, and they warm every shape (a record step
and replay steps). The window goes on with the same parameters and
optimizer.

A step ``i``: at the start of each record epoch (``i`` a multiple of
``rerecord``) the decisions are recorded at the current parameters over
the epoch's sample window, samples ``(i // rerecord) * spp`` on
(``grad.record_decisions``); then ``grad.loss_and_grad(rec=...,
method="replay")`` over that window, the fitted leaf's gradient handed to
Adam, every other leaf's zeroed, and ``optimizer.step()``; the loss is
read on the host, which synchronizes.

End to end: ``grad_step_ms``, the window's seconds over the steps it
completed (the window closes at the end of the first step that ends past
``seconds`` and has completed a record step past the first epoch and the
last step of an epoch), and ``grad_step_ms_p95``, the 95th percentile of
every step's time between two CUDA events on the device's clock.

The check, with the reference the scene module names:

- the first three steps followed from the start: each step's loss
  (``loss_gap``), the first gradient as Adam holds it after one step
  (``grad_gap``, from its first moment) and the change of the fitted leaf
  over the three (``change_gap``), each a relative gap of norms;
- two steps of the window drawn from the seed, a record step past the
  first epoch and the last step of an epoch, each followed from the
  program's own state before it (the fitted leaf and Adam's moments, kept
  in the window at those candidate steps): the step's loss
  (``step_loss_gap``) and the leaf's change, Adam's update with the
  step's gradient (``step_change_gap``), the wider of the two. The norm
  of a late step's gradient is not compared: as the fit converges it
  falls toward nought, and a gap of norms reads the rounding of a
  cancelling sum (4-10% on sound runs), not the step.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from reference import adam as ref_adam

BETA1 = 0.9


def _rerecord(run) -> int:
    return run.over("rerecord", run.traffic["rerecord"])


def setup(run) -> None:
    from crucible_tpu_torch import grad as G

    tr = run.traffic
    if _rerecord(run) < 2:
        raise ValueError("the fit re-records every 2 steps or more")
    run.width, run.height = run.over("width", tr["width"]), run.over("height", tr["height"])
    run.spp = run.over("samples_per_pixel", tr["samples_per_pixel"])
    run.depth = run.over("max_depth", tr["max_depth"])
    sc = run.scenes.program_scene(run.cfg, run.desc, run.width)
    if sc.scene_cam.image_height != run.height:
        raise ValueError(f"the program's image is {sc.scene_cam.image_height} high, "
                         f"the mix's {run.height}")
    dev = run.device
    run.mark("program import, scene")
    sd = run.build(sc)
    run.mark("scene build")
    cp = sc.scene_cam.params(device=dev)
    n_pix = run.width * run.height
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    run.target = torch.rand((n_pix, 3), generator=gen, device=dev)
    run.rseed = int(np.random.default_rng([run.seed, 5]).integers(0, 2**31 - 1))
    params = G.extract_params(sd, cp)
    leaf = tr["leaf"]
    params[leaf] = torch.full_like(params[leaf], tr["init"])
    flat = {k: v.detach().clone().requires_grad_(True) for k, v in G.leaves(params).items()}
    opt = torch.optim.Adam(list(flat.values()), lr=tr["lr"])
    run.fit = dict(G=G, sd=sd, cp=cp, params=G.with_leaves(params, flat), flat=flat, opt=opt,
                   leaf=leaf, rec=None, epoch=-1,
                   pix=torch.arange(n_pix, device=dev), records=0)
    run.theta0 = flat[leaf].detach().clone()
    run.mark("target, optimizer")
    run.losses = []
    run.exp_avg0 = None
    run.snaps = {}
    for i in range(tr["checked_steps"]):
        run.losses.append(float(_step(run, i)))
        if i == 0:
            state = opt.state.get(flat[leaf], {})
            run.exp_avg0 = state["exp_avg"].clone() if "exp_avg" in state else None
    run.theta_k = flat[leaf].detach().clone()
    run.step_index = tr["checked_steps"]


def _candidate(run, i: int) -> str | None:
    """The kind of step ``i`` of the window the check may draw: a record
    step past the first epoch, or the last step of an epoch."""
    r = _rerecord(run)
    if i >= r and i % r == 0:
        return "record"
    if i % r == r - 1:
        return "last"
    return None


def _snapshot(run):
    """The fitted leaf and Adam's state for it, as they stand."""
    f = run.fit
    t = f["flat"][f["leaf"]]
    st = f["opt"].state.get(t, {})
    return dict(theta=t.detach().clone(),
                m=st["exp_avg"].clone() if "exp_avg" in st else None,
                v=st["exp_avg_sq"].clone() if "exp_avg_sq" in st else None,
                steps=int(st["step"]) if "step" in st else 0)


def _step(run, i: int, keep: bool = False) -> torch.Tensor:
    f, tr = run.fit, run.traffic
    G = f["G"]
    epoch = i // _rerecord(run)
    sample0 = 0 if run.fault == "window0" else epoch * run.spp
    pix, target = f["pix"], run.target
    if run.fault == "half":
        half = pix.shape[0] // 2
        pix, target = pix[:half], target[:half]
    kw = dict(width=run.width, height=run.height, spp=run.spp, max_depth=run.depth)
    before = _snapshot(run) if keep else None
    if epoch != f["epoch"]:
        if not (run.fault == "stale_record" and f["rec"] is not None):
            with run.span("fit.record"), torch.no_grad():
                sd, cp = G.apply_params(f["sd"], f["cp"], f["params"])
                f["rec"] = G.record_decisions(sd, cp, pix, run.rseed, sample0=sample0, **kw)
            f["records"] += 1
        f["epoch"] = epoch
    with run.span("fit.loss_and_grad"):
        loss, grads = G.loss_and_grad(f["params"], f["sd"], f["cp"], target, pix, run.rseed,
                                      sample0=sample0, rec=f["rec"], method="replay", **kw)
    with run.span("fit.adam"):
        g = G.leaves(grads)
        for name, t in f["flat"].items():
            t.grad = g[name] if name == f["leaf"] else torch.zeros_like(t)
        if run.fault == "scaled":
            f["flat"][f["leaf"]].grad = f["flat"][f["leaf"]].grad * 1.01
        if run.fault != "unchanged":
            f["opt"].step()
    if keep:
        t = f["flat"][f["leaf"]]
        before.update(after=t.detach().clone(), loss=loss)
        run.snaps[i] = before
    return loss


def window(run, seconds: float, max_items: int | None) -> None:
    cuda = torch.device(run.device).type == "cuda"
    marks, host_ms = [], []
    records0 = run.fit["records"]
    i = run.step_index
    seen = set()
    t0 = time.perf_counter()
    n = 0
    while True:
        ts = time.perf_counter()
        kind = _candidate(run, i)
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        with run.span("fit.step"):
            loss = _step(run, i, keep=kind is not None)
        if cuda:
            e1.record()
            marks.append((e0, e1))
        if not math.isfinite(float(loss)):
            run.failed += 1
        host_ms.append(1e3 * (time.perf_counter() - ts))
        seen.add(kind)
        i += 1
        n += 1
        if {"record", "last"} <= seen and (time.perf_counter() - t0 >= seconds
                                           or (max_items and n >= max_items)):
            break
    elapsed = time.perf_counter() - t0
    run.sync()
    step_ms = [a.elapsed_time(b) for a, b in marks] if cuda else host_ms
    run.attempted = n
    run.facts.update(window_s=elapsed, steps=n, records=run.fit["records"] - records0)
    run.e2e["grad_step_ms"] = 1e3 * elapsed / n
    run.e2e["grad_step_ms_p95"] = sorted(step_ms)[max(0, math.ceil(0.95 * n) - 1)]


def release(run) -> None:
    """Draw the checked window steps from the seed; keep only theirs."""
    rng = np.random.default_rng([run.seed, 9])
    picked = []
    for kind in ("record", "last"):
        steps = sorted(i for i in run.snaps if _candidate(run, i) == kind)
        picked.append(steps[int(rng.integers(len(steps)))])
    run.snaps = {i: {k: (float(v) if k == "loss" else v) for k, v in run.snaps[i].items()}
                 for i in picked}
    run.facts["checked_steps"] = picked
    run.fit = None


def _gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def check(run) -> None:
    """Follow the first ``checked_steps`` steps from the start, and the
    window's drawn steps from the program's state before each, with the
    reference (or, under ``control``, put the reference computed in
    bfloat16 in the program's place); read ``loss_gap``, ``grad_gap``,
    ``change_gap``, ``step_loss_gap`` and ``step_change_gap``."""
    tr, dev, ref = run.traffic, run.device, run.ref
    leaf, r = tr["leaf"], _rerecord(run)
    preps = {torch.float32: ref.prepare(run.cfg, run.desc, run.width, run.height, dev)}
    if run.control:
        preps[torch.bfloat16] = ref.prepare(run.cfg, run.desc, run.width, run.height, dev,
                                            torch.bfloat16)

    def grad_of(dtype, value, i, counts=None):
        return ref.loss_and_grad(preps[dtype], {leaf: value.to(dtype)}, run.target, run.spp,
                                 run.rseed, run.depth, sample0=(i // r) * run.spp,
                                 counts=counts)

    def follow(dtype, counts=None):
        start = torch.full(ref.leaf(preps[torch.float32], leaf).shape, float(tr["init"]),
                           device=dev)
        value = start.to(dtype)
        adam = ref_adam.Adam(lr=tr["lr"])
        losses, g0 = [], None
        for k in range(tr["checked_steps"]):
            loss, g = grad_of(dtype, value, k, counts if k == 0 else None)
            losses.append(float(loss))
            g0 = g[leaf] if k == 0 else g0
            value = adam.step(value.float(), g[leaf]).to(dtype)
        return losses, _norm(g0), _norm(value.float() - start)

    def one_step(dtype, s, i):
        loss, g = grad_of(dtype, s["theta"], i)
        adam = ref_adam.Adam(lr=tr["lr"], step_count=s["steps"], m=s["m"], v=s["v"])
        after = adam.step(s["theta"], g[leaf]).to(dtype).float()
        return float(loss), _norm(after - s["theta"].to(dtype).float())

    counts = {}
    want = follow(torch.float32, counts)
    if run.control:
        got = follow(torch.bfloat16)
    else:
        g_prog = (0.0 if run.exp_avg0 is None else _norm(run.exp_avg0) / (1.0 - BETA1))
        got = (run.losses, g_prog, _norm(run.theta_k - run.theta0))
    rays = run.width * run.height * run.spp
    run.facts.update(alive_per_ray=counts.get("searches", 0) / rays,
                     continued_per_ray=counts.get("continued", 0) / rays)
    run.reading("loss_gap", max(_gap(a, b) for a, b in zip(got[0], want[0])))
    run.reading("grad_gap", _gap(got[1], want[1]))
    run.reading("change_gap", _gap(got[2], want[2]))

    gaps = [0.0, 0.0]
    for i, s in run.snaps.items():
        want = one_step(torch.float32, s, i)
        if run.control:
            got = one_step(torch.bfloat16, s, i)
        else:
            got = (s["loss"], _norm(s["after"] - s["theta"]))
        gaps = [max(a, _gap(x, y)) for a, x, y in zip(gaps, got, want)]
    run.reading("step_loss_gap", gaps[0])
    run.reading("step_change_gap", gaps[1])
