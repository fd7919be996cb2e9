"""End-to-end inverse rendering: recover texture texels and solid albedos
from a rendered target with frozen-decision training steps (port of
``tools/train_demo.py``).

The run renders a target from the scene's true parameters, starts the
trainable leaves (``TRAINABLE``: the texture images and the texture table's
colors) from gray, and fits them with Adam through the record/replay
gradient (``grad.loss_and_grad(rec=...)``). Decisions are re-recorded every
``rerecord`` steps over a fresh sample window, and every ``ckpt_every``
steps the parameters, the optimizer's state and the losses so far are
checkpointed (``grad.save_checkpoint``). Every other leaf's gradient is
set to zero before each Adam step, so the frozen leaves never move.

A run resumed from a checkpoint gives parameters and losses identical, bit
for bit, to an uninterrupted run: records and sample windows are pure
functions of the step index, and the replay's gathers add their
cotangents in a fixed order on a GPU too (``ops.gather``).

Usage (from the repository root; ``earth`` needs the ``earthmap.jpg``
asset, found as every asset is: ``ASSET_DIR``, then ``./assets`` and up to
6 parents, then the repository's ``assets/``)::

    python -m crucible_tpu_torch.train_demo            # earth, 1920 wide, on the card
    python -m crucible_tpu_torch.train_demo --steps 40 --scene earth --out /tmp/td

Artifacts under ``--out`` (default ``artifacts/train_demo_torch``):
``losses.json`` (the loss curve), ``ckpt.npz`` (resumable) and
``recovered.png``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch.io.image import write_png
from crucible_tpu_torch.models import demo, render

TRAINABLE = ("tex_images", "tex_color")
TARGET_SAMPLE0 = 1 << 20  # the target's sample window, apart from every step's
RECOVERED_SAMPLE0 = 1 << 21


def build(scene, width: int, device):
    """(Scene, SceneData, CameraParams) of ``scene``: the name of a demo world
    or a callable ``scene(width=...) -> Scene``."""
    sc = (getattr(demo, scene) if isinstance(scene, str) else scene)(width=width)
    return sc, sc.build(device=device), sc.scene_cam.params(device=device)


def scrambled_init(true_params):
    """Gray texels and mid-gray table colors: the parameters the fit must
    recover."""
    p = dict(true_params)
    p["tex_images"] = tuple(torch.full_like(img, 0.5) for img in true_params["tex_images"])
    p["tex_color"] = torch.full_like(true_params["tex_color"], 0.5)
    return p


def trainable(name: str) -> bool:
    """Whether the leaf ``name`` (as named by ``grad.leaves``) is fitted."""
    return name.split("/")[0] in TRAINABLE


def _optimizer(params, lr: float, state=None):
    """Adam over every leaf of ``params`` (made leaves that require grad),
    in ``grad.leaves`` order -> (params, leaves, optimizer)."""
    flat = {k: v.detach().clone().requires_grad_(True) for k, v in G.leaves(params).items()}
    opt = torch.optim.Adam(list(flat.values()), lr=lr)
    if state is not None:
        opt.load_state_dict(state)
    return G.with_leaves(params, flat), flat, opt


def run(
    scene="earth",
    width: int = 1920,
    steps: int = 30,
    spp: int = 4,
    depth: int = 8,
    target_spp: int = 16,
    rerecord: int = 10,
    ckpt_every: int = 10,
    lr: float = 5e-2,
    out_dir: str | Path = "artifacts/train_demo_torch",
    resume: bool = True,
    seed: int = 123,
    verbose: bool = True,
    device="cuda",
):
    """-> (params, losses: a list of {"step", "loss", "seconds"}). A
    checkpoint in ``out_dir`` is resumed from when ``resume`` is set."""
    sc, sd, cp = build(scene, width, device)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    pix = torch.arange(w * h, device=device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / "ckpt.npz"
    losses_path = out_dir / "losses.json"

    true_params = G.extract_params(sd, cp)
    with torch.no_grad():
        target = G.render_pixels_mean(true_params, sd, cp, pix, w, h, target_spp, depth,
                                      seed, sample0=TARGET_SAMPLE0)
    start, losses, state = 0, [], None
    params = scrambled_init(true_params)
    if resume and ckpt.exists():
        params, state, start = G.load_checkpoint(ckpt, device=device)
        losses = json.loads(losses_path.read_text())[:start]
        if verbose:
            print(f"resumed from {ckpt} at step {start}")
    params, flat, opt = _optimizer(params, lr, state)

    kw = dict(width=w, height=h, spp=spp, max_depth=depth, method="replay")
    rec, rec_epoch = None, -1
    for step in range(start, steps):
        t0 = time.time()
        epoch = step // rerecord
        if rec is None or epoch != rec_epoch:
            # A fresh sample window each record epoch, recorded at the
            # current parameters (the fitted leaves move no decision).
            with torch.no_grad():
                sd_cur, cp_cur = G.apply_params(sd, cp, params)
                rec = G.record_decisions(sd_cur, cp_cur, pix, seed, width=w, height=h,
                                         spp=spp, max_depth=depth, sample0=epoch * spp)
            rec_epoch = epoch
        loss, grads = G.loss_and_grad(params, sd, cp, target, pix, seed,
                                      sample0=epoch * spp, rec=rec, **kw)
        g = G.leaves(grads)
        for name, leaf in flat.items():
            leaf.grad = g[name] if trainable(name) else torch.zeros_like(leaf)
        opt.step()
        losses.append({"step": step, "loss": float(loss),
                       "seconds": round(time.time() - t0, 3)})
        if verbose:
            print(json.dumps(losses[-1]), flush=True)
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            G.save_checkpoint(ckpt, params, opt, step + 1)
            losses_path.write_text(json.dumps(losses, indent=0))

    with torch.no_grad():
        img = G.render_pixels_mean(params, sd, cp, pix, w, h, spp, depth, seed,
                                   sample0=RECOVERED_SAMPLE0)
    write_png(out_dir / "recovered.png", render.to_u8(img.reshape(h, w, 3).cpu()))
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="earth")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--rerecord", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--out", default="artifacts/train_demo_torch")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, losses = run(
        scene=args.scene, width=args.width, steps=args.steps, spp=args.spp,
        depth=args.depth, rerecord=args.rerecord, ckpt_every=args.ckpt_every,
        lr=args.lr, out_dir=args.out, resume=not args.no_resume, device=args.device,
    )
    print(json.dumps({"final_loss": losses[-1]["loss"], "steps": len(losses)}))


if __name__ == "__main__":
    main()
