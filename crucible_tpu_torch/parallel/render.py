"""Sharded renders and gradients over a :class:`~.mesh.DeviceMesh`.

Port of ``crucible_tpu/parallel/render.py``. The JAX package shards a
jitted render with ``shard_map`` / ``NamedSharding`` and lets XLA gather
the framebuffer and psum the gradients; here each grid position's share
is a call on its own device, and the shares meet explicitly:

- :func:`render_image_sharded_mega`: horizontal bands of ``ceil(h / n)``
  rows, one ``flat_kernel`` launch a band (``integrator.
  trace_persistent_mega(row0=, band_height=)``), pixels keyed by their
  global ids;
- :func:`render_image_sharded`: flat pixel shards, padded with the last
  pixel id, each through the staged ``integrator.render_rays`` (K10 on the
  card);
- :func:`loss_and_grad_sharded`: ``grad.loss_and_grad`` on each pixel
  shard, losses and gradients weighted by the shard's share of the pixels
  and summed.

Within one process the positions run in turn and their shares are
concatenated or summed in position order; under an initialized process
group each process runs its own positions and the shares are joined with
``all_gather`` (images) and ``all_reduce`` (losses and gradients). Images
are bit for bit one device's render; a loss and its gradients equal one
call's up to float32 rounding of the weighted sum.
"""

from __future__ import annotations

import math
from dataclasses import fields, is_dataclass, replace

import torch
import torch.distributed as dist

from crucible_tpu_torch import grad as grad_mod
from crucible_tpu_torch.models import integrator
from crucible_tpu_torch.models import render as render_mod
from crucible_tpu_torch.models.scene import Scene
from crucible_tpu_torch.parallel import mesh as mesh_mod


def _on(x, dev):
    """``x`` (a tensor, or a dataclass, dict, tuple or list of them) on
    ``dev``; tensors already there are not copied."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if is_dataclass(x) and not isinstance(x, type):
        return replace(x, **{f.name: _on(getattr(x, f.name), dev) for f in fields(x)})
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, dev) for v in x)
    return x


def _gather(shares: list, mesh: mesh_mod.DeviceMesh) -> torch.Tensor:
    """This process's shares, in position order, joined with every other
    process's (``all_gather``, equal shapes) -> the shares of all
    positions concatenated along dim 0, on this process's first device."""
    mine = torch.cat([s.to(mesh.device(mesh.local_positions()[0])) for s in shares])
    if not mesh.group:
        return mine
    out = [torch.empty_like(mine) for _ in range(mesh.world)]
    dist.all_gather(out, mine)
    return torch.cat(out)


def _scene_on(scene: Scene, dev, cache: dict):
    """(scene data, camera params) of ``scene`` on ``dev``, built once a
    device."""
    key = str(dev)
    if key not in cache:
        cache[key] = (scene.build(device=dev), scene.scene_cam.params(device=dev))
    return cache[key]


def _settings(scene: Scene, samples, max_depth, seed):
    cam = scene.scene_cam
    return (cam.image_width, cam.image_height,
            samples if samples is not None else cam.samples,
            max_depth if max_depth is not None else cam.max_depth,
            seed if seed is not None else scene.seed)


def render_image_sharded_mega(
    scene: Scene,
    mesh: mesh_mod.DeviceMesh | None = None,
    samples: int | None = None,
    max_depth: int | None = None,
    seed: int | None = None,
) -> torch.Tensor:
    """The megakernel render in horizontal bands over the mesh's positions
    -> linear radiance (height, width, 3) float32, bit for bit the
    one-dispatch render (``render.render_image_persistent``, schedule
    'mega').

    Position i renders rows [i * ceil(h / n), (i + 1) * ceil(h / n)) of the
    n positions' bands in one megakernel launch on its device, with the
    whole image's camera and pixel ids; lanes past the image's last row
    never issue. Each band searches the spheres as the one-dispatch render
    does (``render.mega_walk``: above ``render.CULL_MIN_ROWS`` rows the
    scene's tree, K5 or K6). The bands are
    gathered (``all_gather`` across processes) on this process's first
    device. A scene the megakernel does not render raises
    ``NotImplementedError``, naming :func:`render_image_sharded`, which
    takes it."""
    mesh = mesh_mod.make_mesh() if mesh is None else mesh
    w, h, spp, depth, seed_v = _settings(scene, samples, max_depth, seed)
    band_h = math.ceil(h / mesh.size)
    built, bands = {}, []
    for pos in mesh.local_positions():
        sd, cp = _scene_on(scene, mesh.device(pos), built)
        try:
            walk = render_mod.mega_walk(sd, cp)
        except NotImplementedError as e:
            raise NotImplementedError(
                f"render_image_sharded_mega: {e}; render_image_sharded (the staged "
                "bounce) takes this scene") from e
        bands.append(integrator.trace_persistent_mega(
            sd, cp, w, h, spp, depth, seed_v, row0=pos * band_h, band_height=band_h, **walk))
    fb = _gather(bands, mesh)
    return fb[:w * h].reshape(h, w, 3) / spp


def render_image_sharded(
    scene: Scene,
    mesh: mesh_mod.DeviceMesh | None = None,
    samples: int | None = None,
    max_depth: int | None = None,
    seed: int | None = None,
) -> torch.Tensor:
    """The staged render with pixels sharded over the mesh's positions ->
    linear radiance (height, width, 3) float32: the pixel ids, padded with
    the last one to a multiple of the positions, split in equal flat
    shares (``mesh.ray_sharding``); each position traces its pixels'
    ``samples`` through ``integrator.render_rays`` (K10 on the card; the
    exact branch for exact-time motion, which the megakernel does not
    take) and averages them. Bit for bit ``integrator.render_rays`` over the whole
    image."""
    mesh = mesh_mod.make_mesh() if mesh is None else mesh
    w, h, spp, depth, seed_v = _settings(scene, samples, max_depth, seed)
    num_pixels = w * h
    padded = num_pixels + (-num_pixels) % mesh.size
    ranges = mesh_mod.ray_sharding(mesh, padded)
    built, shares = {}, []
    for pos in mesh.local_positions():
        dev = mesh.device(pos)
        sd, cp = _scene_on(scene, dev, built)
        lo, hi = ranges[pos]
        pix = torch.clamp_max(torch.arange(lo, hi, device=dev), num_pixels - 1)
        p = hi - lo
        rad = integrator.render_rays(
            sd, cp, w, h, pix.repeat(spp), torch.arange(spp, device=dev).repeat_interleave(p),
            seed_v, depth)
        shares.append(rad.reshape(spp, p, 3).mean(dim=0))
    return _gather(shares, mesh)[:num_pixels].reshape(h, w, 3)


def loss_and_grad_sharded(params, sd, cp, target, pixel_ids, seed, *,
                          mesh: mesh_mod.DeviceMesh | None = None, **kw):
    """``grad.loss_and_grad`` with the pixels sharded over the mesh's
    positions -> (loss, grads) as one call gives them, on this process's
    first device.

    The L2 loss is a mean over pixels, so each position computes the loss
    and gradients of its flat pixel share (``mesh.ray_sharding``: target
    rows and pixel ids) on its device with ``params``, ``sd`` and ``cp``
    moved there, weights them by its share of the pixels, and the weighted
    terms are summed (in float64, in position order; across processes with
    one ``all_reduce`` of the flattened terms). This is how the JAX
    package's gradients over pixel-sharded inputs are summed by XLA's psum
    (``tests/test_parallel.py``), made explicit. Keyword arguments are
    ``grad.loss_and_grad``'s."""
    mesh = mesh_mod.make_mesh() if mesh is None else mesh
    n = pixel_ids.shape[0]
    ranges = mesh_mod.ray_sharding(mesh, n)
    out_dev = mesh.device(mesh.local_positions()[0])
    keys = list(grad_mod.leaves(params))
    total = None  # loss, then every gradient leaf, flattened
    for pos in mesh.local_positions():
        lo, hi = ranges[pos]
        if hi == lo:
            continue
        dev = mesh.device(pos)
        loss, g = grad_mod.loss_and_grad(
            _on(params, dev), _on(sd, dev), _on(cp, dev), target[lo:hi].to(dev),
            pixel_ids[lo:hi].to(dev), seed, **kw)
        flat = grad_mod.leaves(g)
        term = torch.cat([loss.reshape(1)] + [flat[k].reshape(-1) for k in keys])
        term = term.to(out_dev, torch.float64) * ((hi - lo) / n)
        total = term if total is None else total + term
    if total is None:  # no pixel in this process's positions
        size = 1 + sum(v.numel() for v in grad_mod.leaves(params).values())
        total = torch.zeros(size, dtype=torch.float64, device=out_dev)
    if mesh.group:
        dist.all_reduce(total)
    total = total.to(torch.float32)
    out, at = {}, 1
    for k, leaf in grad_mod.leaves(params).items():
        out[k] = total[at:at + leaf.numel()].reshape(leaf.shape)
        at += leaf.numel()
    return total[0], grad_mod.with_leaves(params, out)
