"""Where the port's sphere_stress render and the JAX package's part, and why.

Prints, for sphere_stress(copies=4) at 24 and 32 wide, 2 spp, depth 4 and
seeds 0-2:
- the fraction of pixel values within isclose(1e-3, 1e-3) of the port's
  walk against the JAX walk, of the JAX walk against the JAX brute search,
  and of the JAX package's own pixel schedule against its mega schedule,
  and whether the port's walk equals its brute search;
- the record pass over every (pixel, sample) lane: how many lanes' decision
  words differ from the JAX walk's, and at each lane's first differing
  bounce whether one side hit and the other missed, the winners differ
  (one of them the ground, row 0, or not), or the winner is the same and
  flags differ.

Run on the CPU from the repository root (about a minute):

    JAX_PLATFORMS=cpu python -m tests.torch_sphere_stress_parity
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crucible_tpu.models import demo as jdemo
from crucible_tpu.models import render as jrender
from crucible_tpu.models import replay as jrep
from crucible_tpu_torch.models import render as trender
from crucible_tpu_torch.models import replay as trep
from crucible_tpu_torch.ops.kernels import megakernel as tmk
from tests.test_torch_scene import bridged

FLAGS = {name: getattr(tmk, "F_" + name)
         for name in ("ALIVE", "HIT", "TRI", "SCAT", "FRONT", "REFL", "DEGEN", "ROOT1")}


def close(a, b) -> float:
    return float(np.isclose(a, b, rtol=1e-3, atol=1e-3).mean())


def first_divergence(port, ref) -> collections.Counter:
    """(bounce, kind) of each lane's first differing decision word."""
    kinds = collections.Counter()
    diff = port != ref
    for lane in np.nonzero(diff.any(0))[0]:
        b = int(np.argmax(diff[:, lane]))
        a, c = int(port[b, lane]), int(ref[b, lane])
        if (a ^ c) & tmk.F_HIT:
            kind = "hit vs miss"
        elif (a >> 8) != (c >> 8):
            kind = "winners differ" + (", one the ground" if 0 in (a >> 8, c >> 8) else "")
        else:
            kind = "same winner, flag " + "+".join(
                n for n, v in FLAGS.items() if (a ^ c) & v)
        kinds[(b, kind)] += 1
    return kinds


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    spp, depth = 2, 4
    for width in (24, 32):
        js = jdemo.sphere_stress(width=width, copies=4)
        w, h = js.scene_cam.image_width, js.scene_cam.image_height
        jsd, jcp = js.build(), js.scene_cam.params()
        sd, cp = bridged(js)
        pix = np.tile(np.arange(w * h), spp)
        smp = np.repeat(np.arange(spp), w * h)
        for seed in range(3):
            def jax_render(**kw):
                return np.asarray(jrender.render_image_persistent(
                    jsd, jcp, w, h, spp, depth, seed, **kw))

            def port_render(**kw):
                return trender.render_image_persistent(
                    sd, cp, w, h, spp, depth, seed, device="cpu", schedule="mega", **kw)

            j_walk = jax_render(schedule="mega")
            j_brute = jax_render(schedule="mega", cull=False)
            j_pixel = jax_render(schedule="pixel")
            t_walk, t_brute = port_render(), port_render(cull=False)
            j_rec = np.asarray(jrep.trace_record_mega(
                jsd, jcp, w, h, jnp.asarray(pix, jnp.uint32), jnp.asarray(smp, jnp.uint32),
                jnp.uint32(seed), depth, interpret=True))
            t_rec = trep.trace_record_mega(sd, cp, w, h, torch.from_numpy(pix),
                                           torch.from_numpy(smp), seed, depth).numpy()
            kinds = first_divergence(t_rec, j_rec)
            print(f"{w}x{h} seed {seed}: port walk vs JAX walk {close(t_walk.numpy(), j_walk):.4f} "
                  f"(mean diff {abs(t_walk.numpy().mean() - j_walk.mean()):.2e}); "
                  f"JAX walk vs JAX brute {close(j_walk, j_brute):.4f}; "
                  f"JAX pixel vs JAX mega {close(j_pixel, j_walk):.4f}; "
                  f"port walk == port brute: {bool(torch.equal(t_walk, t_brute))}; "
                  f"records: {sum(kinds.values())} of {pix.size} lanes differ, first at "
                  f"{dict(sorted(kinds.items()))}", flush=True)


if __name__ == "__main__":
    main()
