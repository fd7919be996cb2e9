"""Vectorized BSDFs over a SoA material table (port of
``crucible_tpu/models/materials.py``).

All scatter programs evaluate on the whole batch and are selected per ray
by material type; EMISSIVE surfaces add ``throughput * emission`` on hit
and terminate the path. Where the JAX staged code and the megakernel differ
in rounding only, this follows the megakernel (``csrc/megakernel.cu``):
1/p and 1/ior are multiplied, and Schlick's power is multiplied out.
"""

from __future__ import annotations

import torch

from crucible_tpu_torch.ops import sampling
from crucible_tpu_torch.utils import vec

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSIVE = 3


def schlick(cosine, ri):
    """Schlick's reflectance approximation. (1 - cosine)^5 is multiplied out
    in the megakernel's order, so that the CUDA kernel and this eager code
    round alike."""
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_m = 1.0 - cosine
    om2 = one_m * one_m
    return r0 + (1.0 - r0) * om2 * om2 * one_m


def scatter(
    mat_type,
    fuzz,
    ior,
    scatter_prob,
    albedo,
    d_in,
    normal,
    front_face,
    u_dir1,
    u_dir2,
    u_decide,
    forced_reflect=None,
    forced_degenerate=None,
):
    """Evaluate all BSDF branches for a batch of hits and select by type.

    Args:
      mat_type: (R,) integer-valued type in {LAMBERTIAN, METAL, DIELECTRIC,
        EMISSIVE}.
      fuzz, ior, scatter_prob: (R,) material parameters.
      albedo: (R, 3) texture-evaluated albedo at the hit.
      d_in: (R, 3) incoming ray direction (unnormalized, as cast).
      normal: (R, 3) unit normal flipped against ``d_in``.
      front_face: (R,) bool.
      u_dir1, u_dir2: uniforms for the scatter-direction sample.
      u_decide: uniform for the material decision (Lambertian roulette /
        dielectric reflectance test).
      forced_reflect, forced_degenerate: optional (R,) bool that replace the
        computed dielectric reflect / Lambertian degenerate decisions with
        recorded ones: the replay freezes every discrete decision, so that
        a last-ulp change in a recomputed value never flips a branch.

    Returns:
      (scatter_dir (R,3), attenuation (R,3), scattered (R,) bool,
      reflect (R,) bool, degenerate (R,) bool); ``scattered`` False means
      the path is absorbed. ``reflect`` (the dielectric's choice) and
      ``degenerate`` (the Lambertian direction's) are evaluated for every
      row whatever its material, as the record-mode megakernel stores them
      (the forced ones where given).
    """
    rnd_unit = sampling.unit_vector(u_dir1, u_dir2)

    # --- Lambertian ------------------------------------------------------
    lam_dir = normal + rnd_unit
    degenerate = vec.near_zero(lam_dir) if forced_degenerate is None else forced_degenerate
    lam_dir = torch.where(degenerate[:, None], normal, lam_dir)
    # Russian roulette with 1/p compensation; all demo scenes pass prob=1.
    lam_atten = albedo * (1.0 / torch.clamp_min(scatter_prob, 1e-8))[:, None]
    lam_alive = u_decide <= scatter_prob

    # --- Metal -----------------------------------------------------------
    reflected = vec.reflect(d_in, normal)
    met_dir = vec.unit(reflected, eps=1e-20) + fuzz[:, None] * rnd_unit
    met_alive = vec.dot(met_dir, normal) > 0.0
    met_atten = albedo

    # --- Dielectric ------------------------------------------------------
    ud = vec.unit(d_in, eps=1e-20)
    ri = torch.where(front_face, 1.0 / torch.clamp_min(ior, 1e-8), ior)
    cos_theta = torch.clamp_max(vec.dot(-ud, normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 1.0e-12))
    cannot_refract = ri * sin_theta > 1.0
    reflect_choice = (
        cannot_refract | (schlick(cos_theta, ri) > u_decide)
        if forced_reflect is None
        else forced_reflect
    )
    die_dir = torch.where(
        reflect_choice[:, None],
        vec.reflect(ud, normal),
        vec.refract(ud, normal, ri),
    )
    die_atten = torch.ones_like(albedo)

    # --- select by type --------------------------------------------------
    is_metal = mat_type == METAL
    is_diel = mat_type == DIELECTRIC
    is_emissive = mat_type == EMISSIVE

    out_dir = torch.where(
        is_diel[:, None], die_dir, torch.where(is_metal[:, None], met_dir, lam_dir)
    )
    atten = torch.where(
        is_diel[:, None], die_atten, torch.where(is_metal[:, None], met_atten, lam_atten)
    )
    alive = is_diel | (is_metal & met_alive) | (~is_metal & ~is_diel & lam_alive)
    alive = alive & ~is_emissive  # emitters terminate the path
    return out_dir, atten, alive, reflect_choice, degenerate
