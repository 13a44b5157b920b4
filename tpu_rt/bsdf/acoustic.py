"""Acoustic (ultrasound) GGX rough reflection/transmission BSDF.

JAX rebuild of the reference's UltraBSDF
(/root/reference/CustomBSDF.py:7-191): impedance-based pressure
reflection/transmission with GGX microfacet normal sampling.

Parameter layout (scene.bsdf_params row, type BSDF_ULTRASOUND):
  [0] impedance (interior, default 1.54 — CustomBSDF.py:12)
  [1] roughness (GGX alpha, default 0.5 — CustomBSDF.py:16)
  [2] exterior medium impedance (1.2 — CustomBSDF.py:105 ``medium_z``)

Documented divergences from the reference (intent-preserving fixes of
SURVEY.md §2d defects):
  * microfacet normals are sampled from the proper visible-normal
    distribution and the branch (reflect vs transmit) weight is divided by
    its selection probability so the estimator is unbiased; the reference
    multiplied by a pdf that degenerated to 1.0 (CustomBSDF.py:81-83) and
    never divided by the lobe probability;
  * the pressure reflection coefficient follows the standard acoustics
    convention R = (Z2 cos_i - Z1 cos_t) / (Z2 cos_i + Z1 cos_t) with
    T = 1 + R; the reference's (Ar, At = 1 - Ar) is the same physics with
    flipped sign (CustomBSDF.py:117-124), which only flips the carrier
    phase and is invisible after envelope detection.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.bsdf import microfacet as mf
from tpu_rt.core import struct
from tpu_rt.core.math import safe_sqrt


@struct.dataclass
class AcousticSample:
    wo: jnp.ndarray  # [N, 3] local outgoing direction
    amplitude: jnp.ndarray  # [N] pressure amplitude factor (R or T, / prob)
    reflected: jnp.ndarray  # [N] bool
    valid: jnp.ndarray  # [N] bool


def sample(params, wi, s1, s2, active):
    """Sample the acoustic BSDF in the local shading frame.

    Args:
      params: [N, 16] BSDF parameter rows.
      wi: [N, 3] local incident direction (toward the ray origin).
      s1: [N] lobe-selection sample.
      s2: [N, 2] microfacet sample.
    """
    z_int = params[..., 0]
    z_ext = jnp.where(params[..., 2] > 0.0, params[..., 2], 1.2)
    alpha = jnp.clip(params[..., 1], 1e-3, 1.0)

    m = mf.ggx_sample_vndf(wi, alpha, s2)

    cos_im = jnp.sum(wi * m, axis=-1)  # > 0 by VNDF construction
    entering = wi[..., 2] > 0.0
    Z1 = jnp.where(entering, z_ext, z_int)
    Z2 = jnp.where(entering, z_int, z_ext)

    # Snell ratio (the reference refracts with the impedance ratio,
    # CustomBSDF.py:111 — kept for behavioral parity).
    ratio = Z1 / jnp.maximum(Z2, 1e-6)
    cos_i = jnp.abs(cos_im)
    sin_t_sqr = ratio * ratio * (1.0 - cos_i * cos_i)
    tir = sin_t_sqr > 1.0
    cos_t = safe_sqrt(1.0 - sin_t_sqr)

    denom = Z2 * cos_i + Z1 * cos_t
    R = (Z2 * cos_i - Z1 * cos_t) / jnp.maximum(denom, 1e-9)
    T = 1.0 + R

    wo_r = 2.0 * cos_im[..., None] * m - wi
    # refraction about m (direction continues through the surface)
    wo_t = -ratio[..., None] * wi + (ratio * cos_i - cos_t)[..., None] * m

    prob_reflect = jnp.clip(R * R, 0.05, 0.95)
    prob_reflect = jnp.where(tir, 1.0, prob_reflect)
    pick_reflect = (s1 < prob_reflect) | tir

    wo = jnp.where(pick_reflect[..., None], wo_r, wo_t)
    wo = wo / jnp.sqrt(jnp.maximum(jnp.sum(wo * wo, -1, keepdims=True), 1e-24))
    amp = jnp.where(
        pick_reflect,
        jnp.abs(R) / prob_reflect,
        jnp.abs(T) / jnp.maximum(1.0 - prob_reflect, 1e-6),
    )
    return AcousticSample(
        wo=wo,
        amplitude=jnp.where(active, amp, 0.0),
        reflected=pick_reflect,
        valid=active,
    )
