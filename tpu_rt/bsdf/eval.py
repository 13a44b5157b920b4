"""BSDF sampling / evaluation / pdf, SoA-dispatched over a megabatch.

JAX equivalents of the Mitsuba BSDF plugins the reference scenes use
(diffuse, dielectric, conductor, roughconductor GGX, polarizer — SURVEY.md
§2b stock-BSDF row).  Instead of per-object virtual dispatch, every ray lane
carries a bsdf index into the flat (type, params) tables; all implemented
lobes are evaluated masked and combined with selects — branch-free and
XLA-fusion friendly.  The acoustic ultrasound BSDF lives in
tpu_rt.bsdf.acoustic (it returns pressure amplitudes, not radiance).

All directions here are in the LOCAL shading frame (+Z = shading normal);
``wi`` points away from the surface toward the ray origin.

Scalar (unpolarized RGB) path.  The polarized Stokes/Mueller path lives in
tpu_rt.integrator.stokes / tpu_rt.bsdf.mueller; in the scalar path the
polarizer behaves like Mitsuba's unpolarized fallback (transmittance * 0.5
on the intensity).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.bsdf import microfacet as mf
from tpu_rt.core import struct, warps
from tpu_rt.core.math import (
    fresnel_conductor,
    fresnel_dielectric,
    reflect_local,
    refract_local,
    vec3,
)
from tpu_rt.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_NULL,
    BSDF_POLARIZER,
    BSDF_ROUGH_CONDUCTOR,
)

INV_PI = 1.0 / jnp.pi


@struct.dataclass
class BSDFSample:
    """SoA equivalent of mi.BSDFSample3f."""

    wo: jnp.ndarray  # [N, 3] sampled outgoing direction (local frame)
    pdf: jnp.ndarray  # [N] solid-angle pdf (1.0 for delta lobes)
    weight: jnp.ndarray  # [N, 3] throughput weight = f * |cos| / pdf
    delta: jnp.ndarray  # [N] bool — sampled a Dirac lobe (no MIS vs NEE)
    eta: jnp.ndarray  # [N] relative IOR of the sampled interaction


def _mirror_eta_k(params):
    """Conductor eta/k with the perfect-mirror marker (params[0] < 0)."""
    is_mirror = params[..., 0] < 0.0
    eta = jnp.where(is_mirror[..., None], 0.0, params[..., 0:3])
    k = jnp.where(is_mirror[..., None], 1e6, params[..., 3:6])
    return eta, k, is_mirror


def sample(bsdf_type, params, wi, s1, s2, active, present=None):
    """Importance-sample the BSDF on every lane.

    Args:
      bsdf_type: [N] int32 type codes.
      params: [N, 16] parameter rows.
      wi: [N, 3] local incident directions (toward origin).
      s1: [N] scalar sample (lobe selection).
      s2: [N, 2] 2-D sample.
      active: [N] bool.
      present: optional static collection of BSDF type codes that occur in
        the scene (Scene.bsdf_types_present) — absent lobes are skipped at
        trace time (the masked-SoA dispatch otherwise evaluates every
        branch on every lane).
    Returns: BSDFSample.
    """
    def has(t):
        return present is None or t in present

    n = wi.shape[0]
    cos_i = wi[..., 2]

    wo = jnp.zeros_like(wi)
    pdf = jnp.zeros((n,), jnp.float32)
    weight = jnp.zeros((n, 3), jnp.float32)
    delta = jnp.zeros((n,), bool)
    eta_out = jnp.ones((n,), jnp.float32)

    def put(mask, wo_i, pdf_i, w_i, delta_i, eta_i):
        nonlocal wo, pdf, weight, delta, eta_out
        mask_v = mask[..., None]
        wo = jnp.where(mask_v, wo_i, wo)
        pdf = jnp.where(mask, pdf_i, pdf)
        weight = jnp.where(mask_v, w_i, weight)
        delta = jnp.where(mask, delta_i, delta)
        eta_out = jnp.where(mask, eta_i, eta_out)

    # ----- diffuse (cosine sampling; front side only like Mitsuba) -----------
    if has(BSDF_DIFFUSE):
        m_diff = bsdf_type == BSDF_DIFFUSE
        wo_d = warps.square_to_cosine_hemisphere(s2)
        wo_d = wo_d * jnp.sign(jnp.where(cos_i == 0, 1.0, cos_i))[..., None]
        pdf_d = warps.square_to_cosine_hemisphere_pdf(wo_d * jnp.sign(cos_i)[..., None])
        refl = params[..., 0:3]
        valid_d = cos_i > 0.0  # Mitsuba diffuse is front-side only
        put(
            m_diff,
            wo_d,
            jnp.where(valid_d, pdf_d, 0.0),
            jnp.where(valid_d[..., None], refl, 0.0),
            jnp.zeros_like(m_diff),
            jnp.ones((n,), jnp.float32),
        )

    # ----- smooth dielectric --------------------------------------------------
    if has(BSDF_DIELECTRIC):
        m_die = bsdf_type == BSDF_DIELECTRIC
        eta_rel = params[..., 0] / jnp.maximum(params[..., 1], 1e-6)
        F, cos_t, eta_it, eta_ti = fresnel_dielectric(cos_i, eta_rel)
        pick_reflect = s1 <= F
        wo_r = reflect_local(wi)
        wo_t = refract_local(wi, cos_t, eta_ti)
        wo_x = jnp.where(pick_reflect[..., None], wo_r, wo_t)
        # radiance scaling on refraction: 1/eta^2 (solid-angle compression)
        w_refl = params[..., 3:6]
        w_trans = params[..., 6:9] * (eta_ti * eta_ti)[..., None]
        w_x = jnp.where(pick_reflect[..., None], w_refl, w_trans)
        pdf_x = jnp.where(pick_reflect, F, 1.0 - F)
        put(
            m_die,
            wo_x,
            pdf_x,
            w_x,
            jnp.ones((n,), bool),
            jnp.where(pick_reflect, 1.0, eta_it),
        )

    # ----- smooth conductor -----------------------------------------------------
    if has(BSDF_CONDUCTOR) or has(BSDF_ROUGH_CONDUCTOR):
        eta_c, k_c, is_mirror = _mirror_eta_k(params)
    if has(BSDF_CONDUCTOR):
        m_con = bsdf_type == BSDF_CONDUCTOR
        Fc = jnp.where(
            is_mirror[..., None],
            1.0,
            fresnel_conductor(jnp.abs(cos_i)[..., None], eta_c, k_c),
        )
        valid_c = cos_i > 0.0
        put(
            m_con,
            reflect_local(wi),
            jnp.where(valid_c, 1.0, 0.0),
            jnp.where(valid_c[..., None], Fc * params[..., 6:9], 0.0),
            jnp.ones((n,), bool),
            jnp.ones((n,), jnp.float32),
        )

    # ----- rough conductor (GGX VNDF) -------------------------------------------
    if has(BSDF_ROUGH_CONDUCTOR):
        m_rc = bsdf_type == BSDF_ROUGH_CONDUCTOR
        alpha = jnp.maximum(params[..., 9], 1e-4)
        m_h = mf.ggx_sample_vndf(wi, alpha, s2)
        wo_rc = 2.0 * jnp.sum(wi * m_h, axis=-1, keepdims=True) * m_h - wi
        pdf_h = mf.ggx_vndf_pdf(wi, m_h, alpha)
        pdf_rc = pdf_h / jnp.maximum(4.0 * jnp.abs(jnp.sum(wi * m_h, axis=-1)), 1e-12)
        cos_im = jnp.abs(jnp.sum(wi * m_h, axis=-1))
        F_rc = jnp.where(
            is_mirror[..., None], 1.0, fresnel_conductor(cos_im[..., None], eta_c, k_c)
        )
        # VNDF weight: F * G2 / G1(wi)
        g2 = mf.ggx_smith_g(wi * jnp.sign(cos_i)[..., None], wo_rc * jnp.sign(cos_i)[..., None], alpha)
        g1 = mf.ggx_smith_g1(wi * jnp.sign(cos_i)[..., None], alpha)
        w_rc = F_rc * params[..., 6:9] * (g2 / jnp.maximum(g1, 1e-12))[..., None]
        valid_rc = (cos_i > 0.0) & (wo_rc[..., 2] > 0.0)
        put(
            m_rc,
            wo_rc,
            jnp.where(valid_rc, pdf_rc, 0.0),
            jnp.where(valid_rc[..., None], w_rc, 0.0),
            jnp.zeros((n,), bool),
            jnp.ones((n,), jnp.float32),
        )

    # ----- polarizer (scalar fallback: straight-through delta transmission) -----
    if has(BSDF_POLARIZER):
        m_pol = bsdf_type == BSDF_POLARIZER
        put(
            m_pol,
            -wi,
            jnp.ones((n,), jnp.float32),
            params[..., 3:6] * 0.5,
            jnp.ones((n,), bool),
            jnp.ones((n,), jnp.float32),
        )

    # ----- null (pass-through) ---------------------------------------------------
    if has(BSDF_NULL):
        m_null = bsdf_type == BSDF_NULL
        put(
            m_null,
            -wi,
            jnp.ones((n,), jnp.float32),
            jnp.ones((n, 3), jnp.float32),
            jnp.ones((n,), bool),
            jnp.ones((n,), jnp.float32),
        )

    ok = active & (pdf > 0.0)
    return BSDFSample(
        wo=wo,
        pdf=jnp.where(ok, pdf, 0.0),
        weight=jnp.where(ok[..., None], weight, 0.0),
        delta=delta,
        eta=eta_out,
    )


def eval_pdf(bsdf_type, params, wi, wo, active, present=None):
    """Evaluate f(wi, wo) * |cos_theta_o| and the sampling pdf (for NEE/MIS).

    Delta lobes evaluate to zero (they can never be hit by NEE), matching
    Mitsuba's eval semantics.
    Returns (value [N, 3], pdf [N]).
    """
    n = wi.shape[0]
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]

    def has(t):
        return present is None or t in present

    value = jnp.zeros((n, 3), jnp.float32)
    pdf = jnp.zeros((n,), jnp.float32)

    # diffuse
    if has(BSDF_DIFFUSE):
        m_diff = (bsdf_type == BSDF_DIFFUSE) & (cos_i > 0.0) & (cos_o > 0.0)
        f_d = params[..., 0:3] * INV_PI * jnp.maximum(cos_o, 0.0)[..., None]
        pdf_d = jnp.maximum(cos_o, 0.0) * INV_PI
        value = jnp.where(m_diff[..., None], f_d, value)
        pdf = jnp.where(m_diff, pdf_d, pdf)

    # rough conductor
    if has(BSDF_ROUGH_CONDUCTOR):
        alpha = jnp.maximum(params[..., 9], 1e-4)
        m_rc = (bsdf_type == BSDF_ROUGH_CONDUCTOR) & (cos_i > 0.0) & (cos_o > 0.0)
        h = wi + wo
        h_len = jnp.sqrt(jnp.maximum(jnp.sum(h * h, -1, keepdims=True), 1e-24))
        h = h / h_len
        d = mf.ggx_d(h, alpha)
        g = mf.ggx_smith_g(wi, wo, alpha)
        eta_c, k_c, is_mirror = _mirror_eta_k(params)
        cos_ih = jnp.abs(jnp.sum(wi * h, axis=-1))
        F_rc = jnp.where(
            is_mirror[..., None], 1.0, fresnel_conductor(cos_ih[..., None], eta_c, k_c)
        )
        f_rc = (
            F_rc
            * params[..., 6:9]
            * (d * g / jnp.maximum(4.0 * cos_i, 1e-12) )[..., None]
        )
        pdf_rc = mf.ggx_vndf_pdf(wi, h, alpha) / jnp.maximum(4.0 * cos_ih, 1e-12)
        value = jnp.where(m_rc[..., None], f_rc, value)
        pdf = jnp.where(m_rc, pdf_rc, pdf)

    value = jnp.where(active[..., None], value, 0.0)
    pdf = jnp.where(active, pdf, 0.0)
    return value, pdf
