"""GGX (Trowbridge-Reitz) microfacet distribution: VNDF sampling, D, G, pdf.

JAX replacement for the reference's hand-rolled GGX
(_ggx_sample, Heitz stretched-VNDF, /root/reference/CustomBSDF.py:30-61) and
the inverse-CDF theta sampling validated by sampling_test.py:18.  Unlike the
reference's ggx_pdf (which degenerates to 1.0 — SURVEY.md §2d), this pdf is
the correct visible-normal distribution pdf so Monte-Carlo estimators can
divide by it.

All functions operate in the local shading frame (+Z = normal) on SoA arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.core.math import safe_sqrt, vec3, normalize


def ggx_d(m, alpha):
    """Isotropic GGX normal distribution function D(m).

    Uses the cancellation-free form a^2 / (pi (a^2 cos^2 + sin^2)^2): the
    textbook cos^2 (a^2-1) + 1 cancels catastrophically in f32 for small
    alpha near normal incidence and produces NaN cotangents in reverse mode.
    """
    cos_theta = m[..., 2]
    c2 = cos_theta * cos_theta
    s2 = jnp.maximum(1.0 - c2, 0.0)
    a2 = alpha * alpha
    denom = a2 * c2 + s2
    d = a2 / jnp.maximum(jnp.pi * denom * denom, 1e-18)
    return jnp.where(cos_theta > 0.0, d, 0.0)


def ggx_smith_g1(v, alpha):
    """Smith masking term G1(v) for isotropic GGX."""
    cos_v = v[..., 2]
    tan2 = jnp.maximum(1.0 - cos_v * cos_v, 0.0) / jnp.maximum(cos_v * cos_v, 1e-12)
    lam = 0.5 * (safe_sqrt(1.0 + alpha * alpha * tan2) - 1.0)
    g1 = 1.0 / (1.0 + lam)
    return jnp.where(cos_v != 0.0, g1, 0.0)


def ggx_smith_g(wi, wo, alpha):
    """Separable Smith shadowing-masking G(wi, wo)."""
    return ggx_smith_g1(wi, alpha) * ggx_smith_g1(wo, alpha)


def ggx_sample_vndf(wi, alpha, sample2):
    """Sample a visible GGX normal (Heitz 2018 spherical-cap formulation).

    ``wi`` must point away from the surface with wi.z possibly of either sign;
    sampling happens on the hemisphere around +Z oriented toward wi.
    Returns the sampled microfacet normal m (unit, m.z > 0 when wi.z > 0).
    """
    flip = jnp.sign(jnp.where(wi[..., 2] == 0.0, 1.0, wi[..., 2]))[..., None]
    wi_f = wi * flip

    # Stretch to hemisphere configuration.
    vh = normalize(vec3(alpha * wi_f[..., 0], alpha * wi_f[..., 1], wi_f[..., 2]))

    # Orthonormal basis around vh.
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / safe_sqrt(jnp.maximum(lensq, 1e-20))
    t1 = jnp.where(
        (lensq > 1e-20)[..., None],
        vec3(-vh[..., 1] * inv_len, vh[..., 0] * inv_len, jnp.zeros_like(inv_len)),
        vec3(jnp.ones_like(inv_len), jnp.zeros_like(inv_len), jnp.zeros_like(inv_len)),
    )
    t2 = jnp.cross(vh, t1)

    # Parameterize the projected, visible area.
    u1 = sample2[..., 0]
    u2 = sample2[..., 1]
    r = safe_sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2

    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh
    )

    # Unstretch.
    m = normalize(
        vec3(alpha * nh[..., 0], alpha * nh[..., 1], jnp.maximum(nh[..., 2], 1e-6))
    )
    return m * flip


def ggx_vndf_pdf(wi, m, alpha):
    """pdf of ggx_sample_vndf in the half-vector measure:
    D_vis(m) = G1(wi) * |wi . m| * D(m) / |wi.z|."""
    flip = jnp.sign(jnp.where(wi[..., 2] == 0.0, 1.0, wi[..., 2]))
    wi_f = wi * flip[..., None]
    m_f = m * flip[..., None]
    # Visible-normal pdf: zero for normals facing away from wi (max, not abs).
    cos_im = jnp.maximum(jnp.sum(wi_f * m_f, axis=-1), 0.0)
    pdf = (
        ggx_smith_g1(wi_f, alpha)
        * cos_im
        * ggx_d(m_f, alpha)
        / jnp.maximum(jnp.abs(wi_f[..., 2]), 1e-12)
    )
    return jnp.maximum(pdf, 0.0)


def ggx_sample_theta_invcdf(xi, alpha):
    """Classic inverse-CDF sampling of the GGX D(m)*cos half-angle theta:
    cos(theta) = sqrt((1 - xi) / (1 + (alpha^2 - 1) xi)).

    Matches the distribution validated by the reference's sampling_test.py:18;
    exposed for the chi-square test that generalizes that script.
    """
    a2 = alpha * alpha
    cos_theta = safe_sqrt((1.0 - xi) / (1.0 + (a2 - 1.0) * xi))
    return jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))


def ggx_theta_pdf(theta, alpha):
    """pdf in theta measure of D(m) cos(theta) sampling: D(theta) cos sin * 2pi."""
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    a2 = alpha * alpha
    denom = cos_t * cos_t * (a2 - 1.0) + 1.0
    d = a2 / jnp.maximum(jnp.pi * denom * denom, 1e-20)
    return d * cos_t * sin_t * 2.0 * jnp.pi
