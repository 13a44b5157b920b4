"""Mueller-matrix algebra for polarized (Stokes) light transport.

JAX rebuild of the capability behind the reference's ``stokes``
integrator and ``polarizer`` BSDF scenes
(/root/reference/scenes/cbox_pol.xml:5-7, polarizers.xml:27-39 —
SURVEY.md §2b stock-integrator row).

Conventions:
  * Stokes vectors are (..., 4[, C]) = (I, Q, U, V) in a right-handed basis
    (b, cross(w, b), w) where w is the propagation direction and b the
    horizontal reference axis.
  * Mueller matrices are (..., 4, 4) (per RGB channel where Fresnel values
    are spectral: (..., 3, 4, 4)).
  * rotator(phi) rotates the reference basis by phi around the propagation
    axis (acts on the Q-U block with 2*phi angles).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.core.math import dot, normalize, safe_sqrt


def rotator(phi):
    """Reference-frame rotation Mueller matrix (..., 4, 4)."""
    c = jnp.cos(2.0 * phi)
    s = jnp.sin(2.0 * phi)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    rows = [
        jnp.stack([o, z, z, z], -1),
        jnp.stack([z, c, s, -z], -1),
        jnp.stack([z, -s, c, z], -1),
        jnp.stack([z, z, z, o], -1),
    ]
    return jnp.stack(rows, -2)


def rotation_angle(w, b_from, b_to):
    """Signed rotation angle around propagation dir w taking basis b_from to
    b_to (both unit, both perpendicular to w)."""
    s = dot(jnp.cross(b_from, b_to), w)
    c = dot(b_from, b_to)
    return jnp.arctan2(s, c)


def depolarizer(value):
    """Ideal depolarizer scaled by ``value`` (diffuse surfaces): output is
    unpolarized with intensity value * I_in."""
    shape = jnp.shape(value) + (4, 4)
    m = jnp.zeros(shape, jnp.float32)
    return m.at[..., 0, 0].set(value)


def absorber(value):
    """Neutral attenuator: scales all Stokes components."""
    eye = jnp.eye(4, dtype=jnp.float32)
    return value[..., None, None] * eye


def linear_polarizer(theta, transmittance=1.0):
    """Ideal linear polarizer with transmission axis at angle ``theta`` from
    the reference basis (Mueller matrix, (..., 4, 4))."""
    c = jnp.cos(2.0 * theta)
    s = jnp.sin(2.0 * theta)
    z = jnp.zeros_like(c)
    rows = [
        jnp.stack([jnp.ones_like(c), c, s, z], -1),
        jnp.stack([c, c * c, s * c, z], -1),
        jnp.stack([s, s * c, s * s, z], -1),
        jnp.stack([z, z, z, z], -1),
    ]
    return 0.5 * jnp.asarray(transmittance)[..., None, None] * jnp.stack(rows, -2)


def _fresnel_rs_rp_complex(cos_i, eta_c):
    """Complex s/p amplitude reflection coefficients for relative complex
    IOR ``eta_c`` (conductor: eta + i k; dielectric: real)."""
    cos_i = jnp.abs(cos_i).astype(jnp.complex64)
    sin2 = 1.0 - cos_i * cos_i
    root = jnp.sqrt(eta_c * eta_c - sin2)
    rs = (cos_i - root) / (cos_i + root)
    rp = (eta_c * eta_c * cos_i - root) / (eta_c * eta_c * cos_i + root)
    return rs, rp


def specular_reflection(cos_i, eta_re, eta_im=None):
    """Fresnel reflection Mueller matrix (..., 4, 4) in the s-p basis
    (s = perpendicular to the plane of incidence = the Q=+1 axis here).

    eta_re/eta_im broadcast against cos_i; pass eta_im=None for dielectrics.
    """
    eta_c = jnp.asarray(eta_re, jnp.complex64)
    if eta_im is not None:
        eta_c = eta_c + 1j * jnp.asarray(eta_im, jnp.complex64)
    rs, rp = _fresnel_rs_rp_complex(cos_i, eta_c)
    Rs = jnp.abs(rs) ** 2
    Rp = jnp.abs(rp) ** 2
    cross = rs * jnp.conj(rp)
    a = 0.5 * (Rs + Rp)
    b = 0.5 * (Rs - Rp)
    c = jnp.real(cross)
    s = jnp.imag(cross)
    z = jnp.zeros_like(a)
    rows = [
        jnp.stack([a, b, z, z], -1),
        jnp.stack([b, a, z, z], -1),
        jnp.stack([z, z, c, s], -1),
        jnp.stack([z, z, -s, c], -1),
    ]
    return jnp.stack(rows, -2).astype(jnp.float32)


def specular_transmission(cos_i, cos_t, eta_it):
    """Fresnel transmission Mueller matrix for a real (dielectric) relative
    IOR; includes the radiance scaling 1/eta^2 applied by the caller."""
    eta = eta_it
    denom_s = cos_i + eta * cos_t
    denom_p = eta * cos_i + cos_t
    ts = 2.0 * cos_i / jnp.maximum(denom_s, 1e-9)
    tp = 2.0 * cos_i / jnp.maximum(denom_p, 1e-9)
    # energy factor for amplitude->power: eta * cos_t / cos_i
    factor = eta * cos_t / jnp.maximum(cos_i, 1e-9)
    Ts = ts * ts * factor
    Tp = tp * tp * factor
    a = 0.5 * (Ts + Tp)
    b = 0.5 * (Ts - Tp)
    c = ts * tp * factor
    z = jnp.zeros_like(a)
    rows = [
        jnp.stack([a, b, z, z], -1),
        jnp.stack([b, a, z, z], -1),
        jnp.stack([z, z, c, z], -1),
        jnp.stack([z, z, z, c], -1),
    ]
    return jnp.stack(rows, -2).astype(jnp.float32)


def stokes_basis(w):
    """A deterministic horizontal basis vector perpendicular to w."""
    # pick the axis least aligned with w
    a = jnp.where(
        (jnp.abs(w[..., 0]) > 0.9)[..., None],
        jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), w.shape),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), w.shape),
    )
    return normalize(jnp.cross(a, w))


def perpendicular_basis(w, reference):
    """Project ``reference`` perpendicular to w and normalize (fallback to
    stokes_basis when degenerate)."""
    proj = reference - dot(w, reference, keepdims=True) * w
    ln2 = jnp.sum(proj * proj, -1, keepdims=True)
    fallback = stokes_basis(w)
    return jnp.where(ln2 > 1e-12, proj / safe_sqrt(ln2), fallback)
