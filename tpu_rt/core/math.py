"""Vector / transform / frame math on SoA jnp arrays.

Vectors are arrays of shape (..., 3); transforms are 4x4 row-major matrices
acting on column vectors (p' = M @ [p, 1]).  Conventions follow Mitsuba 3
(see reference /root/reference/scenes/cbox.xml lookat usage) so that the
reference XML scenes produce identically-oriented images:

  * ``look_at``: +Z is the viewing direction, +Y is up, X = cross(up, dir)
    (the "left" vector — Mitsuba's Transform4f::look_at).
  * Normals transform by the inverse transpose of the upper-left 3x3.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

EPS = 1e-7


# ---------------------------------------------------------------------------
# Basic vector ops
# ---------------------------------------------------------------------------

def dot(a, b, keepdims=False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length(v, keepdims=False):
    # clamp strictly above 0 so the sqrt derivative stays finite (0 * inf
    # NaNs would otherwise leak through jnp.where in reverse mode)
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 1e-24))


def normalize(v):
    return v * jnp.reciprocal(jnp.maximum(length(v, keepdims=True), EPS))


def lerp(a, b, t):
    return a + (b - a) * t


def safe_sqrt(x):
    # max() gives zero derivative at the clamp, keeping reverse-mode finite
    # where plain sqrt(0) would contribute inf * 0 = NaN cotangents.
    return jnp.sqrt(jnp.maximum(x, 1e-20))


def safe_rsqrt(x):
    return jax_rsqrt(jnp.maximum(x, EPS))


def jax_rsqrt(x):
    import jax.lax as lax

    return lax.rsqrt(x)


def vec3(x, y, z):
    """Stack components (broadcasting) into a (..., 3) vector."""
    x, y, z = jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), jnp.asarray(z, jnp.float32)
    )
    return jnp.stack([x, y, z], axis=-1)


# ---------------------------------------------------------------------------
# 4x4 transforms (host-side builders use numpy; device-side apply uses jnp)
# ---------------------------------------------------------------------------

def identity4():
    return np.eye(4, dtype=np.float32)


def translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def scale(s):
    s = np.asarray(s, np.float32)
    if s.ndim == 0:
        s = np.array([s, s, s], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s[0], s[1], s[2]
    return m


def rotate(axis, angle_deg):
    """Rotation about ``axis`` by ``angle_deg`` degrees (Rodrigues)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    a = np.deg2rad(float(angle_deg))
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    R = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = R.astype(np.float32)
    return m


def look_at(origin, target, up):
    """Mitsuba-convention camera-to-world: +Z = view dir, X = cross(up, dir)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    d = target - origin
    d = d / max(np.linalg.norm(d), 1e-12)
    left = np.cross(up / max(np.linalg.norm(up), 1e-12), d)
    left = left / max(np.linalg.norm(left), 1e-12)
    new_up = np.cross(d, left)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


def compose(*mats):
    """compose(A, B, C) = A @ B @ C (applied right-to-left like Mitsuba @)."""
    out = np.eye(4, dtype=np.float32)
    for m in mats:
        out = out @ np.asarray(m, np.float32)
    return out.astype(np.float32)


def inverse(m):
    return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)


# Device-side application ----------------------------------------------------
#
# NOTE: geometry transforms must run in full f32.  A default-precision f32
# einsum/matmul may run in reduced precision (TF32 on the GPU's tensor
# cores keeps ~3 decimal digits), which quantizes hit points and causes
# spurious shadow-ray self-occlusion (observed: floors losing half their
# direct light).  Explicit multiply-adds keep the 3x3 math in f32.

def transform_point(m, p):
    """Apply 4x4 ``m`` (..., 4, 4) to points ``p`` (..., 3)."""
    r = m[..., :3, :3]
    return vec3(
        r[..., 0, 0] * p[..., 0] + r[..., 0, 1] * p[..., 1] + r[..., 0, 2] * p[..., 2]
        + m[..., 0, 3],
        r[..., 1, 0] * p[..., 0] + r[..., 1, 1] * p[..., 1] + r[..., 1, 2] * p[..., 2]
        + m[..., 1, 3],
        r[..., 2, 0] * p[..., 0] + r[..., 2, 1] * p[..., 1] + r[..., 2, 2] * p[..., 2]
        + m[..., 2, 3],
    )


def transform_vector(m, v):
    r = m[..., :3, :3]
    return vec3(
        r[..., 0, 0] * v[..., 0] + r[..., 0, 1] * v[..., 1] + r[..., 0, 2] * v[..., 2],
        r[..., 1, 0] * v[..., 0] + r[..., 1, 1] * v[..., 1] + r[..., 1, 2] * v[..., 2],
        r[..., 2, 0] * v[..., 0] + r[..., 2, 1] * v[..., 1] + r[..., 2, 2] * v[..., 2],
    )


def transform_normal(m_inv, n):
    """Transform a normal given the INVERSE of the forward matrix."""
    r = m_inv[..., :3, :3]
    return vec3(
        r[..., 0, 0] * n[..., 0] + r[..., 1, 0] * n[..., 1] + r[..., 2, 0] * n[..., 2],
        r[..., 0, 1] * n[..., 0] + r[..., 1, 1] * n[..., 1] + r[..., 2, 1] * n[..., 2],
        r[..., 0, 2] * n[..., 0] + r[..., 1, 2] * n[..., 1] + r[..., 2, 2] * n[..., 2],
    )


# ---------------------------------------------------------------------------
# Orthonormal frames (branchless Duff et al. 2017)
# ---------------------------------------------------------------------------

def coordinate_system(n):
    """Build tangent/bitangent for unit normal n.  Returns (s, t)."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = vec3(1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0])
    t = vec3(b, sign + n[..., 1] ** 2 * a, -n[..., 1])
    return s, t


def to_local(n, s, t, v):
    """World vector v -> local frame where n = +Z."""
    return vec3(dot(v, s), dot(v, t), dot(v, n))


def to_world(n, s, t, v):
    return (
        s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]
    )


# ---------------------------------------------------------------------------
# Reflection / refraction / Fresnel
# ---------------------------------------------------------------------------

def reflect(wi, n):
    """Reflect direction ``wi`` (pointing away from surface) about normal n."""
    return 2.0 * dot(wi, n, keepdims=True) * n - wi


def reflect_local(wi):
    """Reflect about +Z in local frame."""
    return vec3(-wi[..., 0], -wi[..., 1], wi[..., 2])


def refract_local(wi, cos_theta_t, eta_ti):
    """Refract in local frame. ``eta_ti`` = eta_transmitted_to_incident ratio
    applied to the tangential component; cos_theta_t carries the sign of the
    transmitted z (negative of incident side)."""
    return vec3(-eta_ti * wi[..., 0], -eta_ti * wi[..., 1], cos_theta_t)


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance for a dielectric.

    Returns (F, cos_theta_t, eta_it, eta_ti) following Mitsuba's fresnel():
    eta is the relative IOR (transmitted / incident for cos_theta_i > 0).
    cos_theta_t has the opposite sign of cos_theta_i.
    """
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = jnp.where(outside, eta, rcp_eta)
    eta_ti = jnp.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    abs_cos_i = jnp.abs(cos_theta_i)
    cos_theta_t = safe_sqrt(cos_theta_t_sqr)

    # max() guards keep 0/0 (grazing + TIR boundary) out of forward AND
    # reverse mode; those lanes are overwritten by the TIR select below.
    rs = (abs_cos_i - eta_it * cos_theta_t) / jnp.maximum(
        abs_cos_i + eta_it * cos_theta_t, 1e-9
    )
    rp = (eta_it * abs_cos_i - cos_theta_t) / jnp.maximum(
        eta_it * abs_cos_i + cos_theta_t, 1e-9
    )
    F = 0.5 * (rs * rs + rp * rp)
    F = jnp.where(cos_theta_t_sqr <= 0.0, 1.0, F)  # total internal reflection
    cos_theta_t_signed = jnp.where(cos_theta_i >= 0.0, -cos_theta_t, cos_theta_t)
    return F, cos_theta_t_signed, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized Fresnel reflectance for a conductor with complex IOR
    eta + i*k (per channel; eta/k broadcast against cos_theta_i[..., None])."""
    c2 = cos_theta_i * cos_theta_i
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k

    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * cos_theta_i
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-12)
    return 0.5 * (rs + rp)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def mis_power_heuristic(pdf_a, pdf_b):
    """Power heuristic with beta=2 (Mitsuba's default for path MIS)."""
    a2 = pdf_a * pdf_a
    w = a2 / jnp.maximum(a2 + pdf_b * pdf_b, 1e-20)
    return jnp.where(pdf_a > 0.0, w, 0.0)


def luminance(rgb):
    return (
        rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169
    )


def small_table_lookup(table, idx, max_unroll=32):
    """``table[idx]`` as a static select chain when the table is small.

    A masked select chain fuses into the surrounding elementwise code;
    big tables fall back to a real gather.  Whether the chain still beats
    a gather on the GPU is not measured (ROADMAP S3).  Callers must
    pre-clip ``idx`` into range (out-of-range lanes produce zeros here
    instead of clamping).
    """
    K = table.shape[0]
    if K == 0 or K > max_unroll:
        return table[idx]
    extra = (1,) * (table.ndim - 1)
    out = jnp.zeros(idx.shape + table.shape[1:], table.dtype)
    for k in range(K):
        m = (idx == k).reshape(idx.shape + extra)
        out = jnp.where(m, table[k], out)
    return out
