"""Analytic primitive intersectors, SoA over rays.

JAX equivalents of Mitsuba's C++ shape plugins consumed by the
reference scenes (sphere/rectangle/cone/cylinder/disk — SURVEY.md §2b shapes
row).  All analytic shapes are canonical in object space:

  sphere:    |p| = 1
  rectangle: z = 0, |x| <= 1, |y| <= 1   (normal +z)
  disk:      z = 0, x^2 + y^2 <= 1       (normal +z)
  cylinder:  x^2 + y^2 = 1, 0 <= z <= 1
  cone:      x^2 + y^2 = (1 - z)^2, 0 <= z <= 1 (base radius 1 at z=0,
             apex (0,0,1))
  roundcone: swept sphere from (0,0,0) radius r0 to (0,0,1) radius r1
             (per-prim r0/r1 parameters; exact B-spline curve segments —
             shadow_art.xml:60-62 'bsplinecurve' via Mitsuba's swept-sphere
             curve semantics)

Each intersector returns (t, u, v) with t = +inf on miss.  Normal/uv
reconstruction happens in interaction.py from the hit point.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.core.math import dot, safe_sqrt

# Miss sentinel: large-but-FINITE so reverse-mode autodiff never sees
# inf * 0 cotangents (inf t values poison jax.grad through the bounce loop).
INF = jnp.float32(1e8)
_EPS = 1e-6


def _select_root(t0, t1, valid0, valid1):
    """Pick nearest valid root of a quadratic."""
    t = jnp.where(valid0, t0, jnp.where(valid1, t1, INF))
    return t


def ray_sphere(o, d, tmin, tmax):
    """Unit sphere at origin.  o, d: (..., 3)."""
    b = 2.0 * dot(o, d)
    a = dot(d, d)
    c = dot(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    hit = disc >= 0.0
    sqrt_disc = safe_sqrt(disc)
    q = -0.5 * (b + jnp.sign(b) * sqrt_disc)
    qa = q / jnp.maximum(a, 1e-9)
    cq = c / jnp.where(jnp.abs(q) < 1e-9, jnp.where(q < 0, -1e-9, 1e-9), q)
    t0 = jnp.minimum(qa, cq)
    t1 = jnp.maximum(qa, cq)
    v0 = hit & (t0 > tmin) & (t0 < tmax)
    v1 = hit & (t1 > tmin) & (t1 < tmax)
    t = _select_root(t0, t1, v0, v1)
    return t, jnp.zeros_like(t), jnp.zeros_like(t)


def ray_rectangle(o, d, tmin, tmax):
    dz = d[..., 2]
    t = -o[..., 2] / jnp.where(jnp.abs(dz) < 1e-9, jnp.where(dz < 0, -1e-9, 1e-9), dz)
    x = o[..., 0] + t * d[..., 0]
    y = o[..., 1] + t * d[..., 1]
    ok = (
        (jnp.abs(dz) > 1e-20)
        & (t > tmin)
        & (t < tmax)
        & (jnp.abs(x) <= 1.0)
        & (jnp.abs(y) <= 1.0)
    )
    t = jnp.where(ok, t, INF)
    return t, 0.5 * (x + 1.0), 0.5 * (y + 1.0)


def ray_disk(o, d, tmin, tmax):
    dz = d[..., 2]
    t = -o[..., 2] / jnp.where(jnp.abs(dz) < 1e-9, jnp.where(dz < 0, -1e-9, 1e-9), dz)
    x = o[..., 0] + t * d[..., 0]
    y = o[..., 1] + t * d[..., 1]
    r2 = x * x + y * y
    ok = (jnp.abs(dz) > 1e-20) & (t > tmin) & (t < tmax) & (r2 <= 1.0)
    t = jnp.where(ok, t, INF)
    return t, safe_sqrt(r2), jnp.arctan2(y, x) / (2.0 * jnp.pi) + 0.5


def ray_cylinder(o, d, tmin, tmax):
    ox, oy = o[..., 0], o[..., 1]
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - 1.0
    disc = b * b - 4.0 * a * c
    hit = (disc >= 0.0) & (a > 1e-20)
    sq = safe_sqrt(disc)
    t0 = (-b - sq) / jnp.maximum(2.0 * a, 1e-9)
    t1 = (-b + sq) / jnp.maximum(2.0 * a, 1e-9)

    def z_ok(t):
        z = o[..., 2] + t * d[..., 2]
        return (z >= 0.0) & (z <= 1.0)

    v0 = hit & (t0 > tmin) & (t0 < tmax) & z_ok(t0)
    v1 = hit & (t1 > tmin) & (t1 < tmax) & z_ok(t1)
    t = _select_root(t0, t1, v0, v1)
    z = o[..., 2] + t * d[..., 2]
    phi = jnp.arctan2(o[..., 1] + t * d[..., 1], o[..., 0] + t * d[..., 0])
    return t, phi / (2.0 * jnp.pi) + 0.5, z


def ray_cone(o, d, tmin, tmax):
    """x^2 + y^2 = (1 - z)^2 for z in [0, 1]."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    k = 1.0 - oz
    a = dx * dx + dy * dy - dz * dz
    b = 2.0 * (ox * dx + oy * dy + k * dz)
    c = ox * ox + oy * oy - k * k
    disc = b * b - 4.0 * a * c
    lin = jnp.abs(a) < 1e-12
    hit = (disc >= 0.0) & ~lin
    sq = safe_sqrt(disc)
    a_safe = jnp.where(lin, 1.0, a)
    r0 = (-b - sq) / (2.0 * a_safe)
    r1 = (-b + sq) / (2.0 * a_safe)
    t0 = jnp.minimum(r0, r1)
    t1 = jnp.maximum(r0, r1)
    # Linear case (ray parallel to cone surface): single root  c + b t = 0.
    t_lin = -c / jnp.where(jnp.abs(b) < 1e-9, jnp.where(b < 0, -1e-9, 1e-9), b)

    def z_ok(t):
        z = oz + t * dz
        return (z >= 0.0) & (z <= 1.0)

    v0 = hit & (t0 > tmin) & (t0 < tmax) & z_ok(t0)
    v1 = hit & (t1 > tmin) & (t1 < tmax) & z_ok(t1)
    vl = lin & (t_lin > tmin) & (t_lin < tmax) & z_ok(t_lin)
    t = _select_root(t0, t1, v0, v1)
    t = jnp.where(vl & ~(v0 | v1), t_lin, t)
    z = oz + t * dz
    phi = jnp.arctan2(oy + t * dy, ox + t * dx)
    return t, phi / (2.0 * jnp.pi) + 0.5, z


def ray_roundcone(o, d, r0, r1, tmin, tmax):
    """Swept sphere (round cone) from center (0,0,0) radius r0 to center
    (0,0,1) radius r1 — the EXACT surface of a linear swept-sphere curve
    segment (Mitsuba `bsplinecurve` geometry, shadow_art.xml:60-62; the
    round-3 tube tessellation is replaced by this closed form).

    The side surface is the envelope of the sphere family
    ``|p - (0,0,s)|^2 = (r0 + s*dr)^2`` (dr = r1 - r0): a point p lies on
    it iff that quadratic in s has a double root, i.e.
    ``(p_z + r0*dr)^2 = (1 - dr^2) * (|p|^2 - r0^2)``.  Substituting
    p = o + t d gives the quadratic solved below; the double-root location
    ``s* = (p_z + r0*dr) / (1 - dr^2)`` is the tangency parameter, and a
    side hit is real only for s* in [0, 1] (outside that band the surface
    is the endpoint sphere caps, gated by the same s*).  Returns
    (t, u, v): u = clamp(s*, 0, 1) along the axis, v = azimuth in [0, 1).
    Requires |dr| < 1 (guaranteed by the builder: segment length is
    normalized to 1 and radii vary slowly along a B-spline).
    """
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    dr = r1 - r0
    d2c = 1.0 - dr * dr  # > 0 for valid (non-degenerate) segments
    dd = dx * dx + dy * dy + dz * dz
    od_ = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    b1 = oz + r0 * dr

    def safe_div(num, den, eps=1e-12):
        return num / jnp.where(jnp.abs(den) < eps,
                               jnp.where(den < 0, -eps, eps), den)

    # ---- side (envelope cone):  k2 t^2 + 2 k1 t + k0 = 0 -----------------
    k2 = d2c * dd - dz * dz
    k1 = d2c * od_ - dz * b1
    k0 = d2c * (oo - r0 * r0) - b1 * b1
    disc = k1 * k1 - k2 * k0
    sq = safe_sqrt(disc)
    ta = safe_div(-k1 - sq, k2)
    tb = safe_div(-k1 + sq, k2)
    t0 = jnp.minimum(ta, tb)
    t1 = jnp.maximum(ta, tb)

    def side_ok(t):
        s = safe_div(b1 + t * dz, d2c)
        return (disc >= 0.0) & (jnp.abs(k2) >= 1e-12) & (s >= 0.0) & (s <= 1.0) \
            & (t > tmin) & (t < tmax)

    t_side = _select_root(t0, t1, side_ok(t0), side_ok(t1))

    # ---- end caps: only the hull portion where the tangency parameter of
    # the hit point falls outside [0, 1] is actual surface (the rest of the
    # endpoint spheres is interior — accepting it would report hits inside
    # the volume and self-shadow the curve).
    def cap(cz, r, outside_lo):
        b = od_ - cz * dz
        c = oo - 2.0 * cz * oz + cz * cz - r * r
        dc = b * b - dd * c
        sqc = safe_sqrt(dc)
        u0 = safe_div(-b - sqc, dd)
        u1 = safe_div(-b + sqc, dd)

        def ok(t):
            s = safe_div(b1 + t * dz, d2c)
            band = (s < 0.0) if outside_lo else (s > 1.0)
            return (dc >= 0.0) & band & (t > tmin) & (t < tmax)

        return _select_root(u0, u1, ok(u0), ok(u1))

    t_a = cap(0.0, r0, True)
    t_b = cap(1.0, r1, False)

    t = jnp.minimum(t_side, jnp.minimum(t_a, t_b))
    s_hit = jnp.clip(safe_div(b1 + t * dz, d2c), 0.0, 1.0)
    phi = jnp.arctan2(oy + t * dy, ox + t * dx)
    u = jnp.where(t < INF, s_hit, 0.0)
    v = jnp.where(t < INF, phi / (2.0 * jnp.pi) + 0.5, 0.0)
    return t, u, v


def ray_triangle(o, d, p0, e1, e2, tmin, tmax):
    """Moller-Trumbore.  All args broadcastable to (..., 3).

    Returns (t, u, v) with t=inf on miss; u, v are barycentrics of e1, e2.
    """
    pvec = jnp.cross(d, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / jnp.where(
        jnp.abs(det) < 1e-9, jnp.where(det < 0, -1e-9, 1e-9), det
    )
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    t = jnp.where(ok, t, INF)
    return t, u, v


def ray_aabb(o, inv_d, bb_min, bb_max, tmin, tmax):
    """Slab test.  Returns (hit, t_near)."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    tsm = jnp.minimum(t0, t1)
    tbg = jnp.maximum(t0, t1)
    t_near = jnp.maximum(jnp.max(tsm, axis=-1), tmin)
    t_far = jnp.minimum(jnp.min(tbg, axis=-1), tmax)
    return t_near <= t_far, t_near
