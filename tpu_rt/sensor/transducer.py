"""Transducer array geometry + ray generation (emitter/sensor pair).

JAX rebuild of the reference's CustomEmitter
(/root/reference/CustomEmmitter.py:5-128) and UltraSensor (pyc-only class
registered at USMain.py:17; SURVEY.md §2a#5): linear or convex element
arrays, plane-wave steering with per-element delays t = -x sin(psi) / c,
cosine directivity weighting, in-element jitter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_rt.core.math import normalize, transform_point, transform_vector
from tpu_rt.core.warps import square_to_uniform_hemisphere
from tpu_rt.scene.types import UltrasoundConfig


def element_geometry(n_elements, pitch, radius, opening_angle_deg=0.0):
    """Element center positions and normals in transducer-local space.

    Linear array when radius is inf or 0 (both conventions appear in the
    reference: CustomEmmitter.py:33 tests radius == 0, the UltraSensor pyc
    tests isinf(radius)); convex arc otherwise.
    Returns (positions [N, 3], normals [N, 3]).
    """
    i = jnp.arange(n_elements, dtype=jnp.float32)
    linear = jnp.logical_or(jnp.isinf(radius), radius == 0.0)

    x_lin = pitch * (i - (n_elements - 1) * 0.5)
    pos_lin = jnp.stack([x_lin, jnp.zeros_like(x_lin), jnp.zeros_like(x_lin)], -1)
    nrm_lin = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), pos_lin.shape)

    r_safe = jnp.where(linear, 1.0, radius)
    if opening_angle_deg and opening_angle_deg > 0.0:
        span = jnp.deg2rad(opening_angle_deg)
        thetas = jnp.linspace(-span / 2, span / 2, n_elements)
    else:
        # UltraSensor convention: theta = (i - N/2) * pitch / R
        thetas = (i - n_elements / 2.0) * pitch / r_safe
    x_cvx = r_safe * jnp.sin(thetas)
    z_cvx = r_safe * (1.0 - jnp.cos(thetas))
    pos_cvx = jnp.stack([x_cvx, jnp.zeros_like(x_cvx), z_cvx], -1)
    nrm_cvx = normalize(
        jnp.stack([jnp.sin(thetas), jnp.zeros_like(thetas), jnp.cos(thetas)], -1)
    )

    lin_b = linear[..., None, None] if jnp.ndim(linear) else linear
    pos = jnp.where(lin_b, pos_lin, pos_cvx)
    nrm = jnp.where(lin_b, nrm_lin, nrm_cvx)
    return pos, nrm


def plane_wave_rays(us: UltrasoundConfig, jitter=None):
    """Primary rays for the (angle x element) acquisition grid.

    Matches CustomIntegrator.simulate_acquisition ray setup
    (/root/reference/CustomIntegrator.py:84-107): element x positions from
    the integrator pitch/n_elements, direction (sin a, 0, cos a), transmit
    delay t = x sin(a) / c, all mapped by the sensor to_world transform.

    Args:
      jitter: optional [A*E, 2] uniform samples for in-element jitter
        (None = ray from element center like the reference).
    Returns dict with o [A*E,3], d [A*E,3], tx_delay [A*E], angle_idx,
    elem_idx, trans_normal_world [3].
    """
    A = us.n_angles
    E = us.n_elements
    angles_rad = jnp.deg2rad(us.angles)

    # Element placement: linear row (the reference integrator's layout,
    # CustomIntegrator.py:84) or a convex arc when the sensor declares a
    # finite radius (extends the CustomEmitter/UltraSensor convex support
    # to the acquisition path).
    pos_local, _nrm = element_geometry(E, us.pitch, us.radius, us.opening_angle)

    ang = jnp.repeat(angles_rad, E)  # [A*E]
    pe = jnp.tile(pos_local, (A, 1))
    angle_idx = jnp.repeat(jnp.arange(A), E)
    elem_idx = jnp.tile(jnp.arange(E), A)

    o_local = pe
    if jitter is not None:
        dx = (jitter[:, 0] - 0.5) * us.elements_width
        dy = (jitter[:, 1] - 0.5) * us.elements_height
        o_local = o_local + jnp.stack([dx, dy, jnp.zeros_like(dx)], -1)
    d_local = jnp.stack([jnp.sin(ang), jnp.zeros_like(ang), jnp.cos(ang)], -1)

    m = us.sensor_to_world
    o = transform_point(m, o_local)
    d = normalize(transform_vector(m, d_local))
    # Plane-wave coherence delay: projection of the element position onto
    # the propagation direction (reduces to x sin(a)/c for linear arrays,
    # CustomIntegrator.py:87).
    tx_delay = (pe[:, 0] * jnp.sin(ang) + pe[:, 2] * jnp.cos(ang)) / us.sound_speed
    trans_n = normalize(transform_vector(m, jnp.asarray([0.0, 0.0, 1.0])))
    return dict(
        o=o, d=d, tx_delay=tx_delay, angle_idx=angle_idx, elem_idx=elem_idx,
        trans_normal=trans_n, x_elem=pos_local[:, 0], elem_pos=pos_local,
    )


def emitter_sample_ray(us: UltrasoundConfig, key, n):
    """CustomEmitter.sample_ray semantics (CustomEmmitter.py:81-107):
    random element + in-element jitter, random steering angle psi in
    [steering_angle_min, steering_angle_max], delay -x sin(psi)/c, cosine
    directivity weight / number_of_total_rays.

    Returns (o [n,3], d [n,3], time_delay [n], weight [n]).
    """
    k1, k2, k3 = jax.random.split(key, 3)
    E = us.n_elements
    pos, nrm = element_geometry(E, us.pitch, us.radius, us.opening_angle)
    idx = jax.random.randint(k1, (n,), 0, E)
    center = pos[idx]
    normal = nrm[idx]
    j = jax.random.uniform(k2, (n, 2))
    dx = (j[:, 0] - 0.5) * us.elements_width
    dy = (j[:, 1] - 0.5) * us.elements_height
    p = center + jnp.stack([dx, dy, jnp.zeros_like(dx)], -1)

    psi_min = jnp.deg2rad(us.steering_angle_min)
    psi_max = jnp.deg2rad(us.steering_angle_max)
    psi = psi_min + jax.random.uniform(k3, (n,)) * (psi_max - psi_min)
    d = jnp.stack([jnp.sin(psi), jnp.zeros_like(psi), jnp.cos(psi)], -1)
    delay = -(p[:, 0] * jnp.sin(psi)) / us.sound_speed  # CustomEmmitter.py:93
    n_total = E * max(us.number_of_rays_per_element, 1)
    fd = jnp.maximum(0.0, jnp.sum(d * normal, axis=-1))
    weight = fd / n_total

    m = us.sensor_to_world
    o_w = transform_point(m, p)
    d_w = normalize(transform_vector(m, d))
    return o_w, d_w, delay, weight


def sensor_sample_ray(us: UltrasoundConfig, key, n, time=0.0):
    """UltraSensor.sample_ray semantics (pyc, SURVEY.md §2a#5): element from
    the position sample, linear/convex placement, in-element jitter, uniform
    hemisphere direction, weight = cos(2 pi f t) * |d_local.z| * directivity.
    """
    k1, k2, k3 = jax.random.split(key, 3)
    E = us.num_elements_lateral
    pos, nrm = element_geometry(E, us.pitch, us.radius, us.opening_angle)
    u = jax.random.uniform(k1, (n,))
    idx = jnp.minimum((u * E).astype(jnp.int32), E - 1)
    center = pos[idx]
    j = jax.random.uniform(k2, (n, 2))
    dx = (j[:, 0] - 0.5) * us.elements_width
    dy = (j[:, 1] - 0.5) * us.elements_height
    p = center + jnp.stack([dx, dy, jnp.zeros_like(dx)], -1)

    d_local = square_to_uniform_hemisphere(jax.random.uniform(k3, (n, 2)))
    weight = (
        jnp.cos(2.0 * jnp.pi * us.frequency * time)
        * jnp.abs(d_local[:, 2])
        * us.directivity
    )
    m = us.sensor_to_world
    return (
        transform_point(m, p),
        normalize(transform_vector(m, d_local)),
        weight,
    )
