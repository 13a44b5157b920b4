"""Warping functions mapping [0,1)^2 samples to distributions on disks,
hemispheres and spheres, with matching pdfs.

JAX equivalents of the mi.warp.* functions the reference consumes
(square_to_uniform_disk_concentric at /root/reference/CustomBSDF.py:48,
square_to_uniform_hemisphere in the UltraSensor pyc — see SURVEY.md §2b).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.core.math import safe_sqrt, vec3

INV_PI = 1.0 / jnp.pi
INV_TWO_PI = 1.0 / (2.0 * jnp.pi)
INV_FOUR_PI = 1.0 / (4.0 * jnp.pi)


def square_to_uniform_disk_concentric(sample):
    """Concentric (Shirley) mapping of the unit square to the unit disk."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    # Handle degenerate origin to avoid 0/0.
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = jnp.abs(x) > jnp.abs(y)
    r = jnp.where(quadrant_x, x, y)
    phi = jnp.where(
        quadrant_x,
        (jnp.pi / 4.0) * (y / jnp.where(x == 0.0, 1.0, x)),
        (jnp.pi / 2.0) - (jnp.pi / 4.0) * (x / jnp.where(y == 0.0, 1.0, y)),
    )
    phi = jnp.where(is_zero, 0.0, phi)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def square_to_uniform_hemisphere(sample):
    """Uniform direction on the +Z hemisphere."""
    z = sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def square_to_uniform_hemisphere_pdf():
    return INV_TWO_PI


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted direction on the +Z hemisphere (via concentric disk)."""
    d = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return vec3(d[..., 0], d[..., 1], z)


def square_to_cosine_hemisphere_pdf(wo):
    return jnp.maximum(wo[..., 2], 0.0) * INV_PI


def square_to_uniform_sphere(sample):
    z = 1.0 - 2.0 * sample[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def square_to_uniform_sphere_pdf():
    return INV_FOUR_PI


def square_to_uniform_triangle(sample):
    """Barycentric (u, v) uniformly over a triangle (sqrt parameterization)."""
    t = safe_sqrt(1.0 - sample[..., 0])
    u = 1.0 - t
    v = t * sample[..., 1]
    return jnp.stack([u, v], axis=-1)


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in a cone around +Z with cos(angle) >= cos_cutoff."""
    z = 1.0 + sample[..., 0] * (cos_cutoff - 1.0)
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * jnp.pi * sample[..., 1]
    return vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWO_PI / (1.0 - cos_cutoff)
