"""Perspective camera ray generation (JAX equivalent of Mitsuba's
perspective sensor used by the optical scenes, cf. scenes/cbox.xml:11-32).

Convention checks (tests/test_render_optical.py): with Mitsuba's look_at
(X = cross(up, dir) = "left"), film u (left->right) increases along
+X_camera, film v (top->bottom) decreases along +Y_camera, so the cbox red
wall (world x=+1, cbox_redwall.obj) lands on the image left.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.core.math import normalize, transform_point, transform_vector
from tpu_rt.scene.types import Camera


def sample_ray(cam: Camera, film_xy):
    """Generate world-space camera rays.

    Args:
      cam: Camera.
      film_xy: [N, 2] continuous film positions in pixels ([0,W) x [0,H),
        (0,0) = top-left).
    Returns (o [N,3], d [N,3]).
    """
    o, d, _, _ = sample_ray_extents(cam, film_xy)
    return o, d


def sample_ray_extents(cam: Camera, film_xy):
    """Camera rays plus Mitsuba clip-plane extents.

    Mitsuba's perspective sensor sets ray.mint/maxt from near_clip/far_clip
    measured along the camera z axis (scenes/cbox.xml:13-14): for the
    normalized world direction whose camera-space z component is
    1/|d_cam|, t = near * |d_cam| reaches the z = near plane.
    Returns (o [N,3], d [N,3], tmin [N], tmax [N]).
    """
    u = film_xy[..., 0] / cam.width
    v = film_xy[..., 1] / cam.height
    dx = (2.0 * u - 1.0) * cam.tan_fov_x
    dy = (1.0 - 2.0 * v) * cam.tan_fov_y
    d_cam = jnp.stack([dx, dy, jnp.ones_like(u)], axis=-1)
    d = normalize(transform_vector(cam.to_world, d_cam))
    o = jnp.broadcast_to(cam.to_world[:3, 3], d.shape)
    inv_z = jnp.sqrt(dx * dx + dy * dy + 1.0)  # |d_cam| = 1 / dz_normalized
    return o, d, cam.near * inv_z, cam.far * inv_z
