"""Projective (visibility-discontinuity) gradients for curve occluders.

Mitsuba's ``direct_projective`` integrator (reference
``scenes/shadow_art.xml:10``) exists precisely to estimate derivatives
across visibility discontinuities — moving an occluder changes the image
only through where its shadow boundary falls, and the hard visibility
indicator has zero gradient almost everywhere.  Mitsuba solves this with
projective/boundary sampling inside Dr.Jit; the reference repo itself
never backpropagates through shadow_art, so the capability contract here
is the *derivative*, not Mitsuba's particular estimator.

JAX design — analytic edge softening over the EXACT curve prims:

* The scene's swept-sphere curve segments (``scene/build.py`` bakes
  Mitsuba ``bsplinecurve`` spans as round-cone prims: world axis
  ``a -> a + to_world[:, 2]``, world radii ``an_param * |axis|``) admit a
  closed-form signed clearance between any shadow segment and the curve
  surface: segment↔segment closest distance minus the local radius.
* The NEE visibility of curve occluders is replaced by
  ``sigmoid(clearance / width)``: smooth in the curve's position AND
  radii, so ``jax.grad`` yields the boundary ("silhouette") derivative
  that the hard indicator hides.  As ``width -> 0`` the render converges
  to the hard render (bias is O(width), confined to a penumbra band),
  and the gradient converges to the true visibility derivative.
* All other prims keep the hard shadow test (a host-side geometry with
  the curve prims displaced out of the scene), so only the curve term is
  differentiable — exactly the shadow_art use case, where the occluder
  IS the curve (``scenes/shadow_art.xml:60-62``).

This is the standard reparameterization-free "soft shadow" estimator: a
vectorized closed form with no data-dependent control flow, which maps
onto the device as a [rays x segments] broadcast — unlike Mitsuba's
boundary sampling, which walks silhouette edges with divergent loops.

Validation: ``tests/test_projective.py`` compares ``jax.grad`` of a
soft-shadow render against central finite differences of the HARD render
on an occluder translation (the FD of the Monte-Carlo image is a valid —
quantized — estimator of the true derivative at high sample counts).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from tpu_rt.scene.types import CURVE, Geometry, Scene


def curve_segments(geom: Geometry):
    """Extract the world-space swept-sphere segments of all CURVE prims.

    Host-side split (the CURVE mask must be concrete).  Returns a dict of
    arrays — ``a``/``b`` [C, 3] axis endpoints, ``r0``/``r1`` [C] world
    radii — ready to be perturbed and differentiated: pass the (traced)
    result to :func:`render_soft`.
    """
    an_type = np.asarray(geom.an_type)
    mask = an_type == CURVE
    if not mask.any():
        raise ValueError("scene has no bsplinecurve prims")
    tw = np.asarray(geom.an_to_world)[mask]
    par = np.asarray(geom.an_param)[mask]
    a = tw[:, :3, 3]
    axis = tw[:, :3, 2]
    h = np.linalg.norm(axis, axis=-1)
    return dict(
        a=jnp.asarray(a),
        b=jnp.asarray(a + axis),
        r0=jnp.asarray(par[:, 0] * h),
        r1=jnp.asarray(par[:, 1] * h),
    )


def geometry_without_curves(geom: Geometry) -> Geometry:
    """Host-side copy of ``geom`` whose CURVE prims can never occlude.

    The prims are displaced 1e7 units away through ``an_to_object`` (the
    array shapes — and therefore every compiled program — are unchanged;
    the BVH keeps the old conservative bounds).  Phantom intersections at
    t ~ 1e7 are rejected by every shadow query's finite tmax.
    """
    an_type = np.asarray(geom.an_type)
    mask = an_type == CURVE
    if not mask.any():
        return geom
    to_obj = np.array(geom.an_to_object)
    to_obj[mask, :3, 3] += 1e7
    return geom.replace(an_to_object=jnp.asarray(to_obj))


def _dot(x, y):
    return jnp.sum(x * y, axis=-1)


def segment_clearance(p, q, curves):
    """Signed clearance between shadow segments [p, q] ([N, 3]) and every
    curve segment: min over segments of (closest segment<->axis distance
    minus the local swept radius).  Negative inside the swept volume.

    Closest-point solve is the standard two-pass clamped form (Ericson,
    Real-Time Collision Detection §5.1.9) with denominators clamped away
    from zero so reverse-mode stays finite (CLAUDE.md NaN-guard rules).
    Returns clearance [N].
    """
    a, b = curves["a"], curves["b"]  # [C, 3]
    r0, r1 = curves["r0"], curves["r1"]  # [C]
    d1 = (q - p)[:, None, :]  # [N, 1, 3] shadow segment
    d2 = (b - a)[None, :, :]  # [1, C, 3] curve axis
    r = p[:, None, :] - a[None, :, :]  # [N, C, 3]
    A = jnp.maximum(_dot(d1, d1), 1e-12)
    E = jnp.maximum(_dot(d2, d2), 1e-12)
    B = _dot(d1, d2)
    C = _dot(d1, r)
    F = _dot(d2, r)
    den = A * E - B * B
    s = jnp.clip((B * F - C * E) / jnp.maximum(den, 1e-12), 0.0, 1.0)
    t = jnp.clip((B * s + F) / E, 0.0, 1.0)
    s = jnp.clip((B * t - C) / A, 0.0, 1.0)
    diff = (p[:, None, :] + s[..., None] * d1) - (
        a[None, :, :] + t[..., None] * d2
    )
    dist = jnp.sqrt(jnp.maximum(_dot(diff, diff), 1e-18))
    clear = dist - (r0[None, :] + t * (r1 - r0)[None, :])
    return jnp.min(clear, axis=1)


def curve_soft_visibility(curves, o, d, dist, width):
    """Smooth visibility factor in [0, 1] of the shadow segment
    ``o -> o + dist * d`` against the curve set: ``sigmoid(c / width)``
    of the minimum clearance ``c``."""
    p = o
    q = o + dist[..., None] * d
    c = segment_clearance(p, q, curves)
    return jax.nn.sigmoid(c / width)


def render_soft(scene: Scene, curves, spp=8, seed=0, width=0.01,
                max_depth=2, shadow_geom=None):
    """Differentiable direct/path render with soft curve-shadow visibility.

    ``curves`` is the (possibly perturbed, traced) dict from
    :func:`curve_segments` — gradients flow to its ``a``/``b``/``r0``/
    ``r1`` arrays through the NEE visibility term.  The primal image
    converges to the hard render as ``width -> 0``.

    ``shadow_geom`` (from :func:`geometry_without_curves`) must be built
    OUTSIDE any trace; it is derived here when None.  Box-filter,
    pixel-aligned sampling (shadow_art.xml uses a box rfilter).  Note the
    curve prims' own camera-facing silhouette stays hard — losses should
    be taken over image regions showing the *shadow*, not the occluder.
    """
    from tpu_rt.integrator.path import path_trace
    from tpu_rt.sensor import camera as cam

    if shadow_geom is None:
        shadow_geom = geometry_without_curves(scene.geometry)
    c = scene.camera
    H, W = c.height, c.width
    xy_int = jnp.stack(
        jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), axis=-1
    ).reshape(-1, 2).astype(jnp.float32)
    soft = dict(curves, width=width)

    def one_pass(carry, key):
        k_jit, k_path = jax.random.split(key)
        jitter = jax.random.uniform(k_jit, xy_int.shape)
        o, d, t0, t1 = cam.sample_ray_extents(c, xy_int + jitter)
        L, _ = path_trace(scene, o, d, k_path, max_depth=max_depth,
                          tmin0=t0, tmax0=t1, shadow_geom=shadow_geom,
                          soft_curves=soft)
        return carry + L, None

    keys = jax.random.split(jax.random.PRNGKey(seed), spp)
    acc, _ = jax.lax.scan(one_pass, jnp.zeros((H * W, 3)), keys)
    return (acc / spp).reshape(H, W, 3)
