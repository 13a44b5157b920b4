"""Integrator dispatch (equivalent of Mitsuba's integrator plugin factory)."""

from tpu_rt.scene.types import (
    INTEGRATOR_DIRECT,
    INTEGRATOR_DIRECT_PROJECTIVE,
    INTEGRATOR_PATH,
    INTEGRATOR_STOKES,
    INTEGRATOR_ULTRASOUND,
    Scene,
)


def _finalize(scene: Scene, img):
    """Develop-time pixel-format conversion: hdrfilm pixel_format =
    "luminance" (reference US film XMLs, /root/reference/USMain.py:62)
    collapses RGB to a single ITU-R BT.709 luminance channel (H, W, 1)."""
    cam = scene.camera
    if (cam is not None and getattr(cam, "pixel_format", "rgb") == "luminance"
            and img.ndim == 3 and img.shape[-1] == 3):
        from tpu_rt.core.math import luminance

        return luminance(img)[..., None]
    return img


def render(scene: Scene, spp=None, seed=0, **kwargs):
    """Render a scene with its configured integrator (mi.render equivalent).

    Optical integrators return an (H, W, 3) image ((H, W, 4, 3) Stokes for
    the stokes wrapper; (H, W, 1) when hdrfilm requests luminance); the
    ultrasound integrator returns the B-mode display image.
    """
    if scene.integrator == INTEGRATOR_DIRECT_PROJECTIVE:
        # Mitsuba's direct_projective (shadow_art.xml:10) differs from
        # `direct` only in HOW discontinuity (silhouette) gradients are
        # estimated under differentiation; its PRIMAL image is the direct
        # integrator's.  tpu_rt renders it as direct and differentiates the
        # continuous terms via jax.grad (detached geometry) — projective
        # silhouette gradients are a documented no-op, matching the
        # reference's actual usage (shadow_art is never differentiated
        # there).
        scene = scene.replace(integrator=INTEGRATOR_DIRECT)
    if scene.integrator in (INTEGRATOR_PATH, INTEGRATOR_DIRECT):
        from tpu_rt.integrator.path import render as render_path

        max_depth = 2 if scene.integrator == INTEGRATOR_DIRECT else None
        return _finalize(scene, render_path(
            scene, spp=spp, seed=seed, max_depth=max_depth, **kwargs))
    if scene.integrator == INTEGRATOR_STOKES:
        from tpu_rt.integrator.stokes import render_stokes

        return render_stokes(scene, spp=spp, seed=seed, **kwargs)
    if scene.integrator == INTEGRATOR_ULTRASOUND:
        from tpu_rt.us.pipeline import us_render

        img, _, _ = us_render(scene, seed=seed, **kwargs)
        return img
    raise ValueError(f"unknown integrator {scene.integrator}")
