"""End-to-end ultrasound pipeline: acquisition -> DAS -> B-mode.

Mirrors /root/reference/USMain.py us_render (:92-252): simulate the
acquisition, beamform over a lambda/4 grid spanning x in [-4, 4] cm and
z in [0.1, 50] mm (:182-199), envelope-detect and 60 dB log-compress
(:213-219).  Returns the display image (depth down) plus the raw buffers.
"""

from __future__ import annotations

import weakref

import jax
import jax.numpy as jnp

from tpu_rt.integrator.ultrasound import simulate_acquisition
from tpu_rt.scene.types import Scene
from tpu_rt.us.beamform import bmode_pipeline, grid_scan


def us_render(scene: Scene, seed=0, rays_per_pair=1, visualize=False,
              x_bounds=(-0.04, 0.04), z_bounds=(0.001, 0.05),
              dynamic_range=60.0):
    """Returns (display_image [Nz, Nx], channel_buf, tx_delays).

    Acquisition runs through the XLA wavefront tracer
    (integrator/ultrasound.py::simulate_acquisition), so the whole pipeline
    is differentiable with ``jax.grad``."""
    us = scene.ultrasound
    channel_buf, tx = simulate_acquisition(scene, seed=seed, rays_per_pair=rays_per_pair)

    c = float(us.sound_speed)
    fc = float(us.frequency)
    wavelength = c / fc
    step = wavelength / 4.0
    x_grid, z_grid = grid_scan(x_bounds[0], x_bounds[1], z_bounds[0], z_bounds[1], step, step)

    # True element (x, z) positions — a convex probe's arc geometry flows
    # into the rx delays (reference convex geometry: CustomEmmitter.py:41-47).
    from tpu_rt.sensor.transducer import element_geometry

    pos, _ = element_geometry(us.n_elements, us.pitch, us.radius,
                              us.opening_angle)
    img = bmode_pipeline(
        channel_buf, us.angles, pos[:, 0], us.sampling_rate, us.sound_speed,
        x_grid, z_grid, dynamic_range, elem_z=pos[:, 2],
    )
    if visualize:
        _show(img, x_grid, z_grid)
    return img, channel_buf, tx


def us_render_jit(scene: Scene, seed=0, rays_per_pair=1):
    """jit-compiled forward (scene params stay traceable for jax.grad)."""

    @jax.jit
    def fwd(sc):
        img, ch, tx = us_render(sc, seed=seed, rays_per_pair=rays_per_pair)
        return img

    return fwd(scene)


# One jitted closure per (scene object, config): the scene is captured
# CONCRETE (host-side float()s and the DAS window autosizing see real
# arrays), only the seed is traced.  Rebuilding a jitted closure per call
# would retrace the whole pipeline, and running it eagerly dispatches
# every op separately.  Keyed by id(scene) and guarded by a weakref
# identity check so a GC'd id can never serve a stale scene.
_US_RENDER_CACHE = {}


def us_render_fast(scene: Scene, seed=0, rays_per_pair=1,
                   x_bounds=(-0.04, 0.04), z_bounds=(0.001, 0.05),
                   dynamic_range=60.0):
    """us_render through one cached jitted dispatch (repeat-render path).

    Same outputs as ``us_render``; use this for frame loops / benchmarks.
    For gradients through scene parameters use ``us_render`` (eager,
    traceable) or ``us_render_jit``.
    """
    key = (id(scene), rays_per_pair, x_bounds, z_bounds, float(dynamic_range))
    entry = _US_RENDER_CACHE.get(key)
    fn = None
    if entry is not None:
        ref, cached = entry
        if ref() is scene:
            fn = cached
    if fn is None:
        @jax.jit
        def fn(seed_):
            return us_render(
                scene, seed=seed_, rays_per_pair=rays_per_pair,
                x_bounds=x_bounds, z_bounds=z_bounds,
                dynamic_range=dynamic_range,
            )

        _US_RENDER_CACHE[key] = (weakref.ref(scene), fn)
    return fn(jnp.int32(seed))


def _show(img, x_grid, z_grid):  # pragma: no cover - display helper
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    plt.figure(figsize=(10, 8))
    extent = [
        float(x_grid[0]) * 1e3,
        float(x_grid[-1]) * 1e3,
        float(z_grid[-1]) * 1e3,
        float(z_grid[0]) * 1e3,
    ]
    plt.imshow(np.asarray(img), extent=extent, cmap="gray", origin="upper",
               vmin=0, vmax=1)
    plt.xlabel("Lateral (mm)")
    plt.ylabel("Axial/Depth (mm)")
    plt.title("Simulated Ultrasound B-mode Image")
    plt.colorbar(label="Relative Echo Intensity (Normalized)")
    plt.gca().invert_yaxis()
    plt.tight_layout()
    import os
    import tempfile

    plt.savefig(os.path.join(tempfile.gettempdir(), "bmode.png"), dpi=100)
    plt.close()
