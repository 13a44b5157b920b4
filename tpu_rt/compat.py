"""Reference-compatible API shims.

Mirrors the plugin surface of ReaganCardoza/Physics-Based-Ray-Tracing so a
user of the reference can port scripts with an import swap
(SURVEY.md §2a component inventory):

  * ``UltraIntegrator`` — CustomIntegrator.py:12 (simulate_acquisition /
    simulate_acquisition_parallel / channel_buf / transmission_delays_buf)
  * ``UltraBSDF``-equivalent config handled by the scene compiler
    ('ultrasound_bsdf' dict/XML type)
  * ``CustomEmitter`` / ``UltraSensor`` ray-generation functions live in
    tpu_rt.sensor.transducer
  * ``us_render`` — USMain.py:92 pipeline (tpu_rt.us.pipeline.us_render)
  * ``register_integrator`` etc. — no-op registry shims (plugins are
    resolved by the scene compiler from their type strings)

The JAX implementations are vectorized and jit-compiled; both
``simulate_acquisition`` variants run the same megabatched program (the
reference's 'parallel' variant only existed to work around Python-loop
slowness, SURVEY.md §2c).
"""

from __future__ import annotations

import numpy as np

from tpu_rt.scene.types import Scene
from tpu_rt.us.pipeline import us_render  # noqa: F401

_REGISTRY = {}


def register_integrator(name, cls=None):
    _REGISTRY[("integrator", name)] = cls


def register_sensor(name, cls=None):
    _REGISTRY[("sensor", name)] = cls


def register_emitter(name, cls=None):
    _REGISTRY[("emitter", name)] = cls


def register_bsdf(name, cls=None):
    _REGISTRY[("bsdf", name)] = cls


class UltraIntegrator:
    """Stateful facade matching the reference UltraIntegrator
    (/root/reference/CustomIntegrator.py:12-49): construct from a Scene (or
    obtain via ``scene_integrator(scene)``), call ``simulate_acquisition``,
    read ``channel_buf`` / ``transmission_delays_buf`` / ``ray_count``."""

    def __init__(self, scene: Scene):
        if scene.ultrasound is None:
            raise ValueError("scene has no ultrasound integrator")
        self.scene = scene
        us = scene.ultrasound
        # reference attribute names (CustomIntegrator.py:16-46)
        self.max_depth = us.max_depth
        self.frequency = float(us.frequency)
        self.sound_speed = float(us.sound_speed)
        self.attenuation = float(us.attenuation)
        self.wave_cycles = us.wave_cycles
        self.main_beam_angle = float(us.main_beam_angle)
        self.cutoff_angle = float(us.cutoff_angle)
        self.fs = float(us.sampling_rate)
        self.n_elements = us.n_elements
        self.pitch = float(us.pitch)
        self.angles = np.asarray(us.angles)
        self.n_angles = us.n_angles
        self.time_samples = us.time_samples
        self.channel_buf = None
        self.transmission_delays_buf = None
        self.ray_count = 0

    def simulate_acquisition(self, scene=None, seed=0, rays_per_pair=1):
        from tpu_rt.integrator.ultrasound import simulate_acquisition

        scene = self.scene if scene is None else scene
        ch, tx = simulate_acquisition(scene, seed=seed, rays_per_pair=rays_per_pair)
        self.channel_buf = np.asarray(ch)
        self.transmission_delays_buf = np.asarray(tx)
        self.ray_count = int(
            self.n_angles * self.n_elements * rays_per_pair * self.max_depth
        )
        return True  # reference returns True (CustomIntegrator.py:232)

    # The reference's threaded variant exists only as a workaround for its
    # Python-loop slowness; here both names run the same fused program.
    simulate_acquisition_parallel = simulate_acquisition


def scene_integrator(scene: Scene) -> UltraIntegrator:
    """Equivalent of scene.integrator() (USMain.py:95)."""
    return UltraIntegrator(scene)


def traverse(scene: Scene):
    """mi.traverse(scene) equivalent: a dict-like parameter view with
    Mitsuba-style keys and .update() semantics (USMain.py:259-266)."""
    from tpu_rt.opt import inverse

    class Params(dict):
        def __init__(self, sc):
            super().__init__()
            self._scene = sc
            self._dirty = {}
            for k in inverse.traverse(sc):
                super().__setitem__(k, inverse.get_param(sc, k))

        def __setitem__(self, key, value):
            self._dirty[key] = value
            super().__setitem__(key, value)

        def update(self, *args, **kwargs):
            sc = self._scene
            for k, v in self._dirty.items():
                sc = inverse.set_param(sc, k, v)
            self._dirty.clear()
            self._scene = sc
            return sc

        @property
        def scene(self):
            return self._scene

    return Params(scene)
