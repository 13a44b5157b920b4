"""tpu_rt — a physics-based ray/path tracing framework in JAX/XLA.

Re-implements in JAX the capabilities of the Mitsuba-3-based reference
`ReaganCardoza/Physics-Based-Ray-Tracing` (see SURVEY.md): an optical wavefront
path tracer (NEE + MIS + Russian roulette), polarized Stokes/Mueller transport,
an ultrasound plane-wave acquisition simulator (transducer emitter/sensor
arrays, impedance-based acoustic GGX BSDF, time-of-flight echo accumulation),
delay-and-sum beamforming to B-mode images, and end-to-end differentiable
inverse rendering via ``jax.grad``.

Everything is built on flat, HBM-resident jnp arrays (SoA), `lax.scan`/
`lax.while_loop` compiled control flow, and `shard_map` data parallelism over
device meshes.
"""

__version__ = "0.1.0"

from tpu_rt.scene import ScalarTransform4f, load_dict, load_file  # noqa: F401


def render(scene, **kwargs):
    """mi.render equivalent — dispatches on the scene's integrator."""
    from tpu_rt.integrator import render as _render

    return _render(scene, **kwargs)
