"""ultraspy-compatible API facades.

The reference drives beamforming through ultraspy's build_probe / GridScan /
DelayAndSum objects (/root/reference/USMain.py:8-10,126-219).  These thin
wrappers expose the same call shapes over the JAX DAS implementation so a
reference user can port USMain.py with an import swap.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpu_rt.us.beamform import das_beamform, hilbert_envelope


class Probe:
    def __init__(self, geometry_type, nb_elements, pitch, central_freq,
                 bandwidth=70, radius=float("inf")):
        if geometry_type not in ("linear", "convex"):
            raise NotImplementedError("geometry_type must be linear or convex")
        if geometry_type == "convex" and not np.isfinite(radius):
            raise ValueError("convex probes need a finite radius")
        self.geometry_type = geometry_type
        self.nb_elements = int(nb_elements)
        self.pitch = float(pitch)
        self.central_freq = float(central_freq)
        self.bandwidth = float(bandwidth)
        self.radius = float(radius)

    def _positions(self):
        from tpu_rt.sensor.transducer import element_geometry

        r = self.radius if self.geometry_type == "convex" else float("inf")
        pos, _ = element_geometry(self.nb_elements, self.pitch, r)
        return np.asarray(pos)

    @property
    def elements_x(self):
        return self._positions()[:, 0]

    @property
    def elements_z(self):
        return self._positions()[:, 2]


def build_probe(geometry_type="linear", nb_elements=128, pitch=0.0003,
                central_freq=5e6, bandwidth=70, radius=float("inf")):
    """ultraspy.probes.factory.build_probe equivalent (USMain.py:129-135);
    convex arrays take a finite ``radius`` (CustomEmmitter.py:41-47)."""
    return Probe(geometry_type, nb_elements, pitch, central_freq, bandwidth,
                 radius)


class GridScan:
    """ultraspy.scan.GridScan equivalent (USMain.py:204)."""

    def __init__(self, x, z):
        self.x = jnp.asarray(np.asarray(x, np.float32).reshape(-1))
        self.z = jnp.asarray(np.asarray(z, np.float32).reshape(-1))

    @property
    def shape(self):
        return (self.x.shape[0], self.z.shape[0])


class DelayAndSum:
    """ultraspy.beamformers.das.DelayAndSum equivalent (USMain.py:175-207).

    ``on_gpu`` is accepted for API compatibility; compute always runs on the
    JAX default backend (the GPU when available).
    """

    def __init__(self, on_gpu=False):
        self.on_gpu = on_gpu
        self.sampling_freq = None
        self.sound_speed = None
        self.t0 = 0.0
        self.angles_deg = None
        self.probe = None

    def automatic_setup(self, acquisition_info, probe):
        self.sampling_freq = float(acquisition_info["sampling_freq"])
        self.sound_speed = float(acquisition_info.get("sound_speed", 1540.0))
        self.t0 = float(acquisition_info.get("t0", 0.0) or 0.0)
        self.probe = probe
        delays = np.asarray(acquisition_info.get("delays"))
        if delays is not None and delays.ndim == 2:
            # recover steering angles from the plane-wave delay law
            # t = x sin(a) / c (CustomIntegrator.py:87)
            x = probe.elements_x
            denom = float(x @ x)
            sin_a = (delays @ x) * self.sound_speed / max(denom, 1e-20)
            self.angles_deg = np.rad2deg(np.arcsin(np.clip(sin_a, -1, 1)))
        return self

    def beamform(self, data, scan: GridScan):
        """data: [A, E, T] RF samples -> beamformed [Nx, Nz]."""
        data = jnp.asarray(np.asarray(data))
        if self.angles_deg is None:
            raise RuntimeError("call automatic_setup first")
        return das_beamform(
            data,
            jnp.asarray(self.angles_deg),
            jnp.asarray(self.probe.elements_x),
            self.sampling_freq,
            self.sound_speed,
            scan.x,
            scan.z,
            t_offset=self.t0,
            elem_z=jnp.asarray(self.probe.elements_z),
        )

    def compute_envelope(self, output, scan: GridScan):
        return hilbert_envelope(output, axis=1)

    def __repr__(self):
        return (
            f"DelayAndSum(fs={self.sampling_freq}, c={self.sound_speed}, "
            f"angles={None if self.angles_deg is None else len(self.angles_deg)})"
        )
