"""The ultrasound product's production scene (the reference's USMain).

``usmain_scene()`` is the scene dict of /root/reference/USMain.py:26-90: a
flat plate tilted 45 degrees at 5 cm depth and a back wall at 1 m, seen by
a 64-element linear array (pitch 0.12 mm) firing 5 plane waves over
+-15 degrees, sampled at 50 MHz for 10,000 samples, traced to depth 10.
"""

from __future__ import annotations

import numpy as np

# Plate centre depth (m) and tilt about the array's elevation axis (deg).
PLATE_DEPTH = 0.05
PLATE_TILT_DEG = 45.0


def usmain_scene():
    """Compiled Scene of the USMain acquisition (see module docstring)."""
    import tpu_rt

    T = tpu_rt.ScalarTransform4f
    return tpu_rt.load_dict({
        "type": "scene",
        "integrator": {
            "type": "ultrasound_integrator",
            "max_depth": 10,
            "sampling_rate": 50e6,
            "frequency": 5e6,
            "sound_speed": 1540,
            "attenuation": 0.2,
            "wave_cycles": 5,
            "main_beam_angle": 24,
            "cutoff_angle": 30,
            "n_elements": 64,
            "pitch": 0.00003 * 4,
            "time_samples": 10000,
            "angles": np.linspace(-15, 15, 5),
        },
        "sensor": {
            "type": "ultrasound_sensor",
            "num_elements_lateral": 1280,
            "elements_width": 0.003,
            "elements_height": 0.01,
            "pitch": 0.0003,
            "radius": float("inf"),
            "center_frequency": 5e6,
            "sound_speed": 1540,
            "directivity": 1.0,
            "to_world": T().look_at(origin=[0, 0, 0.0], target=[0, 0, 0.03],
                                    up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": 512, "height": 512,
                     "pixel_format": "luminance"},
        },
        "flat_plate": {
            "type": "rectangle",
            "to_world": (T().translate([0, 0, PLATE_DEPTH])
                         @ T().rotate([0, 1, 0], PLATE_TILT_DEG)
                         @ T().scale([0.17, 0.17, 0.14])),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8,
                     "roughness": 0.7},
        },
        "wall_back": {
            "type": "rectangle",
            "to_world": (T().translate([0, 0, 1])
                         @ T().rotate([0, 1, 0], 180)
                         @ T().scale([0.05, 0.05, 1])),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8,
                     "roughness": 0.7},
        },
    })
