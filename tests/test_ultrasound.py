"""Ultrasound acquisition + beamforming tests: echo timing against the
wave-physics closed form, plane-wave delay law, DAS point-scatterer
localization, and the golden channel-buffer stats the reference printed
(USMain.py:114-115)."""

import numpy as np
import pytest

import tpu_rt
from tpu_rt.integrator.ultrasound import simulate_acquisition
from tpu_rt.us.beamform import bmode_pipeline, das_beamform, grid_scan, hilbert_envelope, log_compress


def _scene(shape_entries, n_elements=32, time_samples=3000, angles=(0.0,),
           max_depth=2, frequency=5e6, sound_speed=1540.0, attenuation=0.0,
           pitch=0.0003):
    d = {
        "type": "scene",
        "integrator": {
            "type": "ultrasound_integrator",
            "max_depth": max_depth,
            "sampling_rate": 50e6,
            "frequency": frequency,
            "sound_speed": sound_speed,
            "attenuation": attenuation,
            "main_beam_angle": 24,
            "cutoff_angle": 30,
            "n_elements": n_elements,
            "pitch": pitch,
            "time_samples": time_samples,
            "angles": np.asarray(angles, np.float32),
        },
        "sensor": {
            "type": "ultrasound_sensor",
            "num_elements_lateral": n_elements,
            "elements_width": 0.003,
            "elements_height": 0.01,
            "pitch": pitch,
            "radius": float("inf"),
            "center_frequency": frequency,
            "sound_speed": sound_speed,
            "directivity": 1.0,
            "to_world": tpu_rt.ScalarTransform4f(),
        },
    }
    d.update(shape_entries)
    return tpu_rt.load_dict(d)


def test_plane_wave_delay_law():
    """tx delay = x_elem * sin(angle) / c (CustomIntegrator.py:87)."""
    scene = _scene({}, n_elements=8, angles=(-15.0, 0.0, 15.0))
    _, tx = simulate_acquisition(scene, seed=0)
    tx = np.asarray(tx)
    assert tx.shape == (3, 8)
    x = 0.0003 * (np.arange(8) - 3.5)
    c = 1540.0
    for ai, ang in enumerate([-15.0, 0.0, 15.0]):
        np.testing.assert_allclose(
            tx[ai], x * np.sin(np.deg2rad(ang)) / c, rtol=1e-5, atol=1e-12
        )
    np.testing.assert_allclose(tx[1], 0.0, atol=1e-12)


def test_echo_arrival_time_flat_plate():
    """A flat plate at depth z0, normal-incidence plane wave: first echo at
    t = 2 z0 / c (within the receive-element geometry spread)."""
    z0 = 0.02
    scene = _scene(
        {
            "plate": {
                "type": "rectangle",
                "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, z0])
                @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
                @ tpu_rt.ScalarTransform4f().scale([0.05, 0.05, 1]),
                "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.3},
            }
        },
        max_depth=1,
    )
    ch, _ = simulate_acquisition(scene, seed=0)
    ch = np.asarray(ch)
    assert np.abs(ch).sum() > 0, "no echoes recorded"
    fs, c = 50e6, 1540.0
    t_idx = np.nonzero(np.abs(ch).sum(axis=(0, 1)))[0]
    t_expected = 2 * z0 / c * fs  # ~1298
    # element aperture adds sqrt(z0^2 + x^2) spread
    half_ap = 0.0003 * 16
    t_max = (z0 + np.sqrt(z0**2 + (2 * half_ap) ** 2)) / c * fs
    assert t_idx.min() >= t_expected - 2
    assert t_idx.max() <= t_max + 2


def test_attenuation_law():
    """Echo amplitude scales by exp(-alpha f_MHz d / 8.686)
    (CustomIntegrator.py:162,328)."""
    z0 = 0.02
    shapes = {
        "plate": {
            "type": "rectangle",
            "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, z0])
            @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
            @ tpu_rt.ScalarTransform4f().scale([0.05, 0.05, 1]),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.001},
        }
    }
    s0 = _scene(shapes, max_depth=1, attenuation=0.0)
    s1 = _scene(shapes, max_depth=1, attenuation=0.5)
    ch0, _ = simulate_acquisition(s0, seed=3)
    ch1, _ = simulate_acquisition(s1, seed=3)
    e0 = np.abs(np.asarray(ch0)).sum()
    e1 = np.abs(np.asarray(ch1)).sum()
    # one-way distance ~= z0 (outbound only is attenuated at the first
    # bounce deposit)
    expected = np.exp(-0.5 * 5.0 * z0 / 8.686)
    assert e0 > 0
    np.testing.assert_allclose(e1 / e0, expected, rtol=0.05)


def test_das_point_scatterer_localization():
    """Beamformed peak lands on the scatterer position."""
    z0, x0 = 0.025, 0.004
    scene = _scene(
        {
            "pt": {
                "type": "sphere",
                "center": np.asarray([x0, 0.0, z0]),
                "radius": 0.0008,
                "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.9},
            }
        },
        n_elements=64,
        angles=(-10.0, -5.0, 0.0, 5.0, 10.0),
        max_depth=1,
        pitch=0.0005,
    )
    ch, _ = simulate_acquisition(scene, seed=1, rays_per_pair=16)
    ch = np.asarray(ch)
    assert np.abs(ch).sum() > 0
    us = scene.ultrasound
    elem_x = 0.0005 * (np.arange(64) - 31.5)
    x_grid, z_grid = grid_scan(-0.01, 0.01, 0.01, 0.04, 2e-4, 1e-4)
    img = np.asarray(
        bmode_pipeline(ch, us.angles, elem_x, us.sampling_rate, us.sound_speed,
                       x_grid, z_grid)
    )  # [Nz, Nx]
    zi, xi = np.unravel_index(np.argmax(img), img.shape)
    x_peak = np.asarray(x_grid)[xi]
    z_peak = np.asarray(z_grid)[zi]
    # Axial resolution is sharp; lateral has sidelobes from the sparse
    # random-receiver MC sampling, so the lateral tolerance is looser.
    assert abs(z_peak - z0) < 0.0015, f"axial peak {z_peak} != {z0}"
    assert abs(x_peak - x0) < 0.006, f"lateral peak {x_peak} != {x0}"


def test_log_compression_matches_reference_semantics():
    """60 dB log compression (USMain.py:213-219)."""
    env = np.asarray([1e-6, 10 ** (-1.5), 1.0])  # 0 dB, -30 dB, -120 dB
    img = np.asarray(log_compress(env, 60.0))
    # max -> 1.0; -30 dB -> 0.5; below -60 dB clips to 0.0
    np.testing.assert_allclose(img[2], 1.0, atol=1e-6)
    np.testing.assert_allclose(img[1], 0.5, atol=1e-3)
    np.testing.assert_allclose(img[0], 0.0, atol=1e-3)


def test_hilbert_envelope_of_tone():
    t = np.arange(1024) / 1024
    x = np.sin(2 * np.pi * 64 * t) * np.exp(-((t - 0.5) ** 2) / 0.01)
    env = np.asarray(hilbert_envelope(x[None, :], axis=1))[0]
    expected = np.exp(-((t - 0.5) ** 2) / 0.01)
    mask = expected > 0.2
    np.testing.assert_allclose(env[mask], expected[mask], rtol=0.06)


def test_ultraspy_facade_pipeline():
    """build_probe / GridScan / DelayAndSum port of the USMain.py pipeline
    (USMain.py:126-219): angles recovered from the delay matrix, peak at the
    plate depth."""
    from tpu_rt.us import DelayAndSum, GridScan, build_probe

    scene = _scene(
        {
            "plate": {
                "type": "rectangle",
                "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, 0.02])
                @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
                @ tpu_rt.ScalarTransform4f().scale([0.03, 0.03, 1]),
                "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.5},
            }
        },
        n_elements=32, time_samples=2000, angles=(-10.0, 0.0, 10.0),
        max_depth=2, pitch=0.0004,
    )
    ch, tx = simulate_acquisition(scene, seed=0, rays_per_pair=4)
    probe = build_probe("linear", nb_elements=32, pitch=0.0004, central_freq=5e6)
    bf = DelayAndSum(on_gpu=False).automatic_setup(
        {"sampling_freq": 50e6, "t0": 0, "delays": np.asarray(tx),
         "sound_speed": 1540.0},
        probe,
    )
    np.testing.assert_allclose(bf.angles_deg, [-10, 0, 10], atol=0.1)
    z = np.arange(0.005, 0.03, 1e-4)
    scan = GridScan(np.arange(-0.01, 0.01, 2e-4), z)
    out = bf.beamform(ch, scan)
    env = np.asarray(bf.compute_envelope(out, scan))
    zi = np.unravel_index(np.argmax(env), env.shape)[1]
    assert abs(z[zi] - 0.02) < 0.001


def test_sphere_box_scene_acquisition(ref_us_scenes):
    """Sphere_Box.xml runs end to end and produces echoes (BASELINE.json
    config 1)."""
    import os

    scene = tpu_rt.load_file(os.path.join(ref_us_scenes, "Sphere_Box.xml"))
    # shrink for CPU test speed
    ch, tx = simulate_acquisition(scene, seed=0)
    ch = np.asarray(ch)
    assert ch.shape == (5, 64, 10000)
    assert np.isfinite(ch).all()
    assert np.abs(ch).sum() > 0


def test_das_matmul_matches_gather():
    """The windowed-GEMM DAS must reproduce the gather formulation."""
    import jax

    from tpu_rt.us.beamform import das_beamform, das_beamform_matmul, grid_scan

    A, E, T = 3, 16, 3000
    ch = jax.random.normal(jax.random.PRNGKey(0), (A, E, T))
    angles = np.linspace(-10, 10, A).astype(np.float32)
    elem_x = 0.0004 * (np.arange(E) - (E - 1) / 2)
    xg, zg = grid_scan(-0.01, 0.01, 0.005, 0.04, 2e-4, 1e-4)
    a = np.asarray(das_beamform(ch, angles, elem_x, 50e6, 1540.0, xg, zg))
    b = np.asarray(das_beamform_matmul(ch, angles, elem_x, 50e6, 1540.0, xg, zg))
    assert np.abs(a - b).max() / max(np.abs(a).max(), 1e-9) < 1e-3


def test_das_matmul_short_rf_buffer():
    """window > T regression (advisor r3): the matmul form zero-pads the
    time axis up to the strided-overlap view length; pixels whose taps are
    fully in range must still match the gather form exactly.  (Pixels with
    taps beyond T-1 differ by design: matmul masks the whole 2-tap interp,
    gather keeps the single in-range tap — compare only where both are
    exact.)"""
    import jax

    from tpu_rt.us.beamform import das_beamform, das_beamform_matmul, grid_scan

    A, E, T = 2, 8, 90  # T far below the 128+ minimum window
    fs, c = 50e6, 1540.0
    ch = jax.random.normal(jax.random.PRNGKey(1), (A, E, T))
    angles = np.linspace(-5, 5, A).astype(np.float32)
    elem_x = 0.0004 * (np.arange(E) - (E - 1) / 2)
    xg, zg = grid_scan(-0.002, 0.002, 0.0002, 0.0016, 2e-4, 1e-4)
    a = np.asarray(das_beamform(ch, angles, elem_x, fs, c, xg, zg))
    b = np.asarray(das_beamform_matmul(ch, angles, elem_x, fs, c, xg, zg))
    # in-range mask: every (angle, element) tap of the pixel has i0+1 <= T-1
    X, Z = np.meshgrid(np.asarray(xg), np.asarray(zg), indexing="ij")
    t_max = np.zeros_like(X)
    for ang in np.deg2rad(angles):
        for ex in np.asarray(elem_x):
            t_f = ((X * np.sin(ang) + Z * np.cos(ang)) / c
                   + np.sqrt((X - ex) ** 2 + Z ** 2) / c) * fs
            t_max = np.maximum(t_max, t_f)
    exact = t_max <= T - 2
    assert exact.sum() >= 50  # the test must actually cover pixels
    scale = max(np.abs(a[exact]).max(), 1e-9)
    assert np.abs(a[exact] - b[exact]).max() / scale < 1e-3


def test_convex_array_acquisition():
    """Finite sensor radius places elements on a convex arc (CustomEmmitter
    convex support extended to the acquisition path); plane-wave delays
    become the projection onto the propagation direction and echoes still
    arrive at the wave-physics time."""
    from tpu_rt.sensor.transducer import element_geometry, plane_wave_rays

    z0 = 0.02
    d = {
        "type": "scene",
        "integrator": {
            "type": "ultrasound_integrator",
            "max_depth": 1, "n_elements": 16, "time_samples": 2000,
            "pitch": 0.0006, "angles": np.asarray([0.0], np.float32),
        },
        "sensor": {
            "type": "ultrasound_sensor", "num_elements_lateral": 16,
            "pitch": 0.0006, "radius": 0.04,  # convex, 4 cm
            "to_world": tpu_rt.ScalarTransform4f(),
        },
        "plate": {
            "type": "rectangle",
            "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, z0])
            @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
            @ tpu_rt.ScalarTransform4f().scale([0.05, 0.05, 1]),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.3},
        },
    }
    scene = tpu_rt.load_dict(d)
    us = scene.ultrasound
    base = plane_wave_rays(us)
    pos = np.asarray(base["elem_pos"])
    # convex arc: outer elements sit forward (z > 0), center near z = 0
    assert pos[:, 2].max() > 1e-6 and abs(pos[8, 2]) < pos[0, 2]
    # delay law: (x sin a + z cos a)/c with a=0 -> z/c
    np.testing.assert_allclose(
        np.asarray(base["tx_delay"]), pos[:, 2] / 1540.0, rtol=1e-5
    )
    ch, _ = simulate_acquisition(scene, seed=0, rays_per_pair=4)
    ch = np.asarray(ch)
    assert np.abs(ch).sum() > 0
    t_idx = np.nonzero(np.abs(ch).sum(axis=(0, 1)))[0]
    # first echo still ~2 z0/c (central element path)
    assert abs(t_idx.min() - 2 * z0 / 1540.0 * 50e6) < 40


def test_convex_probe_das_localizes_point_target():
    """Convex-probe DAS with the true element (x, z) arc positions focuses
    a point target at its real location (VERDICT r1 item 8: us/pipeline
    previously beamformed convex probes with a linear element layout).
    Deterministic: synthetic RF with exact convex arrival times.
    Reference convex geometry: CustomEmmitter.py:41-47."""
    from tpu_rt.sensor.transducer import element_geometry
    from tpu_rt.us.beamform import bmode_pipeline, grid_scan

    z0, x0, radius = 0.022, 0.003, 0.04
    E, fs, c = 64, 50e6, 1540.0
    angles = np.asarray([-10.0, -5.0, 0.0, 5.0, 10.0], np.float32)
    pos, _ = element_geometry(E, 0.0005, radius)
    pos = np.asarray(pos)
    assert pos[:, 2].max() > 1e-3  # really an arc (3+ mm of axial offset)

    # Synthetic channel data: impulse at t_tx(scatterer) + |p_s - p_e| / c.
    T = 3000
    ch = np.zeros((len(angles), E, T), np.float32)
    for ai, a in enumerate(np.deg2rad(angles)):
        t_tx = (x0 * np.sin(a) + z0 * np.cos(a)) / c
        d_rx = np.hypot(x0 - pos[:, 0], z0 - pos[:, 2])
        tf = (t_tx + d_rx / c) * fs
        i0 = np.floor(tf).astype(int)
        w = tf - i0
        ch[ai, np.arange(E), i0] += 1.0 - w
        ch[ai, np.arange(E), i0 + 1] += w

    x_grid, z_grid = grid_scan(-0.01, 0.01, 0.01, 0.035, 2e-4, 1e-4)
    img = np.asarray(
        bmode_pipeline(ch, angles, pos[:, 0], fs, c, x_grid, z_grid,
                       elem_z=pos[:, 2])
    )  # [Nz, Nx]
    zi, xi = np.unravel_index(np.argmax(img), img.shape)
    assert abs(np.asarray(z_grid)[zi] - z0) < 3e-4
    assert abs(np.asarray(x_grid)[xi] - x0) < 6e-4

    # Beamforming the same data with the WRONG (flat) geometry loses
    # coherence: the arc spans ~3 mm of axial offset, so the delay errors
    # de-phase the sum and the un-normalized focal peak drops.
    from tpu_rt.us.beamform import das_beamform, hilbert_envelope

    peak_arc = float(np.asarray(hilbert_envelope(
        das_beamform(ch, angles, pos[:, 0], fs, c, x_grid, z_grid,
                     elem_z=pos[:, 2]), axis=1)).max())
    peak_flat = float(np.asarray(hilbert_envelope(
        das_beamform(ch, angles, pos[:, 0], fs, c, x_grid, z_grid),
        axis=1)).max())
    assert peak_arc > 1.5 * peak_flat


def test_das_matmul_window_autosize_under_jit():
    """The matmul-DAS RF window must auto-size from the grid pitch EVEN
    INSIDE jax.jit.  Regression: jnp-indexing the closed-over grid arrays
    during tracing raised TracerArrayConversionError (a TypeError
    subclass) that a bare except swallowed, silently leaving the window at
    its floor and dropping every tap beyond it — jitted callers on grids
    with delay spread > floor got wrong images (r3: the USMain-grid sweep
    measured 72% rel error at 8x64 tiles)."""
    import jax

    from tpu_rt.us.beamform import das_beamform, das_beamform_matmul, grid_scan

    fs, c = 50e6, 1540.0
    A, E, T = 2, 8, 4000
    rng = np.random.default_rng(3)
    ch = rng.standard_normal((A, E, T)).astype(np.float32)
    elem_x = ((np.arange(E, dtype=np.float32) - (E - 1) / 2) * 3e-4)
    angles = np.asarray([-8.0, 8.0], np.float32)
    # coarse pitch (lambda at 5 MHz): a 16x16 tile spans ~64 samples of
    # delay spread per axis -> needed window ~ 648 >> the 128 floor
    step = c / 5e6
    xg, zg = grid_scan(-0.01, 0.01, 0.002, 0.03, step, step)

    ref = np.asarray(das_beamform(ch, angles, elem_x, fs, c, xg, zg))
    out = np.asarray(jax.jit(
        lambda d: das_beamform_matmul(d, angles, elem_x, fs, c, xg, zg)
    )(ch))
    rel = np.sqrt(((out - ref) ** 2).mean()) / np.sqrt((ref ** 2).mean())
    # ~1e-4 of f32/edge-tap noise remains between the two forms; the bug
    # this guards against measures >1e-2 (window floor 128 vs needed 648)
    assert rel < 5e-4, rel


def test_das_matmul_window_autosize_inside_pipeline_jit():
    """us_render's form of the call: the grid is built by grid_scan INSIDE
    jax.jit and fs / c are concrete jax arrays (scene fields).  The window
    must still auto-size on the host (a traced grid or a staged 1/c would
    leave it at the floor and drop taps)."""
    import jax
    import jax.numpy as jnp

    from tpu_rt.us.beamform import das_beamform, das_beamform_matmul, grid_scan

    fs, c = jnp.float32(50e6), jnp.float32(1540.0)
    A, E, T = 2, 8, 4000
    rng = np.random.default_rng(4)
    ch = rng.standard_normal((A, E, T)).astype(np.float32)
    elem_x = ((np.arange(E, dtype=np.float32) - (E - 1) / 2) * 3e-4)
    angles = np.asarray([-8.0, 8.0], np.float32)
    step = 1540.0 / 5e6  # coarse pitch: needed window ~648 >> 128 floor

    def grids():
        return grid_scan(-0.01, 0.01, 0.002, 0.03, step, step)

    xg, zg = grids()
    ref = np.asarray(das_beamform(ch, angles, elem_x, 50e6, 1540.0, xg, zg))
    out = np.asarray(jax.jit(
        lambda d: das_beamform_matmul(d, angles, elem_x, fs, c, *grids())
    )(ch))
    rel = np.sqrt(((out - ref) ** 2).mean()) / np.sqrt((ref ** 2).mean())
    assert rel < 5e-4, rel


def test_us_render_fast_is_the_xla_pipeline():
    """us_render_fast has one route (the XLA acquisition; no kernel or
    interpreter switch) and its cached jitted frame equals the eager
    us_render of the same seed."""
    import inspect

    import tpu_rt
    from tpu_rt.us.pipeline import us_render, us_render_fast

    assert "use_pallas" not in inspect.signature(us_render_fast).parameters
    assert "use_pallas" not in inspect.signature(us_render).parameters
    scene = tpu_rt.load_dict({
        "type": "scene",
        "integrator": {
            "type": "ultrasound_integrator", "max_depth": 2,
            "n_elements": 16, "time_samples": 1200, "pitch": 0.0005,
            "angles": np.asarray([-5.0, 5.0], np.float32),
        },
        "sensor": {
            "type": "ultrasound_sensor", "num_elements_lateral": 16,
            "pitch": 0.0005, "radius": float("inf"),
            "to_world": tpu_rt.ScalarTransform4f(),
        },
        "plate": {
            "type": "rectangle",
            "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, 0.012])
            @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
            @ tpu_rt.ScalarTransform4f().scale([0.02, 0.02, 1]),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8,
                     "roughness": 0.4},
        },
    })
    kw = dict(rays_per_pair=2, x_bounds=(-0.004, 0.004),
              z_bounds=(0.008, 0.016))
    img_f, ch_f, tx_f = us_render_fast(scene, seed=3, **kw)
    img_e, ch_e, tx_e = us_render(scene, seed=3, **kw)
    assert np.abs(np.asarray(ch_e)).max() > 0  # the plate echo is recorded
    np.testing.assert_allclose(np.asarray(ch_f), np.asarray(ch_e),
                               rtol=1e-4, atol=1e-6 * np.abs(np.asarray(ch_e)).max())
    np.testing.assert_allclose(np.asarray(tx_f), np.asarray(tx_e), atol=1e-12)
    np.testing.assert_allclose(np.asarray(img_f), np.asarray(img_e), atol=2e-3)
    # a second call with the same scene reuses the cached jitted frame
    from tpu_rt.us import pipeline

    n_cached = len(pipeline._US_RENDER_CACHE)
    us_render_fast(scene, seed=4, **kw)
    assert len(pipeline._US_RENDER_CACHE) == n_cached
