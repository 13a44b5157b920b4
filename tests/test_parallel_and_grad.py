"""Multi-chip sharding and differentiability tests (SURVEY.md §2c / §5):
psum-sharded renders must match single-chip bit-for-bit-ish, and the whole
pipeline must be jax.grad-differentiable with finite gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_rt
from tpu_rt.integrator.path import path_trace, render
from tpu_rt.parallel.render import default_mesh, render_pass_sharded, render_sharded
from tpu_rt.sensor import camera as cam


@pytest.fixture(scope="module")
def cbox16(ref_scenes):
    import os

    return tpu_rt.load_file(os.path.join(ref_scenes, "cbox.xml"), res=16, spp=1)


def test_sharded_render_matches_single_chip(cbox16):
    """8-device psum-sharded pass == single-chip pass (same keys/pixels)."""
    scene = cbox16.replace(max_depth=4)
    assert len(jax.devices()) == 8
    mesh = default_mesh()
    key = jax.random.PRNGKey(3)

    fv, fw, n_sharded = render_pass_sharded(scene, key, mesh)

    # Single-device reference with identical per-pixel keys: rebuild the same
    # computation without shard_map by processing each device's tile.
    H, W = scene.camera.height, scene.camera.width
    xy = jnp.stack(
        jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), -1
    ).reshape(-1, 2)
    keys = jax.random.split(key, 8)
    from tpu_rt.sensor import film as film_mod

    fv2 = jnp.zeros((H, W, 3), jnp.float32)
    fw2 = jnp.zeros((H, W), jnp.float32)
    n2 = 0
    tile = xy.shape[0] // 8
    for i in range(8):
        xs = xy[i * tile : (i + 1) * tile]
        k_jit, k_path = jax.random.split(keys[i])
        jitter = jax.random.uniform(k_jit, xs.shape)
        film_xy = xs.astype(jnp.float32) + jitter
        o, d = cam.sample_ray(scene.camera, film_xy)
        L, n_rays = path_trace(scene, o, d, k_path)
        ok = jnp.all(jnp.isfinite(L), axis=-1)
        fv2, fw2 = film_mod.splat(fv2, fw2, film_xy, L, ok, scene.camera.filter_type)
        n2 += int(n_rays)

    np.testing.assert_allclose(np.asarray(fv), np.asarray(fv2), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fw), np.asarray(fw2), rtol=1e-5, atol=1e-6)
    assert int(n_sharded) == n2


def test_render_sharded_full(cbox16):
    img = render_sharded(cbox16.replace(max_depth=3), spp=2, seed=0)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(np.asarray(img)).all()
    assert render_sharded.last_ray_count > 0


def test_path_gradients_finite(cbox16):
    """jax.grad through the full bounce loop (incl. dielectric refraction)
    must be finite — the reverse-mode guard rails (finite miss sentinels,
    clamped denominators) are regression-tested here."""
    scene = cbox16.replace(max_depth=6)
    H, W = 16, 16
    xy = (
        jnp.stack(jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), -1)
        .reshape(-1, 2)
        .astype(jnp.float32)
        + 0.5
    )
    o, d = cam.sample_ray(scene.camera, xy)

    def loss(params, key):
        L, _ = path_trace(scene.replace(bsdf_params=params), o, d, key)
        return jnp.mean(L)

    for seed in range(3):
        g = np.asarray(jax.grad(loss)(scene.bsdf_params, jax.random.PRNGKey(seed)))
        assert np.isfinite(g).all(), f"non-finite gradient at seed {seed}"
    # gradient wrt diffuse reflectance should be nonzero
    assert np.abs(g[:4, :3]).sum() > 0


def test_ultrasound_gradients_finite():
    """jax.grad through acquisition + beamforming (the inverse-rendering
    path replacing USMain.py:279-289 finite differences)."""
    from tpu_rt.us.pipeline import us_render

    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "integrator": {
                "type": "ultrasound_integrator",
                "max_depth": 3,
                "n_elements": 16,
                "time_samples": 800,
                "pitch": 0.0005,
                "angles": np.asarray([-5.0, 0.0, 5.0], np.float32),
            },
            "sensor": {
                "type": "ultrasound_sensor",
                "num_elements_lateral": 16,
                "pitch": 0.0005,
                "radius": float("inf"),
                "to_world": tpu_rt.ScalarTransform4f(),
            },
            "plate": {
                "type": "rectangle",
                "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, 0.01])
                @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
                @ tpu_rt.ScalarTransform4f().scale([0.02, 0.02, 1]),
                "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.5},
            },
        }
    )
    from tpu_rt.integrator.ultrasound import simulate_acquisition

    def loss(params):
        ch, _ = simulate_acquisition(scene.replace(bsdf_params=params), seed=0)
        return jnp.sum(ch * ch)

    g = np.asarray(jax.grad(loss)(scene.bsdf_params))
    assert np.isfinite(g).all()
    # roughness and impedance of the plate BSDF should receive gradient
    assert np.abs(g[:, 0:2]).sum() > 0


def test_inverse_rendering_recovers_impedance():
    """End-to-end parameter recovery on the RF buffer (jax.grad realization
    of the USMain.py optimization loop, targeting the impedance param)."""
    from tpu_rt.integrator.ultrasound import simulate_acquisition
    from tpu_rt.opt.inverse import get_param, optimize, set_param, traverse

    def make():
        return tpu_rt.load_dict(
            {
                "type": "scene",
                "integrator": {
                    "type": "ultrasound_integrator",
                    "max_depth": 2,
                    "n_elements": 16,
                    "time_samples": 600,
                    "pitch": 0.0005,
                    "angles": np.asarray([0.0], np.float32),
                },
                "sensor": {
                    "type": "ultrasound_sensor",
                    "num_elements_lateral": 16,
                    "pitch": 0.0005,
                    "radius": float("inf"),
                    "to_world": tpu_rt.ScalarTransform4f(),
                },
                "plate": {
                    "type": "rectangle",
                    "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, 0.008])
                    @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
                    @ tpu_rt.ScalarTransform4f().scale([0.02, 0.02, 1]),
                    "bsdf": {
                        "type": "ultrasound_bsdf",
                        "impedance": 4.0,
                        "roughness": 0.5,
                    },
                },
            }
        )

    scene = make()
    key = "plate.bsdf.impedance"
    assert key in traverse(scene)
    target_scene = set_param(scene, key, 7.0)
    ch_target, _ = simulate_acquisition(target_scene, seed=0, rays_per_pair=4)

    def loss_fn(sc):
        ch, _ = simulate_acquisition(sc, seed=0, rays_per_pair=4)
        return jnp.mean((ch - ch_target) ** 2) * 1e6

    out_scene, losses = optimize(
        scene, [key], loss_fn, n_iters=30, lr=0.15, bounds=(1.0, 10.0)
    )
    recovered = float(get_param(out_scene, key))
    assert losses[-1] < losses[0] * 0.5, f"loss did not decrease: {losses[:3]}...{losses[-3:]}"
    assert abs(recovered - 7.0) < 1.5, f"recovered impedance {recovered} != 7.0"


def test_inverse_rendering_recovers_roughness():
    """Roughness recovery — the parameter the reference's FD loop optimized
    (USMain.py:262-289, key 'shape.bsdf.roughness'), here with exact
    jax.grad through the acquisition."""
    from tpu_rt.integrator.ultrasound import simulate_acquisition
    from tpu_rt.opt.inverse import get_param, optimize, set_param

    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "integrator": {
                "type": "ultrasound_integrator",
                "max_depth": 2,
                "n_elements": 16,
                "time_samples": 600,
                "pitch": 0.0005,
                "angles": np.asarray([-5.0, 5.0], np.float32),
            },
            "sensor": {
                "type": "ultrasound_sensor",
                "num_elements_lateral": 16,
                "pitch": 0.0005,
                "radius": float("inf"),
                "to_world": tpu_rt.ScalarTransform4f(),
            },
            "plate": {
                "type": "rectangle",
                "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, 0.008])
                @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
                @ tpu_rt.ScalarTransform4f().scale([0.02, 0.02, 1]),
                "bsdf": {
                    "type": "ultrasound_bsdf",
                    "impedance": 7.8,
                    "roughness": 0.1,  # initial guess (USMain.py:276)
                },
            },
        }
    )
    key = "plate.bsdf.roughness"
    target_scene = set_param(scene, key, 0.7)
    ch_target, _ = simulate_acquisition(target_scene, seed=0, rays_per_pair=8)

    def loss_fn(sc):
        ch, _ = simulate_acquisition(sc, seed=0, rays_per_pair=8)
        return jnp.mean((ch - ch_target) ** 2) * 1e6

    out_scene, losses = optimize(
        scene, [key], loss_fn, n_iters=25, lr=2e-2, bounds=(1e-4, 1.0)
    )
    recovered = float(get_param(out_scene, key))
    assert losses[-1] < losses[0] * 0.7, f"loss: {losses[0]:.3g}->{losses[-1]:.3g}"
    assert abs(recovered - 0.7) < 0.25, f"recovered roughness {recovered} != 0.7"


def test_sharded_acquisition_matches_single_chip_stats():
    """8-device psum-sharded ultrasound acquisition (SURVEY §2c RF-buffer
    row): exact equality to the equivalent single-chip MC average built
    from the same per-device seeds, and gradients flow through the psum."""
    import numpy as np

    from tpu_rt.integrator.ultrasound import simulate_acquisition
    from tpu_rt.parallel.ultrasound import simulate_acquisition_sharded

    z0 = 0.02
    d = {
        "type": "scene",
        "integrator": {
            "type": "ultrasound_integrator",
            "max_depth": 2, "n_elements": 16, "time_samples": 1500,
            "pitch": 0.0005, "angles": np.asarray([0.0], np.float32),
        },
        "sensor": {
            "type": "ultrasound_sensor", "num_elements_lateral": 16,
            "pitch": 0.0005, "radius": float("inf"),
            "to_world": tpu_rt.ScalarTransform4f(),
        },
        "plate": {
            "type": "rectangle",
            "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, z0])
            @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
            @ tpu_rt.ScalarTransform4f().scale([0.04, 0.04, 1]),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8,
                     "roughness": 0.4},
        },
    }
    scene = tpu_rt.load_dict(d)
    mesh = default_mesh()
    n_dev = mesh.devices.size
    assert n_dev == 8

    ch_sh, tx_sh = simulate_acquisition_sharded(
        scene, seed=5, rays_per_pair=8, mesh=mesh
    )

    # reference: average of the 8 per-device single-chip runs
    acc = None
    for i in range(n_dev):
        ch_i, tx_i = simulate_acquisition(scene, seed=5 + i * 7919,
                                          rays_per_pair=1)
        acc = ch_i if acc is None else acc + ch_i
    ch_ref = acc / n_dev
    np.testing.assert_allclose(np.asarray(ch_sh), np.asarray(ch_ref),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(tx_sh), np.asarray(tx_i), atol=1e-12)

    # gradient w.r.t. impedance flows through the sharded acquisition
    def loss(params):
        sc = scene.replace(bsdf_params=params)
        ch, _ = simulate_acquisition_sharded(sc, seed=5, rays_per_pair=8,
                                             mesh=mesh)
        return jnp.sum(ch * ch)

    g = jax.grad(loss)(scene.bsdf_params)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert abs(g[0, 0]) > 0  # impedance gradient is live


@pytest.mark.parametrize("method", ["matmul", "gather"])
def test_sharded_das_matches_single_chip(method):
    """das_beamform_sharded (lateral pixel tiles over the 8-device mesh,
    replicated RF) must equal the single-chip beamformer: per-pixel DAS
    sums run in the same order, so agreement is to f32 exactness.  Nx=13
    exercises the pad-to-n_dev path."""
    from tpu_rt.parallel.ultrasound import das_beamform_sharded
    from tpu_rt.us.beamform import das_beamform, das_beamform_matmul

    rng = np.random.default_rng(3)
    A, E, T = 3, 5, 128
    fs, c = 50e6, 1540.0
    ch = jnp.asarray(rng.standard_normal((A, E, T)), jnp.float32)
    angles = jnp.asarray([-10.0, 0.0, 10.0], jnp.float32)
    elem_x = jnp.linspace(-2e-3, 2e-3, E, dtype=jnp.float32)
    x_grid = jnp.linspace(-3e-3, 3e-3, 13, dtype=jnp.float32)
    z_grid = jnp.linspace(0.2e-3, 3e-3, 9, dtype=jnp.float32)

    das_ref = das_beamform_matmul if method == "matmul" else das_beamform
    ref = np.asarray(das_ref(ch, angles, elem_x, fs, c, x_grid, z_grid))
    out = np.asarray(das_beamform_sharded(
        ch, angles, elem_x, fs, c, x_grid, z_grid, method=method,
        mesh=default_mesh(),
    ))
    assert out.shape == ref.shape == (13, 9)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
