"""Smoke run of both products on the GPU, through their public entry points.

    python chip_smoke.py               # one GPU: phases 0-2
    python chip_smoke.py --four-cards  # four GPUs: phases 0 and 3 only

Phase 0 prints the card (nvidia-smi name and power limit), the JAX devices,
the JAX version and XLA_FLAGS.  Phase 1 renders the in-repo Cornell box
(512^2, 256 spp, depth 6, tent filter) through ``tpu_rt.render`` and checks
a 128^2 box-filter render against the independent golden.  Phase 2 runs the
USMain ultrasound acquisition -> DAS -> B-mode through ``us_render_fast``
and checks the echo position, the matmul DAS against the gather DAS, and a
small acquisition on the GPU against the same acquisition on the CPU.
Phase 3 runs the sharded optical pass, sharded acquisition and sharded DAS
on a 1-D mesh of four GPUs against their one-GPU results.

Everything runs in this one process, the only one to open the card(s).
Any failed check raises, so the script exits nonzero without printing its
last line, which on success is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Sizes of the main paths: the reference's production configurations.
OPT_RES, OPT_SPP = 512, 256  # cbox.xml: 512^2, 256 spp (depth 6, tent)
US_RPP = 64  # USMain: rays per (angle, element) pair
X_BOUNDS, Z_BOUNDS = (-0.04, 0.04), (0.001, 0.05)  # USMain image window (m)

# Phase 1 correctness: 8x8-block rel-RMSE of a 128^2 box-filter render at
# RMSE_SPP against the 8192-spp independent golden.  The bound covers the
# Monte Carlo noise of both images (~0.7% at 2048 spp).
RMSE_SPP = 2048
RMSE_BOUND = 0.02
# Phase 2: matmul DAS vs gather DAS, as a fraction of max|gather|
# (the bound of tests/test_ultrasound.py::test_das_matmul_matches_gather).
DAS_BOUND = 1e-3
# Phase 2: GPU vs CPU acquisition of the same seed.  Both backends draw the
# same threefry streams, but sum the scatter-adds in another order and may
# contract multiply-adds differently.  Deposit times t*fs ~ 5e3 carry f32
# rounding ~5e-4 samples and the carrier phase 2*pi*f*t ~ 3e3 rad carries
# ~2.5e-4 rad, so each deposit may move by ~1e-3 of its size; RF is
# compared as relative L2 error over the whole buffer.
ACQ_REL_L2_BOUND = 1e-2


def log(*args):
    print(*args, flush=True)


def median_time(fn, n):
    """Median wall time of ``n`` calls of ``fn`` ending in block_until_ready."""
    import jax

    ts = []
    for i in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def first_call(fn):
    """(result, seconds) of the first call, compile included."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase0():
    import jax

    from bench import card_name_and_power_limit

    log("== phase 0: device")
    log(card_name_and_power_limit())
    log("jax", jax.__version__, "devices", jax.devices())
    log("XLA_FLAGS", repr(os.environ.get("XLA_FLAGS", "")))


def phase1():
    import tpu_rt
    from bench import block_rel_rmse
    from tpu_rt.integrator.path import render
    from tpu_rt.scene import SCENE_DIR

    log(f"== phase 1: optical (cbox {OPT_RES}^2, {OPT_SPP} spp, depth 6, tent)")
    cbox = os.path.join(SCENE_DIR, "cbox.xml")
    scene = tpu_rt.load_file(cbox, res=OPT_RES, spp=OPT_SPP)
    check(scene.max_depth == 6, "cbox max_depth")
    img, t_first = first_call(lambda: tpu_rt.render(scene, seed=0))
    med, ts = median_time(lambda i: tpu_rt.render(scene, seed=i + 1), 5)
    rays = int(render.last_ray_count)
    img = np.asarray(img)
    log(json.dumps({"cbox_first_call_s": t_first, "cbox_median_s": med,
                    "cbox_times_s": ts, "rays_per_render": rays,
                    "rays_per_s": rays / med, "image_mean": float(img.mean())}))
    check(img.shape == (OPT_RES, OPT_RES, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all(), "non-finite pixels")
    check(img.mean() > 0, "black image")

    golden = np.load(os.path.join(HERE, "tests", "golden",
                                  "cbox_128_gi_independent.npy"))
    s128 = tpu_rt.load_file(cbox, res=128, spp=1)
    s128 = s128.replace(camera=s128.camera.replace(filter_type=0))
    img128 = np.asarray(tpu_rt.render(s128, spp=RMSE_SPP, seed=9))
    rel = block_rel_rmse(img128, golden, 8)
    log(json.dumps({"cbox128_spp": RMSE_SPP, "block8_rel_rmse": rel,
                    "bound": RMSE_BOUND}))
    check(rel <= RMSE_BOUND, f"block rel-RMSE {rel:.4f} > {RMSE_BOUND}")


def echo_depth_span(scene, x_bounds, z_bounds):
    """Depths (m) at which the plate crosses the image plane y = 0 inside
    the image: the plate's centre line is c + s*u (u = its object x axis
    in world space, |s| <= |u|), clipped to the lateral bounds and to the
    depth window."""
    from tpu_rt.us.scenes import PLATE_DEPTH

    m = np.asarray(scene.shape_to_world)[scene.ids["shapes"]["flat_plate"]]
    c, u = m[:3, 3], m[:3, 0]
    check(abs(c[2] - PLATE_DEPTH) < 1e-6, "plate centre")
    s = np.linspace(-1.0, 1.0, 20001)
    x, z = c[0] + s * u[0], c[2] + s * u[2]
    inside = ((x >= x_bounds[0]) & (x <= x_bounds[1])
              & (z >= z_bounds[0]) & (z <= z_bounds[1]))
    return float(z[inside].min()), float(z[inside].max())


def phase2():
    import jax
    import jax.numpy as jnp

    from tpu_rt.integrator.ultrasound import simulate_acquisition
    from tpu_rt.sensor.transducer import element_geometry
    from tpu_rt.us.beamform import das_beamform, das_beamform_matmul, grid_scan
    from tpu_rt.us.pipeline import us_render_fast
    from tpu_rt.us.scenes import usmain_scene

    log("== phase 2: ultrasound (USMain: 5 angles x 64 elements x 10k "
        f"samples, depth 10, {US_RPP} rays per pair)")
    x_bounds, z_bounds = X_BOUNDS, Z_BOUNDS
    scene = usmain_scene()
    us = scene.ultrasound

    def frame(seed):
        return us_render_fast(scene, seed=seed, rays_per_pair=US_RPP,
                              x_bounds=x_bounds, z_bounds=z_bounds)

    (bmode, rf, _), t_first = first_call(lambda: frame(0))
    med, ts = median_time(lambda i: frame(i + 1), 3)
    paths = us.n_angles * us.n_elements * US_RPP
    log(json.dumps({"us_first_call_s": t_first, "us_median_frame_s": med,
                    "us_frame_times_s": ts, "acoustic_paths_per_frame": paths,
                    "primary_rays_per_s": paths / med}))

    step = float(us.sound_speed) / float(us.frequency) / 4.0
    xg, zg = grid_scan(*x_bounds, *z_bounds, step, step)
    bmode = np.asarray(bmode)
    check(bmode.shape == (zg.shape[0], xg.shape[0]), f"B-mode {bmode.shape}")
    check(np.isfinite(bmode).all(), "non-finite B-mode")
    check(bmode.min() >= 0.0 and bmode.max() <= 1.0, "B-mode outside [0, 1]")
    z_lo, z_hi = echo_depth_span(scene, x_bounds, z_bounds)
    z = np.asarray(zg)
    row_mean = bmode.mean(axis=1)
    top = np.sort(z[np.argsort(-row_mean)[:10]])
    shallow = row_mean[z < z_lo].mean()
    span = row_mean[(z >= z_lo) & (z <= z_hi)].mean()
    log(json.dumps({"plate_depth_span_mm": [z_lo * 1e3, z_hi * 1e3],
                    "brightest_rows_mm": (top * 1e3).tolist(),
                    "row_mean_in_span": float(span),
                    "row_mean_above_span": float(shallow)}))
    check(((top >= z_lo) & (top <= z_hi)).all(),
          "brightest B-mode rows outside the plate's depth span")
    check(span > shallow, "plate span no brighter than the rows above it")

    # DAS at USMain size: matmul form vs gather form on this frame's RF.
    pos, _ = element_geometry(us.n_elements, us.pitch, us.radius,
                              us.opening_angle)
    args = (us.angles, pos[:, 0], us.sampling_rate, us.sound_speed, xg, zg)
    das_mm = jax.jit(lambda r: das_beamform_matmul(r, *args, elem_z=pos[:, 2]))
    das_g = jax.jit(lambda r: das_beamform(r, *args, elem_z=pos[:, 2]))
    out_mm, out_g = das_mm(rf), das_g(rf)
    t_mm, _ = median_time(lambda i: das_mm(rf), 3)
    t_g, _ = median_time(lambda i: das_g(rf), 3)
    out_mm, out_g = np.asarray(out_mm), np.asarray(out_g)
    err = float(np.abs(out_mm - out_g).max() / np.abs(out_g).max())
    log(json.dumps({"das_matmul_s": t_mm, "das_gather_s": t_g,
                    "das_max_err_over_max": err, "bound": DAS_BOUND}))
    check(err <= DAS_BOUND, f"matmul DAS vs gather DAS {err:.2e}")

    # Acquisition: GPU vs CPU backend, same seed, 1 angle x 16 elements x
    # 4 rays per pair.
    small = scene.replace(ultrasound=us.replace(
        n_angles=1, n_elements=16, angles=jnp.zeros((1,), jnp.float32)))
    acq = jax.jit(simulate_acquisition, static_argnames=("rays_per_pair",))
    rf_gpu = np.asarray(acq(small, 7, rays_per_pair=4)[0])
    # The CPU program goes through the persistent compile cache, which may
    # be filled on another host: cap its instruction set at AVX2 so a cached
    # executable runs on any x86-64 host.
    acq_cpu = jax.jit(simulate_acquisition, static_argnames=("rays_per_pair",),
                      compiler_options={"xla_cpu_max_isa": "AVX2"})
    cpu = jax.devices("cpu")[0]
    rf_cpu = np.asarray(acq_cpu(jax.device_put(small, cpu), 7, rays_per_pair=4)[0])
    rel_l2 = float(np.linalg.norm(rf_gpu - rf_cpu) / np.linalg.norm(rf_cpu))
    log(json.dumps({"acq_rf_rel_l2_gpu_vs_cpu": rel_l2,
                    "acq_rf_max_abs_diff": float(np.abs(rf_gpu - rf_cpu).max()),
                    "acq_rf_max_abs": float(np.abs(rf_cpu).max()),
                    "bound": ACQ_REL_L2_BOUND}))
    check(np.abs(rf_cpu).max() > 0, "CPU acquisition recorded no echo")
    check(rel_l2 <= ACQ_REL_L2_BOUND, f"GPU vs CPU RF rel-L2 {rel_l2:.2e}")


def phase3():
    import jax
    import jax.numpy as jnp

    import tpu_rt
    from tpu_rt.integrator.path import path_trace
    from tpu_rt.integrator.path import render as render_one
    from tpu_rt.integrator.ultrasound import simulate_acquisition
    from tpu_rt.parallel.render import default_mesh, render_pass_sharded, render_sharded
    from tpu_rt.parallel.ultrasound import das_beamform_sharded, simulate_acquisition_sharded
    from tpu_rt.scene import SCENE_DIR
    from tpu_rt.sensor import camera as cam
    from tpu_rt.sensor import film as film_mod
    from tpu_rt.sensor.transducer import element_geometry
    from tpu_rt.us.beamform import das_beamform_matmul, grid_scan
    from tpu_rt.us.scenes import usmain_scene

    log("== phase 3: four GPUs")
    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = default_mesh(devs)
    d0 = devs[0]

    def peaks():
        return [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                for d in devs]

    # (a) one sharded optical pass vs the same pixels/keys on one GPU
    # (tests/test_parallel_and_grad.py::test_sharded_render_matches_single_chip).
    scene = tpu_rt.load_file(os.path.join(SCENE_DIR, "cbox.xml"), res=OPT_RES, spp=1)
    key = jax.random.PRNGKey(3)
    pass_fn = jax.jit(lambda k: render_pass_sharded(scene, k, mesh))
    fv, fw, n_sh = jax.block_until_ready(pass_fn(key))
    check(fv.sharding.device_set == set(devs), "film not on all four GPUs")
    H = W = OPT_RES
    xy = jnp.stack(jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"),
                   -1).reshape(-1, 2)
    keys = jax.random.split(key, 4)
    tile = xy.shape[0] // 4

    @jax.jit
    def one_tile(xs, k):
        k_jit, k_path = jax.random.split(k)
        film_xy = xs.astype(jnp.float32) + jax.random.uniform(k_jit, xs.shape)
        o, d, t0, t1 = cam.sample_ray_extents(scene.camera, film_xy)
        L, n = path_trace(scene, o, d, k_path, tmin0=t0, tmax0=t1)
        ok = jnp.all(jnp.isfinite(L), axis=-1)
        L = jnp.where(ok[:, None], L, 0.0)
        v, w = film_mod.splat(jnp.zeros((H, W, 3)), jnp.zeros((H, W)),
                              film_xy, L, ok, scene.camera.filter_type)
        return v, w, n

    fv1 = jnp.zeros((H, W, 3), jnp.float32, device=d0)
    fw1 = jnp.zeros((H, W), jnp.float32, device=d0)
    n1 = 0
    for i in range(4):
        v, w, n = one_tile(jax.device_put(xy[i * tile:(i + 1) * tile], d0),
                           jax.device_put(keys[i], d0))
        fv1, fw1, n1 = fv1 + v, fw1 + w, n1 + int(n)
    np.testing.assert_allclose(np.asarray(fv), np.asarray(fv1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fw), np.asarray(fw1), rtol=1e-5, atol=1e-6)
    check(int(n_sh) == n1, f"sharded ray count {int(n_sh)} != {n1}")
    log(json.dumps({"render_pass_sharded_vs_one_gpu": "equal",
                    "max_abs_diff": float(np.abs(np.asarray(fv) - np.asarray(fv1)).max()),
                    "rays": n1}))

    # Full sharded render vs the one-GPU render: time and image statistics.
    spp = 64
    t0 = time.perf_counter()
    img4 = np.asarray(render_sharded(scene, spp=spp, seed=0, mesh=mesh))
    t4_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img4 = np.asarray(render_sharded(scene, spp=spp, seed=1, mesh=mesh))
    t4 = time.perf_counter() - t0
    with jax.default_device(d0):
        img1 = np.asarray(render_one(scene, spp=spp, seed=0))
        t0 = time.perf_counter()
        img1 = np.asarray(render_one(scene, spp=spp, seed=1))
        t1 = time.perf_counter() - t0
    log(json.dumps({"render_sharded_spp": spp, "four_gpu_s": t4,
                    "four_gpu_first_call_s": t4_first, "one_gpu_s": t1,
                    "four_gpu_mean": float(img4.mean()),
                    "one_gpu_mean": float(img1.mean())}))
    check(np.isfinite(img4).all() and img4.mean() > 0, "sharded render")
    check(abs(img4.mean() / img1.mean() - 1.0) < 0.02, "sharded image mean")

    # (b) sharded acquisition vs the mean of the per-device one-GPU runs
    # (tests/test_parallel_and_grad.py::test_sharded_acquisition_matches_single_chip_stats).
    us_scene = usmain_scene()
    rpp = US_RPP
    acq4 = jax.jit(lambda s: simulate_acquisition_sharded(
        us_scene, seed=s, rays_per_pair=rpp, mesh=mesh))
    ch4, _ = jax.block_until_ready(acq4(5))
    acq1 = jax.jit(simulate_acquisition, static_argnames=("rays_per_pair",))
    ref = sum(np.asarray(acq1(jax.device_put(us_scene, d0), 5 + i * 7919,
                              rays_per_pair=rpp // 4)[0]) for i in range(4)) / 4
    ch4 = np.asarray(ch4)
    scale = np.abs(ref).max()
    diff = float(np.abs(ch4 - ref).max())
    log(json.dumps({"acq_sharded_max_abs_diff": diff, "rf_max_abs": float(scale)}))
    np.testing.assert_allclose(ch4, ref, rtol=1e-5, atol=1e-5 * scale)

    # (c) sharded DAS at USMain size vs one GPU
    # (tests/test_parallel_and_grad.py::test_sharded_das_matches_single_chip).
    us = us_scene.ultrasound
    step = float(us.sound_speed) / float(us.frequency) / 4.0
    xg, zg = grid_scan(*X_BOUNDS, *Z_BOUNDS, step, step)
    pos, _ = element_geometry(us.n_elements, us.pitch, us.radius, us.opening_angle)
    bf4 = np.asarray(das_beamform_sharded(
        ch4, us.angles, pos[:, 0], us.sampling_rate, us.sound_speed, xg, zg,
        elem_z=pos[:, 2], mesh=mesh))
    with jax.default_device(d0):
        bf1 = np.asarray(jax.jit(lambda r: das_beamform_matmul(
            r, us.angles, pos[:, 0], us.sampling_rate, us.sound_speed, xg, zg,
            elem_z=pos[:, 2]))(jax.device_put(ch4, d0)))
    scale = np.abs(bf1).max()
    log(json.dumps({"das_sharded_max_abs_diff": float(np.abs(bf4 - bf1).max()),
                    "bf_max_abs": float(scale)}))
    np.testing.assert_allclose(bf4, bf1, rtol=1e-6, atol=1e-7 * scale)

    pk = peaks()
    log(json.dumps({"peak_bytes_in_use_per_gpu": pk}))
    check(min(pk[1:]) > 0, "a GPU of the mesh received no work")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase 3 on four GPUs (and nothing else)")
    args = ap.parse_args()

    import jax

    from tpu_rt.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's backend is "
              f"{jax.default_backend()}", file=sys.stderr)
        sys.exit(2)
    log("compile cache:", enable_compile_cache(min_compile_time_secs=1.0))

    phase0()
    if args.four_cards:
        phase3()
    else:
        phase1()
        phase2()
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
