"""Optical benchmark: the in-repo cbox.xml at 512x512, 256 spp, on one GPU.

Prints the card's name and power limit, then ONE JSON line with the
streaming throughput in rays/s (BENCH_STREAM renders dispatched
back-to-back through JAX's async queue, blocked once at the end), the
median single-render latency over BENCH_REPS blocking renders, the block
rel-RMSE of a 128^2 box-filter render against the independent golden
(tests/golden/cbox_128_gi_independent.npy), and the device busy/idle
share read from a profiler trace of the streamed loop.

Runs only on a GPU: without one it exits nonzero and prints no result.
Knobs: BENCH_RES, BENCH_SPP, BENCH_REPS, BENCH_STREAM, BENCH_TRACE=0 (skip
the traced run).
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def card_name_and_power_limit():
    """``nvidia-smi``'s name and power limit of each visible card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def block_rel_rmse(img, golden, block):
    """Relative RMSE of ``block``x``block``-averaged images: per-pixel MC
    noise (present in both finite-spp renders) divides out, so this
    measures transport bias."""
    def down(x, b):
        h, w, c = x.shape
        return x.reshape(h // b, b, w // b, b, c).mean(axis=(1, 3))

    scale = golden.shape[0] // img.shape[0]
    i = down(img, block)
    g = down(golden, block * scale)
    return float(((i - g) ** 2).mean() ** 0.5 / max(g.mean(), 1e-9))


def main():
    import jax
    import numpy as np

    from tpu_rt.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_secs=1.0)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        sys.exit(1)
    print(card_name_and_power_limit(), flush=True)

    import tpu_rt
    from tpu_rt.integrator.path import render
    from tpu_rt.scene import SCENE_DIR

    res = int(os.environ.get("BENCH_RES", "512"))
    spp = int(os.environ.get("BENCH_SPP", "256"))
    reps = int(os.environ.get("BENCH_REPS", "7"))
    n_stream = int(os.environ.get("BENCH_STREAM", "16"))
    cbox = os.path.join(SCENE_DIR, "cbox.xml")
    scene = tpu_rt.load_file(cbox, res=res, spp=spp)

    t0 = time.perf_counter()
    jax.block_until_ready(tpu_rt.render(scene, spp=spp, seed=123))
    compile_s = time.perf_counter() - t0

    # Latency: median of individual blocking renders.
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(tpu_rt.render(scene, spp=spp, seed=rep))
        times.append(time.perf_counter() - t0)
    rays_per_render = int(render.last_ray_count)  # untimed host sync
    ts = sorted(times)
    lat = ts[len(ts) // 2]

    # Throughput: stream renders through the async queue, block once.
    def stream(seed0):
        imgs, counts = [], []
        for i in range(n_stream):
            imgs.append(tpu_rt.render(scene, spp=spp, seed=seed0 + i))
            counts.append(render.last_ray_count)
        return imgs, counts

    t0 = time.perf_counter()
    imgs, counts = stream(1000)
    jax.block_until_ready(imgs)
    dt_stream = time.perf_counter() - t0
    rays_per_sec = sum(int(c) for c in counts) / dt_stream

    trace = None
    if os.environ.get("BENCH_TRACE", "1") == "1":
        from tpu_rt.utils.profiling import measure_device_trace

        trace = measure_device_trace(lambda: stream(77)[0])

    rmse_spp = 2048
    golden = np.load(os.path.join(HERE, "tests", "golden",
                                  "cbox_128_gi_independent.npy"))
    s128 = tpu_rt.load_file(cbox, res=128, spp=1)
    s128 = s128.replace(camera=s128.camera.replace(filter_type=0))
    img128 = np.asarray(tpu_rt.render(s128, spp=rmse_spp, seed=9))
    rel_rmse = block_rel_rmse(img128, golden, 8)

    print(json.dumps({
        "metric": f"cbox {res}^2 {spp}spp path-tracing throughput (1 GPU)",
        "value": rays_per_sec,
        "unit": "rays/sec",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "renderer": "xla-wavefront",
        "first_call_s": compile_s,
        "median_render_s": lat,
        "latency_spread_s": {"min": ts[0], "median": lat, "max": ts[-1],
                             "n": len(ts)},
        "stream_n": n_stream,
        "stream_wall_s": dt_stream,
        "latency_rays_per_sec": rays_per_render / lat,
        "rays_per_render": rays_per_render,
        "rel_rmse_vs_independent_golden": rel_rmse,
        "rel_rmse_spp": rmse_spp,
        "measured_device_trace": trace,
    }))


if __name__ == "__main__":
    main()
