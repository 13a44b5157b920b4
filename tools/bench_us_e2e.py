"""End-to-end ultrasound product-path timing on one GPU.

Times the full USMain pipeline — acquisition (XLA wavefront tracer) ->
DAS beamforming -> envelope -> log compression -> B-mode — through
``us_render_fast`` at the reference's production config
(tpu_rt/us/scenes.py::usmain_scene: 45-degree plate + back wall, 5
plane-wave angles x 64 elements x 10k time samples, max_depth 10) with 64
rays per (angle, element) pair.

Run:  python tools/bench_us_e2e.py   (knobs: US_RPP, US_REPS)
Prints the card's name and power limit, then one JSON line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from bench import card_name_and_power_limit
    from tpu_rt.us.pipeline import us_render_fast
    from tpu_rt.us.scenes import usmain_scene
    from tpu_rt.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_secs=1.0)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_us_e2e.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(1)
    print(card_name_and_power_limit(), flush=True)

    scene = usmain_scene()
    rpp = int(os.environ.get("US_RPP", "64"))
    reps = int(os.environ.get("US_REPS", "3"))

    t0 = time.perf_counter()
    img, _, _ = us_render_fast(scene, seed=0, rays_per_pair=rpp)
    jax.block_until_ready(img)
    first_s = time.perf_counter() - t0
    assert np.isfinite(np.asarray(img)).all()

    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        img, _, _ = us_render_fast(scene, seed=rep + 1, rays_per_pair=rpp)
        jax.block_until_ready(img)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    us = scene.ultrasound
    paths = us.n_angles * us.n_elements * rpp
    print(json.dumps({
        "metric": "us_e2e_median_s", "value": med, "unit": "s",
        "config": f"USMain {us.n_angles}x{us.n_elements}x{us.time_samples} "
                  f"rpp{rpp}",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "first_call_s": first_s, "times_s": times,
        "acoustic_paths_per_s": paths / med,
        "image_shape": list(np.asarray(img).shape),
    }))


if __name__ == "__main__":
    main()
