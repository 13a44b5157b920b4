"""DAS tiling / precision sweep on one GPU at the USMain size.

Times the gather-form DAS (tpu_rt/us/beamform.py::das_beamform) and the
matmul form (das_beamform_matmul) over tile shapes and precisions of the
hat-weight contraction at the reference USMain acquisition config (5
angles, 64 elements, 10k samples at 50 MHz / 5 MHz / 1540 m/s; lambda/4
grid over x in [-4, 4] cm, z in [1, 50] mm -> 1040 x 638 pixels), and
checks each variant against the gather form.

Run:  python tools/diag_das.py
Prints the card's name and power limit, then one line per variant.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FS, F0, C = 50e6, 5e6, 1540.0
A, E, T = 5, 64, 10000


def main():
    import jax

    from bench import card_name_and_power_limit
    from tpu_rt.us.beamform import das_beamform, das_beamform_matmul, grid_scan
    from tpu_rt.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_secs=1.0)
    if jax.devices()[0].platform != "gpu":
        print("diag_das.py needs a GPU", file=sys.stderr)
        sys.exit(1)
    print(card_name_and_power_limit(), flush=True)

    rng = np.random.default_rng(0)
    # Band-limited synthetic RF: white noise convolved with a 5 MHz pulse
    # so the interpolation error check is representative.
    t = np.arange(64) / FS
    pulse = np.sin(2 * np.pi * F0 * t) * np.exp(-0.5 * ((t - t[32]) / (t[8])) ** 2)
    ch = rng.standard_normal((A, E, T)).astype(np.float32)
    ch = np.apply_along_axis(lambda x: np.convolve(x, pulse, "same"), 2, ch)
    ch = jax.device_put(ch.astype(np.float32))
    elem_x = (np.arange(E, dtype=np.float32) - (E - 1) / 2) * 0.00012
    angles = np.linspace(-15, 15, A).astype(np.float32)
    step = C / F0 / 4.0
    xg, zg = grid_scan(-0.04, 0.04, 0.001, 0.05, step, step)
    print(f"grid {xg.shape[0]} x {zg.shape[0]} = {xg.shape[0] * zg.shape[0]} px",
          flush=True)

    ref = None

    def run(label, fn):
        nonlocal ref
        f = jax.jit(fn)
        out = jax.block_until_ready(f(ch))  # compile + warm
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(f(ch))
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        o = np.asarray(out)
        if ref is None:
            ref = o
            rel = 0.0
        else:
            rel = float(np.sqrt(((o - ref) ** 2).mean())
                        / max(np.sqrt((ref ** 2).mean()), 1e-30))
        print(f"{label:42s} {ms:8.2f} ms   rel-rmse vs gather {rel:.2e}",
              flush=True)

    run("gather (reference form)",
        lambda d: das_beamform(d, angles, elem_x, FS, C, xg, zg))
    P = jax.lax.Precision
    for tx, tz, prec, tag in [
        (4, 4, P.HIGHEST, "4x4 HIGHEST"),
        (8, 8, P.HIGHEST, "8x8 HIGHEST (default)"),
        (16, 16, P.HIGHEST, "16x16 HIGHEST"),
        (8, 8, P.DEFAULT, "8x8 DEFAULT (TF32 hat contraction)"),
    ]:
        run(f"matmul {tag}",
            lambda d, tx=tx, tz=tz, prec=prec: das_beamform_matmul(
                d, angles, elem_x, FS, C, xg, zg, tx=tx, tz=tz,
                precision=prec))


if __name__ == "__main__":
    main()
