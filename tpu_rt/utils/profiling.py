"""Profiling / tracing utilities (SURVEY.md §5 tracing row).

The reference's only observability was a tqdm rays/s bar and print
statements (CustomIntegrator.py:382-389,402-404); tpu_rt couples
jax.profiler device traces with the renderers' ray counters.

Usage:
    with trace(log_dir):
        img = render(scene, spp=16)
    # -> TensorBoard / Perfetto trace directory with the XLA op timeline

    stats = RenderStats()
    img = render(scene, spp=64)
    stats.record("cbox", render.last_ray_count)
    print(stats.summary())

bench.py reads the device busy/idle share of its streamed loop with
measure_device_trace (BENCH_TRACE=0 skips it).
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler device trace around a block (TensorBoard format)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RenderStats:
    """Lightweight rays/sec + wall-time aggregator for render calls."""

    def __init__(self):
        self.entries = []
        self._t0 = time.perf_counter()

    def record(self, tag: str, n_rays: int, wall_s: float | None = None):
        now = time.perf_counter()
        if wall_s is None:
            wall_s = now - self._t0
        self._t0 = now
        self.entries.append(
            {"tag": tag, "rays": int(n_rays), "wall_s": float(wall_s),
             "rays_per_s": int(n_rays) / max(wall_s, 1e-12)}
        )

    def summary(self):
        lines = []
        for e in self.entries:
            lines.append(
                f"{e['tag']}: {e['rays']:,} rays in {e['wall_s']*1e3:.1f} ms"
                f" = {e['rays_per_s']/1e6:.1f}M rays/s"
            )
        total_rays = sum(e["rays"] for e in self.entries)
        total_s = sum(e["wall_s"] for e in self.entries)
        if len(self.entries) > 1:
            lines.append(
                f"total: {total_rays:,} rays, {total_s:.3f} s, "
                f"{total_rays/max(total_s,1e-12)/1e6:.1f}M rays/s"
            )
        return "\n".join(lines)


def _union_length(iv):
    """Total length covered by (start, end) intervals that may nest or
    overlap: a device exposes several tracks (streams, XLA modules, XLA
    ops) that carry the same span, so summing durations double-counts."""
    iv = sorted(iv)
    tot = 0.0
    cur_s, cur_e = iv[0]
    for s_, e_ in iv[1:]:
        if s_ > cur_e:
            tot += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    return tot + (cur_e - cur_s)


def device_busy_us(trace_json: dict) -> dict:
    """Busy time (microseconds) of each GPU in a Perfetto trace, keyed by
    the device's process name (``/device:GPU:<i>``): the union of every
    complete event on that device's tracks.  Raises RuntimeError when the
    trace holds no GPU track (a CPU run has none)."""
    evs = trace_json.get("traceEvents", [])
    names = {
        e["pid"]: str(e.get("args", {}).get("name", ""))
        for e in evs
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    dev = {pid: n for pid, n in names.items() if n.startswith("/device:GPU")}
    if not dev:
        raise RuntimeError(
            f"no GPU device track in trace (processes: {sorted(names.values())})")
    iv = {pid: [] for pid in dev}
    for e in evs:
        if e.get("ph") == "X" and e.get("pid") in iv:
            ts = float(e.get("ts", 0.0))
            iv[e["pid"]].append((ts, ts + float(e.get("dur", 0.0))))
    return {dev[pid]: (_union_length(v) if v else 0.0) for pid, v in iv.items()}


def measure_device_trace(fn, log_dir=None):
    """Run ``fn()`` under a jax.profiler trace and return MEASURED device
    time from its Perfetto trace (``perfetto_trace.json.gz``).

    Returns dict with:
      wall_s            — host wall time of fn() (ends in block_until_ready)
      device_busy_s     — busy time of the busiest GPU (union of its events)
      device_busy_frac  — device_busy_s / wall_s
      device_idle_frac  — 1 - device_busy_frac
      n_devices         — GPUs with a track in the trace
    Raises RuntimeError when the trace has no GPU track.
    """
    import glob
    import gzip
    import json
    import tempfile

    import jax

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="tpu_rt_trace_")
    jax.profiler.start_trace(log_dir, create_perfetto_trace=True)
    t0 = time.perf_counter()
    try:
        out = fn()
        jax.block_until_ready(out)
        wall = time.perf_counter() - t0
    finally:
        jax.profiler.stop_trace()

    files = sorted(glob.glob(
        os.path.join(log_dir, "**", "perfetto_trace.json.gz"), recursive=True))
    if not files:
        raise RuntimeError(f"no perfetto_trace.json.gz under {log_dir}")
    with gzip.open(files[-1], "rt") as f:
        busy = device_busy_us(json.load(f))
    busy_s = max(busy.values()) / 1e6
    frac = busy_s / max(wall, 1e-12)
    return {
        "wall_s": wall,
        "device_busy_s": busy_s,
        "device_busy_frac": frac,
        "device_idle_frac": 1.0 - frac,
        "n_devices": len(busy),
    }
