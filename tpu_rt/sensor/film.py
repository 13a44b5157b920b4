"""Film accumulation with reconstruction filters (box / tent / gaussian).

JAX replacement for Mitsuba's hdrfilm + rfilter splatting
(scenes/cbox.xml:25-31 tent, simple.xml box, cbox_pol.xml gaussian —
SURVEY.md §2b sensor/film row).  Samples scatter-add into (H, W, C) value
and weight planes; ``develop`` normalizes.  Scatter-add is XLA's native
associative accumulation (on the GPU its order may vary between runs).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.scene.types import FILTER_BOX, FILTER_GAUSSIAN, FILTER_TENT

_FOOTPRINT = {FILTER_BOX: 1, FILTER_TENT: 2, FILTER_GAUSSIAN: 4}


def filter_weight(filter_type: int, x):
    """1-D filter kernel (separable), x = distance in pixels."""
    ax = jnp.abs(x)
    if filter_type == FILTER_BOX:
        return (ax <= 0.5).astype(jnp.float32)
    if filter_type == FILTER_TENT:
        return jnp.maximum(0.0, 1.0 - ax)
    # Mitsuba gaussian: stddev 0.5, radius 2, offset subtracted
    sigma = 0.5
    r = 2.0
    g = jnp.exp(-0.5 * (x / sigma) ** 2) - jnp.exp(-0.5 * (r / sigma) ** 2)
    return jnp.maximum(0.0, g) * (ax <= r)


def splat(film_vals, film_wts, film_xy, values, active, filter_type: int):
    """Scatter-add samples into the film.

    Args:
      film_vals: [H, W, C]; film_wts: [H, W].
      film_xy: [N, 2] continuous film position (pixel units).
      values: [N, C] sample values.
      active: [N] bool.
      filter_type: static filter enum.
    Returns updated (film_vals, film_wts).
    """
    H, W = film_wts.shape
    k = _FOOTPRINT[filter_type]
    # Discrete coordinates of the top-left pixel of the footprint.
    x, y = film_xy[..., 0], film_xy[..., 1]
    base_x = jnp.floor(x - 0.5 * (k - 1) - 0.5 + 0.5).astype(jnp.int32)
    base_y = jnp.floor(y - 0.5 * (k - 1) - 0.5 + 0.5).astype(jnp.int32)
    for dy in range(k):
        py = base_y + dy
        wy = filter_weight(filter_type, (py.astype(jnp.float32) + 0.5) - y)
        for dx in range(k):
            px = base_x + dx
            wx = filter_weight(filter_type, (px.astype(jnp.float32) + 0.5) - x)
            w = wx * wy
            ok = active & (px >= 0) & (px < W) & (py >= 0) & (py < H) & (w > 0)
            w = jnp.where(ok, w, 0.0)
            idx = jnp.clip(py, 0, H - 1) * W + jnp.clip(px, 0, W - 1)
            film_vals = film_vals.reshape(H * W, -1).at[idx].add(
                w[..., None] * values, mode="drop"
            ).reshape(H, W, -1)
            film_wts = film_wts.reshape(H * W).at[idx].add(w, mode="drop").reshape(H, W)
    return film_vals, film_wts


def splat_aligned(film_vals, film_wts, jitter, values, active, filter_type: int):
    """Scatter-free splat for the pixel-aligned sample pattern (exactly one
    sample per pixel at pixel + jitter, jitter in [0,1)^2).

    Each footprint cell (dx, dy) becomes a DENSE shifted add of the whole
    sample image, with no scatter.  Numerically
    identical to ``splat`` for film_xy = grid + jitter.

    Args:
      jitter: [H, W, 2]; values: [H, W, C]; active: [H, W].
    """
    H, W = film_wts.shape
    k = _FOOTPRINT[filter_type]
    r = k // 2
    # Footprint offsets relative to the sample's own pixel: with jitter in
    # [0,1) a radius-r filter can touch cells -r .. +r (one of the edge
    # cells gets zero weight for any given jitter — the dense form
    # evaluates it anyway).
    #
    # GATHER form: output pixel o sums over its k*k neighbor samples
    # (pad once, k*k static slice-reads) instead of k*k read-modify-write
    # .at[].add passes over the accumulator — everything fuses into one
    # elementwise sweep.  Whether it beats ``splat`` on the GPU is not
    # measured yet (ROADMAP S6).
    vals = jnp.where(active[..., None], values, 0.0)
    if r == 0:
        return film_vals + vals, film_wts + active.astype(film_wts.dtype)
    pad2 = [(r, r), (r, r)]
    xp = jnp.pad(jitter[..., 0], pad2)
    yp = jnp.pad(jitter[..., 1], pad2)
    vp = jnp.pad(vals, pad2 + [(0, 0)])
    ap = jnp.pad(active, pad2)
    out_v = jnp.zeros_like(film_vals)
    out_w = jnp.zeros_like(film_wts)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            def sl(a, dy=dy, dx=dx):
                return a[r - dy : r - dy + H, r - dx : r - dx + W]

            wy = filter_weight(filter_type, (dy + 0.5) - sl(yp))
            wx = filter_weight(filter_type, (dx + 0.5) - sl(xp))
            w = jnp.where(sl(ap), wx * wy, 0.0)
            out_v = out_v + w[..., None] * sl(vp)
            out_w = out_w + w
    return film_vals + out_v, film_wts + out_w


def _shift_add(acc, img, dy, dx):
    """acc[p + (dy,dx)] += img[p] as a dense slice-add."""
    H, W = acc.shape[0], acc.shape[1]
    ys_a, ye_a = max(dy, 0), H + min(dy, 0)
    ys_i, ye_i = max(-dy, 0), H + min(-dy, 0)
    xs_a, xe_a = max(dx, 0), W + min(dx, 0)
    xs_i, xe_i = max(-dx, 0), W + min(-dx, 0)
    if ys_a >= ye_a or xs_a >= xe_a:
        return acc
    return acc.at[ys_a:ye_a, xs_a:xe_a].add(img[ys_i:ye_i, xs_i:xe_i])


def develop(film_vals, film_wts):
    """Normalize accumulated samples by filter weights."""
    return film_vals / jnp.maximum(film_wts[..., None], 1e-12)
