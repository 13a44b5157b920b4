"""Bitmap texture evaluation (bilinear, repeat wrap).

JAX rebuild of the capability the reference's consumed Mitsuba
stack provides via its ``bitmap`` texture plugin (assets shipped at
/root/reference/scenes/textures/image_00*.png): a BSDF parameter —
reflectance on diffuse here — sampled per hit from an image by UV.

Design: all scene textures live in ONE padded atlas ``tex_data``
[K, Hm, Wm, 3] with true sizes in ``tex_hw`` [K, 2]; each lane carries a
texture index (-1 = constant parameter).  The four bilinear taps become
gathers into the FLATTENED atlas (a single [K*Hm*Wm, 3] table), so the
whole lookup is one vectorized take per tap — no per-texture branching,
XLA-fusion friendly.

Conventions (matching Mitsuba's bitmap defaults): uv (0, 0) addresses the
first stored row/pixel (image top-left), v grows with image row; wrap mode
"repeat"; filter bilinear with half-texel centering (uv*size - 0.5); sRGB
decode to linear happens at LOAD time (scene/png.py srgb=True), matching
``raw=false``.
"""

from __future__ import annotations

import jax.numpy as jnp


def eval_bitmap(tex_data, tex_hw, tex_idx, uv):
    """Bilinear-sample per-lane textures.

    Args:
      tex_data: [K, Hm, Wm, 3] float32 padded texture atlas.
      tex_hw:   [K, 2] float32 true (h, w) of each texture.
      tex_idx:  [N] int32 texture index per lane; lanes with -1 return 0
                (callers select their constant value for those lanes).
      uv:       [N, 2] float32.
    Returns: [N, 3] float32 linear RGB.
    """
    k, hm, wm, _ = tex_data.shape
    flat = tex_data.reshape(k * hm * wm, 3)
    from tpu_rt.core.math import small_table_lookup

    idx = jnp.maximum(tex_idx, 0)
    hw = small_table_lookup(tex_hw, idx)  # [N, 2] — K is tiny
    h, w = hw[:, 0], hw[:, 1]

    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]

    # repeat wrap on the TRUE size (padding is never addressed)
    def wrap(i, size):
        return jnp.mod(i, size).astype(jnp.int32)

    x0 = wrap(x0f, w)
    x1 = wrap(x0f + 1.0, w)
    y0 = wrap(y0f, h)
    y1 = wrap(y0f + 1.0, h)

    base = idx * (hm * wm)

    def tap(yi, xi):
        return jnp.take(flat, base + yi * wm + xi, axis=0)

    c00 = tap(y0, x0)
    c01 = tap(y0, x1)
    c10 = tap(y1, x0)
    c11 = tap(y1, x1)
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    out = top * (1.0 - fy) + bot * fy
    return jnp.where((tex_idx >= 0)[:, None], out, 0.0)


def apply_reflectance_textures(scene, b_c, b_params, uv):
    """Overlay textured reflectance onto gathered BSDF param rows.

    ``b_c``: [N] clamped bsdf indices, ``b_params``: [N, 16] gathered rows,
    ``uv``: [N, 2] hit UVs.  No-op (returns ``b_params``) when the scene has
    no textures — callers gate on ``scene.has_textures`` so untextured
    programs are unchanged.
    """
    from tpu_rt.core.math import small_table_lookup

    t_idx = small_table_lookup(scene.bsdf_tex, b_c)
    rgb = eval_bitmap(scene.tex_data, scene.tex_hw, t_idx, uv)
    textured = (t_idx >= 0)[:, None]
    new_refl = jnp.where(textured, rgb, b_params[:, 0:3])
    return jnp.concatenate([new_refl, b_params[:, 3:]], axis=1)
