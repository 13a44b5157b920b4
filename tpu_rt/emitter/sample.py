"""Emitter sampling for next-event estimation, plus miss-shader env lookup.

JAX equivalents of Mitsuba's area / point / envmap emitters
(SURVEY.md §2b stock-emitter row).  Light selection is uniform over light
units (area shapes, point lights, the envmap) like Mitsuba's uniform emitter
sampling; area emitters then sample a triangle proportional to area within
the shape via a per-emitter CDF.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpu_rt.core import struct
from tpu_rt.core.math import small_table_lookup, dot, normalize, transform_vector, vec3
from tpu_rt.core.warps import square_to_uniform_triangle
from tpu_rt.scene.types import Emitters, Scene


@struct.dataclass
class DirectSample:
    """A light sample toward a reference point (NEE)."""

    p: jnp.ndarray  # [N, 3] point on the light (or far point for envmap)
    n: jnp.ndarray  # [N, 3] light-surface normal (toward scene)
    d: jnp.ndarray  # [N, 3] unit direction ref -> light
    dist: jnp.ndarray  # [N] distance (shortened for shadow-ray tmax)
    pdf: jnp.ndarray  # [N] solid-angle pdf at the reference point
    radiance: jnp.ndarray  # [N, 3] emitted radiance toward ref
    delta: jnp.ndarray  # [N] bool: point lights (no MIS weighting)


def _searchsorted_cdf(cdf, u):
    """Branchless first index with cdf[i] >= u (cdf is small, <= few K)."""
    return jnp.sum((cdf[None, :] < u[:, None]).astype(jnp.int32), axis=1)


def sample_direct(scene: Scene, ref_p, s_light, s_tri, active):
    """Sample a direction to a light from reference points ``ref_p``.

    Args:
      scene: compiled Scene.
      ref_p: [N, 3] reference (shading) points.
      s_light: [N] uniform sample for light selection.
      s_tri: [N, 3] samples: [0] triangle/texel selection, [1:3] position.
    Returns DirectSample (pdf == 0 marks invalid lanes).
    """
    em: Emitters = scene.emitters
    n = ref_p.shape[0]
    L = em.n_lights
    if L == 0:
        z3 = jnp.zeros((n, 3), jnp.float32)
        z1 = jnp.zeros((n,), jnp.float32)
        return DirectSample(p=z3, n=z3, d=z3, dist=z1, pdf=z1, radiance=z3,
                            delta=jnp.zeros((n,), bool))

    light_idx = jnp.minimum((s_light * L).astype(jnp.int32), L - 1)
    sel_pdf = 1.0 / L

    p = jnp.zeros((n, 3), jnp.float32)
    nrm = jnp.zeros((n, 3), jnp.float32)
    radiance = jnp.zeros((n, 3), jnp.float32)
    pdf_area = jnp.zeros((n,), jnp.float32)  # area-measure pdf (0 for delta/env)
    delta = jnp.zeros((n,), bool)
    env_mask = jnp.zeros((n,), bool)

    # --- area emitters: light_idx in [0, n_area) ------------------------------
    if em.n_area > 0:
        is_area = light_idx < em.n_area
        e = jnp.clip(light_idx, 0, em.n_area - 1)
        lo = small_table_lookup(em.em_offsets, e)
        hi = small_table_lookup(em.em_offsets, e + 1)
        # per-emitter CDF search over its slice (global table is small)
        ET = em.em_tri_cdf.shape[0]
        idxs = jnp.arange(ET)[None, :]
        in_slice = (idxs >= lo[:, None]) & (idxs < hi[:, None])
        passed = in_slice & (em.em_tri_cdf[None, :] < s_tri[:, 0:1])
        ti = lo + jnp.sum(passed.astype(jnp.int32), axis=1)
        ti = jnp.minimum(ti, hi - 1)
        # two-step: gather the FEW emissive-tri rows once (cheap — ET
        # indices into the big table), then select-chain per lane
        ti_c = jnp.clip(ti, 0, ET - 1)
        geom = scene.geometry
        p0 = small_table_lookup(geom.tri_p0[em.em_tri_prim], ti_c)
        e1 = small_table_lookup(geom.tri_e1[em.em_tri_prim], ti_c)
        e2 = small_table_lookup(geom.tri_e2[em.em_tri_prim], ti_c)
        bc = square_to_uniform_triangle(s_tri[:, 1:3])
        p_a = p0 + bc[:, 0:1] * e1 + bc[:, 1:2] * e2
        n_a = jnp.cross(e1, e2)
        n_len = jnp.sqrt(jnp.maximum(jnp.sum(n_a * n_a, -1, keepdims=True), 1e-24))
        n_a = n_a / n_len
        pdf_a = 1.0 / jnp.maximum(small_table_lookup(em.area_total, e), 1e-20)
        rad_a = small_table_lookup(em.area_radiance, e)

        p = jnp.where(is_area[:, None], p_a, p)
        nrm = jnp.where(is_area[:, None], n_a, nrm)
        radiance = jnp.where(is_area[:, None], rad_a, radiance)
        pdf_area = jnp.where(is_area, pdf_a, pdf_area)

    # --- point lights ----------------------------------------------------------
    if em.n_point > 0:
        is_pt = (light_idx >= em.n_area) & (light_idx < em.n_area + em.n_point)
        pi = jnp.clip(light_idx - em.n_area, 0, em.n_point - 1)
        p = jnp.where(is_pt[:, None], small_table_lookup(em.point_pos, pi), p)
        delta = delta | is_pt

    # --- envmap ------------------------------------------------------------------
    if em.has_env:
        is_env = light_idx >= em.n_area + em.n_point
        env_mask = is_env

    # Direction/distance for surface + point lights.
    to_light = p - ref_p
    dist2 = jnp.maximum(dot(to_light, to_light), 1e-20)
    dist = jnp.sqrt(dist2)
    d = to_light / dist[..., None]

    # area emitters: convert area pdf -> solid angle; one-sided emission
    cos_l = -dot(d, nrm)
    front = cos_l > 1e-6
    pdf_sa = pdf_area * dist2 / jnp.maximum(cos_l, 1e-6)
    pdf = jnp.where(pdf_area > 0.0, jnp.where(front, pdf_sa, 0.0), 0.0)
    radiance = jnp.where((pdf_area > 0.0)[:, None] & ~front[:, None], 0.0, radiance)

    # point lights: intensity / r^2 handled as radiance with pdf 1
    if em.n_point > 0:
        is_pt = delta
        pi = jnp.clip(light_idx - em.n_area, 0, max(em.n_point - 1, 0))
        rad_pt = small_table_lookup(em.point_intensity, pi) / dist2[:, None]
        radiance = jnp.where(is_pt[:, None], rad_pt, radiance)
        pdf = jnp.where(is_pt, 1.0, pdf)

    # envmap: importance-sample the lat-long map
    if em.has_env:
        d_env, pdf_env, rad_env = _sample_env(em, s_tri[:, 1:3])
        d = jnp.where(env_mask[:, None], d_env, d)
        pdf = jnp.where(env_mask, pdf_env, pdf)
        radiance = jnp.where(env_mask[:, None], rad_env, radiance)
        dist = jnp.where(env_mask, 1e7, dist)
        nrm = jnp.where(env_mask[:, None], -d, nrm)
        p = jnp.where(env_mask[:, None], ref_p + d * 1e7, p)

    pdf = jnp.where(active, pdf * sel_pdf, 0.0)
    return DirectSample(p=p, n=nrm, d=d, dist=dist, pdf=pdf, radiance=radiance,
                        delta=delta)


def _uv_to_dir(uv):
    """Lat-long uv -> direction in envmap local frame (y-up, Mitsuba-style:
    u wraps azimuth from -z through +x, v = polar angle from +y)."""
    phi = (uv[..., 0] - 0.5) * (2.0 * jnp.pi)
    theta = uv[..., 1] * jnp.pi
    st = jnp.sin(theta)
    return vec3(st * jnp.sin(phi), jnp.cos(theta), -st * jnp.cos(phi))


def _dir_to_uv(d):
    u = 0.5 + jnp.arctan2(d[..., 0], -d[..., 2]) / (2.0 * jnp.pi)
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / jnp.pi
    return jnp.stack([u, v], axis=-1)


def _sample_env(em: Emitters, s2):
    H, W = em.env_map.shape[:2]
    row = _searchsorted_cdf(em.env_cdf_rows, s2[..., 0])
    row = jnp.minimum(row, H - 1)
    col_cdf = em.env_cdf_cols[row]
    col = jnp.sum((col_cdf < s2[..., 1:2]).astype(jnp.int32), axis=-1)
    col = jnp.minimum(col, W - 1)

    # Continuous jitter inside the selected texel by rescaling the CDF
    # remainder (keeps the estimator unbiased over the texel's solid angle).
    row_lo = jnp.where(row > 0, em.env_cdf_rows[jnp.maximum(row - 1, 0)], 0.0)
    row_hi = em.env_cdf_rows[row]
    jv = jnp.clip((s2[..., 0] - row_lo) / jnp.maximum(row_hi - row_lo, 1e-12), 0.0, 1.0)
    col_lo = jnp.where(
        col > 0,
        jnp.take_along_axis(col_cdf, jnp.maximum(col - 1, 0)[..., None], axis=-1)[..., 0],
        0.0,
    )
    col_hi = jnp.take_along_axis(col_cdf, col[..., None], axis=-1)[..., 0]
    ju = jnp.clip((s2[..., 1] - col_lo) / jnp.maximum(col_hi - col_lo, 1e-12), 0.0, 1.0)

    uv = jnp.stack([(col + ju) / W, (row + jv) / H], axis=-1)
    d_local = _uv_to_dir(uv)
    d_world = normalize(transform_vector(em.env_to_world, d_local))

    # pdf over solid angle: p(texel)/ (texel solid angle)
    row_pdf = em.env_cdf_rows - jnp.concatenate([jnp.zeros(1), em.env_cdf_rows[:-1]])
    col_pdf = col_cdf - jnp.concatenate(
        [jnp.zeros_like(col_cdf[..., :1]), col_cdf[..., :-1]], axis=-1
    )
    p_texel = row_pdf[row] * jnp.take_along_axis(col_pdf, col[..., None], axis=-1)[..., 0]
    theta = uv[..., 1] * jnp.pi  # continuous: density within the texel
    texel_sa = (2.0 * jnp.pi / W) * (jnp.pi / H) * jnp.maximum(jnp.sin(theta), 1e-6)
    pdf = p_texel / texel_sa
    radiance = em.env_map[row, col] * em.env_scale
    return d_world, pdf, radiance


def pdf_direct_area(scene: Scene, si_shape, d, dist, cos_l):
    """Solid-angle pdf of sample_direct having produced a hit on an emissive
    shape — needed for MIS weighting of BSDF-sampled emitter hits."""
    em = scene.emitters
    if em.n_area == 0:
        return jnp.zeros(si_shape.shape, jnp.float32)
    L = max(em.n_lights, 1)
    e = small_table_lookup(scene.shape_emitter, jnp.maximum(si_shape, 0))
    valid = (si_shape >= 0) & (e >= 0)
    e_c = jnp.clip(e, 0, max(em.n_area - 1, 0))
    pdf_area = 1.0 / jnp.maximum(small_table_lookup(em.area_total, e_c), 1e-20)
    pdf_sa = pdf_area * dist * dist / jnp.maximum(cos_l, 1e-6)
    return jnp.where(valid & (cos_l > 1e-6), pdf_sa / L, 0.0)


def pdf_direct_env(scene: Scene, d_world):
    """Solid-angle pdf of sample_direct for an escaped (envmap) direction."""
    em = scene.emitters
    if not em.has_env:
        return jnp.zeros(d_world.shape[:-1], jnp.float32)
    L = max(em.n_lights, 1)
    H, W = em.env_map.shape[:2]
    d_local = normalize(transform_vector(em.env_to_local, d_world))
    uv = _dir_to_uv(d_local)
    row = jnp.clip((uv[..., 1] * H).astype(jnp.int32), 0, H - 1)
    col = jnp.clip((uv[..., 0] * W).astype(jnp.int32), 0, W - 1)
    row_pdf = em.env_cdf_rows - jnp.concatenate([jnp.zeros(1), em.env_cdf_rows[:-1]])
    col_cdf = em.env_cdf_cols[row]
    col_pdf = col_cdf - jnp.concatenate(
        [jnp.zeros_like(col_cdf[..., :1]), col_cdf[..., :-1]], axis=-1
    )
    p_texel = row_pdf[row] * jnp.take_along_axis(col_pdf, col[..., None], axis=-1)[..., 0]
    theta = uv[..., 1] * jnp.pi  # continuous theta of the actual direction
    texel_sa = (2.0 * jnp.pi / W) * (jnp.pi / H) * jnp.maximum(jnp.sin(theta), 1e-6)
    return p_texel / texel_sa / L


def eval_env(scene: Scene, d_world):
    """Environment radiance for escaped rays (the miss shader)."""
    em = scene.emitters
    if not em.has_env:
        return jnp.zeros(d_world.shape[:-1] + (3,), jnp.float32)
    H, W = em.env_map.shape[:2]
    d_local = normalize(transform_vector(em.env_to_local, d_world))
    uv = _dir_to_uv(d_local)
    row = jnp.clip((uv[..., 1] * H).astype(jnp.int32), 0, H - 1)
    col = jnp.clip((uv[..., 0] * W).astype(jnp.int32), 0, W - 1)
    return em.env_map[row, col] * em.env_scale


def eval_area(scene: Scene, si_shape, cos_l):
    """Radiance of an area emitter hit by a ray (one-sided)."""
    em = scene.emitters
    if em.n_area == 0:
        return jnp.zeros(si_shape.shape + (3,), jnp.float32)
    e = small_table_lookup(scene.shape_emitter, jnp.maximum(si_shape, 0))
    valid = (si_shape >= 0) & (e >= 0) & (cos_l > 0.0)
    e_c = jnp.clip(e, 0, em.n_area - 1)
    return jnp.where(valid[..., None],
                     small_table_lookup(em.area_radiance, e_c), 0.0)
