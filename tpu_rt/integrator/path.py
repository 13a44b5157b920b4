"""Megabatched wavefront path tracer with NEE + MIS + Russian roulette.

JAX rebuild of the capability the reference gets from Mitsuba's C++
``path`` integrator (scenes/cbox.xml:7-9; SURVEY.md §3.3): the whole bounce
loop is a ``lax.scan`` over SoA ray state — one fused XLA program, no
host<->device crossing per bounce (the reference crosses Python->C++ per
bounce per ray, CustomIntegrator.py:309).

Estimator notes (correct-by-construction, unlike the reference's acoustic
loop — SURVEY.md §2d): BSDF importance sampling divides by the sample pdf
(folded into BSDFSample.weight), NEE uses the power heuristic against BSDF
pdfs, every lane draws independent RNG via threefry key folding.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpu_rt.bsdf import eval as bsdf
from tpu_rt.core.math import coordinate_system, dot, mis_power_heuristic, to_local, to_world
from tpu_rt.emitter import sample as emitter
from tpu_rt.geometry import trace
from tpu_rt.scene.types import Scene
from tpu_rt.sensor import camera as cam
from tpu_rt.sensor import film as film_mod

_MAX_DEPTH_CAP = 32


def _resolved_depth(scene: Scene, max_depth=None):
    d = scene.max_depth if max_depth is None else max_depth
    if d is None or d < 0:
        return _MAX_DEPTH_CAP
    return min(d, _MAX_DEPTH_CAP)


def path_trace(scene: Scene, o, d, key, max_depth=None, rr_depth=None,
               return_occupancy=False, tmin0=None, tmax0=None,
               shadow_geom=None, soft_curves=None):
    """Trace paths for rays (o, d) [N, 3]; returns (L [N, 3], n_rays)
    (+ per-bounce active-lane counts when ``return_occupancy``).

    ``max_depth`` counts path vertices like Mitsuba: max_depth=1 sees only
    directly visible emitters, 2 = direct illumination, etc.

    ``tmin0``/``tmax0`` ([N] or scalar) clip the PRIMARY ray's hit range —
    the camera near/far planes (Mitsuba applies near_clip/far_clip to
    camera rays only; secondary rays keep [eps, inf)).  Hits beyond tmax0
    count as misses (the environment shows through, like Mitsuba's maxt).

    The near plane is applied by STARTING the ray at o + tmin0*d (the
    nearest hit must be searched within [near, far] — gating the global
    nearest hit would kill rays whose first intersection lies before the
    near plane instead of continuing past it).  Hit points are unchanged
    (o' + t'd = o + (tmin0+t')d) and depth-0 MIS never reads t
    (prev_delta = 1), so the estimator is exact.

    ``shadow_geom``/``soft_curves`` enable the differentiable
    soft-curve-shadow estimator (integrator/projective.py — Mitsuba
    direct_projective's visibility derivatives): NEE occlusion tests run
    against ``shadow_geom`` (curve prims displaced out) and the NEE
    contribution is scaled by the smooth curve visibility factor.
    """
    if tmin0 is not None:
        tm = jnp.asarray(tmin0, jnp.float32)
        o = o + (tm[..., None] if tm.ndim else tm) * d
        if tmax0 is not None:
            tmax0 = tmax0 - tmin0
        tmin0 = None
    n = o.shape[0]
    depth_cap = _resolved_depth(scene, max_depth)
    # When no emitter is hittable (point lights only — e.g. simple.xml),
    # the final path segment can only contribute through BSDF-MIS emitter
    # hits, which are identically zero: drop that last intersection sweep.
    n_iters = depth_cap
    if scene.emitters.n_area == 0 and not scene.emitters.has_env:
        n_iters = max(depth_cap - 1, 1)
    rr_start = scene.rr_depth if rr_depth is None else rr_depth

    state = dict(
        o=o,
        d=d,
        L=jnp.zeros((n, 3), jnp.float32),
        thr=jnp.ones((n, 3), jnp.float32),
        eta_scale=jnp.ones((n,), jnp.float32),
        active=jnp.ones((n,), bool),
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_delta=jnp.ones((n,), bool),  # depth-0 hits count fully
        n_rays=jnp.zeros((), jnp.int64 if jax.config.jax_enable_x64 else jnp.int32),
    )

    def bounce(state, inputs):
        depth, key_d = inputs
        o, d = state["o"], state["d"]
        active = state["active"]
        L, thr = state["L"], state["thr"]

        si = trace.ray_intersect(scene, o, d)
        if tmax0 is not None:
            # Camera far plane applies to the primary segment only; the
            # where(depth == 0, ...) keeps one compiled bounce body.  A
            # primary hit beyond maxt is a miss (env shows through).
            in_clip = si.t <= jnp.where(depth == 0, tmax0, trace.INF)
            si = si.replace(
                valid=si.valid & in_clip,
                t=jnp.where(in_clip, si.t, trace.INF),
                shape=jnp.where(in_clip, si.shape, -1),
            )
        hit = si.valid & active
        escaped = ~si.valid & active
        n_rays = state["n_rays"] + jnp.sum(active.astype(jnp.int32))

        # ---- directly / BSDF-MIS visible emitters --------------------------
        cos_l = dot(si.n, si.wi)
        le = emitter.eval_area(scene, si.shape, cos_l)
        # si.t is +inf on miss; clamp before squaring so reverse-mode stays
        # finite (inf * 0 cotangent = NaN otherwise).
        t_safe = jnp.where(si.valid, si.t, 1.0)
        pdf_light = emitter.pdf_direct_area(scene, si.shape, d, t_safe, cos_l)
        w_bsdf = jnp.where(
            state["prev_delta"],
            1.0,
            mis_power_heuristic(state["prev_pdf"], pdf_light),
        )
        vis_ok = hit & ~((depth == 0) & scene.hide_emitters)
        L = L + jnp.where(vis_ok[:, None], thr * le * w_bsdf[:, None], 0.0)

        # environment (miss shader)
        if scene.emitters.has_env:
            le_env = emitter.eval_env(scene, d)
            pdf_env = emitter.pdf_direct_env(scene, d)
            w_env = jnp.where(
                state["prev_delta"], 1.0, mis_power_heuristic(state["prev_pdf"], pdf_env)
            )
            env_ok = escaped & ~((depth == 0) & scene.hide_emitters)
            L = L + jnp.where(env_ok[:, None], thr * le_env * w_env[:, None], 0.0)

        # ---- local frame -----------------------------------------------------
        sfr, tfr = coordinate_system(si.n)
        wi_local = to_local(si.n, sfr, tfr, si.wi)

        from tpu_rt.core.math import small_table_lookup

        b_idx = small_table_lookup(scene.shape_bsdf, jnp.maximum(si.shape, 0))
        b_c = jnp.clip(b_idx, 0, scene.bsdf_type.shape[0] - 1)
        b_type = small_table_lookup(scene.bsdf_type, b_c)
        b_params = small_table_lookup(scene.bsdf_params, b_c)
        if scene.has_textures:
            # Bitmap reflectance overlay at the hit UV (bsdf/texture.py);
            # static gate — untextured scenes compile the same program as
            # before.  Covers NEE eval AND BSDF sampling below.
            from tpu_rt.bsdf.texture import apply_reflectance_textures

            b_params = apply_reflectance_textures(scene, b_c, b_params, si.uv)

        # One fused RNG draw per bounce: [0:4] NEE, [4] lobe, [5:7] bsdf 2D,
        # [7] Russian roulette.
        s_all = jax.random.uniform(key_d, (n, 8))

        # ---- next-event estimation -------------------------------------------
        # NEE adds a path one segment longer than this vertex's, so gate it
        # by Mitsuba's depth convention: vertex i+1 -> light = i+2 segments,
        # allowed only while depth + 2 <= max_depth.
        if scene.emitters.n_lights > 0:
            s_l = s_all[:, 0:4]
            ds = emitter.sample_direct(scene, si.p, s_l[:, 0], s_l[:, 1:4], hit)
            nee_possible = hit & (ds.pdf > 0.0) & (depth + 2 <= depth_cap)
            n_rays = n_rays + jnp.sum(nee_possible.astype(jnp.int32))
            wo_nee = to_local(si.n, sfr, tfr, ds.d)
            f_nee, pdf_bsdf_nee = bsdf.eval_pdf(
                b_type, b_params, wi_local, wo_nee, nee_possible,
                present=scene.bsdf_types_present or None,
            )
            shadow_o = si.spawn_origin(ds.d)
            sgeom = scene.geometry if shadow_geom is None else shadow_geom
            occluded = trace.ray_test(
                sgeom, shadow_o, ds.d, tmin=trace.RAY_EPS,
                tmax=ds.dist * (1.0 - 1e-3),
            )
            vis = nee_possible & ~occluded
            w_nee = jnp.where(
                ds.delta, 1.0, mis_power_heuristic(ds.pdf, pdf_bsdf_nee)
            )
            contrib = thr * f_nee * ds.radiance * (w_nee / jnp.maximum(ds.pdf, 1e-20))[:, None]
            contrib = jnp.where(vis[:, None], contrib, 0.0)
            if soft_curves is not None:
                from tpu_rt.integrator import projective as _proj

                v_soft = _proj.curve_soft_visibility(
                    soft_curves, shadow_o, ds.d, ds.dist * (1.0 - 1e-3),
                    soft_curves["width"],
                )
                contrib = contrib * v_soft[:, None]
            L = L + contrib

        # ---- BSDF sampling & bounce ---------------------------------------------
        bs = bsdf.sample(b_type, b_params, wi_local, s_all[:, 4], s_all[:, 5:7],
                         hit, present=scene.bsdf_types_present or None)
        d_new = to_world(si.n, sfr, tfr, bs.wo)
        o_new = si.spawn_origin(d_new)

        thr_new = thr * bs.weight
        eta_scale = state["eta_scale"] * bs.eta
        alive = hit & (bs.pdf > 0.0) & (jnp.max(thr_new, axis=-1) > 0.0)

        # ---- Russian roulette ----------------------------------------------------
        inv_eta2 = 1.0 / jnp.maximum(eta_scale * eta_scale, 1e-12)
        q = jnp.minimum(jnp.max(thr_new, axis=-1) * inv_eta2, 0.95)
        u_rr = s_all[:, 7]
        do_rr = depth >= rr_start
        survive = jnp.where(do_rr, u_rr < q, True)
        thr_new = jnp.where(
            (do_rr & survive)[:, None], thr_new / jnp.maximum(q, 1e-12)[:, None], thr_new
        )
        alive = alive & survive

        new_state = dict(
            o=o_new,
            d=d_new,
            L=L,
            thr=jnp.where(alive[:, None], thr_new, 0.0),
            eta_scale=eta_scale,
            active=alive,
            prev_pdf=bs.pdf,
            prev_delta=bs.delta,
            n_rays=n_rays,
        )
        # per-bounce occupancy (SURVEY.md §5 metrics: active-ray occupancy
        # after each bounce) — a cheap reduction the scan stacks for free
        return new_state, jnp.sum(alive.astype(jnp.int32))

    keys = jax.random.split(key, n_iters)
    depths = jnp.arange(n_iters)
    state, occupancy = jax.lax.scan(bounce, state, (depths, keys))
    if return_occupancy:
        return state["L"], state["n_rays"], occupancy
    return state["L"], state["n_rays"]


def _make_keys_seeds(root, start, seed_base, k):
    """Per-pass PRNG keys (fold_in of ``start + i``) and integer seeds
    (``seed_base + start + i``) for ``k`` sample passes, in one call."""
    idx = start + jnp.arange(k)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(idx)
    seeds = (seed_base + idx).astype(jnp.int32)
    return keys, seeds


def render_sample_batch(scene: Scene, key, max_depth=None):
    """One sample per pixel: raygen -> path_trace -> (film_xy, L, n_rays)."""
    c = scene.camera
    H, W = c.height, c.width
    xy_int = jnp.stack(
        jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), axis=-1
    ).reshape(-1, 2)
    k_jit, k_path = jax.random.split(key)
    jitter = jax.random.uniform(k_jit, (H * W, 2))
    film_xy = xy_int.astype(jnp.float32) + jitter
    o, d, t0, t1 = cam.sample_ray_extents(c, film_xy)
    L, n_rays = path_trace(scene, o, d, k_path, max_depth=max_depth,
                           tmin0=t0, tmax0=t1)
    return film_xy, L, n_rays


@partial(jax.jit, static_argnames=("max_depth",))
def _render_passes(scene, film_vals, film_wts, keys, max_depth):
    """One-sample-per-pixel waves, one per key, via lax.scan.

    Module-level jit taking the scene as an argument: repeated render()
    calls with the same scene *structure* hit the jit cache instead of
    re-tracing a fresh closure."""
    c = scene.camera
    H, W = c.height, c.width
    xy_int = jnp.stack(
        jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), axis=-1
    ).reshape(-1, 2).astype(jnp.float32)

    def one(carry, key):
        fv, fw, acc = carry
        k_jit, k_path = jax.random.split(key)
        jitter = jax.random.uniform(k_jit, (H * W, 2))
        film_xy = xy_int + jitter
        o, d, t0, t1 = cam.sample_ray_extents(c, film_xy)
        L, n_rays = path_trace(scene, o, d, k_path, max_depth=max_depth,
                               tmin0=t0, tmax0=t1)
        ok = jnp.all(jnp.isfinite(L), axis=-1)
        # pixel-aligned sample pattern -> scatter-free dense splat
        fv, fw = film_mod.splat_aligned(
            fv, fw,
            jitter.reshape(H, W, 2),
            L.reshape(H, W, 3),
            ok.reshape(H, W),
            c.filter_type,
        )
        return (fv, fw, acc + n_rays), None

    (fv, fw, acc), _ = jax.lax.scan(
        one, (film_vals, film_wts, jnp.zeros((), jnp.int32)), keys
    )
    return fv, fw, acc


def render(scene: Scene, spp=None, seed=0, max_depth=None, spp_per_pass=8):
    """Full render: returns (H, W, 3) image.

    All spp one-sample-per-pixel waves run in ONE jit dispatch via
    lax.scan (device memory holds a single W*H megabatch of ray state at
    a time regardless of scan length; ``spp_per_pass`` is kept only as an
    API no-op).  ``render.last_ray_count`` is a lazy device scalar — int()
    it to read, outside any timed region.
    """
    c = scene.camera
    spp = c.spp if spp is None else spp
    H, W = c.height, c.width

    film_vals = jnp.zeros((H, W, 3), jnp.float32)
    film_wts = jnp.zeros((H, W), jnp.float32)
    keys, _ = _make_keys_seeds(jax.random.PRNGKey(seed), jnp.int32(0),
                               jnp.int32(0), spp)
    film_vals, film_wts, n_rays = _render_passes(
        scene, film_vals, film_wts, keys, max_depth)
    img = film_mod.develop(film_vals, film_wts)
    render.last_ray_count = n_rays  # observability (SURVEY.md §5 metrics row)
    return img
