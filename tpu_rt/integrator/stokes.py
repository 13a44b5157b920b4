"""Polarized (Stokes-vector) path tracing with Mueller-matrix transport.

JAX rebuild of Mitsuba's ``stokes``-wrapped ``path`` integrator used
by /root/reference/scenes/cbox_pol.xml:5-7 and the ``polarizer`` BSDF of
polarizers.xml (SURVEY.md §2b/§7 step 6).

Transport model: tracing from the camera, every lane carries an accumulated
camera-side Mueller matrix T (N, 3, 4, 4).  At each vertex the interaction
Mueller matrix M (defined in the s-p basis of the scattering plane) is
chained with a reference-frame rotator:  T <- T @ R(basis_out -> s) @ M,
and the carried basis becomes the scattering s-axis (perpendicular to the
next path segment).  Emitters are unpolarized, so each emission contributes
Le * T[..., :, 0].  The Stokes output basis is the camera's horizontal axis
projected perpendicular to each primary ray.

Directional importance sampling reuses the scalar BSDF sampler
(tpu_rt.bsdf.eval); each Mueller matrix is normalized by its own M[0,0] and
scaled by the scalar throughput weight, which guarantees the Stokes-I
channel equals the unpolarized render exactly while Q/U/V carry the
polarization state.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpu_rt.bsdf import eval as bsdf
from tpu_rt.bsdf import mueller
from tpu_rt.core.math import (
    coordinate_system,
    dot,
    mis_power_heuristic,
    normalize,
    to_local,
    to_world,
    transform_vector,
)
from tpu_rt.emitter import sample as emitter
from tpu_rt.geometry import trace
from tpu_rt.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_POLARIZER,
    BSDF_ROUGH_CONDUCTOR,
    Scene,
)
from tpu_rt.sensor import camera as cam
from tpu_rt.sensor import film as film_mod

_MAX_DEPTH_CAP = 16


def _matmul(a, b):
    """Batched 4x4 Mueller product as broadcast-multiply-sum (f32
    multiply-adds, no dot, so no matmul precision setting applies)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _interaction_mueller(scene, b_type, b_params, si, wi_local, wo_local,
                         scalar_weight, has_polarizer):
    """Mueller matrix (N, 3, 4, 4) for the sampled interaction, expressed in
    the s-p basis of the scattering plane, normalized so M[0,0] equals the
    scalar weight per channel."""
    n = wi_local.shape[0]
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n, 3, 4, 4))

    # default: depolarizer with the scalar weight (diffuse & fallback)
    M = mueller.depolarizer(jnp.moveaxis(scalar_weight, -1, -1))  # (N, 3, 4, 4)

    cos_i = jnp.abs(wi_local[..., 2])

    # --- dielectric specular (reflect/transmit share structure) -------------
    m_die = b_type == BSDF_DIELECTRIC
    eta_rel = b_params[..., 0] / jnp.maximum(b_params[..., 1], 1e-6)
    M_die = mueller.specular_reflection(cos_i[..., None], eta_rel[..., None])
    # transmission detected by wo continuing through the surface
    transmitted = wo_local[..., 2] * wi_local[..., 2] < 0.0
    eta_ti = jnp.where(wi_local[..., 2] >= 0, 1.0 / eta_rel, eta_rel)
    cos_t = jnp.abs(wo_local[..., 2])
    M_die_t = mueller.specular_transmission(
        cos_i[..., None], cos_t[..., None], 1.0 / jnp.maximum(eta_ti, 1e-6)[..., None]
    )
    M_die = jnp.where(transmitted[..., None, None, None], M_die_t, M_die)
    M = jnp.where(m_die[..., None, None, None], M_die, M)

    # --- conductors (smooth + rough use the half-vector Fresnel) ------------
    m_con = (b_type == BSDF_CONDUCTOR) | (b_type == BSDF_ROUGH_CONDUCTOR)
    is_mirror = b_params[..., 0] < 0.0
    eta_c = jnp.where(is_mirror[..., None], 1e6, b_params[..., 0:3])
    k_c = jnp.where(is_mirror[..., None], 1e8, b_params[..., 3:6])
    h = normalize(wi_local + wo_local)
    cos_h = jnp.abs(jnp.sum(wi_local * h, axis=-1))
    M_con = mueller.specular_reflection(cos_h[..., None], eta_c, k_c)
    M = jnp.where(m_con[..., None, None, None], M_con, M)

    # --- polarizer: identity-axis matrix; the caller rotates it into the
    # world-space transmission-axis frame -------------------------------------
    m_pol = b_type == BSDF_POLARIZER
    if has_polarizer:
        theta = jnp.deg2rad(b_params[..., 0])
        M_pol = mueller.linear_polarizer(
            jnp.zeros_like(theta)[..., None], jnp.ones_like(theta)[..., None]
        )
        M = jnp.where(m_pol[..., None, None, None], M_pol, M)

    # normalize by M00 and scale by scalar weight (per channel)
    m00 = jnp.maximum(M[..., 0, 0], 1e-12)
    M = M / m00[..., None, None] * scalar_weight[..., None, None]
    return M, m_pol


@partial(jax.jit, static_argnames=("max_depth", "has_polarizer"))
def _stokes_passes(scene, film_vals, film_wts, keys, max_depth,
                   has_polarizer):
    """spp-batched Stokes waves in one dispatch (module-level jit: repeated
    renders with the same scene structure hit the jit cache)."""
    c = scene.camera
    H, W = c.height, c.width
    xy_int = jnp.stack(
        jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), axis=-1
    ).reshape(-1, 2).astype(jnp.float32)

    def one(carry, key):
        fv, fw = carry
        k_jit, k_path = jax.random.split(key)
        jitter = jax.random.uniform(k_jit, (H * W, 2))
        o, d, t0, t1 = cam.sample_ray_extents(c, xy_int + jitter)
        S = stokes_trace(scene, o, d, k_path, max_depth=max_depth,
                         has_polarizer=has_polarizer,
                         tmin0=t0, tmax0=t1)  # [N, 4, 3]
        ok = jnp.all(jnp.isfinite(S), axis=(-2, -1))
        S = jnp.where(ok[:, None, None], S, 0.0).reshape(-1, 12)
        # pixel-aligned sample pattern -> scatter-free dense splat
        fv, fw = film_mod.splat_aligned(
            fv, fw, jitter.reshape(H, W, 2), S.reshape(H, W, 12),
            ok.reshape(H, W), c.filter_type,
        )
        return (fv, fw), None

    (fv, fw), _ = jax.lax.scan(one, (film_vals, film_wts), keys)
    return fv, fw


def render_stokes(scene: Scene, spp=None, seed=0, max_depth=None,
                  spp_per_pass=32):
    """Full polarized render.  Returns (H, W, 4, 3) Stokes images."""
    c = scene.camera
    spp = c.spp if spp is None else spp
    H, W = c.height, c.width

    import numpy as np

    from tpu_rt.integrator.path import _make_keys_seeds

    has_polarizer = bool(np.any(np.asarray(scene.bsdf_type) == BSDF_POLARIZER))
    film_vals = jnp.zeros((H, W, 12), jnp.float32)
    film_wts = jnp.zeros((H, W), jnp.float32)
    root = jax.random.PRNGKey(seed)
    # One dispatch for all spp (scan length does not affect compile time or
    # HBM footprint; ``spp_per_pass`` retained as an API no-op).
    keys, _ = _make_keys_seeds(root, jnp.int32(0), jnp.int32(0), spp)
    film_vals, film_wts = _stokes_passes(
        scene, film_vals, film_wts, keys, max_depth, has_polarizer
    )
    img = film_mod.develop(film_vals, film_wts)
    return img.reshape(H, W, 4, 3)


def stokes_trace(scene: Scene, o, d, key, max_depth=None,
                 has_polarizer=None, tmin0=None, tmax0=None):
    """Returns Stokes radiance [N, 4, 3] for rays (o, d), in the basis of the
    camera's horizontal axis projected perpendicular to each ray.

    ``tmin0``/``tmax0`` clip the PRIMARY segment (camera near/far planes,
    Mitsuba ray.mint/maxt semantics — the near plane offsets the ray
    origin so the nearest-hit search starts AT the plane; see
    integrator/path.py)."""
    if tmin0 is not None:
        tm = jnp.asarray(tmin0, jnp.float32)
        o = o + (tm[..., None] if tm.ndim else tm) * d
        if tmax0 is not None:
            tmax0 = tmax0 - tmin0
        tmin0 = None
    n = o.shape[0]
    depth_cap = scene.max_depth if max_depth is None else max_depth
    if depth_cap is None or depth_cap < 0:
        depth_cap = _MAX_DEPTH_CAP
    depth_cap = min(depth_cap, _MAX_DEPTH_CAP)
    rr_start = scene.rr_depth

    if has_polarizer is None:
        import numpy as np

        # Static (host-side) capability flag; must be resolved before the
        # scan body is traced (inside the scan all closures become
        # tracers).  When stokes_trace is itself called under jit (scene is
        # a tracer), the caller must pass the flag explicitly.
        has_polarizer = bool(
            np.any(np.asarray(scene.bsdf_type) == BSDF_POLARIZER)
        )

    cam_x = scene.camera.to_world[:3, 0] if scene.camera is not None else jnp.asarray(
        [1.0, 0.0, 0.0]
    )
    w0 = -d  # propagation toward the camera
    b0 = mueller.perpendicular_basis(w0, jnp.broadcast_to(cam_x, d.shape))

    state = dict(
        o=o,
        d=d,
        S=jnp.zeros((n, 4, 3), jnp.float32),
        T=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n, 3, 4, 4)),
        basis=b0,
        eta_scale=jnp.ones((n,), jnp.float32),
        active=jnp.ones((n,), bool),
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_delta=jnp.ones((n,), bool),
    )

    def add_emission(S, T, le, mask, w_mis):
        # unpolarized emission: contributes Le * (T @ e0) = Le * T[:, :, :, 0]
        col = T[..., :, 0]  # (N, 3, 4)
        contrib = jnp.moveaxis(col, -1, -2) * le[:, None, :] * w_mis[:, None, None]
        return S + jnp.where(mask[:, None, None], contrib, 0.0)

    def chain(T, basis, p_B, p_A, M):
        """T <- T @ R(angle from s-basis to carried basis) @ M; new basis is
        the scattering s-axis expressed perpendicular to p_A."""
        s_axis_raw = jnp.cross(p_A, p_B)
        ln2 = jnp.sum(s_axis_raw * s_axis_raw, -1, keepdims=True)
        degenerate = ln2[..., 0] < 1e-12
        s_axis = jnp.where(
            degenerate[..., None],
            mueller.perpendicular_basis(p_B, basis),
            s_axis_raw / jnp.sqrt(jnp.maximum(ln2, 1e-24)),
        )
        phi = mueller.rotation_angle(p_B, s_axis, basis)
        R = mueller.rotator(phi)[:, None, :, :]  # channel-broadcast
        T_new = _matmul(T, _matmul(R, M))
        basis_new = jnp.where(
            degenerate[..., None],
            mueller.perpendicular_basis(p_A, s_axis),
            s_axis,
        )
        return T_new, basis_new, s_axis

    def bounce(state, inputs):
        depth, key_d = inputs
        o, d = state["o"], state["d"]
        active = state["active"]
        S, T, basis = state["S"], state["T"], state["basis"]

        si = trace.ray_intersect(scene, o, d)
        if tmax0 is not None:
            # far plane gates the primary segment only (near is an origin
            # offset above)
            in_clip = si.t <= jnp.where(depth == 0, tmax0, trace.INF)
            si = si.replace(
                valid=si.valid & in_clip,
                t=jnp.where(in_clip, si.t, trace.INF),
                shape=jnp.where(in_clip, si.shape, -1),
            )
        hit = si.valid & active
        escaped = ~si.valid & active

        cos_l = dot(si.n, si.wi)
        le = emitter.eval_area(scene, si.shape, cos_l)
        t_safe = jnp.where(si.valid, si.t, 1.0)
        pdf_light = emitter.pdf_direct_area(scene, si.shape, d, t_safe, cos_l)
        w_b = jnp.where(
            state["prev_delta"], 1.0, mis_power_heuristic(state["prev_pdf"], pdf_light)
        )
        vis_ok = hit & ~((depth == 0) & scene.hide_emitters)
        S = add_emission(S, T, le, vis_ok, w_b)

        if scene.emitters.has_env:
            le_env = emitter.eval_env(scene, d)
            pdf_env = emitter.pdf_direct_env(scene, d)
            w_env = jnp.where(
                state["prev_delta"], 1.0, mis_power_heuristic(state["prev_pdf"], pdf_env)
            )
            env_ok = escaped & ~((depth == 0) & scene.hide_emitters)
            S = add_emission(S, T, le_env, env_ok, w_env)

        sfr, tfr = coordinate_system(si.n)
        wi_local = to_local(si.n, sfr, tfr, si.wi)
        from tpu_rt.core.math import small_table_lookup

        b_idx = small_table_lookup(scene.shape_bsdf, jnp.maximum(si.shape, 0))
        b_c = jnp.clip(b_idx, 0, scene.bsdf_type.shape[0] - 1)
        b_type = small_table_lookup(scene.bsdf_type, b_c)
        b_params = small_table_lookup(scene.bsdf_params, b_c)

        # One fused RNG draw per bounce, identical layout to the scalar path
        # tracer so both renderers trace the SAME sample paths (Stokes-I
        # parity is exact per-sample, not just in expectation).
        s_all = jax.random.uniform(key_d, (n, 8))

        # --- NEE (depolarizing + rough-conductor lobes only) -----------------
        if scene.emitters.n_lights > 0:
            s_l = s_all[:, 0:4]
            ds = emitter.sample_direct(scene, si.p, s_l[:, 0], s_l[:, 1:4], hit)
            nee_possible = hit & (ds.pdf > 0.0) & (depth + 2 <= depth_cap)
            wo_nee = to_local(si.n, sfr, tfr, ds.d)
            f_nee, pdf_bsdf_nee = bsdf.eval_pdf(
                b_type, b_params, wi_local, wo_nee, nee_possible,
                present=scene.bsdf_types_present or None,
            )
            occluded = trace.ray_test(
                scene.geometry, si.spawn_origin(ds.d), ds.d,
                tmin=trace.RAY_EPS, tmax=ds.dist * (1.0 - 1e-3),
            )
            vis = nee_possible & ~occluded
            w_nee = jnp.where(ds.delta, 1.0, mis_power_heuristic(ds.pdf, pdf_bsdf_nee))
            scalar_nee = f_nee * ds.radiance * (w_nee / jnp.maximum(ds.pdf, 1e-20))[:, None]
            M_nee, _ = _interaction_mueller(
                scene, b_type, b_params, si, wi_local, wo_nee, scalar_nee, has_polarizer
            )
            T_nee, _, _ = chain(T, basis, -d, -ds.d, M_nee)
            S = add_emission(S, T_nee, jnp.ones_like(scalar_nee), vis, jnp.ones((n,)))

        # --- BSDF sampling & Mueller chain ------------------------------------
        bs = bsdf.sample(b_type, b_params, wi_local, s_all[:, 4], s_all[:, 5:7],
                         hit, present=scene.bsdf_types_present or None)
        d_new = to_world(si.n, sfr, tfr, bs.wo)
        o_new = si.spawn_origin(d_new)

        M, is_pol = _interaction_mueller(
            scene, b_type, b_params, si, wi_local, bs.wo, bs.weight, has_polarizer
        )
        # Polarizer transmission axis: rotate its Mueller into the axis frame.
        if has_polarizer:
            theta = jnp.deg2rad(b_params[..., 0])
            sw = scene.shape_to_world[jnp.maximum(si.shape, 0)]
            axis_local = jnp.stack(
                [jnp.sin(theta), jnp.cos(theta), jnp.zeros_like(theta)], -1
            )
            axis_world = normalize(transform_vector(sw, axis_local))
            p_B = -d
            axis_perp = mueller.perpendicular_basis(p_B, axis_world)
            # angle from the carried basis to the axis (chain() uses the
            # carried basis for degenerate straight-through segments)
            base_b = mueller.perpendicular_basis(p_B, basis)
            phi_ax = mueller.rotation_angle(p_B, base_b, axis_perp)
            Rp = mueller.rotator(phi_ax)[:, None]
            Rm = mueller.rotator(-phi_ax)[:, None]
            M_rot = _matmul(Rm, _matmul(M, Rp))
            M = jnp.where(is_pol[:, None, None, None], M_rot, M)

        T_new, basis_new, _ = chain(T, basis, -d, -d_new, M)

        alive = hit & (bs.pdf > 0.0)
        thr_I = jnp.max(T_new[..., 0, 0], axis=-1)  # channel max of intensity
        alive = alive & (thr_I > 0.0)

        eta_scale = state["eta_scale"] * bs.eta
        inv_eta2 = 1.0 / jnp.maximum(eta_scale * eta_scale, 1e-12)
        q = jnp.minimum(thr_I * inv_eta2, 0.95)
        u_rr = s_all[:, 7]
        do_rr = depth >= rr_start
        survive = jnp.where(do_rr, u_rr < q, True)
        T_new = jnp.where(
            (do_rr & survive)[:, None, None, None],
            T_new / jnp.maximum(q, 1e-12)[:, None, None, None],
            T_new,
        )
        alive = alive & survive

        return (
            dict(
                o=o_new,
                d=d_new,
                S=S,
                T=jnp.where(alive[:, None, None, None], T_new, 0.0),
                basis=basis_new,
                eta_scale=eta_scale,
                active=alive,
                prev_pdf=bs.pdf,
                prev_delta=bs.delta,
            ),
            None,
        )

    keys = jax.random.split(key, depth_cap)
    depths = jnp.arange(depth_cap)
    state, _ = jax.lax.scan(bounce, state, (depths, keys))
    return state["S"]
