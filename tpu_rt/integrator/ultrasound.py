"""Ultrasound Monte-Carlo acquisition integrator.

JAX rebuild of UltraIntegrator.simulate_acquisition
(/root/reference/CustomIntegrator.py:60-232, the vectorized Dr.Jit design)
and simulate_acquisition_parallel (:235-405, the threaded variant actually
run by USMain.py:99): for every (plane-wave angle x transducer element)
pair, trace a multi-bounce ray, and at every bounce scatter an echo back to
a randomly chosen receive element (NEE style), accumulating time-resolved
pressure into an RF channel buffer of shape (n_angles, n_elements,
time_samples).

All (angle x element x spp) rays are one SoA megabatch; the bounce loop is a
lax.scan (differentiable end-to-end for inverse rendering — the capability
the reference's commented-out Dr.Jit AD path intended, USMain.py:300-350);
accumulation is an XLA scatter-add (the dr.scatter_reduce equivalent,
CustomIntegrator.py:203).

Physics per bounce (matching the reference's formulas):
  attenuation *= exp(-alpha * f_MHz * dist / 8.686)        (:162,328)
  total_time = tx_delay + tof + dist_to_recv / c           (:167,329)
  phase = 2 pi f total_time                                 (:168,330)
  pressure = atten * amp * f_d * sin(phase)                 (:187,348)
  t_idx = total_time * fs, clamped to buffer                (:191-193)
  RX directivity ramp 1 -> 0 between main_beam_angle and cutoff_angle
  (:120-135), TX weight dot(d, n)/num_rays (:117-118)

Intent-preserving fixes (documented divergences, SURVEY.md §2d):
  * every lane draws independent random numbers (the reference broadcast
    one Python random per iteration to all lanes, :153-154,173-174);
  * |cos| in the TX directivity weight (the reference's dot(wo, n) was
    negative for front-face hits);
  * time deposition uses differentiable linear interpolation between the
    two neighboring samples instead of round() (:191);
  * Russian roulette is unbiased: survivors divide by the survival
    probability, dead lanes deposit nothing (:364-376 read an undefined
    variable and double-counted).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_rt.bsdf import acoustic
from tpu_rt.core.math import coordinate_system, dot, normalize, to_local, to_world, transform_point
from tpu_rt.geometry import trace
from tpu_rt.scene.types import BSDF_ULTRASOUND, Scene
from tpu_rt.sensor.transducer import plane_wave_rays


def simulate_acquisition(scene: Scene, seed=0, rays_per_pair=1,
                         jitter_elements=False, deposit_sin=True):
    """Run the acoustic acquisition.

    Args:
      scene: compiled Scene with scene.ultrasound config.
      seed: RNG seed.
      rays_per_pair: samples per (angle, element) pair (1 matches the
        reference; more reduces variance at little cost per lane).
      jitter_elements: jitter ray origins within the element aperture.
      deposit_sin: True (reference behavior, CustomIntegrator.py:187)
        deposits atten*amp*fd*sin(phase) instantaneously; False deposits the
        amplitude impulse so tpu_rt.us.beamform.apply_pulse can convolve the
        UltraRay Eq. 14 excitation pulse afterwards.
    Returns:
      channel_buf [n_angles, n_elements, time_samples] float32,
      tx_delays [n_angles, n_elements] float32.
    """
    us = scene.ultrasound
    if us is None:
        raise ValueError("scene has no ultrasound configuration")
    A, E, T = us.n_angles, us.n_elements, us.time_samples
    key = jax.random.PRNGKey(seed)

    base = plane_wave_rays(us)
    if scene.n_shapes == 0:  # empty scene: no echoes, delays still defined
        return (
            jnp.zeros((A, E, T), jnp.float32),
            base["tx_delay"].reshape(A, E),
        )
    n_pairs = A * E
    n = n_pairs * rays_per_pair

    def rep(x):
        return jnp.repeat(x, rays_per_pair, axis=0)

    o0, d0 = rep(base["o"]), rep(base["d"])
    tx_delay = rep(base["tx_delay"])
    angle_idx = rep(base["angle_idx"])
    trans_n = base["trans_normal"]
    x_elem = base["x_elem"]  # [E] local element x positions

    if jitter_elements:
        jit = jax.random.uniform(jax.random.fold_in(key, 999), (n, 2))
        dx = (jit[:, 0] - 0.5) * us.elements_width
        dy = (jit[:, 1] - 0.5) * us.elements_height
        m = us.sensor_to_world
        off = dx[:, None] * m[:3, 0] + dy[:, None] * m[:3, 1]
        o0 = o0 + off

    elem_world = transform_point(us.sensor_to_world, base["elem_pos"])  # [E, 3]

    alpha_m = jnp.deg2rad(us.main_beam_angle)
    alpha_c = jnp.deg2rad(us.cutoff_angle)
    cos_cutoff = jnp.cos(alpha_c)
    f_mhz = us.frequency * 1e-6
    inv_c = 1.0 / us.sound_speed
    num_rays = float(n_pairs)

    channel = jnp.zeros((A * E * T,), jnp.float32)

    state = dict(
        o=o0,
        d=d0,
        amp=jnp.ones((n,), jnp.float32),
        atten=jnp.ones((n,), jnp.float32),
        tof=jnp.zeros((n,), jnp.float32),
        geo_len=jnp.zeros((n,), jnp.float32),
        active=jnp.ones((n,), bool),
        channel=channel,
        rays_traced=jnp.zeros((), jnp.int32),
    )

    def rx_directivity(sec_dir):
        """Angular ramp 1 -> 0 between main beam and cutoff angles
        (CustomIntegrator.py:120-135), measured against the transducer
        normal for the incoming echo direction."""
        # The echo travels along sec_dir (surface -> element); the reception
        # angle is between -sec_dir and the transducer normal
        # (CustomIntegrator.py:123-126 uses wi = -sec_dir).
        cos_a = dot(-sec_dir, trans_n)
        a = jnp.abs(jnp.arccos(jnp.clip(cos_a, -0.999999, 0.999999)))
        mid = (alpha_c - a) / jnp.maximum(alpha_c - alpha_m, 1e-9)
        return jnp.where(a <= alpha_m, 1.0, jnp.where(a <= alpha_c, mid, 0.0))

    def bounce(st, inputs):
        depth, key_d = inputs
        active = st["active"]
        o, d = st["o"], st["d"]

        si = trace.ray_intersect(scene, o, d)
        hit = si.valid & active
        distance = jnp.where(hit, si.t, 0.0)

        # Per-lane receive element choice (independent RNG per lane).
        k_recv, k_b1, k_b2, k_rr = (
            jax.random.fold_in(key_d, 0),
            jax.random.fold_in(key_d, 1),
            jax.random.fold_in(key_d, 2),
            jax.random.fold_in(key_d, 3),
        )
        recv = jax.random.randint(k_recv, (n,), 0, E)
        target = elem_world[recv]
        to_recv = target - si.p
        dist_recv = jnp.sqrt(jnp.maximum(dot(to_recv, to_recv), 1e-20))
        sec_dir = to_recv / dist_recv[:, None]

        shadow_o = si.spawn_origin(sec_dir)
        occ = trace.ray_test(
            scene.geometry, shadow_o, sec_dir, tmin=trace.RAY_EPS,
            tmax=dist_recv * (1.0 - 1e-3),
        )
        visible = hit & ~occ

        atten = st["atten"] * jnp.where(
            hit, jnp.exp(-us.attenuation * f_mhz * distance / 8.686), 1.0
        )
        tof = st["tof"] + distance * inv_c
        total_time = tx_delay + tof + dist_recv * inv_c
        phase = 2.0 * jnp.pi * us.frequency * total_time

        # Acoustic BSDF sample in the local frame.
        sfr, tfr = coordinate_system(si.n)
        wi_local = to_local(si.n, sfr, tfr, si.wi)
        from tpu_rt.core.math import small_table_lookup

        b_idx = small_table_lookup(scene.shape_bsdf, jnp.maximum(si.shape, 0))
        b_params = small_table_lookup(
            scene.bsdf_params, jnp.clip(b_idx, 0, scene.bsdf_params.shape[0] - 1)
        )
        s1 = jax.random.uniform(k_b1, (n,))
        s2 = jax.random.uniform(k_b2, (n, 2))
        bs = acoustic.sample(b_params, wi_local, s1, s2, hit)

        cos_theta = jnp.abs(dot(si.n, si.wi))  # |cos| (fix of :176-177 sign)
        amp = st["amp"] * jnp.where(hit, bs.amplitude * cos_theta, 1.0)

        fd = rx_directivity(sec_dir) * (cos_theta / num_rays)
        carrier = jnp.sin(phase) if deposit_sin else 1.0
        pressure = atten * amp * fd * carrier

        # Differentiable linear-interpolation deposit over the time axis.
        t_f = total_time * us.sampling_rate
        t0 = jnp.floor(t_f)
        w1 = t_f - t0
        t0i = t0.astype(jnp.int32)
        base_idx = (angle_idx * E + recv) * T
        in_range0 = (t0i >= 0) & (t0i < T)
        in_range1 = (t0i + 1 >= 0) & (t0i + 1 < T)
        ch = st["channel"]
        ch = ch.at[jnp.clip(base_idx + t0i, 0, A * E * T - 1)].add(
            jnp.where(visible & in_range0, pressure * (1.0 - w1), 0.0)
        )
        ch = ch.at[jnp.clip(base_idx + t0i + 1, 0, A * E * T - 1)].add(
            jnp.where(visible & in_range1, pressure * w1, 0.0)
        )

        # Bounce ray.
        d_new = normalize(to_world(si.n, sfr, tfr, bs.wo))
        o_new = si.spawn_origin(d_new)
        geo_len = st["geo_len"] + distance

        # Russian roulette (unbiased form; intent of :219-224,364-376).
        rr_prob = jnp.clip(jnp.abs(atten * amp), 0.05, 1.0)
        survive = jax.random.uniform(k_rr, (n,)) < rr_prob
        atten_next = jnp.where(survive, atten / rr_prob, 0.0)

        within_angle = dot(d_new, trans_n) >= cos_cutoff
        path_ok = geo_len < us.max_path_length
        alive = hit & survive & within_angle & path_ok

        return (
            dict(
                o=jnp.where(alive[:, None], o_new, o),
                d=jnp.where(alive[:, None], d_new, d),
                amp=amp,
                atten=atten_next,
                tof=tof,
                geo_len=geo_len,
                active=alive,
                channel=ch,
                rays_traced=st["rays_traced"] + jnp.sum(hit.astype(jnp.int32)),
            ),
            None,
        )

    keys = jax.random.split(key, us.max_depth)
    depths = jnp.arange(us.max_depth)
    state, _ = jax.lax.scan(bounce, state, (depths, keys))

    channel_buf = state["channel"].reshape(A, E, T) / float(rays_per_pair)
    tx = base["tx_delay"].reshape(A, E)
    return channel_buf, tx


def simulate_acquisition_jit(scene: Scene, seed=0, rays_per_pair=1):
    """jit-compiled entry (scene is a pytree, so parameter changes reuse the
    compilation — the property that makes the optimization loop cheap)."""
    return jax.jit(simulate_acquisition, static_argnames=("rays_per_pair",))(
        scene, seed, rays_per_pair
    )
