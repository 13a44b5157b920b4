"""Plane-wave delay-and-sum beamforming, envelope detection, B-mode.

JAX replacement for the ultraspy pipeline the reference drives at
/root/reference/USMain.py:126-219 (build_probe / DelayAndSum / GridScan /
compute_envelope) — SURVEY.md §2b DAS row.  The hot loop is a pure gather +
reduction over (angles x elements), jit-compiled; envelope detection is a
Hilbert transform via jnp.fft; log compression matches USMain.py:213-219
bit-for-bit semantics (20*log10, 60 dB dynamic range, normalize).

Geometry/time conventions match the acquisition integrator: with per-element
transmit delays t = x sin(a)/c (CustomIntegrator.py:87), the synthesized
plane wave reaches pixel (x, z) at t_tx = (x sin a + z cos a)/c; the echo
returns to element x_e after t_rx = sqrt((x - x_e)^2 + z^2)/c.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def grid_scan(x_min, x_max, z_min, z_max, step_lateral, step_axial):
    """Pixel grid equivalent of ultraspy GridScan (USMain.py:193-204).

    Returns host numpy float32 arrays, so the grid stays concrete when this
    is called inside ``jax.jit`` (das_beamform_matmul sizes its RF window
    from it on the host)."""
    x = np.arange(x_min, x_max + step_lateral, step_lateral, dtype=np.float32)
    z = np.arange(z_min, z_max + step_axial, step_axial, dtype=np.float32)
    if x.size == 0:
        x = np.asarray([x_min], np.float32)
    if z.size == 0:
        z = np.asarray([z_min], np.float32)
    return x, z


def das_beamform(channel_data, angles_deg, elem_x, fs, c, x_grid, z_grid,
                 t_offset=0.0, elem_z=None):
    """Delay-and-sum beamforming of plane-wave RF data.

    Args:
      channel_data: [A, E, T] RF samples.
      angles_deg: [A] steering angles (degrees).
      elem_x: [E] element lateral positions (m).
      fs: sampling rate (Hz).  c: sound speed (m/s).
      x_grid: [Nx], z_grid: [Nz] image grid (m).
      t_offset: acquisition start time t0.
      elem_z: [E] element axial positions (m) — nonzero for convex arrays
        (reference convex geometry: /root/reference/CustomEmmitter.py:41-47);
        None means a linear row at z = 0.
    Returns beamformed image [Nx, Nz] (lateral x axial, like ultraspy).
    """
    channel_data = jnp.asarray(channel_data)
    elem_x = jnp.asarray(elem_x)
    A, E, T = channel_data.shape
    if elem_z is None:
        elem_z = jnp.zeros_like(elem_x)
    else:
        elem_z = jnp.asarray(elem_z)
    angles = jnp.deg2rad(jnp.asarray(angles_deg))
    X, Z = jnp.meshgrid(x_grid, z_grid, indexing="ij")  # [Nx, Nz]
    P = X.size
    px = X.reshape(-1)
    pz = Z.reshape(-1)

    inv_c = 1.0 / c

    # Chunk elements so each step is a wide (P, CHUNK) gather instead of a
    # long sequential per-element scan.
    E_CHUNK = min(16, E)
    pad_e = (-E) % E_CHUNK
    rf_all = channel_data
    elem_x_p = jnp.concatenate([elem_x, jnp.zeros((pad_e,), elem_x.dtype)])
    elem_z_p = jnp.concatenate([elem_z, jnp.zeros((pad_e,), elem_z.dtype)])
    if pad_e:
        rf_all = jnp.concatenate(
            [rf_all, jnp.zeros((A, pad_e, T), rf_all.dtype)], axis=1
        )
    n_chunks = (E + pad_e) // E_CHUNK
    rf_chunks = rf_all.reshape(A, n_chunks, E_CHUNK, T)
    ex_chunks = elem_x_p.reshape(n_chunks, E_CHUNK)
    ez_chunks = elem_z_p.reshape(n_chunks, E_CHUNK)

    def one_angle(acc, a_idx):
        t_tx = (px * jnp.sin(angles[a_idx]) + pz * jnp.cos(angles[a_idx])) * inv_c

        def one_chunk(acc_e, c_idx):
            ex = ex_chunks[c_idx]  # [C]
            ez = ez_chunks[c_idx]
            t_rx = jnp.sqrt(
                (px[:, None] - ex[None, :]) ** 2
                + (pz[:, None] - ez[None, :]) ** 2
            ) * inv_c
            t_f = (t_tx[:, None] + t_rx - t_offset) * fs  # [P, C]
            i0 = jnp.floor(t_f)
            w = t_f - i0
            i0 = i0.astype(jnp.int32)
            rf = rf_chunks[a_idx, c_idx]  # [C, T]
            i0c = jnp.clip(i0, 0, T - 1).T  # [C, P]
            i1c = jnp.clip(i0 + 1, 0, T - 1).T
            v0 = jnp.take_along_axis(rf, i0c, axis=1).T  # [P, C]
            v1 = jnp.take_along_axis(rf, i1c, axis=1).T
            v0 = jnp.where((i0 >= 0) & (i0 < T), v0, 0.0)
            v1 = jnp.where((i0 + 1 >= 0) & (i0 + 1 < T), v1, 0.0)
            return acc_e + (v0 * (1.0 - w) + v1 * w).sum(axis=1), None

        acc_a, _ = jax.lax.scan(
            one_chunk, jnp.zeros((P,), jnp.float32), jnp.arange(n_chunks)
        )
        return acc + acc_a, None

    out, _ = jax.lax.scan(one_angle, jnp.zeros((P,), jnp.float32), jnp.arange(A))
    return out.reshape(X.shape)


def pulse_kernel(fs, f0, wave_cycles=5, dtype=jnp.float32):
    """Gaussian-enveloped sinusoid excitation pulse — the reference's
    'Pulse model (UltraRay Eq. 14)' (/root/reference/RayTracingV0.py:195-199)
    parameterized by the integrator's ``wave_cycles`` prop
    (CustomIntegrator.py:20).  Duration = wave_cycles / f0; the Gaussian
    std is chosen so the envelope decays to ~1% at the ends."""
    import numpy as np

    duration = wave_cycles / f0
    n = max(int(round(duration * fs)) | 1, 3)  # odd length
    t = (np.arange(n) - n // 2) / fs
    sigma = duration / 6.0
    kernel = np.sin(2 * np.pi * f0 * t) * np.exp(-0.5 * (t / sigma) ** 2)
    return jnp.asarray(kernel, dtype)


def apply_pulse(channel_data, fs, f0, wave_cycles=5):
    """Convolve impulse RF data with the excitation pulse along the time
    axis (FFT-based, 'same' alignment).  Use with acquisition run in
    amplitude-impulse mode (deposit_sin=False) to get physically-shaped
    echoes instead of instantaneous sin(phase) samples."""
    A, E, T = channel_data.shape
    k = pulse_kernel(fs, f0, wave_cycles)
    n = int(k.shape[0])
    nfft = 1 << (T + n - 2).bit_length()
    Xf = jnp.fft.rfft(channel_data, nfft, axis=-1)
    Kf = jnp.fft.rfft(k, nfft)
    y = jnp.fft.irfft(Xf * Kf, nfft, axis=-1)
    start = n // 2
    return y[..., start : start + T].astype(channel_data.dtype)


def das_beamform_matmul(channel_data, angles_deg, elem_x, fs, c, x_grid,
                        z_grid, t_offset=0.0, block=None, window=128,
                        elem_z=None, tx=8, tz=8,
                        precision=jax.lax.Precision.HIGHEST):
    """Matmul-formulated DAS: random time-gathers become dense
    interpolation-weight contractions over per-block RF windows.

    Pixels are tiled into (tx, tz) blocks; within a block the delay
    spread is bounded, so each (angle, element, block) touches one
    contiguous RF window.  The 2-tap linear interp becomes a hat-function
    weight matrix (block, window) contracted with the window, and the
    per-pixel cost is O(window) elementwise ops — the window size is the
    lever.

    Window fetch: block window starts are quantized to Q=64-sample chunks
    and ALL block windows for one (angle, element) are fetched with a
    single one-hot GEMM  [n_blk, n_chunks] @ [n_chunks, window]  against a
    strided-overlap view of the RF trace, instead of one ``dynamic_slice``
    per block.  Small tiles keep the per-pixel hat build short because it
    shrinks with the tile's delay spread.  Both einsums run at
    ``Precision.HIGHEST`` by default, so the result equals the gather form
    (``das_beamform``) to f32 rounding.  Out-of-range windows are clamped
    and out-of-range pixels contribute 0.  The window auto-sizes from the
    grid pitch to cover the tile's full delay spread; see the sizing note
    below for why that must happen in host numpy.
    """
    channel_data = jnp.asarray(channel_data)
    elem_x = jnp.asarray(elem_x)
    if elem_z is None:
        elem_z = jnp.zeros_like(elem_x)
    else:
        elem_z = jnp.asarray(elem_z)
    A, E, T = channel_data.shape
    angles = jnp.deg2rad(jnp.asarray(angles_deg))
    Nx, Nz = x_grid.shape[0], z_grid.shape[0]

    # 2-D pixel tiles (TX x TZ) bound the per-block delay spread so a
    # ``window``-sample RF slice covers every pixel in the block.
    if block is not None:  # legacy call shape: block = TX * TZ with TX=8
        TX, TZ = 8, max(block // 8, 1)
    else:
        TX, TZ = tx, tz
    # Size the window from the actual grid pitch.  MUST read the grids via
    # host numpy, NOT jnp indexing: under an outer jax.jit, ops on the
    # closed-over (concrete) grid arrays produce tracers and float() then
    # raises TracerArrayConversionError — a TypeError subclass that a bare
    # try/except here used to swallow, silently leaving the window at its
    # floor and DROPPING every tap beyond it (jitted callers on grids with
    # delay spread > floor got wrong images; caught by
    # tests/test_ultrasound.py::test_das_matmul_window_autosize_under_jit).
    # np.asarray on a concrete jax array works even while tracing; only
    # genuinely traced grids (passed as jit arguments) fall back to the
    # caller-provided window.
    # The same holds for a concrete jax-array c or fs: arithmetic on it
    # inside a trace is staged, so it is read with float() first.
    if not any(isinstance(v, jax.core.Tracer) for v in (x_grid, z_grid, c, fs)):
        xs, zs = np.asarray(x_grid), np.asarray(z_grid)
        dx = float(xs[1] - xs[0]) if Nx > 1 else 0.0
        dz = float(zs[1] - zs[0]) if Nz > 1 else 0.0
        spread = (2.0 * TZ * abs(dz) + 2.0 * TX * abs(dx)) / float(c) * float(fs)
        needed = int(np.ceil(spread)) + 8
        window = max(window, ((needed + 127) // 128) * 128)
    # Quantized window starts: Q must divide the window so the
    # strided-overlap RF view below is built from aligned reshapes.
    Q = 64
    # The one-hot chunk selector can put the window start up to Q-1
    # samples below the block's tightest start — widen the window by one
    # chunk to keep every previously-valid tap in range (Q-multiple, not
    # 128: the hat build is O(P * window) elementwise work, so extra taps
    # cost time in proportion).
    window = ((window + Q + Q - 1) // Q) * Q
    n_chunks = (max(T - 1, 0) // Q) + 1  # rows cover every start s <= T-1
    L = (n_chunks - 1) * Q + window
    channel_data = jnp.concatenate(
        [channel_data, jnp.zeros((A, E, L - T), channel_data.dtype)],
        axis=2)
    pad_x = (-Nx) % TX
    pad_z = (-Nz) % TZ
    # Pad with a FAR point (not 0: x=0 is a real mid-aperture position whose
    # earlier arrival time would drag the block's window start below the
    # real pixels' taps, masking them out).  Far-point pad pixels have huge
    # t_f, never drive the per-block min, and are masked by in_rng.
    xg = jnp.concatenate([x_grid, jnp.full((pad_x,), 1e9, jnp.float32)])
    zg = jnp.concatenate([z_grid, jnp.full((pad_z,), 1e9, jnp.float32)])
    X, Z = jnp.meshgrid(xg, zg, indexing="ij")  # [Nx+, Nz+]
    nbx, nbz = (Nx + pad_x) // TX, (Nz + pad_z) // TZ

    def tile(a):
        return (
            a.reshape(nbx, TX, nbz, TZ).transpose(0, 2, 1, 3).reshape(-1, TX * TZ)
        )

    pxb = tile(X)
    pzb = tile(Z)
    n_blk = pxb.shape[0]
    block = TX * TZ
    inv_c = 1.0 / c
    iota_w = jnp.arange(window, dtype=jnp.float32)

    def one_angle(acc, a_idx):
        sin_a = jnp.sin(angles[a_idx])
        cos_a = jnp.cos(angles[a_idx])
        t_tx = (pxb * sin_a + pzb * cos_a) * inv_c  # [n_blk, block]

        def one_elem(acc_e, e_idx):
            t_rx = jnp.sqrt(
                (pxb - elem_x[e_idx]) ** 2 + (pzb - elem_z[e_idx]) ** 2
            ) * inv_c
            t_f = (t_tx + t_rx - t_offset) * fs  # [n_blk, block]
            s = jnp.clip(
                jnp.floor(jnp.min(t_f, axis=1)).astype(jnp.int32),
                0, T - 1,
            )  # [n_blk]
            sq = s // Q  # quantized chunk row, start = sq * Q <= s
            rel = t_f - (sq * Q)[:, None].astype(jnp.float32)
            in_rng = (t_f >= 0.0) & (t_f <= T - 1) & (rel <= window - 1)
            # Fold the validity mask into rel (hat support is [-1, 1], so
            # rel = -2 zeroes every tap) instead of a per-tap select.
            rel = jnp.where(in_rng, rel, -2.0)
            rf = channel_data[a_idx, e_idx]  # [L], zero-padded past T
            # Strided-overlap view: rows[r, j] = rf[r*Q + j], j < window.
            rows = jnp.concatenate(
                [jax.lax.dynamic_slice(rf, (j * Q,), (n_chunks * Q,))
                 .reshape(n_chunks, Q) for j in range(window // Q)],
                axis=1)  # [n_chunks, window]
            onehot = (sq[:, None] ==
                      jnp.arange(n_chunks)[None, :]).astype(jnp.float32)
            # Exact selection (0/1 weights): one GEMM fetches every
            # block's window at once.  Precision is pinned to HIGHEST
            # regardless of the caller's choice: anything lower (TF32 or
            # bf16 passes) rounds the RF trace itself, breaking the "exact
            # selection" invariant (the caller's precision only governs the
            # hat-weight contraction below, where it is a genuine
            # accuracy/speed trade).
            wins = jnp.einsum("nc,cw->nw", onehot, rows,
                              precision=jax.lax.Precision.HIGHEST)
            # hat weights: w[p, k] = max(0, 1 - |rel[p] - k|); zero outside
            w = jnp.maximum(0.0, 1.0 - jnp.abs(rel[:, :, None] - iota_w))
            vals = jnp.einsum("nbw,nw->nb", w, wins, precision=precision)
            return acc_e + vals, None

        acc_a, _ = jax.lax.scan(
            one_elem, jnp.zeros((n_blk, block), jnp.float32), jnp.arange(E)
        )
        return acc + acc_a, None

    out, _ = jax.lax.scan(
        one_angle, jnp.zeros((n_blk, block), jnp.float32), jnp.arange(A)
    )
    # un-tile back to the (Nx, Nz) grid
    out = (
        out.reshape(nbx, nbz, TX, TZ)
        .transpose(0, 2, 1, 3)
        .reshape(Nx + pad_x, Nz + pad_z)
    )
    return out[:Nx, :Nz]


def hilbert_envelope(img, axis=-1):
    """Envelope via the analytic signal (Hilbert transform along ``axis``),
    equivalent of ultraspy compute_envelope (USMain.py:208)."""
    n = img.shape[axis]
    Xf = jnp.fft.fft(img, axis=axis)
    h = np.zeros(n, np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[1 : (n + 1) // 2] = 2.0
    shape = [1] * img.ndim
    shape[axis] = n
    analytic = jnp.fft.ifft(Xf * jnp.asarray(h).reshape(shape), axis=axis)
    return jnp.abs(analytic)


def log_compress(envelope, dynamic_range=60.0):
    """20*log10 compression to [0, 1] over ``dynamic_range`` dB
    (USMain.py:213-219)."""
    db = 20.0 * jnp.log10(envelope + 1e-12)
    max_db = jnp.max(db)
    min_db = max_db - dynamic_range
    return (jnp.clip(db, min_db, max_db) - min_db) / dynamic_range


def bmode_pipeline(channel_data, angles_deg, elem_x, fs, c,
                   x_grid, z_grid, dynamic_range=60.0, method="matmul",
                   elem_z=None):
    """channel data -> beamform -> envelope (axial) -> log compression.
    Returns display image [Nz, Nx] (depth down, like USMain.py:224).

    ``method``: 'matmul' (windowed-interpolation GEMM DAS, default) or
    'gather' (reference formulation; used for cross-checks)."""
    das = das_beamform_matmul if method == "matmul" else das_beamform
    bf = das(channel_data, angles_deg, elem_x, fs, c, x_grid, z_grid,
             elem_z=elem_z)
    env = hilbert_envelope(bf, axis=1)  # axial (z) axis
    img = log_compress(env, dynamic_range)
    return img.T  # (z, x) a.k.a. display orientation
