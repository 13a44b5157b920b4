"""Multi-chip ultrasound acquisition: shard_map + psum RF channel buffers.

SURVEY.md §2c's parallel mapping covers BOTH grids: optical renders shard
(pixel x spp) work (parallel/render.py); the acoustic acquisition shards the
(angle x element x spp) megabatch.  Sample slices are split by
samples-per-pair across a 1-D device mesh — every chip traces its slice
through the full bounce loop, scatter-adds a local RF buffer, and one
`psum` reduces the buffers (the dr.scatter_reduce + thread-pool
analogue of /root/reference/CustomIntegrator.py:203,398, scaled out).

Gradients flow through the psum in reverse, so sharded inverse rendering
(the USMain.py:262-298 loop) works unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tpu_rt.integrator.ultrasound import simulate_acquisition
from tpu_rt.parallel.render import default_mesh
from tpu_rt.scene.types import Scene


def simulate_acquisition_sharded(scene: Scene, seed=0, rays_per_pair=8,
                                 mesh: Mesh = None):
    """Sharded acquisition: returns (channel_buf [A,E,T], tx_delays [A,E]).

    Each device runs the full (angle x element) grid with
    ceil(rays_per_pair / n_dev) samples per pair under its own RNG stream;
    the per-chip RF buffers are psum-averaged.  With one device and the
    same seed this is bit-identical to the single-chip path.
    """
    mesh = mesh or default_mesh()
    n_dev = mesh.devices.size
    rpp_local = -(-rays_per_pair // n_dev)

    # distinct per-device streams; device 0 keeps the caller's seed so the
    # n_dev == 1 case reduces to the single-chip function exactly
    seeds = seed + jnp.arange(n_dev, dtype=jnp.int32) * 7919

    def shard_fn(sc, seed_shard):
        ch, tx = simulate_acquisition(
            sc, seed=seed_shard[0], rays_per_pair=rpp_local
        )
        ch = jax.lax.psum(ch, "rays") / n_dev
        return ch, tx

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P("rays")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(scene, seeds)


def das_beamform_sharded(channel_data, angles_deg, elem_x, fs, c, x_grid,
                         z_grid, t_offset=0.0, elem_z=None, mesh: Mesh = None,
                         method="matmul"):
    """Multi-chip delay-and-sum: the image's LATERAL axis is sharded over
    the device mesh, the RF buffer is replicated.

    DAS is embarrassingly parallel over pixels (every pixel reads the whole
    [A, E, T] buffer — /root/reference/USMain.py:204-207 beamforms the full
    GridScan on one host), so each device beamforms its contiguous x-tile
    with the stock kernel (us/beamform.py, 'matmul' or 'gather' form)
    and the tiles concatenate along x with NO collective: per-pixel sums
    run in the same order as the single-chip kernel, so results match it
    exactly.  Returns the beamformed image [Nx, Nz].
    """
    from tpu_rt.us.beamform import das_beamform, das_beamform_matmul

    mesh = mesh or default_mesh()
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    x_grid = jnp.asarray(x_grid)
    z_grid = jnp.asarray(z_grid)
    elem_x = jnp.asarray(elem_x)
    if elem_z is None:
        elem_z = jnp.zeros_like(elem_x)
    channel_data = jnp.asarray(channel_data)
    angles_deg = jnp.asarray(angles_deg, jnp.float32)

    Nx = x_grid.shape[0]
    pad = (-Nx) % n_dev
    # edge-value pads keep the per-shard matmul RF windows in range; the
    # padded columns are stripped below
    xg = jnp.concatenate([x_grid, jnp.full((pad,), x_grid[-1])]) if pad \
        else x_grid

    if method == "matmul":
        # Size the interpolation window on the HOST from the full grid
        # pitch (das_beamform_matmul's own sizing needs concrete grids,
        # which a shard_map trace does not have) — same formula, so the
        # sharded kernel runs the identical program per tile.
        import numpy as _np

        # The tile shape MUST match what the inner call uses (it is passed
        # explicitly below): sizing for one shape and tiling with another
        # under-sizes the window and silently drops taps.  8x8 is
        # das_beamform_matmul's default tile.
        TX, TZ = 8, 8
        dx = float(x_grid[1] - x_grid[0]) if Nx > 1 else 0.0
        dz = float(z_grid[1] - z_grid[0]) if z_grid.shape[0] > 1 else 0.0
        spread = (2.0 * TZ * abs(dz) + 2.0 * TX * abs(dx)) / c * fs
        window = max(256, ((int(_np.ceil(spread)) + 8 + 127) // 128) * 128)

        def one(xg_shard):
            return das_beamform_matmul(
                channel_data, angles_deg, elem_x, fs, c, xg_shard, z_grid,
                t_offset=t_offset, window=window, elem_z=elem_z,
                tx=TX, tz=TZ,
            )
    else:
        def one(xg_shard):
            return das_beamform(
                channel_data, angles_deg, elem_x, fs, c, xg_shard, z_grid,
                t_offset=t_offset, elem_z=elem_z,
            )

    fn = shard_map(
        one, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis, None),
        check_vma=False,
    )
    out = jax.jit(fn)(xg)
    return out[:Nx]
