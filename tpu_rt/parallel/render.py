"""Multi-chip data-parallel rendering: shard_map over ray tiles + psum film.

The scaling story (SURVEY.md §2c): pure data parallelism over (pixel x spp)
work, a 1-D device mesh, per-device local film scatter-add, and a single
`psum` to reduce films (and, under jax.grad, gradient psums in reverse).
The mesh is a flat list of devices, which suits GPUs joined all to all.
The reference's only concurrency was a Python ThreadPoolExecutor
(CustomIntegrator.py:398).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tpu_rt.integrator.path import path_trace
from tpu_rt.scene.types import Scene
from tpu_rt.sensor import camera as cam
from tpu_rt.sensor import film as film_mod


def default_mesh(devices=None, axis="rays"):
    devices = devices or jax.devices()
    return Mesh(devices, (axis,))


def render_pass_sharded(scene: Scene, key, mesh: Mesh, max_depth=None):
    """One spp over all pixels, sharded across the mesh.

    Pixels are tiled over the 'rays' mesh axis; every device splats its
    samples into a local film and the films are psum-reduced.
    Returns (film_vals [H,W,3], film_wts [H,W], n_rays) fully replicated.
    """
    c = scene.camera
    H, W = c.height, c.width
    n_dev = mesh.devices.size
    total = H * W
    pad = (-total) % n_dev
    xy_int = jnp.stack(
        jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), axis=-1
    ).reshape(-1, 2)
    if pad:
        xy_int = jnp.concatenate([xy_int, jnp.zeros((pad, 2), xy_int.dtype)], 0)
    valid = jnp.arange(total + pad) < total
    keys = jax.random.split(key, n_dev)

    def shard_fn(xy_shard, valid_shard, key_shard):
        key_shard = key_shard[0]
        k_jit, k_path = jax.random.split(key_shard)
        jitter = jax.random.uniform(k_jit, xy_shard.shape)
        film_xy = xy_shard.astype(jnp.float32) + jitter
        o, d, t0, t1 = cam.sample_ray_extents(c, film_xy)
        L, n_rays = path_trace(scene, o, d, k_path, max_depth=max_depth,
                               tmin0=t0, tmax0=t1)
        ok = valid_shard & jnp.all(jnp.isfinite(L), axis=-1)
        L = jnp.where(ok[:, None], L, 0.0)
        fv = jnp.zeros((H, W, 3), jnp.float32)
        fw = jnp.zeros((H, W), jnp.float32)
        fv, fw = film_mod.splat(fv, fw, film_xy, L, ok, c.filter_type)
        fv = jax.lax.psum(fv, "rays")
        fw = jax.lax.psum(fw, "rays")
        n_rays = jax.lax.psum(n_rays, "rays")
        return fv, fw, n_rays

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("rays"), P("rays"), P("rays")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return fn(xy_int, valid, keys)


def render_sharded(scene: Scene, spp=None, seed=0, mesh=None, max_depth=None):
    """Full multi-chip render; numerically matches the single-chip
    tpu_rt.integrator.path.render up to sample assignment."""
    mesh = mesh or default_mesh()
    c = scene.camera
    spp = c.spp if spp is None else spp

    @jax.jit
    def one_pass(fv, fw, key):
        pv, pw, n = render_pass_sharded(scene, key, mesh, max_depth=max_depth)
        return fv + pv, fw + pw, n

    fv = jnp.zeros((c.height, c.width, 3), jnp.float32)
    fw = jnp.zeros((c.height, c.width), jnp.float32)
    root = jax.random.PRNGKey(seed)
    counts = []
    for i in range(spp):
        fv, fw, n = one_pass(fv, fw, jax.random.fold_in(root, i))
        counts.append(n)
    img = film_mod.develop(fv, fw)
    render_sharded.last_ray_count = int(sum(int(x) for x in jax.device_get(counts)))
    return img
