"""Exact swept-sphere (round-cone) curve geometry.

The reference's `bsplinecurve` shape (/root/reference/scenes/shadow_art.xml:
60-62) is Mitsuba's swept-sphere B-spline, intersected exactly in C++.
tpu_rt round 2 approximated it with an 8-sided tube mesh; these tests cover
the round-3 exact representation: geometry/intersect.ray_roundcone (closed
form per linear flattening span) + the CURVE analytic prim plumbing.
"""

import os

import numpy as np
import pytest

import tpu_rt
from tpu_rt.scene import SCENE_DIR

SCENES = SCENE_DIR


def _sdf_swept_sphere(p, r0, r1, ns=1501):
    """Distance from points p (..., 3) to the canonical swept-sphere
    (center (0,0,s), radius r0+(r1-r0)s, s in [0,1]) — dense-sample min."""
    s = np.linspace(0.0, 1.0, ns)
    dz = p[..., 2:3] - s
    dxy = p[..., 0:1] ** 2 + p[..., 1:2] ** 2
    return (np.sqrt(dxy + dz * dz) - (r0 + (r1 - r0) * s)).min(axis=-1)


@pytest.mark.parametrize("r0,r1", [(0.3, 0.1), (0.01, 0.01), (0.1, 0.4)])
def test_roundcone_hits_lie_on_surface(r0, r1):
    import jax
    import jax.numpy as jnp

    from tpu_rt.geometry.intersect import ray_roundcone

    rng = np.random.default_rng(7)
    n = 500
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    tgt = rng.normal(size=(n, 3)) * 0.3 + np.array([0, 0, 0.5])
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d *= rng.uniform(0.5, 2.0, size=(n, 1))  # non-unit |d| preserves t

    t, u, v = jax.jit(ray_roundcone)(
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        r0, r1, 1e-4, 1e8,
    )
    t = np.asarray(t)
    hit = t < 1e7
    assert hit.any()

    # every reported hit lies on the surface (|SDF| ~ 0)
    p = o[hit] + t[hit][:, None] * d[hit]
    assert np.abs(_sdf_swept_sphere(p, r0, r1)).max() < 3e-4
    # axial u in [0, 1]
    assert (np.asarray(u)[hit] >= 0).all() and (np.asarray(u)[hit] <= 1).all()

    # no earlier crossing: the SDF stays positive strictly before each hit
    frac = np.linspace(0.02, 0.995, 50)
    pts = o[hit][:, None, :] + (t[hit][:, None] * frac)[..., None] * d[hit][:, None, :]
    for i in range(0, pts.shape[0], 64):
        assert _sdf_swept_sphere(pts[i:i + 64], r0, r1).min() > -3e-4

    # reported misses really miss (sample along the ray)
    tm = np.linspace(0.1, 8.0, 120)
    pm = o[~hit][:, None, :] + tm[None, :, None] * d[~hit][:, None, :]
    for i in range(0, pm.shape[0], 64):
        assert _sdf_swept_sphere(pm[i:i + 64], r0, r1).min() > -1e-3


def test_curve_scene_exact_prims_and_normals():
    """shadow_art's curve becomes CURVE prims; first-hit normals are unit,
    outward (facing the ray), and match the swept-sphere gradient."""
    import jax.numpy as jnp

    from tpu_rt.geometry.trace import ray_intersect
    from tpu_rt.scene.types import CURVE
    from tpu_rt.sensor import camera as cam

    # the wire is r=0.01 — needs some resolution before it covers pixels
    scene = tpu_rt.load_file(os.path.join(SCENES, "shadow_art.xml"),
                             resx=192, resy=96)
    g = scene.geometry
    an_type = np.asarray(g.an_type)
    n_curve = int((an_type == CURVE).sum())
    assert n_curve > 50
    assert g.an_param is not None

    H, W = scene.camera.height, scene.camera.width
    xy = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"),
                  -1).reshape(-1, 2) + 0.5
    o, d = cam.sample_ray(scene.camera, jnp.asarray(xy, jnp.float32))
    si = ray_intersect(scene, o, d)
    valid = np.asarray(si.valid)
    prim = np.asarray(si.prim)
    is_curve = valid & (prim >= g.n_tris) & (
        an_type[np.clip(prim - g.n_tris, 0, max(g.n_analytic - 1, 0))] == CURVE
    )
    assert is_curve.sum() > 20  # the wire covers some pixels at 192x96

    n = np.asarray(si.n)[is_curve]
    dd = np.asarray(d)[is_curve]
    assert np.abs(np.linalg.norm(n, axis=-1) - 1.0).max() < 1e-4
    # outward: the camera sees front faces
    assert (np.sum(n * dd, axis=-1) < 1e-4).all()


def test_curve_exact_matches_mesh_mode_render():
    """The exact representation renders the same image as the legacy tube
    tessellation (block-averaged; both are unbiased geometry for the same
    curve, differing only by faceting ~ 1e-4)."""
    import tpu_rt.scene.build  # noqa: F401  (env knob read at build time)

    path = os.path.join(SCENES, "shadow_art.xml")
    scene_exact = tpu_rt.load_file(path, resx=64, resy=32)

    os.environ["TPU_RT_CURVE_MODE"] = "mesh"
    try:
        scene_mesh = tpu_rt.load_file(path, resx=64, resy=32)
    finally:
        del os.environ["TPU_RT_CURVE_MODE"]
    assert scene_mesh.geometry.n_tris > 1000  # tube mesh present

    img_e = np.asarray(tpu_rt.render(scene_exact, spp=32, seed=5))
    img_m = np.asarray(tpu_rt.render(scene_mesh, spp=32, seed=5))
    assert np.isfinite(img_e).all() and np.isfinite(img_m).all()

    def blocks(x):
        return x.reshape(8, 4, 16, 4, 3).mean(axis=(1, 3))

    be, bm = blocks(img_e), blocks(img_m)
    rel = np.sqrt(((be - bm) ** 2).mean()) / max(bm.mean(), 1e-9)
    assert rel < 0.05, f"exact-vs-mesh curve render rel {rel:.4f}"


def test_curve_radius_gradient_is_finite_and_nonzero():
    """Inverse shadow art: the exact curve prims are differentiable — the
    render gradient w.r.t. the swept-sphere radii (geometry.an_param) is
    finite and nonzero (a thicker wire blocks more light).  The reference's
    direct_projective integrator exists exactly to differentiate such
    silhouettes (shadow_art.xml:10); here the closed-form intersector gives
    the interior-derivative part through plain jax.grad."""
    import jax
    import jax.numpy as jnp

    scene = tpu_rt.load_file(os.path.join(SCENES, "shadow_art.xml"),
                             resx=48, resy=24)
    from tpu_rt.integrator.path import render as render_xla

    def loss(ap):
        sc = scene.replace(
            geometry=scene.geometry.replace(an_param=ap))
        img = render_xla(sc, spp=8, seed=4, max_depth=2)  # direct
        return jnp.mean(img)

    g = np.asarray(jax.grad(loss)(scene.geometry.an_param))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0
