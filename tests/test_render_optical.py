"""Optical rendering integration tests: geometry, transport, conventions.

These are the golden-stat tests the reference lacks (SURVEY.md §4): white
furnace (energy conservation), cbox orientation (red wall left like
Mitsuba's cbox), direct illumination sanity on simple.xml.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_rt
from tpu_rt.geometry import trace
from tpu_rt.integrator.path import path_trace, render
from tpu_rt.scene.types import Scene


def test_furnace_convex_diffuse():
    """Diffuse convex sphere in a constant-radiance-1 environment: every
    sphere pixel must converge to the albedo, background to 1."""
    albedo = 0.7
    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "integrator": {"type": "path", "max_depth": 8},
            "sensor": {
                "type": "perspective",
                "fov": 40,
                "to_world": tpu_rt.ScalarTransform4f().look_at(
                    origin=[0, 0, -4], target=[0, 0, 0], up=[0, 1, 0]
                ),
                "film": {"type": "hdrfilm", "width": 24, "height": 24,
                         "rfilter": {"type": "box"}},
                "sampler": {"type": "independent", "sample_count": 64},
            },
            "sph": {
                "type": "sphere",
                "bsdf": {"type": "diffuse", "reflectance": np.full(3, albedo)},
            },
            "env": {"type": "constant", "radiance": np.ones(3)},
        }
    )
    img = np.asarray(render(scene, spp=64))
    center = img[10:14, 10:14].mean()
    corner = img[:3, :3].mean()
    assert abs(center - albedo) < 0.03, f"sphere radiance {center} != albedo"
    assert abs(corner - 1.0) < 0.03, f"background {corner} != env radiance"


def test_furnace_constant_env_central_rays():
    """White furnace through path_trace directly: rays aimed at the centre
    of a convex diffuse sphere (albedo 0.7) in a constant unit environment
    average to exactly the albedo (every bounce escapes to the env), and
    rays that miss see exactly the env radiance."""
    albedo = 0.7
    scene = tpu_rt.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 8},
        "sph": {"type": "sphere",
                "bsdf": {"type": "diffuse", "reflectance": np.full(3, albedo)}},
        "env": {"type": "constant", "radiance": np.ones(3)},
    })
    n = 4096
    o = jnp.tile(jnp.asarray([[0.0, 0.0, -4.0]]), (n, 1))
    d_hit = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (n, 1))
    L = np.mean([np.asarray(path_trace(scene, o, d_hit, jax.random.PRNGKey(s))[0])
                 for s in range(4)], axis=0)
    assert np.isfinite(L).all()
    assert abs(L.mean() - albedo) < 0.01, L.mean()
    L_miss, _ = path_trace(scene, o, -d_hit, jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(L_miss), 1.0, rtol=1e-6)


def test_cbox_renders_and_orientation(ref_scenes):
    scene = tpu_rt.load_file(os.path.join(ref_scenes, "cbox.xml"), spp=8, res=48)
    img = np.asarray(render(scene, spp=8))
    assert img.shape == (48, 48, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0
    # Red wall is at world x=+1 (cbox_redwall.obj) => image LEFT.
    left = img[12:36, 2:12]
    right = img[12:36, 36:46]
    red_left = left[..., 0].mean() / max(left[..., 1].mean(), 1e-9)
    red_right = right[..., 0].mean() / max(right[..., 1].mean(), 1e-9)
    assert red_left > 1.5, f"left strip not red-tinted (ratio {red_left})"
    assert red_right < 1.0, f"right strip should be green-tinted (ratio {red_right})"
    # Luminaire at ceiling: top rows contain the brightest pixels.
    assert img.max(axis=-1)[:10].max() >= img.max(axis=-1)[30:].max()


def test_simple_direct(ref_scenes):
    scene = tpu_rt.load_file(os.path.join(ref_scenes, "simple.xml"), spp=8, res=48)
    img = np.asarray(render(scene, spp=8))
    assert np.isfinite(img).all()
    # Teapot is yellow diffuse (0.9, 0.9, 0.0) under white point lights:
    # lit pixels should have blue << red.
    lit = img[..., 0] > 0.05
    assert lit.sum() > 20
    assert img[..., 2][lit].mean() < 0.1 * img[..., 0][lit].mean()


def test_shadow_art_renders(ref_scenes):
    scene = tpu_rt.load_file(
        os.path.join(ref_scenes, "shadow_art.xml"), resx=32, resy=16
    )
    img = np.asarray(render(scene, spp=4))
    assert img.shape == (16, 32, 3)
    assert np.isfinite(img).all()


def test_mesh_bvh_vs_bruteforce(ref_scenes):
    """BVH traversal must agree exactly with brute force on the teapot."""
    scene = tpu_rt.load_file(os.path.join(ref_scenes, "simple.xml"))
    geom = scene.geometry
    assert geom.n_tris > trace.BRUTE_FORCE_MAX_PRIMS  # uses BVH by default
    key = jax.random.PRNGKey(0)
    n = 256
    o = jnp.asarray([[0.0, -12.0, 5.0]]).repeat(n, axis=0)
    d = jax.random.normal(key, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    # aim roughly at the teapot
    d = d * 0.25 + jnp.asarray([[0.0, 12.0, -3.75]]) / 12.6
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    hit_bvh = trace._trace_bvh(geom, o, d, 1e-4, jnp.inf)
    hit_bf = trace._trace_bruteforce(geom, o, d, 1e-4, jnp.inf)
    hit_ck = trace._trace_chunked(geom, o, d, 1e-4, jnp.inf)
    np.testing.assert_array_equal(np.asarray(hit_bvh.prim), np.asarray(hit_bf.prim))
    np.testing.assert_array_equal(np.asarray(hit_ck.prim), np.asarray(hit_bf.prim))
    np.testing.assert_allclose(
        np.asarray(hit_bvh.t)[np.asarray(hit_bvh.prim) >= 0],
        np.asarray(hit_bf.t)[np.asarray(hit_bf.prim) >= 0],
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(hit_ck.t)[np.asarray(hit_ck.prim) >= 0],
        np.asarray(hit_bf.t)[np.asarray(hit_bf.prim) >= 0],
        rtol=1e-5,
    )
    assert (np.asarray(hit_bvh.prim) >= 0).sum() > 50


def _soup_geometry(p0, e1, e2):
    """Triangle-only Geometry (with its BVH) for a raw triangle soup."""
    from tpu_rt.geometry.bvh import build_bvh
    from tpu_rt.scene.types import Geometry

    T = p0.shape[0]
    v = np.stack([p0, p0 + e1, p0 + e2], 1)
    bvh = build_bvh(v.min(1) - 1e-6, v.max(1) + 1e-6)
    z3 = jnp.zeros((T, 3), jnp.float32)
    z2 = jnp.zeros((T, 2), jnp.float32)
    return Geometry(
        tri_p0=jnp.asarray(p0), tri_e1=jnp.asarray(e1), tri_e2=jnp.asarray(e2),
        tri_n0=z3, tri_n1=z3, tri_n2=z3, tri_uv0=z2, tri_uv1=z2, tri_uv2=z2,
        tri_shape=jnp.zeros((T,), jnp.int32),
        an_type=jnp.zeros((0,), jnp.int32),
        an_to_world=jnp.zeros((0, 4, 4), jnp.float32),
        an_to_object=jnp.zeros((0, 4, 4), jnp.float32),
        an_shape=jnp.zeros((0,), jnp.int32),
        bvh_min=jnp.asarray(bvh["node_min"]), bvh_max=jnp.asarray(bvh["node_max"]),
        bvh_a=jnp.asarray(bvh["a"]), bvh_b=jnp.asarray(bvh["b"]),
        bvh_count=jnp.asarray(bvh["count"]),
        prim_order=jnp.asarray(bvh["prim_order"]),
        n_tris=T, n_analytic=0,
    )


@pytest.mark.parametrize("route,T,N", [
    ("bruteforce", 150, 1024),
    ("chunked", 700, 1024),
    ("bvh", 9000, 256),
])
def test_random_soup_matches_numpy(route, T, N):
    """Incoherent random triangle soup + random rays through the public
    ray_intersect_hit vs an independent NumPy Moller-Trumbore closest hit;
    T picks the route (brute force / chunked scan / BVH traversal)."""
    assert {
        "bruteforce": T <= trace.BRUTE_FORCE_MAX_PRIMS,
        "chunked": trace.BRUTE_FORCE_MAX_PRIMS < T <= trace.CHUNKED_MAX_PRIMS,
        "bvh": T > trace.CHUNKED_MAX_PRIMS,
    }[route]
    rng = np.random.default_rng(11)
    scale = 0.25 * (300.0 / T) ** 0.5  # keep the soup's depth complexity modest
    p0 = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, scale, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, scale, (T, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(0, 1, (N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    hit = trace.ray_intersect_hit(_soup_geometry(p0, e1, e2),
                                  jnp.asarray(o), jnp.asarray(d), tmin=1e-4)
    t, prim = np.asarray(hit.t), np.asarray(hit.prim)

    pv = np.cross(d[:, None, :], e2[None, :, :])          # [N, T, 3]
    det = np.einsum("tk,ntk->nt", e1, pv)
    det = np.where(np.abs(det) < 1e-12, np.where(det < 0, -1e-12, 1e-12), det)
    tv = o[:, None, :] - p0[None, :, :]
    uu = np.einsum("ntk,ntk->nt", tv, pv) / det
    qv = np.cross(tv, e1[None, :, :])
    vv = np.einsum("nk,ntk->nt", d, qv) / det
    tt = np.einsum("tk,ntk->nt", e2, qv) / det
    ok = (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 1e-4)
    tt = np.where(ok, tt, np.inf)
    ref_prim = tt.argmin(1)
    ref_t = tt[np.arange(N), ref_prim]
    ref_hit = np.isfinite(ref_t)
    assert ref_hit.mean() > 0.15

    np.testing.assert_array_equal(prim >= 0, ref_hit)
    np.testing.assert_allclose(t[ref_hit], ref_t[ref_hit], rtol=2e-5)
    # same winning triangle wherever the closest hit is unambiguous
    t2 = np.partition(tt, 1, axis=1)[:, 1]
    with np.errstate(invalid="ignore"):
        clear = ref_hit & ((t2 - ref_t) > 1e-3)
    np.testing.assert_array_equal(prim[clear], ref_prim[clear])


def test_analytic_sphere_hit_positions():
    """Ray-sphere hits against closed form."""
    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "s": {
                "type": "sphere",
                "center": np.asarray([0.0, 0.0, 2.0]),
                "radius": 0.5,
                "bsdf": {"type": "diffuse"},
            },
        }
    )
    o = jnp.asarray([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.6, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]] * 3)
    si = trace.ray_intersect(scene, o, d)
    t = np.asarray(si.t)
    np.testing.assert_allclose(t[0], 1.5, rtol=1e-5)
    np.testing.assert_allclose(t[1], 2.0 - np.sqrt(0.25 - 0.01), rtol=1e-5)
    assert not bool(si.valid[2])  # misses
    n = np.asarray(si.n)
    np.testing.assert_allclose(n[0], [0, 0, -1], atol=1e-5)


def test_rectangle_and_disk_hits():
    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "r": {"type": "rectangle", "bsdf": {"type": "diffuse"}},
        }
    )
    o = jnp.asarray([[0.5, 0.5, -1.0], [1.5, 0.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]] * 2)
    si = trace.ray_intersect(scene, o, d)
    assert bool(si.valid[0]) and not bool(si.valid[1])
    np.testing.assert_allclose(np.asarray(si.t)[0], 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(si.uv)[0], [0.75, 0.75], atol=1e-5)


def test_cone_cylinder_hits():
    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "c": {"type": "cylinder", "bsdf": {"type": "diffuse"}},
        }
    )
    o = jnp.asarray([[-3.0, 0.0, 0.5]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    si = trace.ray_intersect(scene, o, d)
    assert bool(si.valid[0])
    np.testing.assert_allclose(np.asarray(si.t)[0], 2.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(si.n)[0], [-1, 0, 0], atol=1e-4)

    scene2 = tpu_rt.load_dict(
        {"type": "scene", "k": {"type": "cone", "bsdf": {"type": "diffuse"}}}
    )
    o2 = jnp.asarray([[-3.0, 0.0, 0.5]])
    si2 = trace.ray_intersect(scene2, o2, d)
    assert bool(si2.valid[0])
    np.testing.assert_allclose(np.asarray(si2.t)[0], 2.5, rtol=1e-4)  # radius 0.5 at z=0.5


def _clip_scene(near=None, far=None, pixel_format=None, emitter_z=2.0,
                blocker=True):
    """Camera at z=-3 looking +z; area emitter at z=+2 facing the camera,
    with an optional black blocker rectangle at z=0 (hit t ~= 3)."""
    sensor = {
        "type": "perspective",
        "fov": 30,
        "to_world": tpu_rt.ScalarTransform4f().look_at(
            origin=[0, 0, -3], target=[0, 0, 1], up=[0, 1, 0]
        ),
        "film": {"type": "hdrfilm", "width": 16, "height": 16,
                 "rfilter": {"type": "box"}},
        "sampler": {"type": "independent", "sample_count": 4},
    }
    if near is not None:
        sensor["near_clip"] = near
    if far is not None:
        sensor["far_clip"] = far
    if pixel_format is not None:
        sensor["film"]["pixel_format"] = pixel_format
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": sensor,
        "light": {
            "type": "rectangle",
            # facing -z toward the camera (rectangle normal is +z; rotate)
            "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, emitter_z])
            @ tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
            @ tpu_rt.ScalarTransform4f().scale([3, 3, 1]),
            "emitter": {"type": "area", "radiance": np.ones(3)},
        },
    }
    if blocker:
        d["blocker"] = {
            "type": "rectangle",
            "to_world": tpu_rt.ScalarTransform4f().rotate([0, 1, 0], 180)
            @ tpu_rt.ScalarTransform4f().scale([3, 3, 1]),
            "bsdf": {"type": "diffuse", "reflectance": np.zeros(3)},
        }
    return tpu_rt.load_dict(d)


def test_camera_clip_propagation(ref_scenes):
    """cbox.xml near/far clip values must reach the Camera
    (/root/reference/scenes/cbox.xml:13-14)."""
    scene = tpu_rt.load_file(os.path.join(ref_scenes, "cbox.xml"), res=16)
    assert abs(float(scene.camera.near) - 0.001) < 1e-9
    assert abs(float(scene.camera.far) - 100.0) < 1e-6


def test_near_far_clip_are_ray_extents():
    """Mitsuba ray.mint/maxt semantics: a blocker nearer than near_clip is
    skipped (the emitter behind it shows); geometry beyond far_clip is
    missed.  Runs both the public render path and the XLA wavefront
    tracer directly."""
    mid = np.asarray(tpu_rt.render(_clip_scene(), spp=4))[6:10, 6:10]
    assert mid.mean() < 0.05  # black blocker fills the view

    # near clip beyond the blocker (t ~= 3 at image center): emitter shows
    bright = np.asarray(tpu_rt.render(_clip_scene(near=4.0), spp=4))[6:10, 6:10]
    assert bright.mean() > 0.9

    # far clip in front of everything: pure miss -> black
    dark = np.asarray(tpu_rt.render(
        _clip_scene(blocker=False, far=2.0), spp=4))[6:10, 6:10]
    assert dark.max() < 1e-6

    # XLA wavefront tracer honors the same extents
    from tpu_rt.integrator.path import render as render_xla

    bright2 = np.asarray(render_xla(_clip_scene(near=4.0), spp=4))[6:10, 6:10]
    assert bright2.mean() > 0.9


def test_luminance_pixel_format():
    """hdrfilm pixel_format=luminance returns (H, W, 1) equal to the BT.709
    luminance of the RGB render (/root/reference/USMain.py:62)."""
    from tpu_rt.core.math import luminance

    rgb = np.asarray(tpu_rt.render(_clip_scene(near=4.0), spp=4, seed=3))
    mono = np.asarray(tpu_rt.render(
        _clip_scene(near=4.0, pixel_format="luminance"), spp=4, seed=3))
    assert mono.shape == rgb.shape[:2] + (1,)
    np.testing.assert_allclose(
        mono[..., 0], np.asarray(luminance(jnp.asarray(rgb))), rtol=1e-5,
        atol=1e-7)
