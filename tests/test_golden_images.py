"""Golden-image RMSE tests: tpu_rt vs the independent NumPy reference
renderer (tests/golden_reference.py) on controlled direct-illumination
scenes — the cross-implementation check demanded by SURVEY.md §4/§7
(BASELINE config 1 class: CPU-runnable direct illumination)."""

import os

import numpy as np
import pytest

import tpu_rt
from tpu_rt.integrator.path import render
from tpu_rt.scene import SCENE_DIR

from golden_reference import Quad, Sphere, render_direct_aa


def _rel_rmse(a, b):
    return np.sqrt(((a - b) ** 2).mean()) / max(b.mean(), 1e-9)


def test_point_light_sphere_on_floor():
    """Sphere on a floor quad lit by a point light: depth-2 path render must
    match the analytic direct-illumination reference within MC noise."""
    albedo_s = [0.6, 0.3, 0.2]
    albedo_f = [0.5, 0.5, 0.5]
    light_pos = [2.0, 3.0, -2.0]
    light_int = [30.0, 30.0, 30.0]
    res = 48

    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "integrator": {"type": "direct"},
            "sensor": {
                "type": "perspective",
                "fov": 45,
                "to_world": tpu_rt.ScalarTransform4f().look_at(
                    origin=[0, 1.0, -5.0], target=[0, 0.5, 0], up=[0, 1, 0]
                ),
                "film": {"type": "hdrfilm", "width": res, "height": res,
                         "rfilter": {"type": "box"}},
                "sampler": {"type": "independent", "sample_count": 64},
            },
            "ball": {
                "type": "sphere",
                "center": np.asarray([0.0, 0.5, 0.0]),
                "radius": 0.5,
                "bsdf": {"type": "diffuse", "reflectance": np.asarray(albedo_s)},
            },
            "floor": {
                "type": "rectangle",
                # rectangle is [-1,1]^2 at z=0 with +z normal; rotate to y-up
                "to_world": tpu_rt.ScalarTransform4f().translate([0, 0, 0])
                @ tpu_rt.ScalarTransform4f().rotate([1, 0, 0], -90)
                @ tpu_rt.ScalarTransform4f().scale([4.0, 4.0, 1.0]),
                "bsdf": {"type": "diffuse", "reflectance": np.asarray(albedo_f)},
            },
            "light": {"type": "point", "position": np.asarray(light_pos),
                      "intensity": np.asarray(light_int)},
        }
    )
    img = np.asarray(render(scene, spp=64))

    golden = render_direct_aa(
        shapes=[
            Sphere([0, 0.5, 0], 0.5, albedo_s),
            Quad([-4, 0, -4], [8, 0, 0], [0, 0, 8], albedo_f),
        ],
        point_lights=[(light_pos, light_int)],
        width=res, height=res,
        cam_origin=[0, 1.0, -5.0], cam_target=[0, 0.5, 0], cam_up=[0, 1, 0],
        fov_deg=45,
    )
    err = _rel_rmse(img, golden)
    assert err < 0.02, f"relative RMSE vs golden reference = {err:.4f}"


def test_area_light_noise_free_regions():
    """Quad area light over a floor: MC render vs grid-integrated reference
    (checks NEE area sampling, one-sided emission, emitter visibility)."""
    res = 40
    rad = [8.0, 6.0, 4.0]
    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "integrator": {"type": "direct"},
            "sensor": {
                "type": "perspective",
                "fov": 50,
                "to_world": tpu_rt.ScalarTransform4f().look_at(
                    origin=[0, 2.0, -4.0], target=[0, 0, 0], up=[0, 1, 0]
                ),
                "film": {"type": "hdrfilm", "width": res, "height": res,
                         "rfilter": {"type": "box"}},
                "sampler": {"type": "independent", "sample_count": 128},
            },
            "floor": {
                "type": "rectangle",
                "to_world": tpu_rt.ScalarTransform4f().rotate([1, 0, 0], -90)
                @ tpu_rt.ScalarTransform4f().scale([3.0, 3.0, 1.0]),
                "bsdf": {"type": "diffuse", "reflectance": np.full(3, 0.7)},
            },
            "lamp": {
                "type": "rectangle",
                # emits along its +z normal; rotate so it faces down (-y up
                # direction: +z -> -y means rotate +90 about x)
                "to_world": tpu_rt.ScalarTransform4f().translate([0, 2.0, 0])
                @ tpu_rt.ScalarTransform4f().rotate([1, 0, 0], 90)
                @ tpu_rt.ScalarTransform4f().scale([0.5, 0.5, 1.0]),
                "bsdf": {"type": "diffuse", "reflectance": np.zeros(3)},
                "emitter": {"type": "area", "radiance": np.asarray(rad)},
            },
        }
    )
    img = np.asarray(render(scene, spp=128))

    # golden: the lamp quad faces -y. corner/e1/e2 chosen so n = -y.
    lamp = Quad([-0.5, 2.0, -0.5], [1.0, 0, 0], [0, 0, 1.0], np.zeros(3), emission=rad)
    assert np.allclose(lamp.n, [0, -1, 0])
    golden = render_direct_aa(
        shapes=[
            Quad([-3, 0, -3], [6, 0, 0], [0, 0, 6], np.full(3, 0.7)),
            lamp,
        ],
        point_lights=[],
        width=res, height=res,
        cam_origin=[0, 2.0, -4.0], cam_target=[0, 0, 0], cam_up=[0, 1, 0],
        fov_deg=50, light_grid=12,
    )
    err = _rel_rmse(img, golden)
    assert err < 0.03, f"relative RMSE vs golden reference = {err:.4f}"


@pytest.fixture(scope="module")
def cbox64_box_render():
    """The in-repo cbox.xml at 64^2, box filter, 3072 spp (one render shared
    by the golden comparisons below), block-averaged to 16x16."""
    scene = tpu_rt.load_file(os.path.join(SCENE_DIR, "cbox.xml"), res=64, spp=1)
    scene = scene.replace(camera=scene.camera.replace(filter_type=0))
    img = np.asarray(render(scene, spp=3072, seed=11))
    return img.reshape(16, 4, 16, 4, 3).mean(axis=(1, 3))


def _golden16(name):
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", name))
    return golden.reshape(16, 8, 16, 8, 3).mean(axis=(1, 3))  # (128,128,3)


def test_cbox_full_gi_vs_independent_golden(cbox64_box_render):
    """Full-GI cbox against the committed INDEPENDENT golden
    (tests/golden/cbox_128_gi_independent.npy: standalone NumPy path tracer,
    8192 spp, box filter — provenance in the sibling .json).  This is the
    fidelity-contract check (SURVEY §7: cbox within 1% RMSE) running in the
    suite; blocks of 16x16 divide per-pixel MC noise out, so the comparison
    measures transport bias."""
    g16 = _golden16("cbox_128_gi_independent.npy")
    i16 = cbox64_box_render
    rel = np.sqrt(((i16 - g16) ** 2).mean()) / g16.mean()
    assert rel < 0.025, f"block rel-RMSE {rel:.4f} vs independent golden"


def test_cbox_vs_earlier_cpu_render(cbox64_box_render):
    """The in-repo cbox.xml against tpu_rt's own earlier CPU render of the
    reference's cbox (tests/golden/cbox_128_cpu.npy): the scene file
    reproduces the scene the project was built against."""
    g16 = _golden16("cbox_128_cpu.npy")
    i16 = cbox64_box_render
    rel = np.sqrt(((i16 - g16) ** 2).mean()) / g16.mean()
    assert rel < 0.025, f"block rel-RMSE {rel:.4f} vs earlier CPU render"


def test_direct_projective_primal_equals_direct():
    """direct_projective's PRIMAL render is the direct integrator's image
    (Mitsuba semantics: projective sampling only changes how discontinuity
    gradients are estimated).  shadow_art.xml:10 is the one reference scene
    using it (VERDICT r2 missing #3)."""
    import jax.numpy as jnp

    import tpu_rt
    from tpu_rt.scene.types import INTEGRATOR_DIRECT, INTEGRATOR_DIRECT_PROJECTIVE

    scene = tpu_rt.load_file(os.path.join(SCENE_DIR, "shadow_art.xml"),
                             res=32, spp=1)
    assert scene.integrator == INTEGRATOR_DIRECT_PROJECTIVE
    img_p = np.asarray(tpu_rt.render(scene, spp=4, seed=3))
    img_d = np.asarray(
        tpu_rt.render(scene.replace(integrator=INTEGRATOR_DIRECT), spp=4, seed=3)
    )
    np.testing.assert_allclose(img_p, img_d, rtol=1e-6, atol=1e-8)
    assert np.isfinite(img_p).all() and img_p.max() > 0


def test_shadow_art_vs_independent_golden():
    """shadow_art content check against the independent NumPy direct
    renderer: emitter quads + wall quads built straight from the XML
    matrices, curve as a DENSE tube tessellation (24 sides — faceting error
    ~0.9% of the 0.01 wire radius) while tpu_rt renders the EXACT
    round-cone swept-sphere prims; the transport — visibility, area light
    sampling, Lambert shading — is fully independent)."""
    import tpu_rt
    from tests.golden_reference import Quad, TriSoup, render_direct

    scene = tpu_rt.load_file(os.path.join(SCENE_DIR, "shadow_art.xml"),
                             res=64, spp=1)
    # camera from the parsed to_world (verified against the XML rotations
    # by the loader tests); forward = +z column, up = +y column
    m = np.asarray(scene.camera.to_world, np.float64)
    origin = m[:3, 3]
    target = origin + m[:3, 2]
    up = m[:3, 1]
    fov_x = float(np.degrees(2 * np.arctan(scene.camera.tan_fov_x)))
    fov_y = float(np.degrees(2 * np.arctan(scene.camera.tan_fov_y)))

    def quad(mat, emission=None):
        M = np.asarray(mat, np.float64).reshape(4, 4)
        corner = (M @ np.array([-1.0, -1.0, 0.0, 1.0]))[:3]
        return Quad(corner, 2 * M[:3, 0], 2 * M[:3, 1], albedo=(0.5,) * 3,
                    emission=emission)

    # the four rectangles verbatim from shadow_art.xml:30-58
    l1 = quad([-0.025, 0, 0, 0, 0, 0.025, 0, 0, 0, 0, -0.025, 5,
               0, 0, 0, 1], emission=(40000.0,) * 3)
    l2 = quad([0, 0, -0.025, 5, 0, 0.025, 0, 0, 0.025, 0, 0, 0,
               0, 0, 0, 1], emission=(40000.0,) * 3)
    w1 = quad([8, 0, 0, 0, 0, 2, 0, 0, 0, 0, 2, -5, 0, 0, 0, 1])
    w2 = quad([0, 0, 2, -5, 0, 2, 0, 0, -8, 0, 0, 0, 0, 0, 0, 1])

    from tpu_rt.scene.types import CURVE
    from tpu_rt.scene.curves import tessellate_bspline_tube

    g = scene.geometry
    assert (np.asarray(g.an_type) == CURVE).sum() > 50  # exact prims in use
    verts, faces, _ = tessellate_bspline_tube(
        os.path.join(SCENE_DIR, "meshes", "bsplinecurve_circle.txt"),
        samples_per_segment=12, sides=24)
    p0 = verts[faces[:, 0]]
    soup = TriSoup(p0, verts[faces[:, 1]] - p0, verts[faces[:, 2]] - p0,
                   albedo=(0.5,) * 3)

    H, W = 32, 64
    golden = render_direct([l1, l2, w1, w2, soup], [], W, H, origin, target,
                           up, fov_x, light_grid=3, fov_y_deg=fov_y)

    cam = scene.camera.replace(height=H, width=W, filter_type=0)
    img = np.asarray(tpu_rt.render(scene.replace(camera=cam), spp=96, seed=2))
    assert np.isfinite(img).all()

    # block-average to 8x16 (washes MC noise + grid-light bias + the
    # emitter-edge aliasing of the un-antialiased golden)
    gb = golden.reshape(8, 4, 16, 4, 3).mean(axis=(1, 3))
    ib = img.reshape(8, 4, 16, 4, 3).mean(axis=(1, 3))
    rel = np.sqrt(((ib - gb) ** 2).mean()) / max(gb.mean(), 1e-9)
    assert rel < 0.12, f"shadow_art block rel-RMSE {rel:.4f} vs independent"
