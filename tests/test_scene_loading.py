"""Scene compiler conformance: all reference XML scenes + the USMain dict
schema must load unmodified (fidelity contract, SURVEY.md §7)."""

import os

import numpy as np
import pytest

import tpu_rt
from tpu_rt.scene import ScalarTransform4f
from tpu_rt.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_ULTRASOUND,
    INTEGRATOR_DIRECT,
    INTEGRATOR_DIRECT_PROJECTIVE,
    INTEGRATOR_PATH,
    INTEGRATOR_STOKES,
    INTEGRATOR_ULTRASOUND,
)


def test_cbox(ref_scenes):
    s = tpu_rt.load_file(os.path.join(ref_scenes, "cbox.xml"))
    assert s.integrator == INTEGRATOR_PATH
    assert s.max_depth == 6
    assert s.camera.spp == 128
    assert s.camera.width == s.camera.height == 256
    # 6 OBJ shapes with 2 tris each, 2 analytic spheres
    assert s.geometry.n_tris == 12
    assert s.geometry.n_analytic == 2
    assert s.emitters.n_area == 1
    types = set(np.asarray(s.bsdf_type).tolist())
    assert {BSDF_DIFFUSE, BSDF_DIELECTRIC, BSDF_CONDUCTOR} <= types
    # default substitution: camera fov from file
    assert abs(float(s.camera.tan_fov_x) - np.tan(np.radians(39.3077) / 2)) < 1e-6


def test_cbox_overrides(ref_scenes):
    s = tpu_rt.load_file(os.path.join(ref_scenes, "cbox.xml"), spp=8, res=64)
    assert s.camera.spp == 8
    assert s.camera.width == 64


def test_simple(ref_scenes):
    s = tpu_rt.load_file(os.path.join(ref_scenes, "simple.xml"))
    assert s.integrator == INTEGRATOR_DIRECT
    assert s.geometry.n_tris == 2256  # teapot.ply faces
    assert s.emitters.n_point == 2
    np.testing.assert_allclose(
        np.asarray(s.emitters.point_intensity), np.full((2, 3), 100.0)
    )


def test_cbox_pol(ref_scenes):
    s = tpu_rt.load_file(os.path.join(ref_scenes, "cbox_pol.xml"))
    assert s.integrator == INTEGRATOR_STOKES
    assert s.emitters.n_area == 1
    np.testing.assert_allclose(np.asarray(s.emitters.area_radiance), [[25.0] * 3])
    # conductor spheres carry explicit eta/k spectra
    bt = np.asarray(s.bsdf_type)
    bp = np.asarray(s.bsdf_params)
    cond = bp[bt == BSDF_CONDUCTOR]
    assert any(abs(row[0] - 0.24873) < 1e-5 for row in cond)


def test_polarizers(ref_scenes):
    s = tpu_rt.load_file(os.path.join(ref_scenes, "polarizers.xml"))
    assert s.emitters.has_env
    assert s.geometry.n_tris == 4  # two rectangle_pol.obj quads


def test_shadow_art(ref_scenes):
    from tpu_rt.scene.types import CURVE

    s = tpu_rt.load_file(os.path.join(ref_scenes, "shadow_art.xml"))
    assert s.integrator == INTEGRATOR_DIRECT_PROJECTIVE
    assert s.emitters.n_area == 2
    # bsplinecurve -> exact round-cone swept-sphere prims (not a tube mesh);
    # the 4 remaining tris are the two emissive light quads
    an_type = np.asarray(s.geometry.an_type)
    assert (an_type == CURVE).sum() > 50
    assert s.geometry.n_tris == 4
    assert float(np.asarray(s.geometry.an_param)[an_type == CURVE].min()) > 0
    assert s.camera.width == 256 and s.camera.height == 128


def test_shadow_art_cli_override(ref_scenes):
    s = tpu_rt.load_file(os.path.join(ref_scenes, "shadow_art.xml"), resx=64, resy=32)
    assert s.camera.width == 64 and s.camera.height == 32


@pytest.mark.parametrize(
    "name", ["Sphere_Box", "Sphere_Floating", "Cone_Box", "Plate_Box", "Plane_Floating"]
)
def test_ultrasound_scenes(ref_us_scenes, name):
    s = tpu_rt.load_file(os.path.join(ref_us_scenes, f"{name}.xml"))
    assert s.integrator == INTEGRATOR_ULTRASOUND
    us = s.ultrasound
    assert us.n_elements == 64
    assert us.time_samples == 10000
    assert us.n_angles == 5
    np.testing.assert_allclose(np.asarray(us.angles), [-15, -7.5, 0, 7.5, 15])
    assert float(us.sound_speed) == 1480.0
    assert us.max_depth == 10
    bt = np.asarray(s.bsdf_type)
    assert (bt == BSDF_ULTRASOUND).any()


def test_usmain_dict():
    """The USMain.py scene-dict schema loads as-is
    (/root/reference/USMain.py:26-90)."""
    scene_dict = {
        "type": "scene",
        "integrator": {
            "type": "ultrasound_integrator",
            "max_depth": 10,
            "sampling_rate": 50e6,
            "frequency": 5e6,
            "sound_speed": 1540,
            "attenuation": 0.2,
            "wave_cycles": 5,
            "main_beam_angle": 24,
            "cutoff_angle": 30,
            "n_elements": 64,
            "pitch": 0.00003 * 4,
            "time_samples": 10000,
            "angles": np.linspace(-15, 15, 5),
        },
        "sensor": {
            "type": "ultrasound_sensor",
            "num_elements_lateral": 1280,
            "elements_width": 0.003,
            "elements_height": 0.01,
            "pitch": 0.0003,
            "radius": float("inf"),
            "center_frequency": 5e6,
            "sound_speed": 1540,
            "directivity": 1.0,
            "to_world": ScalarTransform4f().look_at(
                origin=[0, 0, 0.0], target=[0, 0, 0.03], up=[0, 1, 0]
            ),
            "film": {
                "type": "hdrfilm",
                "width": 512,
                "height": 512,
                "pixel_format": "luminance",
                "component_format": "float32",
            },
        },
        "flat_plate": {
            "type": "rectangle",
            "to_world": ScalarTransform4f().translate([0, 0, 0.05])
            @ ScalarTransform4f().rotate([0, 1, 0], 45)
            @ ScalarTransform4f().scale([0.17, 0.17, 0.14]),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.7},
        },
        "wall_back": {
            "type": "rectangle",
            "to_world": ScalarTransform4f().translate([0, 0, 1])
            @ ScalarTransform4f().rotate([0, 1, 0], 180)
            @ ScalarTransform4f().scale([0.05, 0.05, 1]),
            "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.7},
        },
    }
    s = tpu_rt.load_dict(scene_dict)
    assert s.integrator == INTEGRATOR_ULTRASOUND
    assert s.geometry.n_analytic == 2
    assert s.ultrasound.n_elements == 64
    assert float(s.ultrasound.attenuation) == np.float32(0.2)
    assert "flat_plate" in s.ids["shapes"]
    bp = np.asarray(s.bsdf_params)
    bt = np.asarray(s.bsdf_type)
    row = bp[bt == BSDF_ULTRASOUND][0]
    assert row[0] == np.float32(7.8) and row[1] == np.float32(0.7)


def test_mesh_loaders_roundtrip(ref_scenes):
    from tpu_rt.scene.obj import load_obj
    from tpu_rt.scene.ply import load_ply

    obj = load_obj(os.path.join(ref_scenes, "meshes", "rectangle.obj"))
    assert obj["faces"].shape == (2, 3)
    assert obj["uvs"] is not None

    ring = load_obj(os.path.join(ref_scenes, "..", "TestRing", "TestRing.obj"))
    assert ring["vertices"].shape[0] >= 500 and ring["faces"].shape[0] >= 1000

    teapot = load_ply(os.path.join(ref_scenes, "meshes", "teapot.ply"))
    assert teapot["vertices"].shape == (1177, 3)
    assert teapot["faces"].shape[0] == 2256

    bunny = load_ply(os.path.join(ref_scenes, "meshes", "bunny.ply"))
    assert bunny["vertices"].shape == (35947, 3)
    assert bunny["faces"].shape[0] == 69451

    suzanne = load_ply(os.path.join(ref_scenes, "meshes", "suzanne.ply"))
    assert suzanne["vertices"].shape[0] == 35258
    assert suzanne["normals"] is not None


def test_vol_loader(ref_scenes):
    from tpu_rt.scene.vol import load_vol

    vol = load_vol(os.path.join(ref_scenes, "..", "scenes", "volume.vol"))
    assert vol["shape"] == (44, 45, 53, 1)
    assert vol["data"].shape == (53, 45, 44, 1)


def test_compat_api_usmain_flow():
    """Reference-script port surface (tpu_rt.compat): register_* shims,
    scene_integrator().simulate_acquisition_parallel(), traverse()/update()
    — the USMain.py call shapes (USMain.py:14-24,95-99,259-266)."""
    import tpu_rt.compat as compat

    compat.register_integrator("ultrasound_integrator")
    compat.register_bsdf("ultrasound_bsdf")
    scene = tpu_rt.load_dict(
        {
            "type": "scene",
            "integrator": {
                "type": "ultrasound_integrator",
                "max_depth": 2,
                "n_elements": 8,
                "time_samples": 600,
                "pitch": 0.0004,
                "angles": np.asarray([0.0], np.float32),
            },
            "sensor": {
                "type": "ultrasound_sensor",
                "num_elements_lateral": 8,
                "pitch": 0.0004,
                "radius": float("inf"),
                "to_world": ScalarTransform4f(),
            },
            "flat_plate": {
                "type": "rectangle",
                "to_world": ScalarTransform4f().translate([0, 0, 0.005])
                @ ScalarTransform4f().rotate([0, 1, 0], 180)
                @ ScalarTransform4f().scale([0.01, 0.01, 1]),
                "bsdf": {"type": "ultrasound_bsdf", "impedance": 7.8, "roughness": 0.7},
            },
        }
    )
    integrator = compat.scene_integrator(scene)
    assert integrator.n_elements == 8 and integrator.fs == 50e6
    assert integrator.simulate_acquisition_parallel() is True
    assert integrator.channel_buf.shape == (1, 8, 600)
    assert abs(integrator.channel_buf).sum() > 0
    assert integrator.transmission_delays_buf.shape == (1, 8)

    params = compat.traverse(scene)
    assert "flat_plate.bsdf.roughness" in params
    params["flat_plate.bsdf.roughness"] = 0.3
    sc2 = params.update()
    from tpu_rt.opt.inverse import get_param

    assert abs(float(get_param(sc2, "flat_plate.bsdf.roughness")) - 0.3) < 1e-6
