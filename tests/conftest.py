"""Test configuration: force an 8-device virtual CPU mesh so multi-device
sharding tests run on any host (SURVEY.md §2c parallel mapping)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from tpu_rt.scene import SCENE_DIR  # noqa: E402
from tpu_rt.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: first-time per-op XLA compiles take ~1 s,
# so caching makes repeat test runs fast.
enable_compile_cache(min_compile_time_secs=0.3)

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Quick smoke tier: `pytest tests -m quick` runs a small subset covering
# every subsystem.  Whole files listed here are fast; QUICK_TESTS
# cherry-picks fast items out of slow files.
# ---------------------------------------------------------------------------
QUICK_FILES = {
    "test_warps_and_math.py",
    "test_scene_loading.py",
    "test_pulse_and_film.py",
    "test_exr.py",
}
QUICK_TESTS = {
    "test_render_optical.py::test_simple_direct",
    "test_render_optical.py::test_camera_clip_propagation",
    "test_render_optical.py::test_near_far_clip_are_ray_extents",
    "test_ultrasound.py::test_das_point_scatterer_localization",
    "test_ultrasound.py::test_das_matmul_matches_gather",
    "test_ultrasound.py::test_das_matmul_short_rf_buffer",
    "test_stokes.py::test_malus_law_mueller",
    "test_stokes.py::test_fresnel_mueller_brewster_fully_polarized",
    "test_parallel_and_grad.py::test_sharded_render_matches_single_chip",
    "test_curves.py::test_curve_scene_exact_prims_and_normals",
    "test_golden_images.py::test_point_light_sphere_on_floor",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "quick: fast smoke tier (see CLAUDE.md)"
    )
    config.addinivalue_line(
        "markers", "slow: multi-minute statistical/FD-validation tests"
    )


def pytest_collection_modifyitems(config, items):
    for it in items:
        base = os.path.basename(str(it.fspath))
        if base in QUICK_FILES or f"{base}::{it.name}" in QUICK_TESTS:
            it.add_marker(pytest.mark.quick)


@pytest.fixture(scope="session")
def ref_scenes():
    """The in-repo scenes (cbox.xml; the other reference scenes are queued
    as ROADMAP R1 and absent until then)."""
    return SCENE_DIR


@pytest.fixture(scope="session")
def ref_us_scenes():
    """Ultrasound reference scenes (queued as ROADMAP R1; absent so far)."""
    return os.path.join(SCENE_DIR, "ultrasound")
