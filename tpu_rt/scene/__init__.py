"""Scene loading API (equivalents of mi.load_file / mi.load_dict)."""

import os

from tpu_rt.scene.build import build_scene
from tpu_rt.scene.transforms import ScalarTransform4f  # noqa: F401
from tpu_rt.scene.types import Scene, Camera, UltrasoundConfig  # noqa: F401
from tpu_rt.scene.xml_loader import load_xml

# The scenes that ship with the repository (``scenes/`` at its root).
SCENE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "scenes",
)


def load_file(path, **overrides):
    """Load a Mitsuba XML scene file (equivalent of mi.load_file; overrides
    play the role of command-line -Dname=value parameters)."""
    return build_scene(load_xml(path, overrides=overrides or None))


def load_dict(desc):
    """Load a Mitsuba-style scene dict (equivalent of mi.load_dict,
    /root/reference/USMain.py:257)."""
    return build_scene(desc)
