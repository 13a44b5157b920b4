"""EXR reader tests incl. the PIZ (wavelet+Huffman) decoder on the
reference's textures (envmap.exr is the polarizers.xml emitter)."""

import os

import numpy as np
import pytest

from tpu_rt.scene import SCENE_DIR
from tpu_rt.scene.exr import load_exr


@pytest.mark.parametrize(
    "name,shape",
    [
        ("envmap.exr", (256, 512, 3)),
        ("envmap2.exr", (256, 512, 3)),
        ("multi_channels.exr", (256, 256, 3)),
    ],
)
def test_piz_textures_decode(name, shape):
    img = load_exr(os.path.join(SCENE_DIR, "textures", name))
    assert img.shape == shape
    assert np.isfinite(img).all()
    assert (img >= 0).all()
    assert img.max() > 0.5
    # natural images are smooth: adjacent-row correlation is high; a broken
    # wavelet/Huffman decode produces noise with near-zero correlation
    corr = np.corrcoef(img[:-1].ravel(), img[1:].ravel())[0, 1]
    assert corr > 0.8, f"decoded image is not smooth (corr={corr:.3f})"


def test_polarizers_scene_gets_real_envmap(ref_scenes):
    import os
    import warnings

    import tpu_rt

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no fallback warning anymore
        s = tpu_rt.load_file(os.path.join(ref_scenes, "polarizers.xml"))
    assert s.emitters.env_map.shape == (256, 512, 3)
    assert float(s.emitters.env_map.max()) > 5.0  # HDR sun present
