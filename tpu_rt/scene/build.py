"""Scene compiler: Mitsuba-style description dict -> flat device Scene.

JAX replacement for mi.load_dict / mi.load_file
(/root/reference/USMain.py:257; SURVEY.md §2b scene-construction row).
All geometry is flattened to SoA jnp arrays; meshes are pre-transformed to
world space; a SAH BVH is built host-side; emitters are compiled into
NEE-ready sampling tables.
"""

from __future__ import annotations

import math as pymath
import os
import warnings

import jax.numpy as jnp
import numpy as np

from tpu_rt.core import math as m
from tpu_rt.geometry.bvh import build_bvh
from tpu_rt.scene import types as T
from tpu_rt.scene.obj import load_obj
from tpu_rt.scene.ply import load_ply
from tpu_rt.scene.transforms import ScalarTransform4f, as_matrix
from tpu_rt.scene.types import (
    Camera,
    Emitters,
    Geometry,
    Scene,
    UltrasoundConfig,
)

_SHAPE_TYPES = {
    "sphere", "rectangle", "disk", "cylinder", "cone", "obj", "ply",
    "bsplinecurve",
}
_BSDF_TYPES = {
    "diffuse", "dielectric", "conductor", "roughconductor", "polarizer",
    "ultrasound_bsdf", "null", "twosided",
}
_ANALYTIC_ENUM = {
    "sphere": T.SPHERE,
    "rectangle": T.RECTANGLE,
    "disk": T.DISK,
    "cylinder": T.CYLINDER,
    "cone": T.CONE,
}
_FILTERS = {"box": T.FILTER_BOX, "tent": T.FILTER_TENT, "gaussian": T.FILTER_GAUSSIAN}
_FILTER_RADII = {"box": 0.5, "tent": 1.0, "gaussian": 2.0}
_INTEGRATORS = {
    "path": T.INTEGRATOR_PATH,
    "direct": T.INTEGRATOR_DIRECT,
    "direct_projective": T.INTEGRATOR_DIRECT_PROJECTIVE,
    "stokes": T.INTEGRATOR_STOKES,
    "ultrasound_integrator": T.INTEGRATOR_ULTRASOUND,
}
_TRANSDUCER_EMITTERS = {"ultraray", "ultrasound_emitter"}

# Default IORs matching Mitsuba's dielectric plugin.
_IOR = {"bk7": 1.5046, "air": 1.000277, "water": 1.3330, "diamond": 2.419}


def _to_matrix(v):
    if isinstance(v, ScalarTransform4f):
        return v.matrix
    return as_matrix(v)


def _rgb(v, default):
    if v is None:
        v = default
    arr = np.asarray(v, np.float32).reshape(-1)
    if arr.size == 1:
        arr = np.repeat(arr, 3)
    return arr[:3]


class _Builder:
    def __init__(self):
        self.bsdf_rows = []  # (type, params[16])
        self.bsdf_index = {}  # id(dict) -> index
        self.bsdf_names = {}  # scene key -> index
        self.bsdf_tex = []  # per-bsdf texture index (-1 = constant)
        self.textures = []  # decoded float32 (H, W, 3) images
        self.texture_index = {}  # abs filename -> index
        self.shape_bsdf = []
        self.shape_emitter = []
        self.shape_to_world = []
        self.shape_names = {}
        self.tri = {k: [] for k in ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "shape")}
        # "param": per-prim (r0, r1) for CURVE, zeros otherwise; "bb": exact
        # world AABB override (None -> transformed [-1,1]^3 corners).
        self.an = {"type": [], "to_world": [], "shape": [], "param": [],
                   "bb": []}
        self.area_radiance = []
        self.area_shape = []
        self.emissive_tris = []  # (emitter_idx, list of (prim placeholder) tri indices)
        self.point_pos = []
        self.point_intensity = []
        self.env = None
        self.camera = None
        self.spp = 4
        self.integrator = T.INTEGRATOR_PATH
        self.max_depth = -1
        self.rr_depth = 5
        self.hide_emitters = False
        self.us_int = {}
        self.us_sensor = {}
        self.us_emitter = {}
        self.shape_tri_ranges = []  # per shape: (tri_start, tri_end) for emissive tables

    # -- BSDFs ---------------------------------------------------------------

    def add_bsdf(self, bd, name=None):
        if bd is None:
            bd = {"type": "diffuse", "reflectance": np.full(3, 0.5, np.float32)}
        key = id(bd)
        if key in self.bsdf_index:
            return self.bsdf_index[key]
        btype = bd.get("type")
        if btype == "twosided":
            inner = next(
                (v for v in bd.values() if isinstance(v, dict) and v.get("type") in _BSDF_TYPES),
                None,
            )
            idx = self.add_bsdf(inner, name)
            self.bsdf_index[key] = idx
            return idx
        p = np.zeros(16, np.float32)
        tex = -1
        if btype == "diffuse":
            code = T.BSDF_DIFFUSE
            refl = bd.get("reflectance")
            if isinstance(refl, dict) and refl.get("type") == "bitmap":
                # Bitmap reflectance texture (Mitsuba `bitmap` plugin
                # capability; reference assets scenes/textures/*.png).
                tex = self._add_texture(refl)
                # Constant fallback = texture mean (used only by paths that
                # are out of texture scope, e.g. the Stokes kernel — the
                # path/direct tracers read the texture per hit).
                p[0:3] = self.textures[tex].reshape(-1, 3).mean(0)
            else:
                p[0:3] = _rgb(refl, 0.5)
        elif btype == "dielectric":
            code = T.BSDF_DIELECTRIC
            int_ior = bd.get("int_ior", "bk7")
            ext_ior = bd.get("ext_ior", "air")
            p[0] = _IOR.get(int_ior, int_ior if isinstance(int_ior, (int, float)) else 1.5046)
            p[1] = _IOR.get(ext_ior, ext_ior if isinstance(ext_ior, (int, float)) else 1.000277)
            p[3:6] = _rgb(bd.get("specular_reflectance"), 1.0)
            p[6:9] = _rgb(bd.get("specular_transmittance"), 1.0)
        elif btype in ("conductor", "roughconductor"):
            code = T.BSDF_CONDUCTOR if btype == "conductor" else T.BSDF_ROUGH_CONDUCTOR
            if "eta" in bd:
                p[0:3] = _rgb(bd.get("eta"), 0.0)
                p[3:6] = _rgb(bd.get("k"), 1.0)
            else:
                p[0] = -1.0  # marker: perfect mirror (Mitsuba material="none")
            p[6:9] = _rgb(bd.get("specular_reflectance"), 1.0)
            p[9] = float(np.asarray(bd.get("alpha", 0.1)).reshape(-1)[0])
        elif btype == "polarizer":
            code = T.BSDF_POLARIZER
            p[0] = float(np.asarray(bd.get("theta", 0.0)).reshape(-1)[0])
            p[3:6] = _rgb(bd.get("transmittance"), 1.0)
        elif btype == "ultrasound_bsdf":
            code = T.BSDF_ULTRASOUND
            # defaults per /root/reference/CustomBSDF.py:12-18,105
            p[0] = float(bd.get("impedance", 1.54))
            p[1] = float(bd.get("roughness", 0.5))
            p[2] = float(bd.get("exterior_impedance", 1.2))
        elif btype == "null":
            code = T.BSDF_NULL
        else:
            raise ValueError(f"unsupported bsdf type {btype!r}")
        idx = len(self.bsdf_rows)
        self.bsdf_rows.append((code, p))
        self.bsdf_tex.append(tex)
        self.bsdf_index[key] = idx
        if name:
            self.bsdf_names[name] = idx
        if bd.get("id"):
            self.bsdf_names[bd["id"]] = idx
        return idx

    def _add_texture(self, td):
        """Decode + register a bitmap texture dict; returns its index.

        ``raw`` follows Mitsuba's bitmap default (false => sRGB decode to
        linear at load; the renderer works in linear radiometric units).
        """
        fn = td.get("filename")
        if not fn:
            raise ValueError("bitmap texture requires a filename")
        key = (os.path.abspath(fn), bool(td.get("raw", False)))
        if key in self.texture_index:
            return self.texture_index[key]
        ext = os.path.splitext(fn)[1].lower()
        srgb = not td.get("raw", False)
        if ext == ".png":
            from tpu_rt.scene.png import read_png

            img = read_png(fn, srgb=srgb)
        elif ext in (".jpg", ".jpeg"):
            from tpu_rt.scene.jpeg import read_jpeg

            img = read_jpeg(fn, srgb=srgb)
        elif ext == ".exr":
            from tpu_rt.scene.exr import load_exr_or_fallback

            img = load_exr_or_fallback(fn)  # EXR is already linear
        else:
            raise ValueError(f"unsupported texture format {ext!r} ({fn})")
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        elif img.shape[-1] == 2:  # gray + alpha -> gray rgb (alpha dropped)
            img = np.repeat(img[..., :1], 3, axis=-1)
        elif img.shape[-1] >= 4:
            img = img[..., :3]
        idx = len(self.textures)
        self.textures.append(np.ascontiguousarray(img, np.float32))
        self.texture_index[key] = idx
        return idx

    # -- Shapes --------------------------------------------------------------

    def _add_mesh(self, verts, faces, normals, uvs, to_world, shape_id):
        mw = np.asarray(to_world, np.float32)
        v_world = verts @ mw[:3, :3].T + mw[:3, 3]
        p0 = v_world[faces[:, 0]]
        p1 = v_world[faces[:, 1]]
        p2 = v_world[faces[:, 2]]
        if normals is not None:
            inv_t = np.linalg.inv(mw[:3, :3]).T
            n_world = normals @ inv_t.T
            ln = np.linalg.norm(n_world, axis=-1, keepdims=True)
            n_world = n_world / np.maximum(ln, 1e-12)
            n0, n1, n2 = n_world[faces[:, 0]], n_world[faces[:, 1]], n_world[faces[:, 2]]
        else:
            z = np.zeros_like(p0)
            n0 = n1 = n2 = z
        if uvs is not None:
            uv0, uv1, uv2 = uvs[faces[:, 0]], uvs[faces[:, 1]], uvs[faces[:, 2]]
        else:
            uv0 = uv1 = uv2 = np.zeros((faces.shape[0], 2), np.float32)
        start = len(self.tri["p0"]) and sum(x.shape[0] for x in self.tri["p0"]) or 0
        start = sum(x.shape[0] for x in self.tri["p0"])
        self.tri["p0"].append(p0.astype(np.float32))
        self.tri["e1"].append((p1 - p0).astype(np.float32))
        self.tri["e2"].append((p2 - p0).astype(np.float32))
        self.tri["n0"].append(n0.astype(np.float32))
        self.tri["n1"].append(n1.astype(np.float32))
        self.tri["n2"].append(n2.astype(np.float32))
        self.tri["uv0"].append(uv0.astype(np.float32))
        self.tri["uv1"].append(uv1.astype(np.float32))
        self.tri["uv2"].append(uv2.astype(np.float32))
        self.tri["shape"].append(np.full(faces.shape[0], shape_id, np.int32))
        return start, start + faces.shape[0]

    def add_shape(self, name, sd):
        stype = sd.get("type")
        shape_id = len(self.shape_bsdf)
        self.shape_names[name] = shape_id

        bsdf = next(
            (v for v in sd.values() if isinstance(v, dict) and v.get("type") in _BSDF_TYPES),
            None,
        )
        emitter = next(
            (
                v
                for v in sd.values()
                if isinstance(v, dict)
                and v.get("type") in ({"area"} | _TRANSDUCER_EMITTERS)
            ),
            None,
        )
        bsdf_idx = self.add_bsdf(bsdf)
        to_world = _to_matrix(sd.get("to_world"))

        emitter_idx = -1
        radiance = None
        if emitter is not None:
            if emitter["type"] == "area":
                radiance = _rgb(emitter.get("radiance"), 1.0)
            else:
                # Embedded transducer block (cbox.xml:64-84 'ultraray'): store
                # config; for light transport treat as an area light with its
                # intensity (SURVEY.md §2d — documented divergence).
                self.us_emitter = {k: v for k, v in emitter.items() if k != "type"}
                if "intensity" in emitter:
                    radiance = _rgb(emitter.get("intensity"), 1.0)
        if radiance is not None:
            emitter_idx = len(self.area_radiance)
            self.area_radiance.append(radiance)
            self.area_shape.append(shape_id)

        tri_range = (0, 0)
        if stype in ("obj", "ply"):
            mesh = (load_obj if stype == "obj" else load_ply)(sd["filename"])
            normals = None if sd.get("face_normals", False) else mesh["normals"]
            tri_range = self._add_mesh(
                mesh["vertices"], mesh["faces"], normals, mesh["uvs"], to_world, shape_id
            )
        elif stype == "bsplinecurve":
            import os as _os

            if _os.environ.get("TPU_RT_CURVE_MODE", "exact") == "mesh":
                # Legacy tube tessellation (round-2 representation), kept as
                # a debug/compare knob.
                from tpu_rt.scene.curves import tessellate_bspline_tube

                verts, faces, normals = tessellate_bspline_tube(sd["filename"])
                tri_range = self._add_mesh(verts, faces, normals, None,
                                           to_world, shape_id)
            else:
                # EXACT swept-sphere geometry (Mitsuba `bsplinecurve`
                # semantics, shadow_art.xml:60-62): the spline is flattened
                # to linear spans whose chord error is far below the tube
                # radius, and each span is a closed-form round-cone prim
                # (geometry/intersect.ray_roundcone) — no faceting, exact
                # normals, ~16x fewer prims than the 8-sided tube mesh.
                from tpu_rt.scene.curves import flatten_bspline

                pts = flatten_bspline(sd["filename"])
                M = np.asarray(to_world, np.float64)
                axn = [float(np.linalg.norm(M[:3, i])) for i in range(3)]
                s_uni = sum(axn) / 3.0
                if max(axn) - min(axn) > 1e-4 * max(s_uni, 1e-12):
                    raise NotImplementedError(
                        "bsplinecurve with non-uniform to_world scale"
                    )
                ctrs = pts[:, :3] @ M[:3, :3].T + M[:3, 3]
                radii = pts[:, 3] * s_uni
                for i in range(len(ctrs) - 1):
                    pa, pb = ctrs[i], ctrs[i + 1]
                    r0, r1 = float(radii[i]), float(radii[i + 1])
                    axis = pb - pa
                    h = float(np.linalg.norm(axis))
                    if h < 1e-9:
                        continue
                    if abs(r1 - r0) >= 0.99 * h:
                        # one end sphere (nearly) contains the other: the
                        # envelope formula degenerates (1 - dr^2 <= 0)
                        raise NotImplementedError(
                            "bsplinecurve radius varies faster than arc "
                            "length; refine samples_per_span"
                        )
                    frame = _frame_from_z(axis / h)
                    mseg = np.eye(4, dtype=np.float64)
                    mseg[:3, :3] = frame.astype(np.float64) * h
                    mseg[:3, 3] = pa
                    self.an["type"].append(T.CURVE)
                    self.an["to_world"].append(mseg.astype(np.float32))
                    self.an["shape"].append(shape_id)
                    # object units: the segment is normalized to length 1
                    self.an["param"].append((r0 / h, r1 / h))
                    lo = np.minimum(pa - r0, pb - r1).astype(np.float32) - 1e-6
                    hi = np.maximum(pa + r0, pb + r1).astype(np.float32) + 1e-6
                    self.an["bb"].append((lo, hi))
        elif stype in _ANALYTIC_ENUM:
            if stype == "sphere" and ("center" in sd or "radius" in sd):
                c = np.asarray(sd.get("center", (0.0, 0.0, 0.0)), np.float32)
                r = float(sd.get("radius", 1.0))
                to_world = to_world @ m.translate(c) @ m.scale(r)
            if stype == "cylinder" and ("p0" in sd or "p1" in sd or "radius" in sd):
                pa = np.asarray(sd.get("p0", (0, 0, 0)), np.float64)
                pb = np.asarray(sd.get("p1", (0, 0, 1)), np.float64)
                r = float(sd.get("radius", 1.0))
                axis = pb - pa
                h = np.linalg.norm(axis)
                frame = _frame_from_z(axis / max(h, 1e-12))
                mrot = np.eye(4, dtype=np.float32)
                mrot[:3, :3] = frame
                to_world = to_world @ m.translate(pa) @ mrot @ m.scale((r, r, h))
            if emitter_idx >= 0 and stype == "rectangle":
                # Emissive rectangles (shadow_art.xml:31-46) become 2 triangles
                # so NEE area sampling is uniform over the mesh tables.
                verts = np.array(
                    [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
                )
                faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
                tri_range = self._add_mesh(verts, faces, None, None, to_world, shape_id)
            elif emitter_idx >= 0 and stype != "rectangle":
                raise NotImplementedError(
                    f"area emitter on analytic shape {stype!r} not supported yet"
                )
            else:
                self.an["type"].append(_ANALYTIC_ENUM[stype])
                self.an["to_world"].append(to_world)
                self.an["shape"].append(shape_id)
                self.an["param"].append((0.0, 0.0))
                self.an["bb"].append(None)
        else:
            raise ValueError(f"unsupported shape type {stype!r}")

        self.shape_bsdf.append(bsdf_idx)
        self.shape_emitter.append(emitter_idx)
        self.shape_to_world.append(np.asarray(to_world, np.float32))
        self.shape_tri_ranges.append(tri_range)

    # -- Emitters (top level) --------------------------------------------------

    def add_emitter(self, name, ed):
        etype = ed.get("type")
        if etype == "point":
            pos = np.asarray(ed.get("position", (0.0, 0.0, 0.0)), np.float32)
            self.point_pos.append(pos)
            self.point_intensity.append(_rgb(ed.get("intensity"), 1.0))
        elif etype == "envmap":
            from tpu_rt.scene.exr import load_exr_or_fallback

            img = load_exr_or_fallback(ed["filename"])
            self.env = {
                "map": img * float(ed.get("scale", 1.0)),
                "to_world": _to_matrix(ed.get("to_world")),
            }
        elif etype == "constant":
            self.env = {
                "map": _rgb(ed.get("radiance"), 1.0).reshape(1, 1, 3),
                "to_world": np.eye(4, dtype=np.float32),
            }
        elif etype in _TRANSDUCER_EMITTERS:
            self.us_emitter = {k: v for k, v in ed.items() if k != "type"}
        else:
            raise ValueError(f"unsupported emitter type {etype!r}")

    # -- Sensors ----------------------------------------------------------------

    def add_sensor(self, sd):
        stype = sd.get("type")
        if stype == "perspective":
            film = sd.get("film", {})
            width = int(film.get("width", 768))
            height = int(film.get("height", 576))
            rfilter = film.get("rfilter", {})
            ftype = rfilter.get("type", "gaussian") if isinstance(rfilter, dict) else str(rfilter)
            sampler = sd.get("sampler", {})
            self.spp = int(sampler.get("sample_count", 4))
            fov = float(sd.get("fov", 34.0))
            fov_axis = sd.get("fov_axis", "x")
            aspect = width / height
            tan_half = pymath.tan(pymath.radians(fov) * 0.5)
            if fov_axis == "x" or (fov_axis == "smaller" and aspect <= 1.0) or (
                fov_axis == "larger" and aspect >= 1.0
            ):
                tan_x = tan_half
                tan_y = tan_half / aspect
            else:
                tan_y = tan_half
                tan_x = tan_half * aspect
            self.camera = Camera(
                to_world=jnp.asarray(_to_matrix(sd.get("to_world"))),
                tan_fov_x=jnp.float32(tan_x),
                tan_fov_y=jnp.float32(tan_y),
                near=jnp.float32(sd.get("near_clip", 1e-2)),
                far=jnp.float32(sd.get("far_clip", 1e4)),
                width=width,
                height=height,
                filter_type=_FILTERS.get(ftype, T.FILTER_GAUSSIAN),
                filter_radius=_FILTER_RADII.get(ftype, 2.0),
                spp=self.spp,
                pixel_format=str(film.get("pixel_format", "rgb")),
            )
        elif stype == "ultrasound_sensor":
            self.us_sensor = {k: v for k, v in sd.items() if k != "type"}
        else:
            raise ValueError(f"unsupported sensor type {stype!r}")

    def add_integrator(self, idict):
        itype = idict.get("type")
        if itype == "stokes":
            inner = next(
                (v for v in idict.values() if isinstance(v, dict) and "type" in v), None
            )
            self.integrator = T.INTEGRATOR_STOKES
            if inner:
                self.max_depth = int(inner.get("max_depth", -1))
                self.rr_depth = int(inner.get("rr_depth", 5))
                self.hide_emitters = bool(inner.get("hide_emitters", False))
            return
        if itype not in _INTEGRATORS:
            raise ValueError(f"unsupported integrator type {itype!r}")
        self.integrator = _INTEGRATORS[itype]
        if itype == "ultrasound_integrator":
            self.us_int = {k: v for k, v in idict.items() if k != "type"}
            self.max_depth = int(idict.get("max_depth", 2))
        elif itype in ("direct", "direct_projective"):
            # direct illumination == two path segments (Mitsuba semantics)
            self.max_depth = 2
            self.hide_emitters = bool(idict.get("hide_emitters", False))
        else:
            self.max_depth = int(idict.get("max_depth", -1))
            self.rr_depth = int(idict.get("rr_depth", 5))
            self.hide_emitters = bool(idict.get("hide_emitters", False))

    # -- Finalize ----------------------------------------------------------------

    def finalize(self) -> Scene:
        # Triangle pools.
        def cat(key, width):
            if self.tri[key]:
                return np.concatenate(self.tri[key], axis=0)
            return np.zeros((0, width) if width else (0,), np.float32 if width else np.int32)

        tri_p0 = cat("p0", 3)
        n_tris = tri_p0.shape[0]
        n_an = len(self.an["type"])

        an_to_world = (
            np.stack(self.an["to_world"]) if n_an else np.zeros((0, 4, 4), np.float32)
        )
        an_to_object = (
            np.stack([m.inverse(x) for x in self.an["to_world"]])
            if n_an
            else np.zeros((0, 4, 4), np.float32)
        )

        # Primitive bounds for the BVH.
        bbs = []
        if n_tris:
            p0 = tri_p0
            p1 = tri_p0 + cat("e1", 3)
            p2 = tri_p0 + cat("e2", 3)
            bb_min = np.minimum(np.minimum(p0, p1), p2) - 1e-6
            bb_max = np.maximum(np.maximum(p0, p1), p2) + 1e-6
            bbs.append((bb_min, bb_max))
        if n_an:
            # canonical bbox z-range differs per type; use [-1,1]^3 superset
            corners = np.array(
                [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32
            )
            pts = np.einsum("aij,cj->aci", an_to_world[:, :3, :3], corners) + an_to_world[
                :, None, :3, 3
            ]
            an_lo = pts.min(axis=1) - 1e-6
            an_hi = pts.max(axis=1) + 1e-6
            # exact world-AABB overrides (CURVE prims: union of the two
            # endpoint spheres — the [-1,1]^3 superset does NOT cover the
            # cap bulges at z in [-r0, 1+r1])
            for i, bb in enumerate(self.an["bb"]):
                if bb is not None:
                    an_lo[i], an_hi[i] = bb
            bbs.append((an_lo, an_hi))
        if bbs:
            bb_min = np.concatenate([b[0] for b in bbs], axis=0)
            bb_max = np.concatenate([b[1] for b in bbs], axis=0)
        else:
            bb_min = np.zeros((0, 3), np.float32)
            bb_max = np.zeros((0, 3), np.float32)
        bvh = build_bvh(bb_min, bb_max)

        geometry = Geometry(
            tri_p0=jnp.asarray(tri_p0),
            tri_e1=jnp.asarray(cat("e1", 3)),
            tri_e2=jnp.asarray(cat("e2", 3)),
            tri_n0=jnp.asarray(cat("n0", 3)),
            tri_n1=jnp.asarray(cat("n1", 3)),
            tri_n2=jnp.asarray(cat("n2", 3)),
            tri_uv0=jnp.asarray(cat("uv0", 2)),
            tri_uv1=jnp.asarray(cat("uv1", 2)),
            tri_uv2=jnp.asarray(cat("uv2", 2)),
            tri_shape=jnp.asarray(cat("shape", 0)),
            an_type=jnp.asarray(np.asarray(self.an["type"], np.int32)),
            an_to_world=jnp.asarray(an_to_world),
            an_to_object=jnp.asarray(an_to_object),
            an_shape=jnp.asarray(np.asarray(self.an["shape"], np.int32)),
            an_param=jnp.asarray(
                np.asarray(self.an["param"], np.float32).reshape(n_an, 2)
            ),
            bvh_min=jnp.asarray(bvh["node_min"]),
            bvh_max=jnp.asarray(bvh["node_max"]),
            bvh_a=jnp.asarray(bvh["a"]),
            bvh_b=jnp.asarray(bvh["b"]),
            bvh_count=jnp.asarray(bvh["count"]),
            prim_order=jnp.asarray(bvh["prim_order"]),
            n_tris=n_tris,
            n_analytic=n_an,
            analytic_types=tuple(sorted(set(int(t) for t in self.an["type"]))),
        )

        emitters = self._build_emitters(tri_p0, cat("e1", 3), cat("e2", 3))

        us = self._build_ultrasound() if (self.us_int or self.us_sensor or self.us_emitter) else None

        bsdf_type = np.asarray([r[0] for r in self.bsdf_rows], np.int32)
        bsdf_params = (
            np.stack([r[1] for r in self.bsdf_rows])
            if self.bsdf_rows
            else np.zeros((0, 16), np.float32)
        )

        # Padded texture atlas (bsdf/texture.py conventions).
        tex_data = tex_hw = bsdf_tex = None
        has_textures = bool(self.textures)
        if has_textures:
            hm = max(t.shape[0] for t in self.textures)
            wm = max(t.shape[1] for t in self.textures)
            atlas = np.zeros((len(self.textures), hm, wm, 3), np.float32)
            hw = np.zeros((len(self.textures), 2), np.float32)
            for i, t in enumerate(self.textures):
                atlas[i, : t.shape[0], : t.shape[1]] = t
                hw[i] = (t.shape[0], t.shape[1])
            tex_data = jnp.asarray(atlas)
            tex_hw = jnp.asarray(hw)
            bsdf_tex = jnp.asarray(np.asarray(self.bsdf_tex, np.int32))

        return Scene(
            geometry=geometry,
            emitters=emitters,
            tex_data=tex_data,
            tex_hw=tex_hw,
            bsdf_tex=bsdf_tex,
            has_textures=has_textures,
            shape_bsdf=jnp.asarray(np.asarray(self.shape_bsdf, np.int32)),
            shape_emitter=jnp.asarray(np.asarray(self.shape_emitter, np.int32)),
            shape_to_world=jnp.asarray(
                np.stack(self.shape_to_world)
                if self.shape_to_world
                else np.zeros((0, 4, 4), np.float32)
            ),
            bsdf_type=jnp.asarray(bsdf_type),
            bsdf_types_present=tuple(sorted(set(int(t) for t in bsdf_type))),
            bsdf_params=jnp.asarray(bsdf_params),
            camera=self.camera,
            ultrasound=us,
            integrator=self.integrator,
            max_depth=self.max_depth,
            rr_depth=self.rr_depth,
            hide_emitters=self.hide_emitters,
            n_shapes=len(self.shape_bsdf),
            ids={
                "shapes": dict(self.shape_names),
                "bsdfs": dict(self.bsdf_names),
                "shape_bsdf": list(self.shape_bsdf),
            },
        )

    def _build_emitters(self, tri_p0, tri_e1, tri_e2) -> Emitters:
        n_area = len(self.area_radiance)
        em_offsets = [0]
        em_tri_prim = []
        em_tri_cdf = []
        area_total = []
        for e in range(n_area):
            shape_id = self.area_shape[e]
            lo, hi = self.shape_tri_ranges[shape_id]
            prims = np.arange(lo, hi, dtype=np.int32)
            areas = 0.5 * np.linalg.norm(
                np.cross(tri_e1[lo:hi], tri_e2[lo:hi]), axis=-1
            )
            total = float(areas.sum())
            cdf = np.cumsum(areas) / max(total, 1e-20)
            em_tri_prim.append(prims)
            em_tri_cdf.append(cdf.astype(np.float32))
            em_offsets.append(em_offsets[-1] + prims.size)
            area_total.append(total)

        env = self.env
        has_env = env is not None
        if has_env:
            env_map = np.asarray(env["map"], np.float32)
            if env_map.ndim == 2:
                env_map = np.repeat(env_map[..., None], 3, axis=-1)
            env_to_world = env["to_world"]
        else:
            env_map = np.zeros((1, 1, 3), np.float32)
            env_to_world = np.eye(4, dtype=np.float32)
        H, W = env_map.shape[:2]
        lum = env_map @ np.array([0.212671, 0.715160, 0.072169], np.float32)
        sin_theta = np.sin((np.arange(H) + 0.5) / H * np.pi).astype(np.float32)
        w = lum * sin_theta[:, None] + 1e-12
        row_w = w.sum(axis=1)
        cdf_rows = np.cumsum(row_w) / row_w.sum()
        cdf_cols = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)

        return Emitters(
            area_radiance=jnp.asarray(
                np.stack(self.area_radiance) if n_area else np.zeros((0, 3), np.float32)
            ),
            area_shape=jnp.asarray(np.asarray(self.area_shape, np.int32)),
            area_total=jnp.asarray(np.asarray(area_total, np.float32)),
            em_offsets=jnp.asarray(np.asarray(em_offsets, np.int32)),
            em_tri_prim=jnp.asarray(
                np.concatenate(em_tri_prim) if em_tri_prim else np.zeros(0, np.int32)
            ),
            em_tri_cdf=jnp.asarray(
                np.concatenate(em_tri_cdf) if em_tri_cdf else np.zeros(0, np.float32)
            ),
            point_pos=jnp.asarray(
                np.stack(self.point_pos) if self.point_pos else np.zeros((0, 3), np.float32)
            ),
            point_intensity=jnp.asarray(
                np.stack(self.point_intensity)
                if self.point_intensity
                else np.zeros((0, 3), np.float32)
            ),
            env_map=jnp.asarray(env_map),
            env_to_world=jnp.asarray(env_to_world),
            env_to_local=jnp.asarray(m.inverse(env_to_world)),
            env_cdf_rows=jnp.asarray(cdf_rows.astype(np.float32)),
            env_cdf_cols=jnp.asarray(cdf_cols.astype(np.float32)),
            env_scale=jnp.float32(1.0),
            n_area=n_area,
            n_point=len(self.point_pos),
            has_env=has_env,
        )

    def _build_ultrasound(self) -> UltrasoundConfig:
        ii, ss, ee = self.us_int, self.us_sensor, self.us_emitter
        angles = np.asarray(ii.get("angles", np.linspace(-30, 30, 25)), np.float32)
        radius = ss.get("radius", float("inf"))
        if isinstance(radius, str):
            radius = float(radius)
        return UltrasoundConfig(
            frequency=jnp.float32(ii.get("frequency", 5e6)),
            sound_speed=jnp.float32(ii.get("sound_speed", 1540.0)),
            attenuation=jnp.float32(ii.get("attenuation", 0.5)),
            main_beam_angle=jnp.float32(ii.get("main_beam_angle", 10.0)),
            cutoff_angle=jnp.float32(ii.get("cutoff_angle", 20.0)),
            sampling_rate=jnp.float32(ii.get("sampling_rate", 50e6)),
            pitch=jnp.float32(ii.get("pitch", 0.00035)),
            angles=jnp.asarray(angles),
            sensor_to_world=jnp.asarray(_to_matrix(ss.get("to_world"))),
            elements_width=jnp.float32(ss.get("elements_width", ee.get("element_width", 0.003))),
            elements_height=jnp.float32(
                ss.get("elements_height", ee.get("element_height", 0.01))
            ),
            radius=jnp.float32(radius),
            directivity=jnp.float32(ss.get("directivity", 1.0)),
            max_depth=int(ii.get("max_depth", 2)),
            wave_cycles=int(ii.get("wave_cycles", 5)),
            n_elements=int(ii.get("n_elements", 128)),
            time_samples=int(ii.get("time_samples", 3000)),
            n_angles=int(angles.shape[0]),
            num_elements_lateral=int(ss.get("num_elements_lateral", 128)),
            number_of_rays_per_element=int(ee.get("number_of_rays_per_element", 1)),
            opening_angle=float(ee.get("opening_angle", 0.0)),
            steering_angle_min=float(ee.get("steering_angle_min", -10.0)),
            steering_angle_max=float(ee.get("steering_angle_max", 10.0)),
        )


def _frame_from_z(z):
    z = np.asarray(z, np.float64)
    a = np.array([0.0, 1.0, 0.0]) if abs(z[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    x = np.cross(a, z)
    x /= max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32)


_SENSOR_TYPES = {"perspective", "ultrasound_sensor"}
_INTEGRATOR_KEYS = set(_INTEGRATORS) | {"stokes"}
_EMITTER_TYPES = {"point", "envmap", "constant"} | _TRANSDUCER_EMITTERS


def build_scene(desc: dict) -> Scene:
    if desc.get("type") != "scene":
        raise ValueError("scene description must have type 'scene'")
    b = _Builder()
    for key, val in desc.items():
        if key == "type" or not isinstance(val, dict):
            continue
        vtype = val.get("type")
        if vtype in _INTEGRATOR_KEYS:
            b.add_integrator(val)
        elif vtype in _SENSOR_TYPES:
            b.add_sensor(val)
        elif vtype in _SHAPE_TYPES:
            b.add_shape(key, val)
        elif vtype in _EMITTER_TYPES:
            b.add_emitter(key, val)
        elif vtype in _BSDF_TYPES:
            b.add_bsdf(val, name=key)
        elif vtype == "ref":
            raise KeyError(f"unresolved ref at scene key {key!r}")
        else:
            raise ValueError(
                f"unsupported scene entry {key!r} (type={vtype!r})"
            )
    return b.finalize()
