"""Mitsuba XML scene parser -> plugin-description dict.

JAX replacement for Mitsuba's pugixml scene loader (SURVEY.md §2b):
handles scene versions 2.0.0 / 2.1.0 / 3.0.0 as exercised by the reference
scenes, ``<default name=.. value=..>`` declarations with ``$var``
substitution and command-line-style overrides
(/root/reference/scenes/cbox.xml:2-9, shadow_art.xml:3 "-Darg=value"),
nested transforms (translate/rotate/scale/lookat/matrix), rgb/spectrum/
point/vector/float_array values, top-level named bsdfs + ``<ref id>``.

Output format is the Mitsuba dict format (same schema as
/root/reference/USMain.py:26-90), consumed by tpu_rt.scene.build.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from tpu_rt.core import math as m

_VAR_RE = re.compile(r"\$(\w+)")


def _substitute(value: str, defaults: dict) -> str:
    def repl(match):
        name = match.group(1)
        if name not in defaults:
            raise KeyError(f"undefined scene parameter ${name}")
        return str(defaults[name])

    return _VAR_RE.sub(repl, value)


def _parse_floats(s: str):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _parse_rgb(s: str):
    vals = _parse_floats(s)
    if len(vals) == 1:
        vals = vals * 3
    return np.asarray(vals[:3], np.float32)


def _xyz_attrs(el, defaults, default=0.0):
    def get(name):
        v = el.get(name)
        return float(_substitute(v, defaults)) if v is not None else default

    if el.get("value") is not None:
        vals = _parse_floats(_substitute(el.get("value"), defaults))
        if len(vals) == 1:
            vals = vals * 3
        return np.asarray(vals[:3], np.float64)
    return np.asarray([get("x"), get("y"), get("z")], np.float64)


def _parse_transform(el, defaults) -> np.ndarray:
    """Sequential ops compose Mitsuba-style: the FIRST listed child is applied
    first to object-space points (ctx.transform = op * ctx.transform)."""
    mat = np.eye(4, dtype=np.float32)
    for child in el:
        tag = child.tag
        if tag == "translate":
            op = m.translate(_xyz_attrs(child, defaults, 0.0))
        elif tag == "scale":
            if child.get("value") is not None:
                vals = _parse_floats(_substitute(child.get("value"), defaults))
                op = m.scale(vals[0] if len(vals) == 1 else vals[:3])
            else:
                v = _xyz_attrs(child, defaults, 1.0)
                op = m.scale(v)
        elif tag == "rotate":
            axis = _xyz_attrs(child, defaults, 0.0)
            angle = float(_substitute(child.get("angle", "0"), defaults))
            op = m.rotate(axis, angle)
        elif tag == "lookat":
            origin = _parse_floats(_substitute(child.get("origin"), defaults))
            target = _parse_floats(_substitute(child.get("target"), defaults))
            up = _parse_floats(_substitute(child.get("up", "0,1,0"), defaults))
            op = m.look_at(origin, target, up)
        elif tag == "matrix":
            vals = _parse_floats(_substitute(child.get("value"), defaults))
            op = np.asarray(vals, np.float32).reshape(4, 4)
        else:
            raise ValueError(f"unknown transform op <{tag}>")
        mat = op @ mat
    return mat


_PLUGIN_TAGS = {
    "integrator", "sensor", "emitter", "bsdf", "shape", "film", "sampler",
    "rfilter", "texture", "medium", "phase", "volume",
}
_UNNAMED_COUNTER_KEY = "__anon"


def _parse_plugin(el, defaults, named, base_dir):
    out = {"type": _substitute(el.get("type", ""), defaults)}
    if el.get("id"):
        out["id"] = el.get("id")
    anon = 0
    for child in el:
        tag = child.tag
        name = child.get("name")
        if tag in _PLUGIN_TAGS:
            sub = _parse_plugin(child, defaults, named, base_dir)
            if tag == "bsdf" and el.tag == "scene":
                pass  # handled by caller
            key = name or child.get("id") or tag
            if key in out:  # e.g. two nested emitters — disambiguate
                anon += 1
                key = f"{key}_{anon}"
            out[key] = sub
            if child.get("id"):
                named[child.get("id")] = sub
        elif tag == "ref":
            rid = child.get("id")
            out[name or f"ref_{anon}"] = {"type": "ref", "id": rid}
            anon += 1
        elif tag == "transform":
            out[name or "to_world"] = _parse_transform(child, defaults)
        elif tag in ("float", "integer", "boolean", "string", "spectrum", "rgb",
                     "point", "vector", "float_array"):
            raw = child.get("value")
            if raw is not None:
                raw = _substitute(raw, defaults)
            if tag == "float":
                out[name] = float(raw)
            elif tag == "integer":
                out[name] = int(float(raw))
            elif tag == "boolean":
                out[name] = raw.strip().lower() == "true"
            elif tag == "string":
                if name == "filename":
                    raw = os.path.join(base_dir, raw)
                out[name] = raw
            elif tag == "rgb":
                out[name] = _parse_rgb(raw)
            elif tag == "spectrum":
                # Uniform spectra only (reference uses single values,
                # e.g. cbox_pol.xml:35-36); wavelength lists unsupported.
                vals = _parse_floats(raw)
                out[name] = np.asarray(vals * 3 if len(vals) == 1 else vals[:3], np.float32)
            elif tag == "point" or tag == "vector":
                out[name] = _xyz_attrs(child, defaults)
            elif tag == "float_array":
                out[name] = np.asarray(_parse_floats(raw), np.float32)
        elif tag == "default":
            pass
        else:
            raise ValueError(f"unknown element <{tag}> under <{el.tag}>")
    return out


def load_xml(path, overrides=None):
    """Parse a Mitsuba XML scene file into the Mitsuba dict format.

    ``overrides`` maps parameter names to values, equivalent to Mitsuba's
    command line -Dname=value (shadow_art.xml:3)."""
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "scene":
        raise ValueError(f"{path}: root element must be <scene>")
    version = root.get("version", "3.0.0")
    if version.split(".")[0] not in ("2", "3"):
        raise ValueError(f"{path}: unsupported scene version {version}")
    base_dir = os.path.dirname(os.path.abspath(path))

    defaults = {}
    for child in root:
        if child.tag == "default":
            defaults[child.get("name")] = child.get("value")
    if overrides:
        defaults.update({k: str(v) for k, v in overrides.items()})

    named = {}
    scene = {"type": "scene"}
    counters = {}
    for child in root:
        if child.tag == "default":
            continue
        key = child.get("id")
        if not key:
            counters[child.tag] = counters.get(child.tag, 0) + 1
            key = f"{child.tag}_{counters[child.tag]}"
        obj = _parse_plugin(child, defaults, named, base_dir)
        if child.get("id"):
            named[child.get("id")] = obj
        scene[key] = obj

    _resolve_refs(scene, named)
    return scene


def _resolve_refs(obj, named, depth=0):
    if depth > 32 or not isinstance(obj, dict):
        return
    for k, v in list(obj.items()):
        if isinstance(v, dict):
            if v.get("type") == "ref":
                rid = v["id"]
                if rid not in named:
                    raise KeyError(f"unresolved <ref id={rid!r}>")
                obj[k] = named[rid]
            else:
                _resolve_refs(v, named, depth + 1)
