"""Native (C++) runtime components, compiled on demand and loaded via ctypes.

The reference's heavy host-side machinery was C++ inside Mitsuba/Dr.Jit
(SURVEY.md §2b); here the scene-compile hot spots (BVH construction) are
native too, with a pure-numpy fallback when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _build_library():
    src = os.path.join(_THIS_DIR, "bvh_builder.cpp")
    build_dir = os.path.join(_THIS_DIR, "_build")
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir, "libbvh_builder.so")
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src):
        return so_path
    cmd = [
        "g++", "-O3", "-fPIC", "-shared", "-std=c++17",
        src, "-o", so_path,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return so_path


def get_library():
    """Returns the loaded ctypes library or None (no toolchain / build
    failure — callers fall back to numpy implementations)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = _build_library()
        lib = ctypes.CDLL(path)
        lib.tpu_rt_build_bvh.restype = ctypes.c_int
        lib.tpu_rt_build_bvh.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def build_bvh_native(bb_min, bb_max):
    """C++ binned-SAH BVH build; returns same dict as
    tpu_rt.geometry.bvh.build_bvh or None when the native library is
    unavailable."""
    import numpy as np

    lib = get_library()
    if lib is None:
        return None
    n = int(bb_min.shape[0])
    if n == 0:
        return None
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    max_nodes = 2 * n + 2
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_a = np.empty(max_nodes, np.int32)
    node_b = np.empty(max_nodes, np.int32)
    node_count = np.empty(max_nodes, np.int32)
    prim_order = np.empty(n, np.int32)
    n_nodes = lib.tpu_rt_build_bvh(
        bb_min.ctypes.data, bb_max.ctypes.data, n,
        node_min.ctypes.data, node_max.ctypes.data,
        node_a.ctypes.data, node_b.ctypes.data, node_count.ctypes.data,
        prim_order.ctypes.data, max_nodes,
    )
    if n_nodes <= 0:
        return None
    return {
        "node_min": node_min[:n_nodes].copy(),
        "node_max": node_max[:n_nodes].copy(),
        "a": node_a[:n_nodes].copy(),
        "b": node_b[:n_nodes].copy(),
        "count": node_count[:n_nodes].copy(),
        "prim_order": prim_order,
    }
