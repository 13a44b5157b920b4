"""Host-side BVH construction (numpy, binned SAH).

JAX replacement for the Embree/OptiX BVHs the reference consumes via
scene.ray_intersect (/root/reference/CustomIntegrator.py:146,159 — SURVEY.md
§2b).  The build runs once on host at scene-compile time; the flat node
arrays live in HBM and are traversed on device (tpu_rt.geometry.trace).

Node layout (see tpu_rt.scene.types.Geometry): internal nodes store child
indices in (a, b) with count == 0; leaves store (first, _, count) indexing
the ``prim_order`` permutation.
"""

from __future__ import annotations

import numpy as np

LEAF_SIZE = 4
N_BINS = 16


def build_bvh(bb_min, bb_max, use_native=True):
    """Build a SAH-binned BVH over primitive AABBs.

    Prefers the native C++ builder (tpu_rt.ops.native, ~100x faster on large
    meshes) and falls back to the numpy implementation below.

    Args:
      bb_min, bb_max: [P, 3] float32 primitive bounds.
    Returns:
      dict with node_min [M,3], node_max [M,3], a [M], b [M], count [M],
      prim_order [P] (int32).
    """
    P = bb_min.shape[0]
    if use_native and P > 0:
        from tpu_rt.ops.native import build_bvh_native

        result = build_bvh_native(np.asarray(bb_min), np.asarray(bb_max))
        if result is not None:
            return result
    if P == 0:
        return {
            "node_min": np.zeros((1, 3), np.float32),
            "node_max": np.zeros((1, 3), np.float32),
            "a": np.zeros(1, np.int32),
            "b": np.zeros(1, np.int32),
            "count": np.zeros(1, np.int32),
            "prim_order": np.zeros(0, np.int32),
        }
    centroid = 0.5 * (bb_min + bb_max)
    order = np.arange(P, dtype=np.int32)

    node_min, node_max, node_a, node_b, node_count = [], [], [], [], []

    def alloc():
        node_min.append(None)
        node_max.append(None)
        node_a.append(0)
        node_b.append(0)
        node_count.append(0)
        return len(node_min) - 1

    root = alloc()
    stack = [(root, 0, P)]  # (node index, start, end) over `order`
    while stack:
        ni, s, e = stack.pop()
        idx = order[s:e]
        nmin = bb_min[idx].min(axis=0)
        nmax = bb_max[idx].max(axis=0)
        node_min[ni] = nmin
        node_max[ni] = nmax
        n = e - s
        if n <= LEAF_SIZE:
            node_a[ni], node_count[ni] = s, n
            continue

        c = centroid[idx]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:  # all centroids coincide -> leaf
            node_a[ni], node_count[ni] = s, n
            continue

        # Binned SAH along the widest axis.
        rel = (c[:, axis] - cmin[axis]) / extent[axis]
        bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
        counts = np.bincount(bins, minlength=N_BINS)
        bmin = np.full((N_BINS, 3), np.inf, np.float32)
        bmax = np.full((N_BINS, 3), -np.inf, np.float32)
        for k in range(3):
            np.minimum.at(bmin[:, k], bins, bb_min[idx, k])
            np.maximum.at(bmax[:, k], bins, bb_max[idx, k])

        # prefix/suffix areas
        def grow_area(mins, maxs, counts_):
            cum_min = np.minimum.accumulate(mins, axis=0)
            cum_max = np.maximum.accumulate(maxs, axis=0)
            d = np.maximum(cum_max - cum_min, 0.0)
            area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
            return area, np.cumsum(counts_)

        area_l, cnt_l = grow_area(bmin, bmax, counts)
        area_r_rev, cnt_r_rev = grow_area(bmin[::-1], bmax[::-1], counts[::-1])
        area_r = area_r_rev[::-1]
        cnt_r = cnt_r_rev[::-1]

        # split after bin k: left = bins [0..k], right = [k+1..]
        cost = area_l[:-1] * cnt_l[:-1] + area_r[1:] * cnt_r[1:]
        cost = np.where((cnt_l[:-1] == 0) | (cnt_r[1:] == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if not np.isfinite(cost[k]):  # degenerate, median split
            mid = s + n // 2
            part = np.argsort(c[:, axis], kind="stable").astype(np.int32)
            order[s:e] = idx[part]
        else:
            left_mask = bins <= k
            order[s:e] = np.concatenate([idx[left_mask], idx[~left_mask]])
            mid = s + int(left_mask.sum())
        if mid == s or mid == e:
            mid = s + n // 2

        li, ri = alloc(), alloc()
        node_a[ni], node_b[ni], node_count[ni] = li, ri, 0
        # Push larger child first so the smaller is processed next (locality).
        stack.append((li, s, mid))
        stack.append((ri, mid, e))

    return {
        "node_min": np.asarray(node_min, np.float32),
        "node_max": np.asarray(node_max, np.float32),
        "a": np.asarray(node_a, np.int32),
        "b": np.asarray(node_b, np.int32),
        "count": np.asarray(node_count, np.int32),
        "prim_order": order,
    }
