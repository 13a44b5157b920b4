"""Device-side scene intersection: brute-force, chunked and BVH routes.

JAX replacement for ``scene.ray_intersect``
(/root/reference/CustomIntegrator.py:146,159 -> Embree/OptiX; SURVEY.md §2b):
rays are SoA megabatches and all geometry lives in flat device tables.

Three routes, chosen statically at trace time from the prim count:
  * brute force over all prims at once (<= BRUTE_FORCE_MAX_PRIMS) — the
    small analytic scenes (cbox is 12 tris + 2 spheres);
  * a ``lax.scan`` over wide triangle chunks (<= CHUNKED_MAX_PRIMS);
  * BVH traversal, a vmapped per-ray ``while_loop`` — bunny-class meshes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_rt.core import struct
from tpu_rt.core.math import (
    normalize,
    transform_point,
    transform_vector,
    vec3,
)
from tpu_rt.geometry import intersect as isect
from tpu_rt.scene.types import (
    CONE,
    CURVE,
    CYLINDER,
    DISK,
    RECTANGLE,
    SPHERE,
    Geometry,
)

# Finite miss sentinel (see tpu_rt.geometry.intersect.INF): keeps jax.grad
# free of inf * 0 = NaN cotangents through the bounce loop.
INF = jnp.float32(1e8)
# Route thresholds (see the module docstring).  These values date from
# another accelerator and have not been re-swept on the GPU yet; ROADMAP S4
# re-sweeps them from a trace.
BRUTE_FORCE_MAX_PRIMS = 192
CHUNKED_MAX_PRIMS = 8192
CHUNK = 512
STACK_DEPTH = 48
RAY_EPS = 1e-4


@struct.dataclass
class Hit:
    t: jnp.ndarray  # [N]
    prim: jnp.ndarray  # [N] global prim id (-1 on miss)
    u: jnp.ndarray  # [N]
    v: jnp.ndarray  # [N]

    @property
    def valid(self):
        return self.prim >= 0


@struct.dataclass
class Interaction:
    """SoA SurfaceInteraction (equivalent of mi.SurfaceInteraction3f)."""

    valid: jnp.ndarray  # [N] bool
    t: jnp.ndarray  # [N]
    p: jnp.ndarray  # [N, 3]
    n: jnp.ndarray  # [N, 3] shading normal
    ng: jnp.ndarray  # [N, 3] geometric normal
    uv: jnp.ndarray  # [N, 2]
    wi: jnp.ndarray  # [N, 3] world-space direction toward the ray origin
    shape: jnp.ndarray  # [N] shape id (-1 on miss)
    prim: jnp.ndarray  # [N]

    def spawn_origin(self, direction):
        """Offset hit point along the geometric normal toward ``direction``
        (equivalent of si.spawn_ray origin handling)."""
        sign = jnp.sign(jnp.sum(self.ng * direction, axis=-1, keepdims=True))
        scale = jnp.maximum(1.0, jnp.abs(self.p).max(axis=-1, keepdims=True))
        return self.p + self.ng * sign * RAY_EPS * scale


# ---------------------------------------------------------------------------
# Per-prim intersection helpers
# ---------------------------------------------------------------------------

_INTERSECTORS = {
    SPHERE: isect.ray_sphere,
    RECTANGLE: isect.ray_rectangle,
    DISK: isect.ray_disk,
    CYLINDER: isect.ray_cylinder,
    CONE: isect.ray_cone,
}


def _analytic_sweep(geom: Geometry, atype, params, oo, od, tmin, tmax):
    """Evaluate only the intersectors for analytic types actually present
    (static dispatch via geom.analytic_types).  ``params`` broadcasts like
    ``atype`` with a trailing (2,) axis (CURVE r0/r1; unused otherwise)."""
    present = geom.analytic_types or tuple(_INTERSECTORS)
    t = jnp.full(jnp.broadcast_shapes(atype.shape, oo.shape[:-1]), INF)
    u = jnp.zeros_like(t)
    v = jnp.zeros_like(t)
    for code in present:
        if code == CURVE:
            t_i, u_i, v_i = isect.ray_roundcone(
                oo, od, params[..., 0], params[..., 1], tmin, tmax
            )
        else:
            t_i, u_i, v_i = _INTERSECTORS[code](oo, od, tmin, tmax)
        m = atype == code
        t = jnp.where(m, t_i, t)
        u = jnp.where(m, u_i, u)
        v = jnp.where(m, v_i, v)
    return t, u, v


def _an_params(geom: Geometry):
    if geom.an_param is not None:
        return geom.an_param
    return jnp.zeros((geom.n_analytic, 2), jnp.float32)


def _intersect_analytic(geom: Geometry, aid, o, d, tmin, tmax):
    """Intersect rays with analytic prim index ``aid`` (scalar or [N])."""
    m = geom.an_to_object[aid]
    oo = transform_point(m, o)
    od = transform_vector(m, d)  # NOT normalized: preserves the t parameter
    atype = geom.an_type[aid]
    return _analytic_sweep(geom, atype, _an_params(geom)[aid], oo, od,
                           tmin, tmax)


def _intersect_prim(geom: Geometry, pid, o, d, tmin, tmax):
    """Intersect rays with global prim id ``pid`` (broadcastable)."""
    T = geom.n_tris
    if T == 0:
        return _intersect_analytic(geom, pid - T, o, d, tmin, tmax)
    if geom.n_analytic == 0:
        tid = jnp.clip(pid, 0, T - 1)
        return isect.ray_triangle(
            o, d, geom.tri_p0[tid], geom.tri_e1[tid], geom.tri_e2[tid], tmin, tmax
        )
    is_tri = pid < T
    tid = jnp.clip(pid, 0, T - 1)
    aid = jnp.clip(pid - T, 0, geom.n_analytic - 1)
    t_t, u_t, v_t = isect.ray_triangle(
        o, d, geom.tri_p0[tid], geom.tri_e1[tid], geom.tri_e2[tid], tmin, tmax
    )
    t_a, u_a, v_a = _intersect_analytic(geom, aid, o, d, tmin, tmax)
    t = jnp.where(is_tri, t_t, t_a)
    u = jnp.where(is_tri, u_t, u_a)
    v = jnp.where(is_tri, v_t, v_a)
    return t, u, v


# ---------------------------------------------------------------------------
# Brute force
# ---------------------------------------------------------------------------

def _trace_bruteforce(geom: Geometry, o, d, tmin, tmax) -> Hit:
    """All-prims-at-once brute force: one wide (N, P) vectorized intersection
    + argmin, instead of a sequential loop, for the small analytic scenes
    (cbox is 12 tris + 2 spheres)."""
    # Keep the search range strictly below the finite miss sentinel so a
    # caller-provided tmax of +inf can't turn sentinel values into "hits".
    tmax = jnp.minimum(tmax, 0.99 * INF)
    shp = o.shape[:-1]
    o2 = o.reshape(-1, 1, 3)
    d2 = d.reshape(-1, 1, 3)
    tmin_b = jnp.broadcast_to(tmin, shp).reshape(-1, 1)
    tmax_b = jnp.broadcast_to(tmax, shp).reshape(-1, 1).astype(jnp.float32)

    ts, us, vs = [], [], []
    if geom.n_tris > 0:
        t, u, v = isect.ray_triangle(
            o2, d2,
            geom.tri_p0[None, :, :], geom.tri_e1[None, :, :], geom.tri_e2[None, :, :],
            tmin_b, tmax_b,
        )
        ts.append(t)
        us.append(u)
        vs.append(v)
    if geom.n_analytic > 0:
        rot = geom.an_to_object[:, :3, :3]  # [A, 3, 3]
        trans = geom.an_to_object[:, :3, 3]  # [A, 3]
        # full-f32 multiply-adds, not a dot: a default-precision f32 dot
        # may round ray geometry (see core.math.transform_point note)
        o_f = o.reshape(-1, 1, 1, 3)
        d_f = d.reshape(-1, 1, 1, 3)
        oo = jnp.sum(rot[None] * o_f, axis=-1) + trans[None]
        od = jnp.sum(rot[None] * d_f, axis=-1)
        t_a, u_a, v_a = _analytic_sweep(
            geom, geom.an_type[None, :], _an_params(geom)[None], oo, od,
            tmin_b, tmax_b
        )
        ts.append(t_a)
        us.append(u_a)
        vs.append(v_a)

    t_all = jnp.concatenate(ts, axis=1)  # [N, P]
    u_all = jnp.concatenate(us, axis=1)
    v_all = jnp.concatenate(vs, axis=1)
    best = jnp.argmin(t_all, axis=1)
    idx = best[:, None]
    best_t = jnp.take_along_axis(t_all, idx, axis=1)[:, 0]
    best_u = jnp.take_along_axis(u_all, idx, axis=1)[:, 0]
    best_v = jnp.take_along_axis(v_all, idx, axis=1)[:, 0]
    hit = best_t < tmax_b[:, 0]
    best_prim = jnp.where(hit, best.astype(jnp.int32), -1)
    return Hit(
        t=jnp.where(hit, best_t, INF).reshape(shp),
        prim=best_prim.reshape(shp),
        u=best_u.reshape(shp),
        v=best_v.reshape(shp),
    )


def _trace_chunked(geom: Geometry, o, d, tmin, tmax, chunk=CHUNK) -> Hit:
    """Triangles in lax.scan chunks of ``chunk`` wide component-form
    intersections (+ analytic prims in one wide sweep), carrying the
    running best hit.

    ``chunk`` may be lowered (or raised to T for a single no-padding scan
    step); on small scenes the vector-form _trace_bruteforce measured
    FASTER end-to-end despite more counted bytes, so the dispatch keeps it."""
    tmax = jnp.minimum(tmax, 0.99 * INF)
    shp = o.shape[:-1]
    o2 = o.reshape(-1, 1, 3)
    d2 = d.reshape(-1, 1, 3)
    n = o2.shape[0]
    tmin_b = jnp.broadcast_to(tmin, shp).reshape(-1, 1)
    tmax_b = jnp.broadcast_to(tmax, shp).reshape(-1, 1).astype(jnp.float32)

    best_t = tmax_b[:, 0]
    best_prim = jnp.full((n,), -1, jnp.int32)
    best_u = jnp.zeros((n,), jnp.float32)
    best_v = jnp.zeros((n,), jnp.float32)

    T = geom.n_tris
    if T > 0:
        CHUNK_ = min(chunk, max(T, 1))
        pad = (-T) % CHUNK_
        def padded(x):
            return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], 0)

        p0 = padded(geom.tri_p0).reshape(-1, CHUNK_, 3)
        e1 = padded(geom.tri_e1).reshape(-1, CHUNK_, 3)
        e2 = padded(geom.tri_e2).reshape(-1, CHUNK_, 3)
        n_chunks = p0.shape[0]

        ox, oy, oz = o.reshape(-1, 3).T
        dx, dy, dz = d.reshape(-1, 3).T
        ox, oy, oz = ox[:, None], oy[:, None], oz[:, None]
        dx, dy, dz = dx[:, None], dy[:, None], dz[:, None]

        def body(carry, inputs):
            bt, bp, bu, bv = carry
            cp0, ce1, ce2, base = inputs
            # Component-form Moller-Trumbore over (N, CHUNK): avoids
            # materializing (N, CHUNK, 3) temporaries (3x HBM traffic).
            e1x, e1y, e1z = ce1[None, :, 0], ce1[None, :, 1], ce1[None, :, 2]
            e2x, e2y, e2z = ce2[None, :, 0], ce2[None, :, 1], ce2[None, :, 2]
            p0x, p0y, p0z = cp0[None, :, 0], cp0[None, :, 1], cp0[None, :, 2]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv = 1.0 / jnp.where(
                jnp.abs(det) < 1e-9, jnp.where(det < 0, -1e-9, 1e-9), det
            )
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
            ok = (
                (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > tmin_b) & (t < bt[:, None])
            )
            t = jnp.where(ok, t, INF)
            ci = jnp.argmin(t, axis=1)
            idx = ci[:, None]
            t_c = jnp.take_along_axis(t, idx, axis=1)[:, 0]
            closer = t_c < bt
            pid = base + ci.astype(jnp.int32)
            return (
                jnp.where(closer, t_c, bt),
                jnp.where(closer & (pid < T), pid, jnp.where(closer, -1, bp)),
                jnp.where(closer, jnp.take_along_axis(u, idx, axis=1)[:, 0], bu),
                jnp.where(closer, jnp.take_along_axis(v, idx, axis=1)[:, 0], bv),
            ), None

        bases = jnp.arange(n_chunks, dtype=jnp.int32) * CHUNK_
        (best_t, best_prim, best_u, best_v), _ = jax.lax.scan(
            body, (best_t, best_prim, best_u, best_v), (p0, e1, e2, bases)
        )

    if geom.n_analytic > 0:
        rot = geom.an_to_object[:, :3, :3]
        trans = geom.an_to_object[:, :3, 3]
        o_f = o.reshape(-1, 1, 1, 3)
        d_f = d.reshape(-1, 1, 1, 3)
        oo = jnp.sum(rot[None] * o_f, axis=-1) + trans[None]
        od = jnp.sum(rot[None] * d_f, axis=-1)
        t_a, u_a, v_a = _analytic_sweep(
            geom, geom.an_type[None, :], _an_params(geom)[None], oo, od,
            tmin_b, best_t[:, None]
        )
        ai = jnp.argmin(t_a, axis=1)
        idx = ai[:, None]
        t_c = jnp.take_along_axis(t_a, idx, axis=1)[:, 0]
        closer = t_c < best_t
        best_prim = jnp.where(closer, T + ai.astype(jnp.int32), best_prim)
        best_t = jnp.where(closer, t_c, best_t)
        best_u = jnp.where(closer, jnp.take_along_axis(u_a, idx, axis=1)[:, 0], best_u)
        best_v = jnp.where(closer, jnp.take_along_axis(v_a, idx, axis=1)[:, 0], best_v)

    hit = best_prim >= 0
    return Hit(
        t=jnp.where(hit, best_t, INF).reshape(shp),
        prim=best_prim.reshape(shp),
        u=best_u.reshape(shp),
        v=best_v.reshape(shp),
    )


# ---------------------------------------------------------------------------
# BVH traversal (vmapped while_loop with short stack)
# ---------------------------------------------------------------------------

def _trace_bvh_one(geom: Geometry, o, d, tmin, tmax):
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)

    def leaf_intersect(first, count, best):
        best_t, best_prim, best_u, best_v = best
        for i in range(4):  # LEAF_SIZE static unroll
            pid = geom.prim_order[jnp.clip(first + i, 0, geom.prim_order.shape[0] - 1)]
            t, u, v = _intersect_prim(geom, pid, o, d, tmin, best_t)
            ok = (i < count) & (t < best_t)
            best_t = jnp.where(ok, t, best_t)
            best_prim = jnp.where(ok, pid, best_prim)
            best_u = jnp.where(ok, u, best_u)
            best_v = jnp.where(ok, v, best_v)
        return best_t, best_prim, best_u, best_v

    def cond(state):
        sp = state[1]
        return sp > 0

    def body(state):
        stack, sp, best = state
        node = stack[sp - 1]
        sp = sp - 1
        best_t = best[0]
        hit, _ = isect.ray_aabb(o, inv_d, geom.bvh_min[node], geom.bvh_max[node], tmin, best_t)
        count = geom.bvh_count[node]
        a = geom.bvh_a[node]
        b = geom.bvh_b[node]

        is_leaf = count > 0
        new_best = jax.lax.cond(
            hit & is_leaf, lambda bb: leaf_intersect(a, count, bb), lambda bb: bb, best
        )
        # Push children for internal nodes.
        push = hit & ~is_leaf
        stack = stack.at[sp].set(jnp.where(push, a, stack[sp]))
        stack = stack.at[sp + 1].set(jnp.where(push, b, stack[sp + 1]))
        sp = jnp.where(push, sp + 2, sp)
        return stack, sp, new_best

    stack0 = jnp.zeros((STACK_DEPTH,), jnp.int32)
    best0 = (
        jnp.asarray(tmax, jnp.float32),
        jnp.int32(-1),
        jnp.float32(0.0),
        jnp.float32(0.0),
    )
    _, _, best = jax.lax.while_loop(cond, body, (stack0, jnp.int32(1), best0))
    return best


def _trace_bvh(geom: Geometry, o, d, tmin, tmax) -> Hit:
    tmax = jnp.minimum(tmax, 0.99 * INF)  # see _trace_bruteforce
    tmin_b = jnp.broadcast_to(tmin, o.shape[:-1]).astype(jnp.float32)
    tmax_b = jnp.broadcast_to(tmax, o.shape[:-1]).astype(jnp.float32)
    t, prim, u, v = jax.vmap(lambda oo, dd, t0, t1: _trace_bvh_one(geom, oo, dd, t0, t1))(
        o.reshape(-1, 3), d.reshape(-1, 3), tmin_b.reshape(-1), tmax_b.reshape(-1)
    )
    shp = o.shape[:-1]
    return Hit(t=t.reshape(shp), prim=prim.reshape(shp), u=u.reshape(shp), v=v.reshape(shp))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def ray_intersect_hit(geom: Geometry, o, d, tmin=RAY_EPS, tmax=INF) -> Hit:
    P = geom.n_tris + geom.n_analytic
    if P <= BRUTE_FORCE_MAX_PRIMS:
        return _trace_bruteforce(geom, o, d, tmin, tmax)
    if P <= CHUNKED_MAX_PRIMS:
        return _trace_chunked(geom, o, d, tmin, tmax)
    return _trace_bvh(geom, o, d, tmin, tmax)


def ray_test(geom: Geometry, o, d, tmin=RAY_EPS, tmax=INF):
    """Shadow/visibility query: True where something is hit in (tmin, tmax)."""
    return ray_intersect_hit(geom, o, d, tmin, tmax).valid


def compute_interaction(scene, o, d, hit: Hit) -> Interaction:
    """Reconstruct the surface interaction from a Hit (two-phase design)."""
    geom: Geometry = scene.geometry
    T = geom.n_tris
    valid = hit.valid
    pid = jnp.maximum(hit.prim, 0)
    t = jnp.where(valid, hit.t, INF)
    p = o + jnp.where(valid, hit.t, 0.0)[..., None] * d

    if T > 0:
        tid = jnp.clip(pid, 0, T - 1)
        e1 = geom.tri_e1[tid]
        e2 = geom.tri_e2[tid]
        ng_t = normalize(jnp.cross(e1, e2))
        w = (1.0 - hit.u - hit.v)[..., None]
        ns_t = (
            w * geom.tri_n0[tid]
            + hit.u[..., None] * geom.tri_n1[tid]
            + hit.v[..., None] * geom.tri_n2[tid]
        )
        ns_len = jnp.sqrt(jnp.maximum(jnp.sum(ns_t * ns_t, -1, keepdims=True), 1e-24))
        ns_t = jnp.where(ns_len > 1e-6, ns_t / ns_len, ng_t)
        uv_t = (
            w * geom.tri_uv0[tid]
            + hit.u[..., None] * geom.tri_uv1[tid]
            + hit.v[..., None] * geom.tri_uv2[tid]
        )
        shape_t = geom.tri_shape[tid]
    if geom.n_analytic > 0:
        aid = jnp.clip(pid - T, 0, geom.n_analytic - 1)
        m_obj = geom.an_to_object[aid]
        p_obj = transform_point(m_obj, p)
        atype = geom.an_type[aid]
        # CURVE (round-cone swept sphere): the surface point is on the
        # sphere centered at the tangency parameter s* = (p_z + r0*dr)
        # / (1 - dr^2) clamped to [0, 1] (clamping lands on the endpoint
        # cap centers), so the normal is p - (0, 0, s*).
        par = _an_params(geom)[aid]
        crv_dr = par[..., 1] - par[..., 0]
        crv_s = jnp.clip(
            (p_obj[..., 2] + par[..., 0] * crv_dr)
            / jnp.maximum(1.0 - crv_dr * crv_dr, 1e-6),
            0.0, 1.0,
        )
        n_obj = jnp.where(
            (atype == SPHERE)[..., None],
            p_obj,
            jnp.where(
                (atype == CYLINDER)[..., None],
                vec3(p_obj[..., 0], p_obj[..., 1], jnp.zeros_like(p_obj[..., 2])),
                jnp.where(
                    (atype == CONE)[..., None],
                    vec3(p_obj[..., 0], p_obj[..., 1], 1.0 - p_obj[..., 2]),
                    jnp.where(
                        (atype == CURVE)[..., None],
                        vec3(p_obj[..., 0], p_obj[..., 1],
                             p_obj[..., 2] - crv_s),
                        vec3(
                            jnp.zeros_like(p_obj[..., 0]),
                            jnp.zeros_like(p_obj[..., 0]),
                            jnp.ones_like(p_obj[..., 0]),
                        ),
                    ),
                ),
            ),
        )
        # normals transform by (M_obj)^T (inverse-transpose of to_world)
        r3 = m_obj[..., :3, :3]
        ng_a = normalize(jnp.stack([
            r3[..., 0, 0] * n_obj[..., 0] + r3[..., 1, 0] * n_obj[..., 1]
            + r3[..., 2, 0] * n_obj[..., 2],
            r3[..., 0, 1] * n_obj[..., 0] + r3[..., 1, 1] * n_obj[..., 1]
            + r3[..., 2, 1] * n_obj[..., 2],
            r3[..., 0, 2] * n_obj[..., 0] + r3[..., 1, 2] * n_obj[..., 1]
            + r3[..., 2, 2] * n_obj[..., 2],
        ], axis=-1))
        # uv for spheres from spherical coords; others use intersector (u, v)
        p_obj_len = jnp.sqrt(jnp.maximum(jnp.sum(p_obj * p_obj, -1), 1e-24))
        theta = jnp.arccos(jnp.clip(p_obj[..., 2] / p_obj_len, -0.999999, 0.999999))
        phi = jnp.arctan2(p_obj[..., 1], p_obj[..., 0])
        uv_sph = jnp.stack([phi / (2.0 * jnp.pi) + 0.5, theta / jnp.pi], axis=-1)
        uv_a = jnp.where(
            (atype == SPHERE)[..., None], uv_sph, jnp.stack([hit.u, hit.v], axis=-1)
        )
        shape_a = geom.an_shape[aid]

    if T > 0 and geom.n_analytic > 0:
        is_tri = (pid < T)[..., None]
        ng = jnp.where(is_tri, ng_t, ng_a)
        ns = jnp.where(is_tri, ns_t, ng_a)
        uv = jnp.where(is_tri, uv_t, uv_a)
        shape = jnp.where(pid < T, shape_t, shape_a)
    elif T > 0:
        ng, ns, uv, shape = ng_t, ns_t, uv_t, shape_t
    else:
        ng, ns, uv, shape = ng_a, ng_a, uv_a, shape_a

    shape = jnp.where(valid, shape, -1)
    return Interaction(
        valid=valid,
        t=t,
        p=p,
        n=ns,
        ng=ng,
        uv=uv,
        wi=-d,
        shape=shape,
        prim=jnp.where(valid, hit.prim, -1),
    )


def ray_intersect(scene, o, d, tmin=RAY_EPS, tmax=INF) -> Interaction:
    hit = ray_intersect_hit(scene.geometry, o, d, tmin, tmax)
    return compute_interaction(scene, o, d, hit)
