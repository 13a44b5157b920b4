"""Flat, device-resident scene representation (the "scene compiler" target).

The reference delegates scene storage to Mitsuba's C++ object graph
(mi.load_dict at /root/reference/USMain.py:257, XML scenes).  This
design instead compiles every scene into a frozen pytree of flat jnp arrays
(SoA) so the whole render is a single jit-compiled program over device-resident
tables — no host<->device crossings per bounce (contrast
/root/reference/CustomIntegrator.py:309 which crosses Python->C++ per ray).

Static configuration (resolutions, counts, enum types that drive control
flow) lives in non-pytree fields so jit re-traces only when the scene
*structure* changes, not its parameters — which keeps every float parameter
(BSDF params, transforms, radiance, ...) differentiable via jax.grad.
"""

from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp
import numpy as np

from tpu_rt.core import struct

# Shape type enums (analytic primitives)
SPHERE = 0
RECTANGLE = 1
DISK = 2
CYLINDER = 3
CONE = 4
CURVE = 5  # round-cone swept-sphere curve segment (an_param = [r0, r1])

# BSDF type enums
BSDF_DIFFUSE = 0
BSDF_DIELECTRIC = 1
BSDF_CONDUCTOR = 2
BSDF_ROUGH_CONDUCTOR = 3
BSDF_POLARIZER = 4
BSDF_ULTRASOUND = 5
BSDF_NULL = 6

# BSDF parameter layout (bsdf_params[:, 16]) by type:
#   DIFFUSE:         [0:3] reflectance rgb
#   DIELECTRIC:      [0] int_ior, [1] ext_ior, [3:6] specular_reflectance,
#                    [6:9] specular_transmittance
#   CONDUCTOR:       [0:3] eta rgb, [3:6] k rgb, [6:9] specular_reflectance
#   ROUGH_CONDUCTOR: [0:3] eta rgb, [3:6] k rgb, [6:9] specular_reflectance,
#                    [9] alpha
#   POLARIZER:       [0] theta (deg), [3:6] transmittance
#   ULTRASOUND:      [0] impedance (default 1.54), [1] roughness (default 0.5),
#                    [2] exterior medium impedance (1.2)
#                    (props per /root/reference/CustomBSDF.py:12-18,105)

# Emitter category enums (for the NEE selection table)
EM_AREA = 0
EM_POINT = 1
EM_ENVMAP = 2

# Reconstruction filter enums
FILTER_BOX = 0
FILTER_TENT = 1
FILTER_GAUSSIAN = 2

# Integrator kind enums
INTEGRATOR_PATH = 0
INTEGRATOR_DIRECT = 1
INTEGRATOR_STOKES = 2
INTEGRATOR_ULTRASOUND = 3
INTEGRATOR_DIRECT_PROJECTIVE = 4  # primal == direct (see integrator dispatch)


def _f32(x):
    return jnp.asarray(x, jnp.float32)


def _i32(x):
    return jnp.asarray(x, jnp.int32)


@struct.dataclass
class Geometry:
    """All primitives, flattened.  Prim ids: [0, n_tris) are triangles,
    [n_tris, n_tris + n_analytic) index the analytic tables."""

    # Triangles, pre-transformed to world space at build time.
    tri_p0: jnp.ndarray  # [T, 3]
    tri_e1: jnp.ndarray  # [T, 3] = p1 - p0
    tri_e2: jnp.ndarray  # [T, 3] = p2 - p0
    tri_n0: jnp.ndarray  # [T, 3] shading normals (geometric if none in file)
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_uv0: jnp.ndarray  # [T, 2]
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray
    tri_shape: jnp.ndarray  # [T] owning shape id

    # Analytic primitives.
    an_type: jnp.ndarray  # [A] SPHERE/RECTANGLE/...
    an_to_world: jnp.ndarray  # [A, 4, 4]
    an_to_object: jnp.ndarray  # [A, 4, 4]
    an_shape: jnp.ndarray  # [A] owning shape id

    # Flattened BVH over all prim ids (leaf ranges reference prim_order).
    bvh_min: jnp.ndarray  # [M, 3]
    bvh_max: jnp.ndarray  # [M, 3]
    bvh_a: jnp.ndarray  # [M] internal: left child; leaf: first offset into prim_order
    bvh_b: jnp.ndarray  # [M] internal: right child
    bvh_count: jnp.ndarray  # [M] 0 for internal, >0 leaf prim count
    prim_order: jnp.ndarray  # [T + A]

    # Per-prim scalar parameters ([A, 2]; CURVE: [r0, r1] in object units,
    # zeros for parameter-free types).  Optional for pytree compat.
    an_param: Optional[jnp.ndarray] = None

    n_tris: int = struct.field(pytree_node=False, default=0)
    n_analytic: int = struct.field(pytree_node=False, default=0)
    # Static set of analytic shape types present — lets the tracer skip
    # intersectors for absent types at compile time.
    analytic_types: tuple = struct.field(pytree_node=False, default=())


@struct.dataclass
class Emitters:
    """NEE-ready emitter tables.  Light units are selected uniformly
    (Mitsuba-style), then sampled within the unit."""

    # Area emitters: one entry per emissive shape.
    area_radiance: jnp.ndarray  # [Ea, 3]
    area_shape: jnp.ndarray  # [Ea] shape id
    area_total: jnp.ndarray  # [Ea] total surface area
    # Emissive triangles grouped by emitter (offsets index em_tri_*)
    em_offsets: jnp.ndarray  # [Ea + 1]
    em_tri_prim: jnp.ndarray  # [ET] global prim id
    em_tri_cdf: jnp.ndarray  # [ET] per-emitter normalized area CDF

    # Point lights.
    point_pos: jnp.ndarray  # [Ep, 3]
    point_intensity: jnp.ndarray  # [Ep, 3]

    # Environment map (lat-long); zero-size when absent.
    env_map: jnp.ndarray  # [H, W, 3]
    env_to_world: jnp.ndarray  # [4, 4]
    env_to_local: jnp.ndarray  # [4, 4]
    env_cdf_rows: jnp.ndarray  # [H] marginal CDF over rows (lum * sin(theta))
    env_cdf_cols: jnp.ndarray  # [H, W] conditional CDF within row
    env_scale: jnp.ndarray  # [] scalar radiance scale

    n_area: int = struct.field(pytree_node=False, default=0)
    n_point: int = struct.field(pytree_node=False, default=0)
    has_env: bool = struct.field(pytree_node=False, default=False)

    @property
    def n_lights(self) -> int:
        return self.n_area + self.n_point + (1 if self.has_env else 0)


@struct.dataclass
class Camera:
    to_world: jnp.ndarray  # [4, 4]
    tan_fov_x: jnp.ndarray  # [] tan(fov_x / 2)
    tan_fov_y: jnp.ndarray
    near: jnp.ndarray
    far: jnp.ndarray
    width: int = struct.field(pytree_node=False, default=256)
    height: int = struct.field(pytree_node=False, default=256)
    filter_type: int = struct.field(pytree_node=False, default=FILTER_BOX)
    filter_radius: float = struct.field(pytree_node=False, default=0.5)
    spp: int = struct.field(pytree_node=False, default=16)
    # hdrfilm pixel_format ("rgb" | "luminance" — the reference's US film
    # XMLs request luminance, /root/reference/USMain.py:62); develop-time
    # conversion, see integrator.render.
    pixel_format: str = struct.field(pytree_node=False, default="rgb")


@struct.dataclass
class UltrasoundConfig:
    """Transducer + acquisition configuration.

    Prop names and defaults mirror the reference exactly (API-compat
    requirement, SURVEY.md §5 config row):
      integrator props  /root/reference/CustomIntegrator.py:16-46
      sensor props      UltraSensor (pyc, SURVEY.md §2a#5)
      emitter props     /root/reference/CustomEmmitter.py:10-22
    """

    # Integrator props (CustomIntegrator.py:16-46)
    frequency: jnp.ndarray  # default 5e6
    sound_speed: jnp.ndarray  # 1540
    attenuation: jnp.ndarray  # 0.5 dB/(MHz cm)-style coefficient
    main_beam_angle: jnp.ndarray  # 10 deg
    cutoff_angle: jnp.ndarray  # 20 deg
    sampling_rate: jnp.ndarray  # fs, 50e6
    pitch: jnp.ndarray  # 0.00035 (differentiable, CustomIntegrator.py:409)
    angles: jnp.ndarray  # [n_angles] plane-wave steering angles, degrees

    # Sensor props (UltraSensor pyc)
    sensor_to_world: jnp.ndarray  # [4, 4]
    elements_width: jnp.ndarray  # 0.003
    elements_height: jnp.ndarray  # 0.01
    radius: jnp.ndarray  # inf => linear array
    directivity: jnp.ndarray  # 1.0

    max_depth: int = struct.field(pytree_node=False, default=2)
    wave_cycles: int = struct.field(pytree_node=False, default=5)
    n_elements: int = struct.field(pytree_node=False, default=128)
    time_samples: int = struct.field(pytree_node=False, default=3000)
    n_angles: int = struct.field(pytree_node=False, default=25)
    num_elements_lateral: int = struct.field(pytree_node=False, default=128)
    # Emitter props (CustomEmmitter.py:10-22)
    number_of_rays_per_element: int = struct.field(pytree_node=False, default=1)
    opening_angle: float = struct.field(pytree_node=False, default=0.0)
    steering_angle_min: float = struct.field(pytree_node=False, default=-10.0)
    steering_angle_max: float = struct.field(pytree_node=False, default=10.0)
    # Hard path-length cutoff (CustomIntegrator.py:141: geo_len < 0.2)
    max_path_length: float = struct.field(pytree_node=False, default=0.2)


@struct.dataclass
class Scene:
    geometry: Geometry
    emitters: Emitters

    # Per-shape tables (indexed by shape id).
    shape_bsdf: jnp.ndarray  # [N] bsdf index
    shape_emitter: jnp.ndarray  # [N] area-emitter index or -1
    shape_to_world: jnp.ndarray  # [N, 4, 4] original to_world (meshes are
    # baked to world space; this keeps the authored frame, e.g. for
    # polarizer transmission axes)

    # BSDF tables.
    bsdf_type: jnp.ndarray  # [B]
    bsdf_params: jnp.ndarray  # [B, 16]

    camera: Optional[Camera] = None
    ultrasound: Optional[UltrasoundConfig] = None

    # Bitmap textures bound to BSDF reflectance (the reference's consumed
    # Mitsuba `bitmap` texture capability; assets at
    # /root/reference/scenes/textures/).  One padded atlas + true sizes;
    # per-BSDF texture index (-1 = constant).  See bsdf/texture.py.
    tex_data: Optional[jnp.ndarray] = None  # [K, Hm, Wm, 3]
    tex_hw: Optional[jnp.ndarray] = None  # [K, 2] float32 (h, w)
    bsdf_tex: Optional[jnp.ndarray] = None  # [B] int32

    # Static set of BSDF type codes present — lets the SoA dispatch skip
    # absent lobes at trace time (bsdf/eval.py ``present`` argument).
    bsdf_types_present: tuple = struct.field(pytree_node=False, default=())
    # Static flag: any bitmap texture present (gates the per-lane texture
    # overlay at trace time).
    has_textures: bool = struct.field(pytree_node=False, default=False)
    integrator: int = struct.field(pytree_node=False, default=INTEGRATOR_PATH)
    max_depth: int = struct.field(pytree_node=False, default=-1)
    rr_depth: int = struct.field(pytree_node=False, default=5)
    hide_emitters: bool = struct.field(pytree_node=False, default=False)
    n_shapes: int = struct.field(pytree_node=False, default=0)
    # Original id -> index maps for mi.traverse()-style parameter access.
    ids: Any = struct.field(pytree_node=False, default=None)
