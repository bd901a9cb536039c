"""Scene tables as padded structure-of-arrays torch tensors.

Counterpart of ``pathtracer_tpu/scene/schema.py`` for the fields the port
reads: materials, spheres, quads (with the baked unit normal ``quad_n``),
planes and the always-empty box table, plus the static counts and flags.
The numpy :class:`WorldBuilder` pads exactly as the JAX builder does
(materials to a multiple of 128, primitives to 16), so a port scene and a
converted JAX scene hold the same tables (``scene/convert.py``).

A sphere table of more than ``clusters.CLUSTER_MIN`` rows is also kept in
cluster order (``csph_*``, padded to a multiple of 128, as in JAX) with its
cluster descriptors: the static tuple ``sph_clusters`` and, for the
kernel, the small ``cl_*`` tables (offset, count, bounds, huge flag) that
:func:`cluster_tables` derives from it.

Conventions kept from the reference: material 0 is the sky and a miss
reports material 0; ``spheres[0]`` is the light the next-event estimator
aims at.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.vec import Vec3
from . import clusters

# Reference constants (win32_main.cpp:86-95).
MAX_BOUNCE_COUNT = 4
MIN_HIT_DISTANCE = 1e-4
QUAD_MIN_HIT_DISTANCE = 0.02  # Cornell-box hack, win32_main.cpp:446
TOLERANCE = 1e-9
WORLD_SIZE = 5.0
LEVELS = 6
N_AIR = 1.003
LIGHT_KIND_DIRECTIONAL = 0
LIGHT_KIND_POINT = 1
LIGHT_KIND_TRIANGLE = 2
FIXED_FOCAL_LENGTH = 0.098
MIN_ROUGHNESS = 0.01
F32_MAX = float(np.finfo(np.float32).max)

WORLD_DEFAULT = 0
WORLD_BRDF_TEST = 1
WORLD_CORNELL_BOX = 2
WORLD_RAYTRACING_ONE_WEEKEND = 3
WORLD_MARIO = 4
WORLD_CORNELL_QUAD = 5
WORLD_MESH_UV = 6
WORLD_KIND_COUNT = 7


def _pad(n: int, multiple: int = 16) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


# Field groups, in one place for Scene.to, the converter and the tests.
VEC_FIELDS = (
    "mat_albedo", "mat_emit", "mat_metal_color",
    "sph_center", "quad_point", "quad_u", "quad_v", "quad_n",
    "pln_n", "box_min", "box_max", "csph_center",
)
TENSOR_FIELDS = (
    "mat_metalness", "mat_roughness", "mat_ior", "mat_transmission",
    "mat_dispersion", "mat_alpha", "mat_albedo_idx", "mat_bump_idx",
    "mat_bump_scale", "mat_metalness_idx", "mat_roughness_idx",
    "mat_normal_idx",
    "sph_radius", "sph_mat", "sph_mask",
    "quad_mat", "quad_mask",
    "pln_d", "pln_mat", "pln_mask",
    "box_mat", "box_mask",
    "csph_radius", "csph_mat",
)
STATIC_FIELDS = (
    "n_spheres", "n_quads", "n_planes", "n_tris", "n_boxes", "n_materials",
    "n_textures", "quad_light", "just_cosine", "any_transmissive",
    "any_dispersive", "any_bump", "has_mesh_uvs", "fog_sigma_t",
    "sph_clusters",
)
# Kernel tables derived from ``sph_clusters`` (cluster_tables).
CLUSTER_VEC_FIELDS = ("cl_min", "cl_max")
CLUSTER_TENSOR_FIELDS = ("cl_offset", "cl_count", "cl_huge")


@dataclasses.dataclass(frozen=True, eq=False)
class Scene:
    """All scene data the slice reads. Float tables are float32, index
    tables int32, masks bool; every tensor is contiguous and on one device.
    """

    mat_albedo: Vec3
    mat_emit: Vec3
    mat_metal_color: Vec3
    mat_metalness: torch.Tensor
    mat_roughness: torch.Tensor
    mat_ior: torch.Tensor
    mat_transmission: torch.Tensor
    mat_dispersion: torch.Tensor
    mat_alpha: torch.Tensor
    mat_albedo_idx: torch.Tensor
    mat_bump_idx: torch.Tensor
    mat_bump_scale: torch.Tensor
    mat_metalness_idx: torch.Tensor
    mat_roughness_idx: torch.Tensor
    mat_normal_idx: torch.Tensor

    sph_center: Vec3
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    sph_mask: torch.Tensor

    quad_point: Vec3
    quad_u: Vec3
    quad_v: Vec3
    quad_n: Vec3            # normalize(cross(u, v), eps=1e-30), baked
    quad_mat: torch.Tensor
    quad_mask: torch.Tensor

    pln_n: Vec3
    pln_d: torch.Tensor
    pln_mat: torch.Tensor
    pln_mask: torch.Tensor

    box_min: Vec3
    box_max: Vec3
    box_mat: torch.Tensor
    box_mask: torch.Tensor

    # spheres in cluster order (size-1 dummies without clusters)
    csph_center: Vec3
    csph_radius: torch.Tensor
    csph_mat: torch.Tensor
    # per cluster: first row, row count, bounds, 1 = huge (always tested)
    cl_offset: torch.Tensor
    cl_count: torch.Tensor
    cl_min: Vec3
    cl_max: Vec3
    cl_huge: torch.Tensor

    n_spheres: int = 0
    n_quads: int = 0
    n_planes: int = 0
    n_tris: int = 0
    n_boxes: int = 0
    n_materials: int = 0
    n_textures: int = 0
    quad_light: int = -1    # NEE quad index, -1 = spheres[0]
    just_cosine: bool = False
    any_transmissive: bool = False
    any_dispersive: bool = False
    any_bump: bool = False
    has_mesh_uvs: bool = False
    fog_sigma_t: float = 0.0
    # (offset, count, mn3 | None, mx3 | None) over csph_*; huge first
    sph_clusters: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.mat_roughness.device

    def to(self, device) -> "Scene":
        """The same scene with every table on ``device``."""
        moved = {k: Vec3(*(c.to(device).contiguous() for c in getattr(self, k)))
                 for k in VEC_FIELDS + CLUSTER_VEC_FIELDS}
        moved.update({k: getattr(self, k).to(device).contiguous()
                      for k in TENSOR_FIELDS + CLUSTER_TENSOR_FIELDS})
        return dataclasses.replace(self, **moved)

    def without_clusters(self) -> "Scene":
        """The same scene with its sphere clusters dropped: the brute sweep
        over ``sph_*`` (the yardstick the clustered walk is measured
        against)."""
        return dataclasses.replace(self, sph_clusters=(),
                                   **cluster_tables(())).to(self.device)

    def unsupported(self) -> list:
        """Names of the features this scene uses that the port has not yet
        ported (empty when the slice covers it)."""
        out = []
        if self.n_textures:
            out.append("textures (ROADMAP queue 1 item 9)")
        if self.n_tris:
            out.append("triangle meshes (ROADMAP queue 1 item 10)")
        if self.any_transmissive or self.any_dispersive:
            out.append("transmission/dispersion (ROADMAP queue 1 item 11)")
        if self.any_bump:
            out.append("bump maps (ROADMAP queue 1 item 11)")
        if self.fog_sigma_t > 0.0:
            out.append("fog (ROADMAP queue 1 item 11)")
        if self.has_mesh_uvs:
            out.append("mesh UVs (ROADMAP queue 1 item 10)")
        if self.n_boxes:
            out.append("boxes (never populated by the reference worlds)")
        return out


@dataclasses.dataclass
class HostMaterial:
    """Host-side material with material_t's defaults (ray.hpp:63-78)."""
    alpha: float = 1.0
    albedo: tuple = (0.0, 0.0, 0.0)
    emit: tuple = (0.0, 0.0, 0.0)
    metal_color: tuple = (0.0, 0.0, 0.0)
    metalness: float = 0.0
    roughness: float = 1.0
    ior: float = 1.0
    transmission: float = 0.0
    dispersion: float = 0.0
    albedo_idx: int = 0
    metalness_idx: int = 0
    roughness_idx: int = 0
    normal_idx: int = 0
    bump_idx: int = 0
    bump_scale: float = 1.0


def _vec_columns(a: np.ndarray) -> Vec3:
    """An (N, 3) array -> a Vec3 of contiguous (N,) tensors."""
    return Vec3(*(torch.from_numpy(a[:, k].copy()) for k in range(3)))


def _vec_table(rows, pad_to: int) -> Vec3:
    a = np.zeros((pad_to, 3), np.float32)
    if rows:
        a[: len(rows)] = np.asarray(rows, np.float32)
    return _vec_columns(a)


def _scalar_table(rows, pad_to: int, dtype=np.float32, fill=0):
    a = np.full((pad_to,), fill, dtype)
    if len(rows):
        a[: len(rows)] = np.asarray(rows, dtype)
    return torch.from_numpy(a)


def cluster_tables(sph_clusters: tuple) -> dict:
    """The kernel's cluster tables (CPU tensors, at least one row) for the
    static descriptors; a huge cluster has no bounds and is always tested."""
    rows = sph_clusters or ((0, 0, None, None),)
    box = lambda b: (0.0, 0.0, 0.0) if b is None else b
    return dict(
        cl_offset=torch.tensor([c[0] for c in rows], dtype=torch.int32),
        cl_count=torch.tensor([c[1] for c in rows], dtype=torch.int32),
        cl_min=_vec_columns(np.asarray([box(c[2]) for c in rows], np.float32)),
        cl_max=_vec_columns(np.asarray([box(c[3]) for c in rows], np.float32)),
        cl_huge=torch.tensor([int(c[2] is None) for c in rows],
                             dtype=torch.int32),
    )


def _mask_table(n: int, pad_to: int):
    m = np.zeros((pad_to,), bool)
    m[:n] = True
    return torch.from_numpy(m)


def bake_quad_normals(u: Vec3, v: Vec3) -> Vec3:
    """normalize(cross(u, v), eps=1e-30) in float32, one IEEE rounding per
    operation, as the JAX builder evaluates it op by op."""
    f = lambda t: t.numpy()
    ux, uy, uz, vx, vy, vz = map(f, (*u, *v))
    cx = uy * vz - vy * uz
    cy = uz * vx - vz * ux
    cz = ux * vy - vx * uy
    m = np.sqrt(cx * cx + cy * cy + cz * cz)
    inv = np.float32(1.0) / np.maximum(m, np.float32(1e-30))
    return Vec3(*(torch.from_numpy(c * inv) for c in (cx, cy, cz)))


class WorldBuilder:
    """Host-side scene assembly for spheres, quads and planes."""

    def __init__(self):
        self.materials: list[HostMaterial] = []
        self.spheres: list[tuple] = []      # (center, radius, mat)
        self.quads: list[tuple] = []        # (point, u, v, mat)
        self.planes: list[tuple] = []       # (n, d, mat)
        self.quad_light: int = -1

    def add_material(self, **kw) -> int:
        self.materials.append(HostMaterial(**kw))
        return len(self.materials) - 1

    def add_sphere(self, center, radius, mat) -> int:
        self.spheres.append((tuple(center), float(radius), int(mat)))
        return len(self.spheres) - 1

    def add_quad(self, point, u, v, mat) -> int:
        self.quads.append((tuple(point), tuple(u), tuple(v), int(mat)))
        return len(self.quads) - 1

    def set_quad_light(self, idx: int):
        """Mark quad ``idx`` as the NEE target (default -1: spheres[0])."""
        if not (0 <= idx < len(self.quads)):
            raise ValueError(f"quad light index {idx} out of range")
        self.quad_light = idx

    def add_plane(self, n, d, mat) -> int:
        self.planes.append((tuple(n), float(d), int(mat)))
        return len(self.planes) - 1

    def _sphere_clusters(self, view_origin):
        """(csph center, radius, mat, clusters) as in the JAX builder: the
        spheres in cluster order, padded to a multiple of 128."""
        f32, i32 = np.float32, np.int32
        if len(self.spheres) <= clusters.CLUSTER_MIN:
            return (np.zeros((1, 3), f32), np.zeros((1,), f32),
                    np.zeros((1,), i32), ())
        centers = np.asarray([s[0] for s in self.spheres], f32)
        radii = np.asarray([s[1] for s in self.spheres], f32)
        order, sph_clusters = clusters.build_clusters(
            *clusters.sphere_bounds(centers, radii), sort_origin=view_origin)
        pad = -len(order) % 128
        c = np.concatenate([centers[order], np.zeros((pad, 3), f32)])
        r = np.concatenate([radii[order], np.zeros((pad,), f32)])
        m = np.concatenate([np.asarray([s[2] for s in self.spheres], i32)[order],
                            np.zeros((pad,), i32)])
        return c, r, m, sph_clusters

    def finalize(self, world_kind: int = WORLD_DEFAULT,
                 view_origin=None) -> Scene:
        """Host lists -> padded CPU Scene (``Scene.to`` moves it).
        ``view_origin`` (the camera position) orders sphere clusters
        near-to-far."""
        mats = self.materials
        M = _pad(len(mats), 128)
        S, Q, P = _pad(len(self.spheres)), _pad(len(self.quads)), _pad(len(self.planes))
        i32 = np.int32
        col = lambda name: [getattr(m, name) for m in mats]
        quad_u = _vec_table([q[1] for q in self.quads], Q)
        quad_v = _vec_table([q[2] for q in self.quads], Q)
        csph_c, csph_r, csph_m, sph_clusters = self._sphere_clusters(view_origin)
        return Scene(
            mat_albedo=_vec_table(col("albedo"), M),
            mat_emit=_vec_table(col("emit"), M),
            mat_metal_color=_vec_table(col("metal_color"), M),
            mat_metalness=_scalar_table(col("metalness"), M),
            mat_roughness=_scalar_table(col("roughness"), M, fill=1),
            mat_ior=_scalar_table(col("ior"), M, fill=1),
            mat_transmission=_scalar_table(col("transmission"), M),
            mat_dispersion=_scalar_table(col("dispersion"), M),
            mat_alpha=_scalar_table(col("alpha"), M, fill=1),
            mat_albedo_idx=_scalar_table(col("albedo_idx"), M, i32),
            mat_bump_idx=_scalar_table(col("bump_idx"), M, i32),
            mat_bump_scale=_scalar_table(col("bump_scale"), M, fill=1),
            mat_metalness_idx=_scalar_table(col("metalness_idx"), M, i32),
            mat_roughness_idx=_scalar_table(col("roughness_idx"), M, i32),
            mat_normal_idx=_scalar_table(col("normal_idx"), M, i32),
            sph_center=_vec_table([s[0] for s in self.spheres], S),
            sph_radius=_scalar_table([s[1] for s in self.spheres], S),
            sph_mat=_scalar_table([s[2] for s in self.spheres], S, i32),
            sph_mask=_mask_table(len(self.spheres), S),
            quad_point=_vec_table([q[0] for q in self.quads], Q),
            quad_u=quad_u,
            quad_v=quad_v,
            quad_n=bake_quad_normals(quad_u, quad_v),
            quad_mat=_scalar_table([q[3] for q in self.quads], Q, i32),
            quad_mask=_mask_table(len(self.quads), Q),
            pln_n=_vec_table([p[0] for p in self.planes], P),
            pln_d=_scalar_table([p[1] for p in self.planes], P),
            pln_mat=_scalar_table([p[2] for p in self.planes], P, i32),
            pln_mask=_mask_table(len(self.planes), P),
            box_min=_vec_table([], 8),
            box_max=_vec_table([], 8),
            box_mat=_scalar_table([], 8, i32),
            box_mask=_mask_table(0, 8),
            csph_center=_vec_columns(csph_c),
            csph_radius=torch.from_numpy(csph_r),
            csph_mat=torch.from_numpy(csph_m),
            **cluster_tables(sph_clusters),
            sph_clusters=sph_clusters,
            n_spheres=len(self.spheres),
            n_quads=len(self.quads),
            n_planes=len(self.planes),
            n_materials=len(mats),
            quad_light=self.quad_light,
            just_cosine=(world_kind == WORLD_RAYTRACING_ONE_WEEKEND),
            any_transmissive=any(m.transmission > 0.0 for m in mats),
            any_dispersive=any(m.transmission > 0.0 and m.dispersion > 0.0
                               for m in mats),
            any_bump=any(m.bump_idx != 0 for m in mats),
        )
