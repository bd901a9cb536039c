"""Scene tables as padded structure-of-arrays torch tensors.

Counterpart of ``pathtracer_tpu/scene/schema.py`` for the fields the port
reads: materials, spheres, quads (with the baked unit normal ``quad_n``),
planes, the always-empty box table and the combined texture set, plus the
static counts and flags.
The numpy :class:`WorldBuilder` pads exactly as the JAX builder does
(materials to a multiple of 128, primitives to 16), so a port scene and a
converted JAX scene hold the same tables (``scene/convert.py``).

A sphere table of more than ``clusters.CLUSTER_MIN`` rows is also kept in
cluster order (``csph_*``, padded to a multiple of 128, as in JAX) with its
cluster descriptors: the static tuple ``sph_clusters`` and, for the
kernel, the small ``cl_*`` tables (offset, count, bounds, huge flag) that
:func:`cluster_tables` derives from it. The kernel walks the spheres outside
the huge cluster through a BVH over them (``sbvh_nodes``/``sbvh_sph``/
``sbvh_idx``, :func:`sphere_bvh_tables`).

Textures: the reference's canonical 4-map set (four equal-size maps, every
material's indices all 0 or exactly (1, 2, 3, 4): world 1) packs into two
int32 words per texel, A = albedo.rgb | metalness << 24 and B = normal.rgb
| roughness << 24, kept flat (``tex_comb_a/b``) and tiled (``tex_tile``:
one 128-word row per 8x8-texel tile, A and B of a texel in adjacent words
at ``((y & 7) * 8 + (x & 7)) * 2``). A square power-of-two set also gets
its mip pyramid, level 0 first, described by the static ``tex_mip_meta``
rows ``(row_off, tiles_x, word_off, w, h)`` and, for the kernel, the int32
table ``tex_mip`` (:func:`mip_table`). Any other texture set is kept as the
flat RGB8 stack ``tex_packed`` with per-layer sizes (:func:`texture_stack`),
read by mesh-UV albedo maps (``tex_mesh_only``: every textured material is
a triangle albedo binding) and by planar maps at the hit's world xy
(``Scene.planar_maps``: albedo, metalness, roughness, normal and bump).
The kernel's fetches of such a set (K10's planar and texel forms, K11's
bump heights) read the same texels from ``planar_tile``
(:func:`planar_tables`): each layer at its own size in 8x8-texel tiles,
with ``planar_meta``'s offsets, sizes and the wraps' reciprocals
(:func:`planar_recip`).

A mesh inside the world volume may also carry the reference's uniform
grid (``grid_cell_start``/``grid_cell_count``/``grid_tris``, ``grid_res``;
``scene/accel.py``). Such a scene, a mesh above ``clusters.DMA_MAX``
triangles (kept without clusters), a UV mesh beside a combined set and a
bump map on a combined set (which then keeps its flat stack) are the
scenes JAX renders on XLA only (``Scene.off_kernel``); the port renders
them as torch ops.

Fog is the static ``fog_sigma_t`` (0: none), ``fog_albedo`` and ``fog_g``
(``WorldBuilder.set_fog``). A scene with fog, transmission, bump or planar
maps or a brute-force mesh takes the feature path (``Scene.featured``),
whatever its spheres, texture set or mesh tier.

A triangle mesh (``set_mesh``; UVs scaled to texel units there) is kept as
``tri_*`` tables and swept brute force up to ``clusters.CLUSTER_MIN``
triangles (K4t), which the kernel walks through a BVH over the
triangles' precomputed records instead (``bvh_*``, :func:`bvh_tables`: a
brute mesh has no tier of its own to fill them). A larger one is also kept in cluster order in the precomputed
barycentric form (``ctri_*``, padded to a multiple of 128, as in JAX); up
to ``clusters.STREAM_MIN`` triangles that is the static tier, with its
cluster descriptors ``tri_clusters`` and ``tcl_box`` / ``tcl_range``
(:func:`tri_cluster_tables`, read by the plain version's table-order
walk); the kernel walks it through a BVH over the triangles outside the
huge cluster (:func:`bvh_tables`). Above ``clusters.STREAM_MIN``
triangles the mesh takes the streamed tier instead (``ctri_*`` then hold
JAX's zero dummies): ``mtri_bounds``, ``mtri_pack``, ``mtri_uvpack`` (the
uv rows, cluster-field-major, or parallel to the record rows where the
largest cluster exceeds 128 triangles: ``stream_uv_cfm`` False) with
the static parent descriptors ``stream_parents`` and, for the kernel,
``stream_pbox``/``stream_prange`` (:func:`parent_tables`). Above
``clusters.STREAM_MAX`` triangles (``STREAM_MAX // 2`` with UVs) it is the
DMA tier (``tri_dma``): with at least ``clusters.GPARENT_MIN`` parents the
parents are regrouped under the grandparents ``stream_gparents``
(``stream_gbox``/``stream_grange``), as JAX's finalize regroups them. The
kernel walks either tier through a BVH over the record rows
(``bvh_nodes``/``bvh_tris``/``bvh_tri_k``, :func:`bvh_tables`).

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
from . import textures as textures_mod

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
    "tri_a", "tri_u", "tri_v", "ctri_n", "ctri_e1", "ctri_e2",
)
TRI_UV_FIELDS = ("tri_uv0u", "tri_uv0v", "tri_uvdu1", "tri_uvdv1",
                 "tri_uvdu2", "tri_uvdv2")
CTRI_UV_FIELDS = ("ctri_uv0u", "ctri_uv0v", "ctri_uvdu1", "ctri_uvdv1",
                  "ctri_uvdu2", "ctri_uvdv2")
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
    "tri_mat", *TRI_UV_FIELDS, "ctri_d", "ctri_a0", "ctri_b0", "ctri_mat",
    *CTRI_UV_FIELDS, "mtri_bounds", "mtri_pack", "mtri_uvpack",
    "tex_tile", "tex_comb_a", "tex_comb_b",
    "tex_packed", "tex_w", "tex_h",
    "grid_cell_start", "grid_cell_count", "grid_tris",
)
STATIC_FIELDS = (
    "n_spheres", "n_quads", "n_planes", "n_tris", "n_boxes", "n_materials",
    "n_textures", "quad_light", "just_cosine", "any_transmissive",
    "any_dispersive", "any_bump", "has_mesh_uvs", "fog_sigma_t",
    "fog_albedo", "fog_g", "sph_clusters", "tri_clusters",
    "tri_streamed", "tri_dma", "stream_uv_cfm", "stream_leaf",
    "n_stream_clusters", "stream_parents", "stream_gparents",
    "stream_row_cull", "bvh_root", "bvh_depth", "sbvh_root", "sbvh_depth",
    "bvh_far", "bvh_wide", "sbvh_far", "bvh_apart",
    "tex_combined", "tex_comb_w", "tex_comb_h", "tex_tiles_x",
    "tex_mip_meta", "tex_hmax", "tex_wmax", "tex_mesh_only",
    "tex_stack_tiled",
    "use_normal_maps", "use_metalness_maps",
    "use_roughness_maps", "tbn_normal_maps", "grid_res",
)
# Kernel tables derived from statics (cluster_tables, mip_table,
# parent_tables, tri_cluster_tables) and, for the card's BVHs, from the
# record rows (bvh_tables) and the cluster-ordered spheres
# (sphere_bvh_tables); their roots and depths are statics.
DERIVED_VEC_FIELDS = ("cl_min", "cl_max")
DERIVED_TENSOR_FIELDS = ("cl_offset", "cl_count", "cl_huge", "tex_mip",
                         "stream_pbox", "stream_prange", "stream_gbox",
                         "stream_grange", "tcl_box", "tcl_range",
                         "bvh_nodes", "bvh_tris", "bvh_tri_k",
                         "sbvh_nodes", "sbvh_sph", "sbvh_idx",
                         "planar_tile", "planar_meta", "quad_rec")


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
    # the card's walk of the sphere clusters (sphere_bvh_tables): binary
    # nodes over the spheres outside the huge cluster, their records (cx cy
    # cz r, by leaf) and each record's cluster-order index ((1, 16), (1, 4)
    # and (1,) dummies without)
    sbvh_nodes: torch.Tensor
    sbvh_sph: torch.Tensor
    sbvh_idx: torch.Tensor
    # each quad's precomputed 64-byte record (quad_records)
    quad_rec: torch.Tensor

    # the combined texture set ((1,)/(1, 128) dummies without one)
    tex_tile: torch.Tensor      # (rows, 128) int32, 8x8-texel tiles, A/B
    tex_comb_a: torch.Tensor    # flat A words, every level in order
    tex_comb_b: torch.Tensor    # flat B words
    tex_mip: torch.Tensor       # (levels or 1, 5) int32 = tex_mip_meta

    # triangles: vertex A, edges u = B - A and v = C - A, material, and
    # with mesh UVs the texel-space uv0, uv1 - uv0, uv2 - uv0 per triangle
    # ((1,) dummies without)
    tri_a: Vec3
    tri_u: Vec3
    tri_v: Vec3
    tri_mat: torch.Tensor
    tri_uv0u: torch.Tensor
    tri_uv0v: torch.Tensor
    tri_uvdu1: torch.Tensor
    tri_uvdv1: torch.Tensor
    tri_uvdu2: torch.Tensor
    tri_uvdv2: torch.Tensor
    # triangles of a clustered mesh in cluster order, precomputed
    # (clusters.triangle_precompute: unit normal n, plane offset d, edge
    # covectors e1/e2 with offsets a0/b0), their materials and, with mesh
    # UVs, their uv tables (zero dummies of 128 rows in the streamed tier,
    # of one row below it); per static-tier cluster its box (mn3 mx3) and
    # (first triangle, count, 1 = huge: always tested)
    ctri_n: Vec3
    ctri_d: torch.Tensor
    ctri_e1: Vec3
    ctri_e2: Vec3
    ctri_a0: torch.Tensor
    ctri_b0: torch.Tensor
    ctri_mat: torch.Tensor
    ctri_uv0u: torch.Tensor
    ctri_uv0v: torch.Tensor
    ctri_uvdu1: torch.Tensor
    ctri_uvdv1: torch.Tensor
    ctri_uvdu2: torch.Tensor
    ctri_uvdv2: torch.Tensor
    tcl_box: torch.Tensor
    tcl_range: torch.Tensor
    # the streamed tier (K7; (1, 128) dummies without): one bounds row per
    # cluster, the record rows, the uv rows (cluster-field-major, or
    # parallel to the record rows where a cluster exceeds 128 triangles)
    mtri_bounds: torch.Tensor
    mtri_pack: torch.Tensor
    mtri_uvpack: torch.Tensor
    # per parent (parent_tables): box mn3 mx3, and (first cluster, count,
    # 1 = huge: always descended)
    stream_pbox: torch.Tensor
    stream_prange: torch.Tensor
    # the same per grandparent (DMA tier), over the parents
    stream_gbox: torch.Tensor
    stream_grange: torch.Tensor
    # the card's walk of the streamed tier (bvh_tables): binary nodes over
    # the record rows, the rows' triangles as 16-byte-aligned records and
    # each record's table-order winner number; of the static tier: the huge
    # cluster's records, then nodes over the other triangles, each record's
    # cluster-order index; of a brute mesh (K4t): nodes over its triangles,
    # their 64-byte records and each record's table index ((1, 16), (1, 12)
    # and (1,) dummies without)
    bvh_nodes: torch.Tensor
    bvh_tris: torch.Tensor
    bvh_tri_k: torch.Tensor
    # the flat RGB8 texture stack, texel (layer*hmax + y)*wmax + x, and
    # each layer's size ((1,) dummies for a combined set, read via tex_tile)
    tex_packed: torch.Tensor
    tex_w: torch.Tensor
    tex_h: torch.Tensor
    # the uniform grid over the triangles (scene/accel.py: per cell its
    # first entry and count in grid_tris, each cell's triangles in table
    # order; (1,) zeros without a grid, grid_res 0)
    grid_cell_start: torch.Tensor
    grid_cell_count: torch.Tensor
    grid_tris: torch.Tensor
    # the kernel's texel table (planar_tables, from the flat stack, read by
    # K10 and K11): each layer at its own size in 8x8-texel tiles of 64
    # words, and eight int32 words per layer ((64,) and (1, 8) dummies
    # without a texture set outside a combined set)
    planar_tile: torch.Tensor
    planar_meta: torch.Tensor

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
    # global homogeneous fog (WorldBuilder.set_fog): extinction, the
    # single-scatter albedo per channel and the Henyey-Greenstein g
    fog_sigma_t: float = 0.0
    fog_albedo: tuple = (1.0, 1.0, 1.0)
    fog_g: float = 0.0
    # (offset, count, mn3 | None, mx3 | None) over csph_*; huge first
    sph_clusters: tuple = ()
    # the same over ctri_* (the static tier)
    tri_clusters: tuple = ()
    # the mesh's tier: streamed (more than clusters.STREAM_MIN triangles),
    # and of those the DMA tier; the uv rows' layout (cluster-field-major,
    # or row-parallel)
    tri_streamed: bool = False
    tri_dma: bool = False
    stream_uv_cfm: bool = False
    stream_leaf: int = 0            # triangles of the largest cluster
    n_stream_clusters: int = 0
    # (first cluster, count, mn3 | None, mx3 | None) per parent, and
    # (first parent, count, mn3 | None, mx3 | None) per grandparent
    stream_parents: tuple = ()
    stream_gparents: tuple = ()
    stream_row_cull: bool = False   # test each record row's own box
    bvh_root: tuple = ()            # the BVH's root box, mn3 + mx3
    bvh_depth: int = 0              # its inner levels on the deepest path
    sbvh_root: tuple = ()           # the same of the sphere clusters' BVH
    sbvh_depth: int = 0
    # a ray from further off walks its BVH with every box widened by its
    # own bound: the static tier's and K4t's largest |o|_inf walked through
    # the boxes as they are and the widening's factor and addend
    # (clusters.far_bound), and the sphere BVH's centre, largest distance
    # |o - z| and widening constants (clusters.build_sphere_bvh)
    bvh_far: float = float("inf")
    bvh_wide: tuple = (0.0, 0.0)
    sbvh_far: tuple = (0.0, 0.0, 0.0, float("inf"), 0.0, 0.0, 0.0, 0.0)
    # the mesh walk's triangles set apart (clusters.mesh_pads): the first
    # record and the records of the section every ray tests, then of the
    # section a ray from beyond bvh_far tests too
    bvh_apart: tuple = (0, 0, 0, 0)
    tex_combined: bool = False
    tex_comb_w: int = 1
    tex_comb_h: int = 1
    tex_tiles_x: int = 1
    # per level (row_off, tiles_x, word_off, w, h); () = no pyramid
    tex_mip_meta: tuple = ()
    tex_hmax: int = 1
    tex_wmax: int = 1
    # every textured material is a mesh-UV albedo binding (no planar fetch)
    tex_mesh_only: bool = False
    # JAX's tiled texture stack exists (stack_tiled): a texture set outside
    # a combined set, every layer a power of two, within its row cap; the
    # kernel reads the planar table whatever this says, and the pixel
    # orders of JAX's kernel follow it (render/orders.py::sub_chunks,
    # stack_tiles)
    tex_stack_tiled: bool = False
    # -n -m -r turn the maps off (win32_main.cpp:2173-2178); --tbn rotates
    # the decoded normal into the geometric frame instead of replacing N
    use_normal_maps: bool = True
    use_metalness_maps: bool = True
    use_roughness_maps: bool = True
    tbn_normal_maps: bool = False
    grid_res: int = 0       # cells per axis of the grid, 0 = no grid

    @property
    def device(self) -> torch.device:
        return self.mat_roughness.device

    def to(self, device) -> "Scene":
        """The same scene with every table on ``device``."""
        moved = {k: Vec3(*(c.to(device).contiguous() for c in getattr(self, k)))
                 for k in VEC_FIELDS + DERIVED_VEC_FIELDS}
        moved.update({k: getattr(self, k).to(device).contiguous()
                      for k in TENSOR_FIELDS + DERIVED_TENSOR_FIELDS})
        return dataclasses.replace(self, **moved)

    def without_clusters(self) -> "Scene":
        """The same scene with its sphere clusters dropped: the brute sweep
        over ``sph_*`` (the yardstick the clustered walk is measured
        against)."""
        return dataclasses.replace(
            self, sph_clusters=(), **cluster_tables(()),
            **sphere_bvh_tables(self.csph_center, self.csph_radius, ())
        ).to(self.device)

    @property
    def planar_maps(self) -> bool:
        """Material maps fetched at the hit's world xy from the flat stack
        (K10's planar form): textures outside the combined set that are not
        all mesh-UV albedo bindings."""
        return bool(self.n_textures and not self.tex_combined
                    and not self.tex_mesh_only)

    @property
    def tri_brute(self) -> bool:
        """A mesh of at most ``clusters.CLUSTER_MIN`` triangles, swept
        brute force (K4t)."""
        return bool(self.n_tris and self.n_tris <= clusters.CLUSTER_MIN)

    @property
    def tri_static(self) -> bool:
        """A mesh of ``clusters.CLUSTER_MIN + 1`` to ``clusters.STREAM_MIN``
        triangles: the static tier's cluster walk (K5's triangle form,
        with the winner's uv K8)."""
        return bool(self.tri_clusters) and not self.tri_streamed

    @property
    def featured(self) -> bool:
        """The scene needs the feature path: fog, transmission, bump maps,
        planar maps or a brute-force mesh (on any base: brute or clustered
        spheres, the combined texture set or a mesh tier)."""
        return bool(self.fog_sigma_t > 0.0 or self.any_transmissive
                    or self.any_bump or self.planar_maps or self.tri_brute)

    @property
    def off_kernel(self) -> bool:
        """JAX renders this scene on XLA only: its ``supports``
        (pallas_backend.py:140-167) turns away a mesh with a grid, a mesh
        beyond the DMA tier, a UV mesh beside a combined texture set and a
        bump map on a combined set. The port renders it as torch ops, and
        its triangle pass walks the grid or sweeps the mesh as JAX's XLA
        drivers do (``ops/intersect.py``)."""
        return bool(
            (self.n_tris and self.grid_res)
            or self.n_tris > clusters.DMA_MAX
            or (self.tex_combined and self.n_tris and self.has_mesh_uvs)
            or (self.tex_combined and self.n_textures and self.any_bump))


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


def _box_tables(rows: tuple, box: str, rng: str) -> dict:
    """(first, count, mn3 | None, mx3 | None) descriptors as the kernel's
    tables (CPU tensors, at least one row): ``box`` (n, 6) float32 mn3 mx3
    and ``rng`` (n, 3) int32 (first, count, 1 = huge: no box, always
    descended)."""
    rows = rows or ((0, 0, None, None),)
    return {
        box: torch.tensor([(0.0,) * 6 if r[2] is None else r[2] + r[3]
                           for r in rows], dtype=torch.float32),
        rng: torch.tensor([(r[0], r[1], int(r[2] is None)) for r in rows],
                          dtype=torch.int32),
    }


def parent_tables(stream_parents: tuple, stream_gparents: tuple = ()) -> dict:
    """The kernel's parent tables (``stream_pbox``/``stream_prange``, in
    clusters) and grandparent tables (``stream_gbox``/``stream_grange``,
    in parents) for the streamed tier's static descriptors."""
    return {**_box_tables(stream_parents, "stream_pbox", "stream_prange"),
            **_box_tables(stream_gparents, "stream_gbox", "stream_grange")}


def bvh_tables(mtri_pack: torch.Tensor, tri_streamed: bool, stream_leaf: int,
               stream_uv_cfm: bool, static=None, brute=None,
               stream_tris=None) -> dict:
    """The card's mesh BVH: the streamed tier's
    (``clusters.build_stream_bvh``) over the record rows ``mtri_pack`` and
    the triangles ``stream_tris`` they were made from (A, u, v by record
    row and slot), its winners numbered by their uv column with the
    cluster-field-major uv rows, else by record; the static tier's
    (``clusters.build_static_bvh``, whose arguments ``static`` holds: the
    cluster-ordered precomputed triangles, their A, u, v and the
    clusters); or K4t's over a mesh of at most ``clusters.CLUSTER_MIN``
    triangles (``clusters.build_brute_bvh``, whose arguments ``brute``
    holds: the table-order A, u, v); the dummies without any."""
    if static is not None:
        b = clusters.build_static_bvh(*static)
    elif brute is not None:
        b = clusters.build_brute_bvh(*brute)
    elif not tri_streamed:
        return dict(bvh_nodes=torch.zeros((1, clusters.BVH_NODE_FLOATS)),
                    bvh_tris=torch.zeros((1, clusters.BVH_TRI_FLOATS)),
                    bvh_tri_k=torch.zeros((1,), dtype=torch.int32),
                    bvh_root=(), bvh_depth=0, bvh_far=float("inf"),
                    bvh_wide=(0.0, 0.0), bvh_apart=(0, 0, 0, 0))
    else:
        b = clusters.build_stream_bvh(
            mtri_pack.cpu().numpy(),
            clusters.stream_rows_per_cluster(stream_leaf), stream_uv_cfm,
            stream_tris)
    return dict(b, **{k: torch.from_numpy(b[k])
                      for k in ("bvh_nodes", "bvh_tris", "bvh_tri_k")})


def sphere_bvh_tables(csph_center: Vec3, csph_radius: torch.Tensor,
                      sph_clusters: tuple) -> dict:
    """The sphere clusters' BVH (``clusters.build_sphere_bvh``) over the
    cluster-ordered spheres (CPU tensors), the dummies without clusters."""
    b = clusters.build_sphere_bvh(
        torch.stack([c.cpu() for c in csph_center], 1).numpy(),
        csph_radius.cpu().numpy(), sph_clusters)
    return dict(b, **{k: torch.from_numpy(b[k])
                      for k in ("sbvh_nodes", "sbvh_sph", "sbvh_idx")})


def tri_cluster_tables(tri_clusters: tuple) -> dict:
    """The kernel's static-tier cluster tables (``tcl_box``/``tcl_range``,
    over ``ctri_*``)."""
    return _box_tables(tri_clusters, "tcl_box", "tcl_range")


# JAX's cap on its tiled stack: 8192 rows of 128 words (schema.py:840)
STACK_TILE_MAX_ROWS = 8192


def stack_tiled(textures: list, combined: bool) -> bool:
    """Whether JAX's ``finalize`` builds its tiled texture stack
    (``tex_stack_tiled``, pathtracer_tpu/scene/schema.py:843-867): textures
    outside a combined set, every layer's height and width a power of two,
    each layer padded to 8 rows and 16 columns in rows of two 8x8 tiles,
    all of them within ``STACK_TILE_MAX_ROWS``."""
    if not textures or combined or not all(
            (t.shape[0] & (t.shape[0] - 1)) == 0
            and (t.shape[1] & (t.shape[1] - 1)) == 0 for t in textures):
        return False
    rows = sum((-(-t.shape[0] // 8)) * (-(-t.shape[1] // 16))
               for t in textures)
    return rows <= STACK_TILE_MAX_ROWS


def texture_stack(textures: list, combined: bool) -> dict:
    """The flat RGB8 stack of a texture set (schema.py:728-740 in JAX: every
    layer padded to the largest height and width, one int32 word per texel)
    and its statics, or (1,) dummies for a ``combined`` set, whose fetch
    reads ``tex_tile`` instead (a combined set beside a UV mesh or a bump
    map keeps its stack: those read it)."""
    if combined or not textures:
        return dict(tex_packed=torch.zeros((1,), dtype=torch.int32),
                    tex_w=torch.ones((1,), dtype=torch.int32),
                    tex_h=torch.ones((1,), dtype=torch.int32),
                    tex_hmax=1, tex_wmax=1)
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    tex = np.zeros((len(textures), hmax, wmax, 3), np.float32)
    for k, t in enumerate(textures):
        tex[k, :t.shape[0], :t.shape[1]] = t
    q = np.clip(np.round(tex * 255.0), 0, 255).astype(np.int64)
    packed = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)).astype(np.int32)
    return dict(
        tex_packed=torch.from_numpy(packed.reshape(-1)),
        tex_w=torch.tensor([t.shape[1] for t in textures], dtype=torch.int32),
        tex_h=torch.tensor([t.shape[0] for t in textures], dtype=torch.int32),
        tex_hmax=hmax, tex_wmax=wmax)


def recip32(n: int) -> int:
    """The kernel's reciprocal of a divisor ``n`` >= 1 (``udivmod``):
    floor(2^32 / n), or 2^32 - 1 for n = 1. With it, q = umulhi(x, m) is
    floor(x / n) or one less for every uint32 x, and one conditional
    subtract of n from x - q * n finishes x / n and x % n."""
    return 0xFFFF_FFFF if n == 1 else (1 << 32) // n


def planar_recip(n: int) -> int:
    """A planar layer's wrap constant (the kernel's ``wrap_mod``): 0 where
    ``n`` is a power of two (the wrap is a mask), else :func:`recip32`."""
    return 0 if n & (n - 1) == 0 else recip32(n)


def udivmod32(x, n, m):
    """The kernel's ``udivmod`` on numpy arrays (broadcast): (x / n, x % n)
    of uint32 ``x`` from n's reciprocal ``m`` (:func:`recip32`), no
    division."""
    x, n, m = (np.asarray(a, np.uint64) for a in (x, n, m))
    q = (x * m) >> np.uint64(32)
    r = x - q * n
    over = r >= n
    return q + over, np.where(over, r - n, r)


PLANAR_TILE = 8        # a planar layer's tiles: 8x8 texels, 64 words
PLANAR_META_WORDS = 8  # tile_off, tiles_x, w, h, mw, mh, w and h as f32 bits


def planar_tables(tex_packed: torch.Tensor, tex_w: torch.Tensor,
                  tex_h: torch.Tensor, tex_hmax: int, tex_wmax: int,
                  planar: bool) -> dict:
    """K10's planar table from the flat stack (:func:`texture_stack`): each
    layer at its own size, not padded to the largest, in 8x8-texel tiles
    of 64 words, tiles row-major (texel (y, x) at word (tile_off + (y >> 3)
    * tiles_x + (x >> 3)) * 64 + (y & 7) * 8 + (x & 7); a partial tile's
    other texels are never read), and per layer ``PLANAR_META_WORDS`` int32
    words: tile_off, tiles_x, w, h, the wraps' :func:`planar_recip` of w and
    h (as int32 bits) and w and h as float32 bits. The kernel reads every
    map outside a combined set from it: planar maps (K10's planar form),
    mesh-UV albedo maps (its texel form) and bump maps (K11). Dummies where
    the scene has no such map (``planar`` false)."""
    if not planar:
        return dict(planar_tile=torch.zeros((PLANAR_TILE ** 2,),
                                            dtype=torch.int32),
                    planar_meta=torch.zeros((1, PLANAR_META_WORDS),
                                            dtype=torch.int32))
    t = PLANAR_TILE
    stack = tex_packed.cpu().numpy().reshape(-1, tex_hmax, tex_wmax)
    tiles, meta, off = [], [], 0
    for k, (w, h) in enumerate(zip(tex_w.tolist(), tex_h.tolist())):
        tx, ty = -(-w // t), -(-h // t)
        layer = np.zeros((ty * t, tx * t), np.int32)
        layer[:h, :w] = stack[k, :h, :w]
        tiles.append(layer.reshape(ty, t, tx, t).transpose(0, 2, 1, 3)
                     .reshape(-1))
        sizes = np.asarray([w, h], np.float32).view(np.int32)
        meta.append([off, tx, w, h,
                     *np.asarray([planar_recip(w), planar_recip(h)],
                                 np.uint32).view(np.int32), *sizes])
        off += tx * ty
    return dict(planar_tile=torch.from_numpy(np.concatenate(tiles)),
                planar_meta=torch.tensor(meta, dtype=torch.int32))


def mip_table(tex_mip_meta: tuple) -> dict:
    """The kernel's copy of the static pyramid rows (a CPU int32 tensor of
    at least one row)."""
    rows = tex_mip_meta or ((0, 1, 0, 1, 1),)
    return dict(tex_mip=torch.tensor(rows, dtype=torch.int32))


def combined_texture_set(textures: list, materials: list) -> dict:
    """The combined-set tables and statics for the host texture list, as
    JAX's WorldBuilder packs them (schema.py:742-823), or the dummies when the
    list is not the canonical 4-map set."""
    i32 = np.int32
    combined = (
        len(textures) == 4
        and len({t.shape[:2] for t in textures}) == 1
        and all((m.albedo_idx, m.metalness_idx, m.roughness_idx,
                 m.normal_idx) in ((0, 0, 0, 0), (1, 2, 3, 4))
                for m in materials))
    if not combined:
        return dict(tex_tile=torch.zeros((1, 128), dtype=torch.int32),
                    tex_comb_a=torch.zeros((1,), dtype=torch.int32),
                    tex_comb_b=torch.zeros((1,), dtype=torch.int32),
                    **mip_table(()), tex_combined=False, tex_comb_w=1,
                    tex_comb_h=1, tex_tiles_x=1, tex_mip_meta=())
    alb, mtl, rgh, nrm = (np.clip(np.round(t * 255.0), 0, 255).astype(np.int64)
                          for t in textures)
    comb_a = (alb[..., 0] | (alb[..., 1] << 8) | (alb[..., 2] << 16)
              | (mtl[..., 0] << 24))
    comb_b = (nrm[..., 0] | (nrm[..., 1] << 8) | (nrm[..., 2] << 16)
              | (rgh[..., 0] << 24))
    # the top byte wraps into the int32 sign
    comb_a = comb_a.astype(np.uint32).astype(np.int64).astype(i32)
    comb_b = comb_b.astype(np.uint32).astype(np.int64).astype(i32)
    ch, cw = textures[0].shape[:2]
    tiles_x = -(-cw // 8)

    def level_tables(a2, b2):
        """One level's (tile rows, 128) table and its tile columns."""
        hh, ww = a2.shape
        hp, wp = -(-hh // 8) * 8, -(-ww // 8) * 8
        pa = np.zeros((hp, wp), i32)
        pb = np.zeros((hp, wp), i32)
        pa[:hh, :ww], pb[:hh, :ww] = a2, b2
        tx = wp // 8

        def tile64(m):  # (hp, wp) -> (tiles, 64) in tile-major order
            return (m.reshape(hp // 8, 8, tx, 8)
                    .transpose(0, 2, 1, 3).reshape(-1, 64))

        t = np.zeros((hp // 8 * tx, 128), i32)
        t[:, 0::2] = tile64(pa)
        t[:, 1::2] = tile64(pb)
        return t, tx

    # A square pow2 set gets its pyramid: GenerateMipmapChain's even-texel
    # decimation of the packed words, level 0 leading every table.
    mip_meta = ()
    if ch == cw and ch >= 8 and (ch & (ch - 1)) == 0:
        chain_a = textures_mod.generate_mipmap_chain(comb_a)
        chain_b = textures_mod.generate_mipmap_chain(comb_b)
        metas, tiled_parts = [], []
        row_off = word_off = 0
        for a_l, b_l in zip(chain_a, chain_b):
            t_l, tx_l = level_tables(a_l, b_l)
            wl = a_l.shape[0]
            metas.append((row_off, tx_l, word_off, wl, wl))
            tiled_parts.append(t_l)
            row_off += t_l.shape[0]
            word_off += wl * wl
        mip_meta = tuple(metas)
        tiled = np.concatenate(tiled_parts)
        comb_a = np.concatenate([a.reshape(-1) for a in chain_a])
        comb_b = np.concatenate([b.reshape(-1) for b in chain_b])
    else:
        tiled, tiles_x = level_tables(comb_a, comb_b)
    return dict(tex_tile=torch.from_numpy(np.ascontiguousarray(tiled)),
                tex_comb_a=torch.from_numpy(np.ascontiguousarray(
                    comb_a.reshape(-1))),
                tex_comb_b=torch.from_numpy(np.ascontiguousarray(
                    comb_b.reshape(-1))),
                **mip_table(mip_meta), tex_combined=True, tex_comb_w=cw,
                tex_comb_h=ch, tex_tiles_x=tiles_x, tex_mip_meta=mip_meta)


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


def quad_records(quad_point: Vec3, quad_u: Vec3, quad_v: Vec3,
                 quad_n: Vec3) -> dict:
    """The quads' precomputed records (``quad_rec``, (Q, 16) float32, K4t's
    layout: ``clusters.brute_records``): n_unit.xyz d | w.xyz v.z | A.xyz
    u.x | u.y u.z v.x v.y, n_unit the baked ``quad_n`` and d = A . n_unit,
    w = cross(u, v) * (1 / |cross(u, v)|^2), each formed in float32 in the
    order ``ray_planar_quad`` forms it per test (ops/intersect.py:106), so
    the kernel's quad test gives its t, alpha and beta bit for bit. A quad
    whose cross(u, v) is zero (the tables' padding) takes w = 0 where the
    per-test form's is NaN: its normal is zero, so its test never hits
    either way."""
    cols = lambda v: torch.stack([c.cpu() for c in v], 1).numpy()
    u, v = cols(quad_u), cols(quad_v)
    rec = clusters.brute_records(cols(quad_point), u, v, cols(quad_n))
    flat = ~clusters._cross32(u, v).any(axis=1)
    rec[flat, 4:7] = 0.0
    return dict(quad_rec=torch.from_numpy(rec))


class WorldBuilder:
    """Host-side scene assembly for spheres, quads, planes, one triangle
    mesh and textures."""

    def __init__(self):
        self.materials: list[HostMaterial] = []
        self.spheres: list[tuple] = []      # (center, radius, mat)
        self.quads: list[tuple] = []        # (point, u, v, mat)
        self.planes: list[tuple] = []       # (n, d, mat)
        self.textures: list[np.ndarray] = []  # (H, W, 3) float32 each
        self.triangles = None                 # (T, 3, 3) float32
        self.tri_mats = None                  # (T,) int32
        self.tri_uvs = None                   # (T, 3, 2) float32, texels
        self.quad_light: int = -1
        self.fog: tuple = (0.0, (1.0, 1.0, 1.0), 0.0)  # see set_fog
        self.tbn_normal_maps: bool = False  # see Scene.tbn_normal_maps

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

    def set_fog(self, sigma_t: float, albedo=(1.0, 1.0, 1.0), g: float = 0.0):
        """Global homogeneous medium: extinction ``sigma_t`` (1/units of
        free flight), single-scatter ``albedo`` per channel and the
        Henyey-Greenstein anisotropy ``g`` in (-1, 1)."""
        if sigma_t < 0.0 or not (-1.0 < g < 1.0):
            raise ValueError("fog needs sigma_t >= 0 and -1 < g < 1")
        self.fog = (float(sigma_t), tuple(float(a) for a in albedo), float(g))

    def add_plane(self, n, d, mat) -> int:
        self.planes.append((tuple(n), float(d), int(mat)))
        return len(self.planes) - 1

    def add_texture(self, data: np.ndarray) -> int:
        """Returns the 1-based texture index the material *_idx fields use."""
        self.textures.append(np.asarray(data, np.float32))
        return len(self.textures)

    def set_mesh(self, points: np.ndarray, mat_indices: np.ndarray,
                 uvs=None):
        """``points``: (T*3, 3) vertices, three per triangle; a triangle's
        material is its first vertex's. ``uvs``: optional (T*3, 2) per-vertex
        coordinates in [0, 1] units, scaled here to texel units by the size
        of the triangle's material's albedo texture (scale 1 without one),
        so materials and textures are registered first."""
        self.triangles = np.asarray(points, np.float32).reshape(-1, 3, 3)
        self.tri_mats = np.asarray(mat_indices, np.int32).reshape(-1, 3)[:, 0]
        if uvs is None:
            self.tri_uvs = None
            return
        uv = np.asarray(uvs, np.float32).reshape(-1, 3, 2)
        mw = np.ones((len(self.materials),), np.float32)
        mh = np.ones((len(self.materials),), np.float32)
        for j, m in enumerate(self.materials):
            if m.albedo_idx and m.albedo_idx <= len(self.textures):
                mh[j], mw[j] = self.textures[m.albedo_idx - 1].shape[:2]
        scale = np.stack([mw[self.tri_mats], mh[self.tri_mats]],
                         axis=-1)[:, None, :]
        self.tri_uvs = (uv * scale).astype(np.float32)

    def _mesh_tables(self, view_origin) -> dict:
        """The triangle tables and, for a mesh of more than
        clusters.CLUSTER_MIN triangles, the clustered ones, as the JAX
        builder makes them (schema.py:562-727): the static tier's
        precomputed triangles in cluster order with their clusters, or the
        streamed tier's records in cluster order, clusters regrouped under
        parents (and, in the DMA tier, parents under grandparents),
        row-aligned record rows and the uv rows: cluster-field-major where
        the largest cluster fits the 128 lanes, else parallel to the record
        rows (schema.py:656-665 in JAX)."""
        f32, i32 = np.float32, np.int32
        tris = self.triangles
        ntri = 0 if tris is None else len(tris)
        T = _pad(ntri)
        tri_a, tri_u, tri_v = (np.zeros((T, 3), f32) for _ in range(3))
        tri_m = np.zeros((T,), i32)
        if ntri:
            tri_a[:ntri] = tris[:, 0]
            tri_u[:ntri] = tris[:, 1] - tris[:, 0]
            tri_v[:ntri] = tris[:, 2] - tris[:, 0]
            tri_m[:ntri] = self.tri_mats
        has_uvs = self.tri_uvs is not None and ntri > 0
        uvt = np.zeros((T if has_uvs else 1, 6), f32)
        if has_uvs:
            uvt[:ntri, 0:2] = self.tri_uvs[:, 0]
            uvt[:ntri, 2:4] = self.tri_uvs[:, 1] - self.tri_uvs[:, 0]
            uvt[:ntri, 4:6] = self.tri_uvs[:, 2] - self.tri_uvs[:, 0]
        out = dict(tri_a=_vec_columns(tri_a), tri_u=_vec_columns(tri_u),
                   tri_v=_vec_columns(tri_v), tri_mat=torch.from_numpy(tri_m),
                   **{k: torch.from_numpy(uvt[:, j].copy())
                      for j, k in enumerate(TRI_UV_FIELDS)},
                   n_tris=ntri, has_mesh_uvs=has_uvs)

        def ctri_dummies():
            return ({k: np.zeros((1, 3) if k in ("n", "e1", "e2") else (1,),
                                 f32) for k in ("n", "d", "e1", "e2", "a0",
                                                "b0")},
                    np.zeros((1,), i32))

        ctri, ctri_m = ctri_dummies()
        ctri_uvt = np.zeros((1, 6), f32)
        tri_clusters = ()
        static = None  # build_static_bvh's arguments
        stream_tris = None  # build_stream_bvh's triangles
        dummy = lambda: torch.zeros((1, 128), dtype=torch.float32)
        stream = dict(mtri_bounds=dummy(), mtri_pack=dummy(),
                      mtri_uvpack=dummy(), stream_parents=(),
                      stream_gparents=())
        # (a mesh above clusters.DMA_MAX never reaches a kernel: JAX's XLA
        # drivers sweep it or walk its grid, and so does the port, which
        # builds it no clusters; JAX's go unread)
        if clusters.CLUSTER_MIN < ntri <= clusters.DMA_MAX:
            bmn, bmx = clusters.triangle_bounds(tris)
            order, tri_clusters = clusters.build_clusters(
                bmn, bmx, sort_origin=view_origin)
            ctri = clusters.triangle_precompute(
                tri_a[:ntri][order], tri_u[:ntri][order], tri_v[:ntri][order])
            ctri_m = tri_m[:ntri][order]
            if has_uvs:
                ctri_uvt = uvt[:ntri][order]
            if ntri > clusters.STREAM_MIN:
                cperm, parents = clusters.build_parents(
                    tri_clusters, sort_origin=view_origin)
                tri_clusters = tuple(tri_clusters[i] for i in cperm)
                leaf = max(c[1] for c in tri_clusters)
                bounds, pack = clusters.pack_stream_clusters(
                    ctri, ctri_m, tri_clusters, leaf,
                    (bmn[order], bmx[order]))
                cfm = has_uvs and leaf <= 128
                uvpack = (clusters.pack_stream_uv_cfm(ctri_uvt, tri_clusters,
                                                      leaf) if cfm
                          else clusters.pack_stream_uv(ctri_uvt, tri_clusters,
                                                       leaf) if has_uvs
                          else np.zeros((1, 128), f32))
                # the DMA tier regroups many parents under grandparents: a
                # permutation of the parent list (their cluster ranges move
                # with them), as JAX's finalize does (schema.py:691-707)
                dma = ntri > (clusters.STREAM_MAX // 2 if has_uvs
                              else clusters.STREAM_MAX)
                gparents = ()
                if dma and len(parents) >= clusters.GPARENT_MIN:
                    pperm, gparents = clusters.build_parents(
                        parents, sort_origin=view_origin)
                    parents = tuple(parents[i] for i in pperm)
                stream_tris = tuple(
                    clusters.stream_slots(x[:ntri][order], tri_clusters, leaf)
                    for x in (tri_a, tri_u, tri_v))
                stream = dict(
                    mtri_bounds=torch.from_numpy(bounds),
                    mtri_pack=torch.from_numpy(pack),
                    mtri_uvpack=torch.from_numpy(uvpack),
                    stream_parents=parents, stream_gparents=gparents,
                    tri_streamed=True, tri_dma=dma, stream_uv_cfm=cfm,
                    stream_leaf=leaf, n_stream_clusters=len(tri_clusters),
                    stream_row_cull=ntri >= clusters.ROW_CULL_MIN)
                # the records carry what the static tier's tables would
                tri_clusters = ()
                ctri, ctri_m = ctri_dummies()
                ctri_uvt = np.zeros((1, 6), f32)
            else:
                static = (ctri, tri_a[:ntri][order], tri_u[:ntri][order],
                          tri_v[:ntri][order], tri_clusters)
            # JAX pads these to a multiple of 128, dummies included
            pad = -len(ctri_m) % 128
            ctri = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], f32)])
                    for k, v in ctri.items()}
            ctri_m = np.concatenate([ctri_m, np.zeros((pad,), i32)])
            ctri_uvt = np.concatenate(
                [ctri_uvt, np.zeros((-len(ctri_uvt) % 128, 6), f32)])
        out.update(
            ctri_n=_vec_columns(ctri["n"]), ctri_d=torch.from_numpy(ctri["d"]),
            ctri_e1=_vec_columns(ctri["e1"]), ctri_e2=_vec_columns(ctri["e2"]),
            ctri_a0=torch.from_numpy(ctri["a0"]),
            ctri_b0=torch.from_numpy(ctri["b0"]),
            ctri_mat=torch.from_numpy(np.ascontiguousarray(ctri_m)),
            **{k: torch.from_numpy(ctri_uvt[:, j].copy())
               for j, k in enumerate(CTRI_UV_FIELDS)},
            tri_clusters=tri_clusters, **tri_cluster_tables(tri_clusters))
        out.update(stream)
        out.update(parent_tables(stream["stream_parents"],
                                 stream["stream_gparents"]))
        brute = ((tri_a[:ntri], tri_u[:ntri], tri_v[:ntri])
                 if 0 < ntri <= clusters.CLUSTER_MIN else None)
        out.update(bvh_tables(stream["mtri_pack"],
                              stream.get("tri_streamed", False),
                              stream.get("stream_leaf", 0),
                              stream.get("stream_uv_cfm", False), static,
                              brute, stream_tris))
        return out

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
                 use_normal_maps: bool = True,
                 use_metalness_maps: bool = True,
                 use_roughness_maps: bool = True,
                 grid=None, view_origin=None) -> Scene:
        """Host lists -> padded CPU Scene (``Scene.to`` moves it).
        ``view_origin`` (the camera position) orders sphere clusters
        near-to-far; the ``use_*_maps`` flags are the CLI's -n -m -r;
        ``grid`` is ``accel.build_uniform_grid``'s result over the mesh,
        which the triangle pass then walks (schema.py:533 in JAX)."""
        mats = self.materials
        M = _pad(len(mats), 128)
        S, Q, P = _pad(len(self.spheres)), _pad(len(self.quads)), _pad(len(self.planes))
        i32 = np.int32
        col = lambda name: [getattr(m, name) for m in mats]
        quad_point = _vec_table([q[0] for q in self.quads], Q)
        quad_u = _vec_table([q[1] for q in self.quads], Q)
        quad_v = _vec_table([q[2] for q in self.quads], Q)
        quad_n = bake_quad_normals(quad_u, quad_v)
        csph_c, csph_r, csph_m, sph_clusters = self._sphere_clusters(view_origin)
        mesh = self._mesh_tables(view_origin)
        tex_set = combined_texture_set(self.textures, mats)
        non_tri_mats = ({s[2] for s in self.spheres} | {q[3] for q in self.quads}
                        | {p[2] for p in self.planes})
        # every textured material binds an albedo map to mesh UVs alone
        tex_mesh_only = bool(
            mesh["has_mesh_uvs"] and self.textures
            and all(m.metalness_idx == 0 and m.roughness_idx == 0
                    and m.normal_idx == 0 and m.bump_idx == 0
                    and (m.albedo_idx == 0 or j not in non_tri_mats)
                    for j, m in enumerate(mats)))
        if grid is None:
            zero = lambda: torch.zeros((1,), dtype=torch.int32)
            grid = (zero(), zero(), zero(), 0)
        # a combined set's fetch reads tex_tile; its flat stack is built
        # only where a UV mesh's albedo or a bump map reads it (as torch
        # ops: JAX renders such a scene on XLA only)
        stack = texture_stack(self.textures, tex_set["tex_combined"] and not (
            mesh["has_mesh_uvs"] or any(m.bump_idx != 0 for m in mats)))
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
            quad_point=quad_point,
            quad_u=quad_u,
            quad_v=quad_v,
            quad_n=quad_n,
            **quad_records(quad_point, quad_u, quad_v, quad_n),
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
            **sphere_bvh_tables(_vec_columns(csph_c), torch.from_numpy(csph_r),
                                sph_clusters),
            **tex_set,
            **stack,
            **planar_tables(**stack, planar=bool(
                self.textures and not tex_set["tex_combined"])),
            **mesh,
            tex_mesh_only=tex_mesh_only,
            tex_stack_tiled=stack_tiled(self.textures,
                                        tex_set["tex_combined"]),
            sph_clusters=sph_clusters,
            n_spheres=len(self.spheres),
            n_quads=len(self.quads),
            n_planes=len(self.planes),
            n_materials=len(mats),
            n_textures=len(self.textures),
            quad_light=self.quad_light,
            fog_sigma_t=self.fog[0],
            fog_albedo=self.fog[1],
            fog_g=self.fog[2],
            tbn_normal_maps=self.tbn_normal_maps,
            just_cosine=(world_kind == WORLD_RAYTRACING_ONE_WEEKEND),
            any_transmissive=any(m.transmission > 0.0 for m in mats),
            any_dispersive=any(m.transmission > 0.0 and m.dispersion > 0.0
                               for m in mats),
            any_bump=any(m.bump_idx != 0 for m in mats),
            use_normal_maps=use_normal_maps,
            use_metalness_maps=use_metalness_maps,
            use_roughness_maps=use_roughness_maps,
            grid_cell_start=grid[0],
            grid_cell_count=grid[1],
            grid_tris=grid[2],
            grid_res=grid[3],
        )
