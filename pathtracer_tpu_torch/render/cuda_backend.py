"""The hand-written CUDA render kernel: build, binding, wrapper, plain version.

``csrc/wave_kernel.cu`` is the Hopper counterpart of the JAX package's one
Pallas kernel, ``render/pallas_backend.py::render_chunk_pallas`` with its
path-regeneration loop ``_wave_loop`` (K2) and its bounce-lockstep loop
``_lockstep_loop`` (K3). Its compile-time variants (``VARIANTS``) are the
instantiations of one kernel template: untextured, the brute sphere sweep
or the clustered walk (K5/K6: the huge cluster, then one near-first walk
over a BVH of the other spheres, each warp on an 8x4 pixel tile), each
with the pinhole or the thin-lens primary ray; textured (the combined 4-map set, K9), the brute sweep with
either primary under ``TEXTURED_SCHEDULE``, and the pinhole under the
other schedule as its yardstick; the mesh tiers (``MESH_KINDS``), either
primary under ``MESH_SCHEDULE``: the streamed triangle walk K7 with the
mesh-UV texel fetch K10 (``mesh``, with the pinhole under the other
schedule too) or without UVs (``meshplain``), the resident and the DMA
tier alike (one near-first walk over a BVH of the record rows, each warp
on an 8x4 pixel tile), and the static tier's walk (K5's triangle form:
the huge cluster, then the same near-first walk over a BVH of the other
triangles, each warp on an 8x4 pixel tile) with the winner's uv (K8,
``static``) or without (``staticplain``, with the pinhole under the other
schedule too); feature (fog, transmission with dispersion, planar maps
from their own tiled table with K10's planar form, bump maps with the height
fetch K11, K4t, the brute triangle sweep, as a near-first walk over a BVH
of the triangles' precomputed records, with or without UVs), either
primary under path regeneration, the schedule JAX runs these scenes
under, with the pinhole also under lockstep as its yardstick; and the same
feature bounce on each other base, named "feat" + the base: sphere
clusters (``featclustered``, regen), the combined set (``feattextured``
under ``TEXTURED_SCHEDULE``, its pinhole also under the other schedule)
and every mesh tier (``featmesh`` ... ``featstaticplain`` under
``MESH_SCHEDULE``, ``featmesh``'s pinhole also under the other one).
The feature variants without a mesh tier carry K4t's walk only in forms
of their own (``K4T_VARIANTS``, named with ``K4T_SUFFIX``), which a scene
with a brute mesh takes.
The mixed bases (``MIXED_VARIANTS``: sphere clusters with the combined set
or with any mesh tier, the combined set with a mesh tier without UVs, and
all three), named by their parts joined with "+", each carry the feature
bounce and pick the primary ray at run time, so one instantiation covers
either camera with or without features, under ``MIXED_SCHEDULE``. Every
variant with the feature bounce but ``textured+meshplain`` regroups its
shading lanes by event each bounce (the kernel's ``regroup_shading``;
``render/regroup.py`` is its plain model). The
file is compiled at first use for ``sm_90a`` into
``pathtracer_tpu_torch/_build/`` (a library named by the hash of the
source and flags, so an edit rebuilds it): one ``nvcc`` for each of its
parts (:func:`build_parts`), all started together, and one link. It is loaded
with ``ctypes`` and launched on PyTorch's current stream.

- :func:`render_chunk_cuda` takes the accumulator's device: on CUDA tensors
  it launches the kernel or raises; on CPU tensors it runs the plain version.
  It picks the variant from the scene and camera (:func:`variant`): the
  base from the scene (the textured kernel for a combined texture set, a
  mesh kernel for a mesh of more than ``clusters.CLUSTER_MIN`` triangles
  by its tier, :func:`mesh_kind`, else the clustered walk when the scene
  has sphere clusters, else the brute sweep; a mixed base where two of
  those meet), its feature form for a scene with fog, transmission, bump
  or planar maps or a brute-force mesh (``Scene.featured``), and the
  thin-lens primary when the camera has one.
- :func:`render_chunk_plain` is the plain PyTorch version of the same
  function (``render/lockstep.py`` under the lockstep schedule,
  ``render/wavefront.py`` otherwise), which the CPU tests run and which
  ``chip_smoke.py`` holds the kernel against on the card.
- ``LAUNCHES`` counts the kernel's launches, ``VARIANT_LAUNCHES`` the same
  launches by variant name, ``PROBE_LAUNCHES`` the launches of the
  kernel's intersect probe (:func:`intersect_probe_cuda`, no render's).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..scene.camera import Camera, define_camera
from ..scene import clusters
from ..scene.clusters import stream_rows_per_cluster
from ..scene.schema import Scene, planar_recip, recip32
from .lockstep import render_chunk_lockstep
from .raygen import focal_plane
from .wavefront import lane_pixels, render_chunk_wavefront

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "wave_kernel.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

# The sample schedule of the textured variants (world 1's main path), and
# the other one, instantiated for the pinhole only, as its yardstick; the
# same for the mesh variants (world 7's main path; kMeshMain in the kernel)
# and for the feature forms of brute and clustered spheres (JAX runs them
# under path regeneration; the brute pinhole also under lockstep).
TEXTURED_SCHEDULE = "lockstep"
OTHER_SCHEDULE = "regen"
MESH_SCHEDULE = "lockstep"
MESH_OTHER_SCHEDULE = "regen"
FEATURE_SCHEDULE = "regen"
FEATURE_OTHER_SCHEDULE = "lockstep"
MIXED_SCHEDULE = "lockstep"  # kMixedMain in the kernel
_SCHED_CODE = {"lockstep": 1, "regen": 2}  # wave_render's tex/mesh/feat

# The mesh tiers' kernels by name, with their kTri bits in the kernel:
# without UVs (1), the static tier (4); the streamed walk serves the
# resident and the DMA tier alike.
MESH_KINDS = {"mesh": 0, "meshplain": 1, "static": 4, "staticplain": 5}
# the mixed bases' instantiations, one per base tuple (either camera, with
# or without features): sphere clusters with the combined set, the
# combined set with a tier without UVs, sphere clusters with every tier,
# and all three
_NOUV_KINDS = ("meshplain", "staticplain")
MIXED_VARIANTS = ("clustered+textured",
                  *(f"textured+{k}" for k in _NOUV_KINDS),
                  *(f"clustered+{k}" for k in MESH_KINDS),
                  *(f"clustered+textured+{k}" for k in _NOUV_KINDS))

# the kernel's variants, as variant() names them: each base with the
# pinhole and the lens under its main schedule and, as a yardstick, the
# pinhole under the other one (the textured set, the mesh tiers mesh and
# staticplain); then the feature forms of the other bases and their
# yardsticks
VARIANTS = ("brute_pinhole", "brute_lens", "clustered_pinhole",
            "clustered_lens", "textured_pinhole", "textured_lens",
            f"textured_pinhole_{OTHER_SCHEDULE}", "mesh_pinhole", "mesh_lens",
            f"mesh_pinhole_{MESH_OTHER_SCHEDULE}", "feature_pinhole",
            "feature_lens",
            *(f"{k}_{cam}" for k in MESH_KINDS if k != "mesh"
              for cam in ("pinhole", "lens")),
            f"staticplain_pinhole_{MESH_OTHER_SCHEDULE}",
            *(f"feat{k}_{cam}" for k in ("clustered", "textured", *MESH_KINDS)
              for cam in ("pinhole", "lens")),
            f"feattextured_pinhole_{OTHER_SCHEDULE}",
            f"featmesh_pinhole_{MESH_OTHER_SCHEDULE}",
            f"feature_pinhole_{FEATURE_OTHER_SCHEDULE}", *MIXED_VARIANTS)
# the feature variants without a mesh tier carry K4t's walk over a brute
# mesh (at most clusters.CLUSTER_MIN triangles) in instantiations of their
# own, named with K4T_SUFFIX (kTriBrute, K4T_TRI, in the kernel): those
# without it carry no triangle code
K4T_SUFFIX = "_k4t"
K4T_TRI = 8
# intersect_probe's code for the streamed tier with UVs (kProbeStreamUV)
PROBE_STREAM_UV = 16
K4T_VARIANTS = tuple(
    v + K4T_SUFFIX for v in VARIANTS if v.split("_")[0] in (
        "feature", "featclustered", "feattextured", "clustered+textured"))
VARIANTS = VARIANTS + K4T_VARIANTS
LAUNCHES = 0      # kernel launches, counted where the launch succeeds
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)  # the same, by variant
PROBE_LAUNCHES = 0  # intersect_probe_cuda's launches
BUILD_LOG = ""    # nvcc's output (ptxas registers and spills per variant)
BUILD_SECONDS = None  # wall seconds of the build in this process, or None
LIB_PATH = None   # the loaded library (for cuobjdump)

_lib = None

_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
_PTR_FIELDS = (
    "mat_albedo_x", "mat_albedo_y", "mat_albedo_z",
    "mat_emit_x", "mat_emit_y", "mat_emit_z",
    "mat_metal_x", "mat_metal_y", "mat_metal_z",
    "mat_metalness", "mat_roughness", "mat_ior",
    "sph_cx", "sph_cy", "sph_cz", "sph_r", "sph_mat",
    "q_px", "q_py", "q_pz", "q_ux", "q_uy", "q_uz", "q_vx", "q_vy", "q_vz",
    "q_nx", "q_ny", "q_nz", "q_mat",
    "p_nx", "p_ny", "p_nz", "p_d", "p_mat",
    "sum_x", "sum_y", "sum_z", "sq_x", "sq_y", "sq_z", "count",
    "nan_px", "rays_px",
)
# the clustered and thin-lens variants' fields, at the end of the struct
_CLUSTER_PTR_FIELDS = (
    "csph_cx", "csph_cy", "csph_cz", "csph_r", "csph_mat",
    "cl_off", "cl_cnt", "cl_huge",
    "cl_mnx", "cl_mny", "cl_mnz", "cl_mxx", "cl_mxy", "cl_mxz",
)
# the textured variants' fields, after those
_TEX_PTR_FIELDS = ("mat_tex", "tex_tile", "tex_mip")
# the mesh variants' fields, after those
_MESH_PTR_FIELDS = ("mtri_pack", "mtri_uvpack", "stack_words", "stack_w",
                    "stack_h")
# the feature variants' fields, after those
_FEAT_PTR_FIELDS = (
    "tri_ax", "tri_ay", "tri_az", "tri_ux", "tri_uy", "tri_uz",
    "tri_vx", "tri_vy", "tri_vz", "tri_mat",
    "tri_uv0u", "tri_uv0v", "tri_uvdu1", "tri_uvdv1", "tri_uvdu2",
    "tri_uvdv2", "mat_met_idx", "mat_rgh_idx", "mat_nrm_idx",
    "mat_bump_idx", "mat_bump_scale", "mat_transmission", "mat_dispersion",
)
# the static tier's fields, after those
_TIER_PTR_FIELDS = (
    "ctri_nx", "ctri_ny", "ctri_nz", "ctri_d", "ctri_e1x", "ctri_e1y",
    "ctri_e1z", "ctri_a0", "ctri_e2x", "ctri_e2y", "ctri_e2z", "ctri_b0",
    "ctri_mat", "ctri_uv0u", "ctri_uv0v", "ctri_uvdu1", "ctri_uvdv1",
    "ctri_uvdu2", "ctri_uvdv2", "tcl_box", "tcl_range",
)
# the streamed walk's BVH, after those
_BVH_PTR_FIELDS = ("bvh_nodes", "bvh_tris", "bvh_tri_k")
# the sphere clusters' BVH, after those
_SBVH_PTR_FIELDS = ("sbvh_nodes", "sbvh_sph", "sbvh_idx")
# K10's planar table, last
_PLANAR_PTR_FIELDS = ("planar_tile", "planar_meta")
_FEAT_FLOAT_FIELDS = ("fog_sigma_t", "hg_a", "hg_b", "hg_c", "hg_d")
# the launch's pixels and their warp tiles (shard_tiles), after everything
_LANE_FIELDS = ("lane_lo", "lane_hi", "tile_lo", "n_tiles")
# the per-pixel outputs, indexed by pixel: their pointers are offset so that
# a shard's pixel lo lands on its first lane
_ACC_FIELDS = ("sum_x", "sum_y", "sum_z", "sq_x", "sq_y", "sq_z", "count",
               "nan_px", "rays_px")
_INT_PTRS = ("sph_mat", "q_mat", "p_mat", "csph_mat", "cl_off", "cl_cnt",
             "cl_huge", "nan_px", "rays_px", "stack_words",
             "stack_w", "stack_h", "tri_mat", "mat_met_idx", "mat_rgh_idx",
             "mat_nrm_idx", "mat_bump_idx", "ctri_mat", "tcl_range",
             "bvh_tri_k", "sbvh_idx") + _TEX_PTR_FIELDS + _PLANAR_PTR_FIELDS
_INT_FIELDS = (
    "n_spheres", "n_quads", "n_planes", "quad_light",
    "just_cosine", "use_rr",
    "width", "height", "pp", "n_pixels", "s0", "n_samples",
)
_FLOAT_FIELDS = ("width_f", "height_f", "pp_f", "hpw", "hph", "step_x",
                 "step_y", "half_step_x", "half_step_y", "hfw", "hfh")


class WaveParams(ctypes.Structure):
    """Mirror of ``struct WaveParams`` in csrc/wave_kernel.cu."""
    _fields_ = ([(n, _P) for n in _PTR_FIELDS] + [(n, _I) for n in _INT_FIELDS]
                + [("key", ctypes.c_uint32)] + [(n, _F) for n in _FLOAT_FIELDS]
                + [(n, _F * 3) for n in ("fc", "ax", "ay", "pos")]
                + [(n, _P) for n in _CLUSTER_PTR_FIELDS]
                + [("n_clusters", _I), ("aperture", _F), ("lens_d", _F),
                   ("lens_n", _F * 3)]
                + [(n, _P) for n in _TEX_PTR_FIELDS]
                + [(n, _I) for n in ("tex_w", "tex_h", "tex_tiles_x",
                                     "tex_levels", "tex_flags")]
                + [(n, _F) for n in ("tex_half_w", "tex_half_h",
                                     "tex_lod_k")]
                + [(n, _P) for n in _MESH_PTR_FIELDS]
                + [(n, _I) for n in ("stream_rpc", "stack_hmax", "stack_wmax")]
                + [(n, _P) for n in _FEAT_PTR_FIELDS]
                + [("n_tris", _I), ("feat_flags", _I)]
                + [(n, _F) for n in _FEAT_FLOAT_FIELDS]
                + [("fog_albedo", _F * 3)]
                + [(n, _P) for n in _TIER_PTR_FIELDS]
                + [("n_tclusters", _I)]
                + [("cam_lens", _I)]
                + [(n, _P) for n in _BVH_PTR_FIELDS]
                + [("bvh_root", _F * 6)]
                + [(n, _P) for n in _SBVH_PTR_FIELDS]
                + [("sbvh_root", _F * 6), ("n_sph_huge", _I),
                   ("stream_uv_cfm", _I)]
                + [(n, _P) for n in _PLANAR_PTR_FIELDS]
                + [("pp_m", ctypes.c_uint32), ("lens_t0", _F)]
                + [("bvh_far", _F), ("bvh_wide", _F * 2), ("sbvh_far", _F * 8)]
                + [("bvh_apart", _I * 4), ("q_rec", _P)]
                + [("tex_m", ctypes.c_uint32 * 2)]
                + [(n, _I) for n in _LANE_FIELDS])

# WaveParams.tex_flags bits (TEX_* in the kernel)
TEX_METALNESS, TEX_ROUGHNESS, TEX_NORMAL, TEX_TBN = 1, 2, 4, 8
# WaveParams.feat_flags bits (FEAT_* in the kernel)
FEAT_PLANAR, FEAT_BUMP, FEAT_TRANS, FEAT_DISP, FEAT_FOG, FEAT_HG_ISO = (
    1, 2, 4, 8, 16, 32)
FEAT_TRI_UV = 64


def check_supported(scene: Scene, camera: Camera, config):
    """Raise NotImplementedError for an input that neither the kernel nor
    its plain version covers yet, and ValueError for a config that
    ``renderer.render_chunk`` routes elsewhere (``config.on_kernel()``)."""
    config.check_supported()
    if not config.on_kernel():
        raise ValueError(
            f"the kernel renders the regular and variance targets under "
            f"path regeneration without just_importance; render_chunk runs "
            f"debug kind {config.debug_kind!r}, mode {config.mode!r}, "
            f"just_importance={config.just_importance} as torch ops")
    missing = scene.unsupported()
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
    if scene.off_kernel:
        raise NotImplementedError(
            "JAX renders a mesh with the uniform grid, a mesh of more than "
            f"{clusters.DMA_MAX} triangles, a UV mesh or a bump map beside a "
            "combined texture set on XLA only; renderer.render_chunk "
            "renders them as torch ops")


def textured(scene: Scene) -> bool:
    """Whether the scene fetches from a combined texture set."""
    return bool(scene.n_textures and scene.tex_combined)


def meshed(scene: Scene) -> bool:
    """Whether the scene has a mesh of more than ``clusters.CLUSTER_MIN``
    triangles (the mesh variants)."""
    return bool(scene.n_tris and not scene.tri_brute)


def mesh_kind(scene: Scene) -> str:
    """The mesh variants' kind for a meshed scene's tier: the static tier
    (``static``) or the streamed walk, resident or DMA (``mesh``);
    ``plain`` appended for a mesh without UVs."""
    kind = "static" if scene.tri_static else "mesh"
    return kind + ("" if scene.has_mesh_uvs else "plain")


def _parts(scene: Scene) -> list:
    """The bases the scene has, in the kernel's order: ``clustered``
    (sphere clusters), ``textured``, a mesh kind."""
    return ((["clustered"] if scene.sph_clusters else [])
            + (["textured"] if textured(scene) else [])
            + ([mesh_kind(scene)] if meshed(scene) else []))


def mixed(scene: Scene) -> bool:
    """Whether two bases meet in the scene (a ``MIXED_VARIANTS`` base)."""
    return len(_parts(scene)) > 1


def _base(scene: Scene) -> str:
    """The scene's base kind: ``textured``, a mesh kind, ``clustered`` or
    ``brute``; a mixed base's parts joined with "+"."""
    return "+".join(_parts(scene)) or "brute"


def _main_schedule(scene: Scene):
    """The main sample schedule of the scene's variants: the textured,
    mesh or mixed one for those bases, FEATURE_SCHEDULE for the feature
    form of brute or clustered spheres; None for untextured spheres
    without features, which have one schedule."""
    if mixed(scene):
        return MIXED_SCHEDULE
    base = _base(scene)
    if base == "textured":
        return TEXTURED_SCHEDULE
    if base in MESH_KINDS:
        return MESH_SCHEDULE
    return FEATURE_SCHEDULE if scene.featured else None


def _schedule(scene: Scene, schedule):
    """The sample schedule the scene runs under (None: its main one);
    None for a scene with one schedule."""
    main = _main_schedule(scene)
    if main is None:
        return None
    schedule = schedule or main
    if schedule not in _SCHED_CODE:
        raise ValueError(f"schedule {schedule!r}: lockstep or regen")
    return schedule


def variant(scene: Scene, camera: Camera, schedule=None) -> str:
    """The kernel variant that renders this scene through this camera
    under ``schedule`` (by default the scene's main one). A featured scene
    takes its base's feature form: ``feature`` for brute spheres, else
    ``feat`` + the base. A mixed base is its own name: its instantiation
    carries the feature bounce and serves either camera. A scene with a
    brute mesh (``Scene.tri_brute``) takes the form with K4t's walk
    (``K4T_SUFFIX``)."""
    base = _base(scene)
    if "+" in base:
        name = base
    else:
        if scene.featured:
            base = "feature" if base == "brute" else "feat" + base
        name = base + ("_pinhole" if camera.use_pinhole else "_lens")
    schedule = _schedule(scene, schedule)
    if schedule != _main_schedule(scene):
        name += "_" + schedule
    if scene.tri_brute:
        name += K4T_SUFFIX
    if name not in VARIANTS:
        if "+" in base:
            raise NotImplementedError(
                f"{name}: not instantiated (the mixed bases run "
                f"{MIXED_SCHEDULE} only)")
        others = sorted({v.split("_")[0] for v in VARIANTS
                         if v.count("_") == 2
                         and not v.endswith(K4T_SUFFIX)})
        raise NotImplementedError(
            f"{name}: not instantiated (the other schedule runs the pinhole "
            f"only, of {', '.join(others)})")
    return name


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def build_parts(source: str) -> tuple[int, ...]:
    """The kernel source's build parts: the numbers of its
    ``#if WAVE_HAS(n)`` blocks, each compiled with ``-DWAVE_PART=n``."""
    return tuple(sorted({int(n) for n in
                         re.findall(r"^#if WAVE_HAS\((\d+)\)", source,
                                    re.MULTILINE)}))


def compile_library(defines: tuple = ()) -> tuple:
    """Compile the kernel source with ``NVCC_FLAGS`` and ``-D`` each of
    ``defines`` into ``BUILD_DIR`` (one nvcc for each build part, all
    started together, then a link), unless this source and these flags
    were built already, and load it. Returns (the library, its path,
    nvcc's output, the build's wall seconds or None when it was built
    before). Raises on a failed build."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    source = SOURCE.read_bytes()
    tag = hashlib.sha256(source + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libwave_{tag}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = None
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        parts = build_parts(source.decode())
        objs = [tmp.with_name(f"{tmp.name}.part{k}.o") for k in parts]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen(
                [_nvcc(), *flags, f"-DWAVE_PART={k}", "-c", "-o",
                 str(obj), str(SOURCE)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
                for k, obj in zip(parts, objs)]
            log = "".join(proc.communicate()[0] for proc in procs)
            if any(proc.returncode != 0 for proc in procs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                                   *map(str, objs)],
                                  capture_output=True, text=True, check=False)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        log_path.write_text(log + link.stdout + link.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.wave_render.argtypes = [ctypes.POINTER(WaveParams), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wave_render.restype = ctypes.c_int
    lib.wave_occupancy.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.wave_occupancy.restype = ctypes.c_int
    lib.wave_intersect.argtypes = [ctypes.POINTER(WaveParams),
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.wave_intersect.restype = ctypes.c_int
    lib.wave_trig_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.wave_trig_check.restype = ctypes.c_int
    lib.wave_error_string.argtypes = [ctypes.c_int]
    lib.wave_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return lib, lib_path, log, seconds


def build() -> ctypes.CDLL:
    """Compile (if this source and these flags have not been built yet) and
    load the kernel library. Raises on a failed build."""
    global _lib, BUILD_LOG, BUILD_SECONDS, LIB_PATH
    if _lib is not None:
        return _lib
    _lib, LIB_PATH, BUILD_LOG, seconds = compile_library()
    if seconds is not None:
        BUILD_SECONDS = seconds
    return _lib


def shard_tiles(width: int, height: int, lo: int, hi: int) -> tuple:
    """(first tile, count) of the 8x4 warp tiles, in row-major tile order,
    that hold pixels ``lo .. hi-1`` of a ``width`` x ``height`` image
    (y-major): the tiles of one run of a pixel row, else every tile of the
    tile rows from ``lo``'s to ``hi-1``'s; the whole image's are all of
    them. A tile of the run may hold pixels outside the range, which its
    threads skip."""
    tiles_x = (width + 7) >> 3
    y0, y1 = lo // width, (hi - 1) // width
    if y0 == y1:
        first = (y0 >> 2) * tiles_x + ((lo % width) >> 3)
        last = (y0 >> 2) * tiles_x + (((hi - 1) % width) >> 3)
    else:
        first = (y0 >> 2) * tiles_x
        last = (y1 >> 2) * tiles_x + tiles_x - 1
    return first, last - first + 1


def _params(scene: Scene, camera: Camera, config, key: int, s0: int,
            n_samples: int, state, nan_px, rays_px, pixels=None,
            acc_offset: int = 0) -> WaveParams:
    """Pointers and host-folded constants for one launch over ``pixels``
    (lo, hi) of the image (default: all), whose outputs land at lane
    ``pixel + acc_offset`` of ``state``, ``nan_px`` and ``rays_px``."""
    ptrs = dict(zip(_PTR_FIELDS + _CLUSTER_PTR_FIELDS + _TEX_PTR_FIELDS
                    + _MESH_PTR_FIELDS + _FEAT_PTR_FIELDS + _TIER_PTR_FIELDS
                    + _BVH_PTR_FIELDS + _SBVH_PTR_FIELDS
                    + _PLANAR_PTR_FIELDS + ("q_rec",), (
        *scene.mat_albedo, *scene.mat_emit, *scene.mat_metal_color,
        scene.mat_metalness, scene.mat_roughness, scene.mat_ior,
        *scene.sph_center, scene.sph_radius, scene.sph_mat,
        *scene.quad_point, *scene.quad_u, *scene.quad_v, *scene.quad_n,
        scene.quad_mat,
        *scene.pln_n, scene.pln_d, scene.pln_mat,
        *state.sum, *state.sum_sq, state.count, nan_px, rays_px,
        *scene.csph_center, scene.csph_radius, scene.csph_mat,
        scene.cl_offset, scene.cl_count, scene.cl_huge,
        *scene.cl_min, *scene.cl_max,
        scene.mat_albedo_idx, scene.tex_tile, scene.tex_mip,
        scene.mtri_pack, scene.mtri_uvpack,
        scene.tex_packed, scene.tex_w, scene.tex_h,
        *scene.tri_a, *scene.tri_u, *scene.tri_v, scene.tri_mat,
        scene.tri_uv0u, scene.tri_uv0v, scene.tri_uvdu1, scene.tri_uvdv1,
        scene.tri_uvdu2, scene.tri_uvdv2,
        scene.mat_metalness_idx, scene.mat_roughness_idx,
        scene.mat_normal_idx, scene.mat_bump_idx, scene.mat_bump_scale,
        scene.mat_transmission, scene.mat_dispersion,
        *scene.ctri_n, scene.ctri_d, *scene.ctri_e1, scene.ctri_a0,
        *scene.ctri_e2, scene.ctri_b0, scene.ctri_mat,
        scene.ctri_uv0u, scene.ctri_uv0v, scene.ctri_uvdu1, scene.ctri_uvdv1,
        scene.ctri_uvdu2, scene.ctri_uvdv2, scene.tcl_box, scene.tcl_range,
        scene.bvh_nodes, scene.bvh_tris, scene.bvh_tri_k,
        scene.sbvh_nodes, scene.sbvh_sph, scene.sbvh_idx,
        scene.planar_tile, scene.planar_meta, scene.quad_rec,
    )))
    for name, t in ptrs.items():
        want = torch.int32 if name in _INT_PTRS else torch.float32
        if t.device != state.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {want} tensor on "
                             f"{state.device}, got {t.dtype} on {t.device}")
    n = config.width * config.height
    lo, hi = pixels or (0, n)
    if not (0 <= lo < hi <= n and 0 <= lo + acc_offset
            and hi + acc_offset <= state.count.numel()):
        raise ValueError(f"pixels {lo}..{hi - 1} of {n} at lane offset "
                         f"{acc_offset}: outside an accumulator of "
                         f"{state.count.numel()} lanes")
    addr = {k: t.data_ptr() for k, t in ptrs.items()}
    for k in _ACC_FIELDS:
        addr[k] += 4 * acc_offset
    tile_lo, n_tiles = shard_tiles(config.width, config.height, lo, hi)
    pp = config.pp
    hpw, hph = camera.half_film_pixel_w, camera.half_film_pixel_h
    step_x = (1.0 / pp) * hpw * 2.0
    step_y = (1.0 / pp) * hph * 2.0
    lens_n, lens_d = (((0.0, 0.0, 0.0), 0.0) if camera.use_pinhole
                      else focal_plane(camera))
    # lens_d - lens_n . pos, each operand rounded to float as the kernel
    # reads it and each operation rounded once, in the kernel's order
    n32, pos32 = np.float32(lens_n), np.float32(camera.pos)
    lens_t0 = np.float32(lens_d) - ((n32[0] * pos32[0] + n32[1] * pos32[1])
                                    + n32[2] * pos32[2])
    w_tex = scene.tex_comb_w
    mips = bool(config.mip_scale and scene.tex_mip_meta)
    tex_flags = ((TEX_METALNESS if scene.use_metalness_maps else 0)
                 | (TEX_ROUGHNESS if scene.use_roughness_maps else 0)
                 | (TEX_NORMAL if scene.use_normal_maps else 0)
                 | (TEX_TBN if scene.tbn_normal_maps else 0))
    g = scene.fog_g
    feat_flags = ((FEAT_PLANAR if scene.planar_maps else 0)
                  | (FEAT_BUMP if scene.any_bump and scene.n_textures else 0)
                  | (FEAT_TRANS if scene.any_transmissive else 0)
                  | (FEAT_DISP if scene.any_dispersive else 0)
                  | (FEAT_FOG if scene.fog_sigma_t > 0.0 else 0)
                  | (FEAT_HG_ISO if abs(g) < 1e-3 else 0)
                  | (FEAT_TRI_UV if scene.tri_brute and scene.has_mesh_uvs
                     else 0))
    p = WaveParams(
        **addr, lane_lo=lo, lane_hi=hi, tile_lo=tile_lo, n_tiles=n_tiles,
        n_spheres=scene.n_spheres, n_quads=scene.n_quads,
        n_planes=scene.n_planes, quad_light=scene.quad_light,
        n_clusters=len(scene.sph_clusters),
        just_cosine=int(scene.just_cosine),
        use_rr=int(config.use_russian_roulette),
        width=config.width, height=config.height, pp=pp, n_pixels=n,
        s0=s0, n_samples=n_samples, key=int(key) & 0xFFFF_FFFF,
        width_f=float(config.width), height_f=float(config.height),
        pp_f=float(pp), hpw=hpw, hph=hph, step_x=step_x, step_y=step_y,
        half_step_x=0.5 * step_x, half_step_y=0.5 * step_y,
        hfw=camera.half_film_width, hfh=camera.half_film_height,
        aperture=camera.aperture_radius, lens_d=lens_d,
        tex_w=w_tex, tex_h=scene.tex_comb_h, tex_tiles_x=scene.tex_tiles_x,
        tex_levels=len(scene.tex_mip_meta) if mips else 0,
        tex_flags=tex_flags, tex_half_w=w_tex * 0.5,
        tex_half_h=scene.tex_comb_h * 0.5,
        tex_lod_k=float(np.float32(config.mip_scale * w_tex * 0.5)),
        stream_rpc=(stream_rows_per_cluster(scene.stream_leaf)
                    if scene.tri_streamed else 0),
        stack_hmax=scene.tex_hmax, stack_wmax=scene.tex_wmax,
        n_tris=scene.n_tris if scene.tri_brute else 0,
        feat_flags=feat_flags, fog_sigma_t=scene.fog_sigma_t,
        # the phase function's constants, folded in double as JAX folds
        # the static g, each rounded once to float
        hg_a=1.0 - g * g, hg_b=1.0 - g, hg_c=2.0 * g, hg_d=1.0 + g * g,
        n_tclusters=len(scene.tri_clusters),
        # the huge cluster comes first in cluster order
        n_sph_huge=sum(c[1] for c in scene.sph_clusters if c[2] is None),
        stream_uv_cfm=int(scene.stream_uv_cfm),
        pp_m=recip32(pp), lens_t0=float(lens_t0),
        bvh_far=scene.bvh_far,
    )
    p.fc[:] = camera.frustum_center
    p.ax[:] = camera.axis_x
    p.ay[:] = camera.axis_y
    p.pos[:] = camera.pos
    p.lens_n[:] = lens_n
    p.fog_albedo[:] = scene.fog_albedo
    # no mesh BVH (or no triangle outside the static tier's huge cluster),
    # no sphere outside the huge cluster: a NaN root, which no ray enters
    p.bvh_root[:] = scene.bvh_root or (float("nan"),) * 6
    p.sbvh_root[:] = scene.sbvh_root or (float("nan"),) * 6
    p.bvh_wide[:] = scene.bvh_wide
    p.sbvh_far[:] = scene.sbvh_far
    p.bvh_apart[:] = scene.bvh_apart
    # K9's level-0 wraps: a mask, or the size's reciprocal (no division)
    p.tex_m[:] = (planar_recip(scene.tex_comb_w),
                  planar_recip(scene.tex_comb_h))
    return p


def shard_launches(n_pixels: int, lanes) -> list:
    """The launches of one shard, lanes ``lo .. lo+n-1`` of the padded pixel
    order (``lanes`` (lo, n)): ((pixel lo, pixel hi), lane offset) each. The
    image's pixels of the shard in one launch, each at lane ``pixel - lo``;
    then each lane at or past ``n_pixels``, which renders pixel 0 (JAX's
    padding lanes, parallel/shard.py), in a launch of pixel 0 alone at that
    lane."""
    lo, n = lanes
    out = [((lo, min(lo + n, n_pixels)), -lo)] if lo < n_pixels else []
    return out + [((0, 1), j) for j in range(max(n_pixels - lo, 0), n)]


def _moved(p: WaveParams, config, pixels, delta: int) -> WaveParams:
    """``p`` over ``pixels`` (lo, hi), its per-pixel outputs moved by
    ``delta`` lanes: ``p`` itself for the same launch, else a copy."""
    if delta == 0 and (p.lane_lo, p.lane_hi) == pixels:
        return p
    q = WaveParams.from_buffer_copy(p)
    for k in _ACC_FIELDS:
        setattr(q, k, getattr(p, k) + 4 * delta)
    q.lane_lo, q.lane_hi = pixels
    q.tile_lo, q.n_tiles = shard_tiles(config.width, config.height, *pixels)
    return q


def render_chunk_cuda(scene: Scene, camera: Camera, config, key: int,
                      s0: int, n_samples: int, state, lanes=None):
    """Accumulate samples ``s0 .. s0+n_samples-1`` of every pixel into
    ``state`` in place (one kernel launch on CUDA tensors; the plain version
    on CPU tensors). ``lanes`` (lo, n): render only lanes ``lo .. lo+n-1``
    of the padded pixel order, which ``state`` holds (a shard of
    parallel/shard.py; lanes past the image render pixel 0, each in a launch
    of its own: :func:`shard_launches`). ``config.schedule`` picks a
    textured scene's sample schedule. Raises for inputs the kernel does not
    cover."""
    global LAUNCHES
    check_supported(scene, camera, config)
    if state.device.type != "cuda":
        return render_chunk_plain(scene, camera, config, key, s0, n_samples,
                                  state, lanes)
    n_pix = config.width * config.height
    lanes = lanes or (0, n_pix)
    if state.count.numel() != lanes[1]:
        raise ValueError(f"accumulator holds {state.count.numel()} lanes, "
                         f"the shard {lanes[1]}")
    nan_px = torch.zeros(lanes[1], dtype=torch.int32, device=state.device)
    rays_px = torch.zeros(lanes[1], dtype=torch.int32, device=state.device)
    name = variant(scene, camera, config.schedule)
    code = _SCHED_CODE.get(_schedule(scene, config.schedule), 0)
    lib = build()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    launches = shard_launches(n_pix, lanes)
    first = _params(scene, camera, config, key, s0, n_samples, state,
                    nan_px, rays_px, *launches[0])
    for pixels, offset in launches:
        params = _moved(first, config, pixels, offset - launches[0][1])
        err = lib.wave_render(ctypes.byref(params),
                              int(bool(scene.sph_clusters)),
                              int(not camera.use_pinhole),
                              code if textured(scene) else 0,
                              code if meshed(scene) else 0,
                              code if scene.featured or mixed(scene) else 0,
                              MESH_KINDS[mesh_kind(scene)] if meshed(scene)
                              else K4T_TRI if scene.tri_brute else 0,
                              ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"wave_kernel ({name}) launch failed: "
                               + lib.wave_error_string(err).decode())
        LAUNCHES += 1
        VARIANT_LAUNCHES[name] += 1
    state.nan_count += nan_px.sum(dtype=torch.int64)
    state.rays_cast += rays_px.sum(dtype=torch.int64)
    state.samples_done += n_samples
    return state


def intersect_probe_cuda(scene: Scene, rays: torch.Tensor):
    """The kernel's ``intersect_scene`` as the scene's variants run it
    (brute spheres or the sphere clusters' walk, quads, planes, then K4t's
    walk as ``feature_pinhole_k4t`` runs it, the static tier's walk or
    K7's) for
    ``rays`` ((N, 6) float32: o.xyz d.xyz): (t, material, normal (N, 3),
    uvx, uvy, uv_ok). On CUDA tensors one launch of the kernel's probe; on
    CPU tensors the plain version (:func:`intersect_probe_plain`).
    ``chip_smoke.py`` holds the one to the other on the card on rays aimed
    at a mesh's edges and vertices and on rays from far away; no render
    calls it."""
    global PROBE_LAUNCHES
    from .renderer import RenderConfig, init_accum
    if (textured(scene) or rays.dtype != torch.float32
            or rays.dim() != 2 or rays.shape[1] != 6):
        raise ValueError("the probe takes (N, 6) float32 rays and a scene "
                         "of spheres (brute or clustered), quads, planes and "
                         "a mesh of any tier")
    if rays.device.type != "cuda":
        return intersect_probe_plain(scene, rays)
    rays = rays.contiguous()
    cam = define_camera((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, 1, 1)
    state = init_accum(1, rays.device)
    px = torch.zeros(1, dtype=torch.int32, device=rays.device)
    params = _params(scene, cam, RenderConfig(1, 1, pp=1), 0, 0, 0, state,
                     px, px.clone())
    out = torch.empty((len(rays), 8), dtype=torch.float32, device=rays.device)
    tri = (K4T_TRI if scene.tri_brute else 0 if not meshed(scene)
           else PROBE_STREAM_UV if mesh_kind(scene) == "mesh"
           else MESH_KINDS[mesh_kind(scene)])
    err = build().wave_intersect(
        ctypes.byref(params), rays.data_ptr(), len(rays), out.data_ptr(),
        int(bool(scene.sph_clusters)), tri,
        ctypes.c_void_p(torch.cuda.current_stream(rays.device).cuda_stream))
    if err != 0:
        raise RuntimeError("intersect_probe launch failed: "
                           + build().wave_error_string(err).decode())
    PROBE_LAUNCHES += 1
    return (out[:, 0], out[:, 1].contiguous().view(torch.int32), out[:, 2:5],
            out[:, 5], out[:, 6], out[:, 7] != 0)


def trig_check_cuda(device="cuda") -> int:
    """The kernel's shade trig (``sincos_2pi``) against ``sinf``/``cosf`` on
    every u1 its draws give (2^24 values), on the card: the count of inputs
    where a bit differs. ``chip_smoke.py`` requires 0; no render calls
    it."""
    bad = torch.zeros(1, dtype=torch.int32, device=device)
    err = build().wave_trig_check(
        bad.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(bad.device).cuda_stream))
    if err != 0:
        raise RuntimeError("trig_check launch failed: "
                           + build().wave_error_string(err).decode())
    return int(bad.item())


def intersect_probe_plain(scene: Scene, rays: torch.Tensor):
    """The plain version of :func:`intersect_probe_cuda` on whatever device
    ``rays`` lie: ``ops/intersect.py::intersect_scene_uv`` for a mesh with
    UVs, else ``intersect_scene`` (uv 0, uv_ok False): the sphere clusters
    by the table-order walk, K4t by its sweep, the static tier by its
    table-order walk."""
    from ..ops import intersect
    from ..utils.vec import Vec3
    o, d = Vec3(*rays[:, 0:3].T), Vec3(*rays[:, 3:6].T)
    if scene.has_mesh_uvs:
        hit, uvx, uvy, ok = intersect.intersect_scene_uv(scene, o, d)
    else:
        hit = intersect.intersect_scene(scene, o, d)
        uvx = uvy = torch.zeros_like(hit.t)
        ok = torch.zeros_like(hit.t, dtype=torch.bool)
    return hit.t, hit.mat, torch.stack(list(hit.normal), 1), uvx, uvy, ok


def render_chunk_plain(scene: Scene, camera: Camera, config, key: int,
                       s0: int, n_samples: int, state, lanes=None):
    """The plain PyTorch version of :func:`render_chunk_cuda`, on whatever
    device the tensors live: the lockstep loop for a scene under the
    lockstep schedule, path regeneration otherwise (``lanes``: its)."""
    check_supported(scene, camera, config)
    variant(scene, camera, config.schedule)  # raises without an instantiation
    pixel_idx = lane_pixels(config, lanes, state.device)
    run = (render_chunk_lockstep
           if _schedule(scene, config.schedule) == "lockstep"
           else render_chunk_wavefront)
    run(scene, camera, config, int(key) & 0xFFFF_FFFF, s0, n_samples, state,
        pixel_idx)
    state.samples_done += n_samples
    return state
