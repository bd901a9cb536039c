"""The hand-written CUDA render kernel: build, binding, wrapper, plain version.

``csrc/wave_kernel.cu`` is the Hopper counterpart of the JAX package's one
Pallas kernel, ``render/pallas_backend.py::render_chunk_pallas`` with its
path-regeneration loop ``_wave_loop`` (K2) and its bounce-lockstep loop
``_lockstep_loop`` (K3). Its compile-time variants (``VARIANTS``) are the
instantiations of one kernel template: untextured, the brute sphere sweep
or the clustered walk (K5/K6), each with the pinhole or the thin-lens
primary ray; textured (the combined 4-map set, K9), the brute sweep with
either primary under ``TEXTURED_SCHEDULE``, and the pinhole under the
other schedule as its yardstick. The file is compiled at first use by one
``nvcc`` for ``sm_90a`` into ``pathtracer_tpu_torch/_build/`` (a library
named by the hash of the source and flags, so an edit rebuilds it), loaded
with ``ctypes`` and launched on PyTorch's current stream.

- :func:`render_chunk_cuda` takes the accumulator's device: on CUDA tensors
  it launches the kernel or raises; on CPU tensors it runs the plain version.
  It picks the variant from the scene and camera (:func:`variant`): the
  textured kernel for a combined texture set, else the clustered walk when
  the scene has sphere clusters; the thin-lens primary when the camera has
  one.
- :func:`render_chunk_plain` is the plain PyTorch version of the same
  function (``render/lockstep.py`` for the textured lockstep schedule,
  ``render/wavefront.py`` otherwise), which the CPU tests run and which
  ``chip_smoke.py`` holds the kernel against on the card.
- ``LAUNCHES`` counts the kernel's launches, ``VARIANT_LAUNCHES`` the same
  launches by variant name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..scene.camera import Camera
from ..scene.schema import Scene
from .lockstep import render_chunk_lockstep
from .raygen import focal_plane
from .wavefront import render_chunk_wavefront

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "wave_kernel.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# The sample schedule of the textured variants (world 1's main path), and
# the other one, instantiated for the pinhole only, as its yardstick.
TEXTURED_SCHEDULE = "lockstep"
OTHER_SCHEDULE = "regen"
_TEX_CODE = {"lockstep": 1, "regen": 2}  # wave_render's tex argument

# the kernel's variants, as variant() names them
VARIANTS = ("brute_pinhole", "brute_lens", "clustered_pinhole",
            "clustered_lens", "textured_pinhole", "textured_lens",
            f"textured_pinhole_{OTHER_SCHEDULE}")
LAUNCHES = 0      # kernel launches, counted where the launch succeeds
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)  # the same, by variant
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
_INT_PTRS = ("sph_mat", "q_mat", "p_mat", "csph_mat", "cl_off", "cl_cnt",
             "cl_huge", "nan_px", "rays_px") + _TEX_PTR_FIELDS
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
                                     "tex_lod_k")])

# WaveParams.tex_flags bits (TEX_* in the kernel)
TEX_METALNESS, TEX_ROUGHNESS, TEX_NORMAL, TEX_TBN = 1, 2, 4, 8


def check_supported(scene: Scene, camera: Camera, config):
    """Raise NotImplementedError for an input that neither the kernel nor
    its plain version covers yet."""
    config.check_supported()
    missing = scene.unsupported()
    if textured(scene) and scene.sph_clusters:
        missing.append("a textured scene with sphere clusters (ROADMAP "
                       "queue 2 item 1)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def textured(scene: Scene) -> bool:
    """Whether the scene fetches from a combined texture set."""
    return bool(scene.n_textures and scene.tex_combined)


def _schedule(scene: Scene, schedule):
    """The sample schedule of a textured scene (None: TEXTURED_SCHEDULE);
    None for an untextured one, which has one schedule."""
    if not textured(scene):
        return None
    schedule = schedule or TEXTURED_SCHEDULE
    if schedule not in _TEX_CODE:
        raise ValueError(f"schedule {schedule!r}: lockstep or regen")
    return schedule


def variant(scene: Scene, camera: Camera, schedule=None) -> str:
    """The kernel variant that renders this scene through this camera (a
    textured scene under ``schedule``, by default TEXTURED_SCHEDULE)."""
    lens = "_pinhole" if camera.use_pinhole else "_lens"
    schedule = _schedule(scene, schedule)
    if schedule is None:
        return ("clustered" if scene.sph_clusters else "brute") + lens
    name = "textured" + lens
    if schedule != TEXTURED_SCHEDULE:
        name += "_" + schedule
    if name not in VARIANTS:
        raise NotImplementedError(f"{name}: the {schedule} schedule is "
                                  "instantiated for the pinhole only")
    return name


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def build() -> ctypes.CDLL:
    """Compile (if this source and these flags have not been built yet) and
    load the kernel library. Raises on a failed build."""
    global _lib, BUILD_LOG, BUILD_SECONDS, LIB_PATH
    if _lib is not None:
        return _lib
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libwave_{tag}.so"
    log_path = lib_path.with_suffix(".log")
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, check=False)
        BUILD_SECONDS = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    BUILD_LOG = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    LIB_PATH = lib_path
    lib.wave_render.argtypes = [ctypes.POINTER(WaveParams), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wave_render.restype = ctypes.c_int
    lib.wave_error_string.argtypes = [ctypes.c_int]
    lib.wave_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _params(scene: Scene, camera: Camera, config, key: int, s0: int,
            n_samples: int, state, nan_px, rays_px) -> WaveParams:
    """Pointers and host-folded constants for one launch."""
    ptrs = dict(zip(_PTR_FIELDS + _CLUSTER_PTR_FIELDS + _TEX_PTR_FIELDS, (
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
    )))
    for name, t in ptrs.items():
        want = torch.int32 if name in _INT_PTRS else torch.float32
        if t.device != state.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {want} tensor on "
                             f"{state.device}, got {t.dtype} on {t.device}")
    n = config.width * config.height
    if state.count.numel() != n:
        raise ValueError(f"accumulator holds {state.count.numel()} pixels, "
                         f"the image {n}")
    pp = config.pp
    hpw, hph = camera.half_film_pixel_w, camera.half_film_pixel_h
    step_x = (1.0 / pp) * hpw * 2.0
    step_y = (1.0 / pp) * hph * 2.0
    lens_n, lens_d = (((0.0, 0.0, 0.0), 0.0) if camera.use_pinhole
                      else focal_plane(camera))
    w_tex = scene.tex_comb_w
    mips = bool(config.mip_scale and scene.tex_mip_meta)
    tex_flags = ((TEX_METALNESS if scene.use_metalness_maps else 0)
                 | (TEX_ROUGHNESS if scene.use_roughness_maps else 0)
                 | (TEX_NORMAL if scene.use_normal_maps else 0)
                 | (TEX_TBN if scene.tbn_normal_maps else 0))
    p = WaveParams(
        **{k: t.data_ptr() for k, t in ptrs.items()},
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
    )
    p.fc[:] = camera.frustum_center
    p.ax[:] = camera.axis_x
    p.ay[:] = camera.axis_y
    p.pos[:] = camera.pos
    p.lens_n[:] = lens_n
    return p


def render_chunk_cuda(scene: Scene, camera: Camera, config, key: int,
                      s0: int, n_samples: int, state):
    """Accumulate samples ``s0 .. s0+n_samples-1`` of every pixel into
    ``state`` in place (one kernel launch on CUDA tensors; the plain version
    on CPU tensors). ``config.schedule`` picks a textured scene's sample
    schedule. Raises for inputs the kernel does not cover."""
    global LAUNCHES
    check_supported(scene, camera, config)
    if state.device.type != "cuda":
        return render_chunk_plain(scene, camera, config, key, s0, n_samples,
                                  state)
    n = config.width * config.height
    nan_px = torch.zeros(n, dtype=torch.int32, device=state.device)
    rays_px = torch.zeros(n, dtype=torch.int32, device=state.device)
    params = _params(scene, camera, config, key, s0, n_samples, state,
                     nan_px, rays_px)
    name = variant(scene, camera, config.schedule)
    sched = _schedule(scene, config.schedule)
    lib = build()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.wave_render(ctypes.byref(params), int(bool(scene.sph_clusters)),
                          int(not camera.use_pinhole),
                          _TEX_CODE[sched] if sched else 0,
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


def render_chunk_plain(scene: Scene, camera: Camera, config, key: int,
                       s0: int, n_samples: int, state):
    """The plain PyTorch version of :func:`render_chunk_cuda`, on whatever
    device the tensors live: the lockstep loop for a textured scene under
    the lockstep schedule, path regeneration otherwise."""
    check_supported(scene, camera, config)
    variant(scene, camera, config.schedule)  # raises without an instantiation
    pixel_idx = torch.arange(config.width * config.height, device=state.device)
    run = (render_chunk_lockstep
           if _schedule(scene, config.schedule) == "lockstep"
           else render_chunk_wavefront)
    run(scene, camera, config, int(key) & 0xFFFF_FFFF, s0, n_samples, state,
        pixel_idx)
    state.samples_done += n_samples
    return state
