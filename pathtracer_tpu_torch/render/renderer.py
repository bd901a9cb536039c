"""Renderer: sample accumulation, tonemap, packing (the RenderTexel role).

Counterpart of ``pathtracer_tpu/render/renderer.py``. The accumulator holds
per-pixel (sum, sum of squares, valid count) plus the NaN-sample and ray
counters; NaN samples are masked and counted instead of resampled. The
accumulator is the checkpoint: ``samples_done`` records how many whole-image
samples it holds, and the counter-based PRNG regenerates the rest exactly.

``render_chunk`` routes by the scene and the config as JAX's does (its
kernel takes the regular and variance targets of the scenes its
``supports`` admits, the rest run on XLA; :func:`kernel_renders`): under
``mode`` auto or wavefront the regular and variance targets go to the
hand-written kernel on CUDA tensors (``cuda_backend.render_chunk_cuda``)
and to its plain version on CPU tensors; a scene JAX renders on XLA only
(``Scene.off_kernel``: a mesh with the uniform grid, a mesh above
``clusters.DMA_MAX`` triangles, a UV mesh or a bump map beside a combined
texture set) and ``just_importance`` under wavefront go to the plain
path-regeneration loop (``render/wavefront.py``); every other debug kind,
and ``mode="unrolled"``, to the unrolled driver (``integrator.trace``,
one sample at a time, :func:`_one_sample`), both as torch ops on the
tensors' device. The route is decided before anything runs: a kernel
that fails to build or launch raises, and nothing falls back from one
route to another.

``finalize`` denoises (``config.denoise``), applies ``config.exposure``
and tonemaps the regular target, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from ..scene.camera import Camera
from ..scene.schema import Scene
from ..utils.color import bgra_pack, tonemap_aces
from ..utils import prng
from ..utils.vec import Vec3, to_stacked
from . import cuda_backend
from .integrator import DEBUG_KINDS, REGULAR, VARIANCE, trace
from .wavefront import _primary_rays, lane_pixels, render_chunk_wavefront

MODES = ("auto", "unrolled", "wavefront")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """A render's settings. JAX's ``backend`` (the Pallas kernel, XLA or
    the interpreter) and ``bounce_fori`` (the lockstep kernel's bounce-loop
    form) are TPU choices and have no counterpart: the route follows from
    the tensors' device and the config (``render_chunk``)."""
    width: int = 1280
    height: int = 720
    pp: int = 4                  # sqrt(rays per pixel), g_pp (win32_main.cpp:2112)
    seed: int = 0
    debug_kind: str = REGULAR    # one of integrator.DEBUG_KINDS
    # the diffuse estimator samples the light only (px = PdfLight)
    just_importance: bool = False
    use_russian_roulette: bool = False
    # "auto": path regeneration (the kernel) for regular and variance, the
    # unrolled driver otherwise; "unrolled" or "wavefront" force a driver
    mode: str = "auto"
    # linear exposure multiplier before the tonemap (1.0: the reference's)
    exposure: float = 1.0
    # a-trous iterations on the linear image before the tonemap (0: none)
    denoise: int = 0
    # texels per pixel at unit distance for --mips (0 = mip 0 everywhere,
    # the reference's sampling); the CLI sets it for a scene with a pyramid
    mip_scale: float = 0.0
    # sample schedule of a textured scene's kernel, "lockstep" or "regen"
    # (None: cuda_backend.TEXTURED_SCHEDULE, the faster one on the H100)
    schedule: Optional[str] = None

    @property
    def spp(self) -> int:
        return self.pp * self.pp

    def resolved_mode(self) -> str:
        if self.mode != "auto":
            return self.mode
        return ("wavefront" if self.debug_kind in (REGULAR, VARIANCE)
                else "unrolled")

    def on_kernel(self) -> bool:
        """Whether the kernel (or its plain version) renders this config:
        the regular and variance targets under path regeneration, without
        ``just_importance`` (JAX's ``pallas_backend.supports``)."""
        return (self.resolved_mode() == "wavefront"
                and self.debug_kind in (REGULAR, VARIANCE)
                and not self.just_importance)

    def check_supported(self):
        if self.debug_kind not in DEBUG_KINDS:
            raise ValueError(f"debug kind {self.debug_kind!r}: not one of "
                             f"{DEBUG_KINDS}")
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}: not one of {MODES}")


@dataclasses.dataclass
class AccumState:
    """Progressive accumulator; its tensors are updated in place."""
    sum: Vec3                  # per-pixel radiance sum over valid samples
    sum_sq: Vec3               # per-pixel sum of squares
    count: torch.Tensor        # per-pixel valid (non-NaN) sample count, f32
    nan_count: torch.Tensor    # int64 scalar: NaN samples masked
    rays_cast: torch.Tensor    # int64 scalar: rays traced (exact)
    samples_done: int = 0      # whole-image samples folded in

    @property
    def device(self) -> torch.device:
        return self.count.device

    def to(self, device) -> "AccumState":
        mv = lambda t: t.to(device).contiguous()
        return AccumState(Vec3(*map(mv, self.sum)), Vec3(*map(mv, self.sum_sq)),
                          mv(self.count), mv(self.nan_count),
                          mv(self.rays_cast), self.samples_done)


def init_accum(n_pixels: int, device="cpu") -> AccumState:
    z = lambda: torch.zeros((n_pixels,), dtype=torch.float32, device=device)
    zi = lambda: torch.zeros((), dtype=torch.int64, device=device)
    return AccumState(Vec3(z(), z(), z()), Vec3(z(), z(), z()), z(), zi(), zi())


def _one_sample(scene: Scene, camera: Camera, config: RenderConfig,
                key: int, s: int, state: AccumState,
                pixel_idx: Optional[torch.Tensor] = None) -> AccumState:
    """Trace sample ``s`` of every pixel (or of ``pixel_idx``, one a lane
    of ``state``) through the unrolled driver and fold it into ``state`` in
    place, NaN samples masked and counted (JAX's ``renderer._one_sample``)."""
    if pixel_idx is None:
        pixel_idx = lane_pixels(config, None, state.device)
    key = int(key) & 0xFFFF_FFFF
    s_lane = torch.full_like(pixel_idx, s)
    o, d = _primary_rays(camera, config, key, pixel_idx, s_lane)
    radiance, stats = trace(scene, o, d, prng.path_keys(key, pixel_idx, s),
                            debug_kind=config.debug_kind,
                            just_importance=config.just_importance,
                            use_russian_roulette=config.use_russian_roulette,
                            mip_scale=config.mip_scale)
    bad = (torch.isnan(radiance.x) | torch.isnan(radiance.y)
           | torch.isnan(radiance.z))
    ok = ~bad
    for acc, sq, c in zip(state.sum, state.sum_sq, radiance):
        r = torch.where(ok, c, 0.0)
        acc += r
        sq += r * r
    state.count += ok.to(torch.float32)
    state.nan_count += bad.sum()
    state.rays_cast += stats.rays_cast
    state.samples_done += 1
    return state


def kernel_renders(scene: Scene, config: RenderConfig) -> bool:
    """Whether the kernel (or its plain version) renders this scene under
    this config: ``config.on_kernel()``, but for the scenes that the four
    clauses of JAX's ``supports`` send to XLA (pallas_backend.py:140-167,
    ``Scene.off_kernel``). The scenes JAX's kernel refuses for the TPU's
    sake (more than 1024 spheres, quads or planes, stacks that do not
    tile) stay on the port's kernel."""
    return config.on_kernel() and not scene.off_kernel


def render_chunk(scene: Scene, camera: Camera, config: RenderConfig,
                 key: int, s0: int, n_samples: int,
                 state: AccumState, lanes=None) -> AccumState:
    """Accumulate sample indices ``s0 .. s0+n_samples-1`` of every pixel into
    ``state`` (in place; also returned). Runs where the tensors live, on
    the route the config picks (see the module's docstring). ``lanes`` (lo,
    n): only lanes ``lo .. lo+n-1`` of the padded pixel order, which
    ``state`` holds, a lane at or past ``width*height`` rendering pixel 0
    (one device's shard, parallel/shard.py; ``wavefront.lane_pixels``)."""
    if scene.device != state.device:
        raise ValueError(f"scene on {scene.device}, accumulator on "
                         f"{state.device}")
    config.check_supported()
    if kernel_renders(scene, config):
        if state.device.type == "cuda":
            return cuda_backend.render_chunk_cuda(scene, camera, config, key,
                                                  s0, n_samples, state, lanes)
        return cuda_backend.render_chunk_plain(scene, camera, config, key,
                                               s0, n_samples, state, lanes)
    pixel_idx = lane_pixels(config, lanes, state.device)
    if config.resolved_mode() == "wavefront":
        # JAX's XLA wavefront driver: a scene off the kernel,
        # just_importance, or a debug kind forced onto it (which then
        # renders the regular radiance)
        render_chunk_wavefront(
            scene, camera, config, int(key) & 0xFFFF_FFFF, s0, n_samples,
            state, pixel_idx)
        state.samples_done += n_samples
        return state
    for k in range(n_samples):
        _one_sample(scene, camera, config, key, s0 + k, state, pixel_idx)
    return state


def _pixel_value(state: AccumState, config: RenderConfig) -> Vec3:
    """Mean radiance, or the biased per-sample variance for the variance
    target (win32_main.cpp:1076-1082)."""
    cnt = torch.clamp_min(state.count, 1.0)
    mean = Vec3(state.sum.x / cnt, state.sum.y / cnt, state.sum.z / cnt)
    if config.debug_kind == VARIANCE:
        mean = Vec3(state.sum_sq.x / cnt - mean.x * mean.x,
                    state.sum_sq.y / cnt - mean.y * mean.y,
                    state.sum_sq.z / cnt - mean.z * mean.z)
    return mean


def resolve(state: AccumState, config: RenderConfig) -> torch.Tensor:
    """Accumulator -> (H, W, 3) float32 linear image."""
    return to_stacked(_pixel_value(state, config)).reshape(
        config.height, config.width, 3)


def finalize(state: AccumState, config: RenderConfig) -> torch.Tensor:
    """Accumulator -> (H, W) packed BGRA (int64 holding uint32), the
    reference's pixel pipeline: ACES -> sRGB -> x255 -> pack, with the
    tonemap only for the regular target; before it, with ``config.denoise``
    > 0, the variance-guided a-trous filter on the linear image
    (render/denoise.py), then ``config.exposure``."""
    config.check_supported()
    mean = _pixel_value(state, config)
    if config.debug_kind == REGULAR:
        if config.denoise > 0:
            from .denoise import accum_variance, atrous_denoise
            img = to_stacked(mean).reshape(config.height, config.width, 3)
            img = atrous_denoise(img, accum_variance(state, config),
                                 iterations=config.denoise)
            flat = img.reshape(-1, 3)
            mean = Vec3(flat[:, 0], flat[:, 1], flat[:, 2])
        if config.exposure != 1.0:
            mean = mean * config.exposure
        mean = tonemap_aces(mean)
    return bgra_pack(mean).reshape(config.height, config.width)


def render_image(scene: Scene, camera: Camera, config: RenderConfig,
                 chunk_samples: Optional[int] = None,
                 state: Optional[AccumState] = None,
                 progress_cb=None, device="cuda",
                 adapt_chunk_s: Optional[float] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, AccumState]:
    """Full render on ``device``: (linear image (H,W,3), packed BGRA (H,W),
    state). ``chunk_samples`` bounds the samples per ``render_chunk`` call
    (default: all); a given ``state`` resumes exactly where it stopped.

    ``adapt_chunk_s`` (the ``--live`` cadence): target seconds between
    progress callbacks. When a chunk overshoots it by half, the chunk
    halves (power-of-two steps); the first chunk's time, which carries any
    first-use kernel build, is ignored. Chunking is exact: the same
    samples, the same sums."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_image(device='cuda'): no CUDA device is "
                           "available")
    config.check_supported()
    scene = scene.to(device)
    total = config.spp
    chunk = min(chunk_samples or total, total)
    state = (init_accum(config.width * config.height, device) if state is None
             else state.to(device))
    s0 = state.samples_done
    first = True
    while s0 < total:
        n = min(chunk, total - s0)
        t0 = time.perf_counter()
        state = render_chunk(scene, camera, config, config.seed, s0, n, state)
        s0 += n
        if adapt_chunk_s and s0 < total:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if first:
                first = False
            else:
                while chunk > 1 and dt > adapt_chunk_s * 1.5:
                    chunk //= 2
                    dt /= 2.0
        if progress_cb is not None:
            progress_cb(s0, total, state)
    return resolve(state, config), finalize(state, config), state
