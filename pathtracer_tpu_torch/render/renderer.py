"""Renderer: sample accumulation, tonemap, packing (the RenderTexel role).

Counterpart of ``pathtracer_tpu/render/renderer.py``. The accumulator holds
per-pixel (sum, sum of squares, valid count) plus the NaN-sample and ray
counters; NaN samples are masked and counted instead of resampled. The
accumulator is the checkpoint: ``samples_done`` records how many whole-image
samples it holds, and the counter-based PRNG regenerates the rest exactly.

``render_chunk`` dispatches on the device of the accumulator: CUDA tensors
launch the hand-written kernel (``cuda_backend.render_chunk_cuda``), CPU
tensors run its plain version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..scene.camera import Camera
from ..scene.schema import Scene
from ..utils.color import bgra_pack, tonemap_aces
from ..utils.vec import Vec3, to_stacked
from . import cuda_backend
from .integrator import REGULAR, VARIANCE


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    pp: int = 4                  # sqrt(rays per pixel), g_pp (win32_main.cpp:2112)
    seed: int = 0
    # regular or variance; the other debug kinds need the unrolled driver
    debug_kind: str = REGULAR
    use_russian_roulette: bool = False
    denoise: int = 0             # a-trous iterations: ROADMAP queue 1 item 11
    # texels per pixel at unit distance for --mips (0 = mip 0 everywhere,
    # the reference's sampling); the CLI sets it for a scene with a pyramid
    mip_scale: float = 0.0
    # sample schedule of a textured scene's kernel, "lockstep" or "regen"
    # (None: cuda_backend.TEXTURED_SCHEDULE, the faster one on the H100)
    schedule: Optional[str] = None

    @property
    def spp(self) -> int:
        return self.pp * self.pp

    def check_supported(self):
        if self.debug_kind not in (REGULAR, VARIANCE):
            raise NotImplementedError(
                f"debug kind {self.debug_kind!r}: the unrolled trace driver "
                "is not ported yet (ROADMAP queue 1 item 5)")
        if self.denoise:
            raise NotImplementedError(
                "the a-trous denoiser is not ported yet (ROADMAP queue 1 "
                "item 11)")


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


def render_chunk(scene: Scene, camera: Camera, config: RenderConfig,
                 key: int, s0: int, n_samples: int,
                 state: AccumState) -> AccumState:
    """Accumulate sample indices ``s0 .. s0+n_samples-1`` of every pixel into
    ``state`` (in place; also returned). Runs where the tensors live."""
    if scene.device != state.device:
        raise ValueError(f"scene on {scene.device}, accumulator on "
                         f"{state.device}")
    if state.device.type == "cuda":
        return cuda_backend.render_chunk_cuda(scene, camera, config, key, s0,
                                              n_samples, state)
    return cuda_backend.render_chunk_plain(scene, camera, config, key, s0,
                                           n_samples, state)


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
    tonemap only for the regular target."""
    config.check_supported()
    mean = _pixel_value(state, config)
    if config.debug_kind == REGULAR:
        mean = tonemap_aces(mean)
    return bgra_pack(mean).reshape(config.height, config.width)


def render_image(scene: Scene, camera: Camera, config: RenderConfig,
                 chunk_samples: Optional[int] = None,
                 state: Optional[AccumState] = None,
                 progress_cb=None, device="cuda",
                 ) -> Tuple[torch.Tensor, torch.Tensor, AccumState]:
    """Full render on ``device``: (linear image (H,W,3), packed BGRA (H,W),
    state). ``chunk_samples`` bounds the samples per ``render_chunk`` call
    (default: all); a given ``state`` resumes exactly where it stopped."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_image(device='cuda'): no CUDA device is "
                           "available")
    scene = scene.to(device)
    total = config.spp
    chunk = min(chunk_samples or total, total)
    state = (init_accum(config.width * config.height, device) if state is None
             else state.to(device))
    s0 = state.samples_done
    while s0 < total:
        n = min(chunk, total - s0)
        state = render_chunk(scene, camera, config, config.seed, s0, n, state)
        s0 += n
        if progress_cb is not None:
            progress_cb(s0, total, state)
    return resolve(state, config), finalize(state, config), state
