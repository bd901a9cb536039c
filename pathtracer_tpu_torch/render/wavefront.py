"""Path-regeneration driver in eager torch: the plain version of the kernel.

Counterpart of ``pathtracer_tpu/render/wavefront.py``. Each lane owns one
pixel; when its path ends it folds the path radiance into the accumulator
and regenerates the primary ray of the same pixel's next sample. The loop
runs until every lane has spent its sample budget. Randomness is a pure
function of (pixel, sample, bounce), so the result does not depend on how
lanes interleave: ``csrc/wave_kernel.cu`` runs each pixel's paths in one
thread and must agree with this function. Every live lane draws both PCG4D
blocks of its bounce, so Russian roulette (u[4]), the fog's free flight
(u[5]) and dispersion's channel (u[6]) read one set of draws, sky and light
hits included.

The accumulator tensors are updated in place.
"""

from __future__ import annotations

import torch

from ..ops.intersect import intersect_scene, intersect_scene_uv
from ..scene.camera import Camera
from ..scene.schema import MAX_BOUNCE_COUNT, Scene
from ..utils import prng
from ..utils.vec import Vec3, hadamard, splat, where as vwhere
from . import raygen
from .integrator import russian_roulette, shade_bounce


def intersect(scene: Scene, o: Vec3, d: Vec3):
    """(hit, uv): ``intersect_scene_uv``'s hit and (uvx, uvy, uv_ok) in a
    mesh-UV scene, else ``intersect_scene``'s hit and None (wavefront.py:
    115-120 in JAX)."""
    if scene.has_mesh_uvs:
        hit, uvx, uvy, uv_ok = intersect_scene_uv(scene, o, d)
        return hit, (uvx, uvy, uv_ok)
    return intersect_scene(scene, o, d), None


def _primary_rays(camera: Camera, config, key: int,
                  pixel_idx: torch.Tensor, s: torch.Tensor):
    """Primary rays (pinhole or thin lens) for per-lane sample indices
    ``s``: stratum / ray indices (s // pp, s % pp)."""
    i = torch.div(s, config.pp, rounding_mode="floor")
    j = torch.remainder(s, config.pp)
    if camera.use_pinhole:
        jit_u = prng.jitter_uniforms(prng.path_keys(key, pixel_idx, s))
        return raygen.pinhole_rays(camera, config.width, config.height,
                                   config.pp, i, j, jit_u, pixel_idx)
    lens_u = prng.lens_uniforms(prng.path_keys(key, pixel_idx, i))
    return raygen.thin_lens_rays(camera, config.width, config.height,
                                 config.pp, i, j, lens_u, pixel_idx)


def render_chunk_wavefront(scene: Scene, camera: Camera, config, key: int,
                           s0: int, n_samples: int, state,
                           pixel_idx: torch.Tensor):
    """Accumulate ``n_samples`` samples per pixel (sample indices
    ``s0 .. s0+n_samples-1``) into ``state`` with path regeneration."""
    z = torch.zeros_like(pixel_idx, dtype=torch.float32)
    s_rel = torch.zeros_like(pixel_idx, dtype=torch.int64)
    bounce = torch.zeros_like(pixel_idx, dtype=torch.int64)
    o, d = Vec3(z, z, z), Vec3(z, z, z + 1.0)
    thr, prad = splat((1.0, 1.0, 1.0), z), Vec3(z, z, z)
    ones = splat((1.0, 1.0, 1.0), z)
    zeros3 = Vec3(z, z, z)
    acc_sum, acc_sq = state.sum, state.sum_sq

    while True:
        active = s_rel < n_samples
        if not bool(active.any()):
            break

        # --- regenerate fresh paths --------------------------------------
        regen = active & (bounce == 0)
        s_abs = s0 + s_rel
        po, pd = _primary_rays(camera, config, key, pixel_idx, s_abs)
        o = vwhere(regen, po, o)
        d = vwhere(regen, pd, d)
        thr = vwhere(regen, ones, thr)
        prad = vwhere(regen, zeros3, prad)

        # --- one bounce ----------------------------------------------------
        state.rays_cast += active.sum()
        hit, uv = intersect(scene, o, d)
        u = prng.bounce_uniforms(prng.path_keys(key, pixel_idx, s_abs), bounce)
        out = shade_bounce(scene, o, d, hit, u,
                           just_importance=config.just_importance,
                           mip_scale=config.mip_scale, uv=uv)

        contrib = hadamard(thr, out.emit)
        prad = vwhere(active, prad + contrib, prad)

        at_depth_limit = bounce >= MAX_BOUNCE_COUNT - 1
        cont = active & out.cont & ~at_depth_limit
        new_thr = hadamard(thr, out.weight)
        if config.use_russian_roulette:
            survive, rr_thr = russian_roulette(new_thr, u[4])
            rr_applies = bounce >= 1
            cont = cont & (survive | ~rr_applies)
            new_thr = vwhere(rr_applies, rr_thr, new_thr)

        path_end = active & ~cont

        # --- fold finished paths into the accumulator ----------------------
        bad = torch.isnan(prad.x) | torch.isnan(prad.y) | torch.isnan(prad.z)
        ok_end = path_end & ~bad
        r = Vec3(*(torch.where(ok_end, c, 0.0) for c in prad))
        for acc, sq, c in zip(acc_sum, acc_sq, r):
            acc += c
            sq += c * c
        state.count += ok_end.to(torch.float32)
        state.nan_count += (path_end & bad).sum()

        s_rel = torch.where(path_end, s_rel + 1, s_rel)
        bounce = torch.where(path_end, 0,
                             torch.where(cont, bounce + 1, bounce))
        o = vwhere(cont, out.hitpoint, o)
        d = vwhere(cont, out.L, d)
        thr = vwhere(cont, new_thr, thr)
    return state
