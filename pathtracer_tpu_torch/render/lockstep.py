"""Bounce-lockstep sample loop in eager torch: the plain version of K3.

Counterpart of ``pathtracer_tpu/render/pallas_backend.py::_lockstep_loop``
with ``render/integrator.py::trace_fori``. For each sample in order, every
pixel casts its primary ray (pinhole or thin lens, keyed as
``wavefront._primary_rays`` keys it), then all lanes run bounces 0 ..
MAX_BOUNCE_COUNT-2 together under an alive mask, with Russian roulette
from bounce 1 as in ``trace_fori``; the last bounce only adds emission
(its shading could not continue the path, which is ``body_last``'s peel).
Rays are counted per live lane, and the NaN-masked fold runs once per
sample.

Randomness is keyed on (pixel, sample, bounce) and samples fold in order,
so this computes the per-pixel values of ``render/wavefront.py``; the two
differ only in which lanes advance together. The textured kernel variants
of ``csrc/wave_kernel.cu`` that run this schedule must agree with it.

The accumulator tensors are updated in place.
"""

from __future__ import annotations

import torch

from ..ops.intersect import intersect_scene
from ..scene.camera import Camera
from ..scene.schema import MAX_BOUNCE_COUNT, Scene
from ..utils import prng
from ..utils.vec import Vec3, gather, hadamard, splat, where as vwhere
from .integrator import russian_roulette, shade_bounce
from .wavefront import _primary_rays


def trace_lockstep(scene: Scene, o: Vec3, d: Vec3, pkeys: prng.PathStream,
                   use_russian_roulette: bool = False,
                   mip_scale: float = 0.0):
    """One sample's path for every lane, bounce by bounce: (radiance Vec3,
    per-lane int64 ray counts)."""
    z = torch.zeros_like(o.x)
    radiance = Vec3(z, z, z)
    throughput = splat((1.0, 1.0, 1.0), z)
    alive = torch.ones_like(z, dtype=torch.bool)
    casts = torch.zeros_like(z, dtype=torch.int64)
    for b in range(MAX_BOUNCE_COUNT):
        casts += alive
        hit = intersect_scene(scene, o, d)
        if b == MAX_BOUNCE_COUNT - 1:
            emit = gather(scene.mat_emit, hit.mat.long())
            return vwhere(alive, radiance + hadamard(throughput, emit),
                          radiance), casts
        u = prng.bounce_uniforms(pkeys, b)
        out = shade_bounce(scene, o, d, hit, u, mip_scale=mip_scale)
        radiance = vwhere(alive, radiance + hadamard(throughput, out.emit),
                          radiance)
        cont = alive & out.cont
        new_thr = hadamard(throughput, out.weight)
        if use_russian_roulette and b >= 1:
            survive, new_thr = russian_roulette(new_thr, u[4])
            cont = cont & survive
        throughput = vwhere(cont, new_thr, throughput)
        o = vwhere(cont, out.hitpoint, o)
        d = vwhere(cont, out.L, d)
        alive = cont
    return radiance, casts


def render_chunk_lockstep(scene: Scene, camera: Camera, config, key: int,
                          s0: int, n_samples: int, state,
                          pixel_idx: torch.Tensor):
    """Accumulate ``n_samples`` samples per pixel (sample indices
    ``s0 .. s0+n_samples-1``) into ``state``, one sample at a time."""
    for s_rel in range(n_samples):
        s = torch.full_like(pixel_idx, s0 + s_rel)
        o, d = _primary_rays(camera, config, key, pixel_idx, s)
        radiance, casts = trace_lockstep(
            scene, o, d, prng.path_keys(key, pixel_idx, s),
            use_russian_roulette=config.use_russian_roulette,
            mip_scale=config.mip_scale)
        bad = (torch.isnan(radiance.x) | torch.isnan(radiance.y)
               | torch.isnan(radiance.z))
        r = Vec3(*(torch.where(bad, 0.0, c) for c in radiance))
        for acc, sq, c in zip(state.sum, state.sum_sq, r):
            acc += c
            sq += c * c
        state.count += (~bad).to(torch.float32)
        state.nan_count += bad.sum()
        state.rays_cast += casts.sum()
    return state
