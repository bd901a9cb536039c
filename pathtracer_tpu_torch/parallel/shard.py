"""Rendering across devices: the image's pixels sharded over a device list.

Counterpart of ``pathtracer_tpu/parallel/shard.py``. JAX shards the
flattened (y-major) pixel axis over a 1-D device mesh with ``shard_map``;
here each device of a list renders one contiguous run of lanes of the same
padded pixel order through ``renderer.render_chunk`` (``lanes``), on its
own copy of the scene, into accumulators that stay on it between chunks.

- The pixel count is padded to a multiple of the device count; a padding
  lane renders pixel 0, as JAX's do, and is dropped by :func:`trim_accum`.
- Randomness and geometry are pure functions of the pixel index, so the
  sharded render is bit-identical to ``render_image``'s on every route.
- Every device's shard of a chunk is launched before any is synchronised:
  on the card a launch returns at once, so the devices run together.
- ``nan_count`` and ``rays_cast`` are summed over the shards (JAX's
  ``psum``), so ``rays_cast`` counts the padding lanes' rays too. JAX adds
  each shard's count to the replicated total before its ``psum``, which
  counts an incoming total once per device after the first chunk; here the
  incoming total is counted once.
- The devices may repeat (``[cuda:0] * k``, ``[cpu] * 8``): a list of one
  card with k entries renders k shards on it, which is how a machine with
  one card runs this path.

A launch that fails raises: nothing falls back to fewer devices or to the
CPU.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..scene.camera import Camera
from ..scene.schema import Scene
from ..utils.vec import Vec3
from ..render.renderer import (
    AccumState, RenderConfig, finalize, init_accum, render_chunk, resolve,
)


def make_devices(devices=None) -> List[torch.device]:
    """The device list of a sharded render (JAX's ``make_mesh``): every
    CUDA device in order, or the given ones. Raises without a card when
    none are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("render_image_sharded: no CUDA device is "
                               "available (pass devices=[...] to choose)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("render_image_sharded: an empty device list")
    return devices


def _padded_pixels(n_pix: int, n_dev: int) -> int:
    return ((n_pix + n_dev - 1) // n_dev) * n_dev


def _on(device: torch.device):
    """The context a launch or an upload on ``device`` runs in: the card's
    own, so that the runtime's current device is its stream's."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _split(state: AccumState, devices: Sequence[torch.device]
           ) -> List[AccumState]:
    """A padded state's lanes, one contiguous run a device, each on it; the
    counters go to the first shard, the others start at zero."""
    n = state.count.shape[0] // len(devices)
    out = []
    for k, dev in enumerate(devices):
        cut = lambda t: t[k * n:(k + 1) * n].to(dev).contiguous()
        with _on(dev):
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            out.append(AccumState(
                Vec3(*map(cut, state.sum)), Vec3(*map(cut, state.sum_sq)),
                cut(state.count),
                state.nan_count.to(dev).clone() if k == 0 else zero,
                state.rays_cast.to(dev).clone() if k == 0 else zero.clone(),
                state.samples_done))
    return out


def _gather(shards: Sequence[AccumState]) -> AccumState:
    """The shards' lanes in one padded state on the first shard's device,
    the counters summed."""
    dev = shards[0].device
    cat = lambda ts: torch.cat([t.to(dev) for t in ts])
    return AccumState(
        Vec3(*(cat([s.sum[c] for s in shards]) for c in range(3))),
        Vec3(*(cat([s.sum_sq[c] for s in shards]) for c in range(3))),
        cat([s.count for s in shards]),
        sum(s.nan_count.to(dev) for s in shards),
        sum(s.rays_cast.to(dev) for s in shards),
        shards[0].samples_done)


def _render_chunk_sharded(scenes: Sequence[Scene], camera: Camera,
                          config: RenderConfig,
                          devices: Sequence[torch.device], key: int, s0: int,
                          n_samples: int, shards: Sequence[AccumState]):
    """Samples ``s0 .. s0+n_samples-1`` of every lane, device k rendering
    lanes ``k*n .. (k+1)*n - 1`` of the padded order into ``shards[k]`` (in
    place) with ``scenes[k]``; every shard is launched before any is
    synchronised. Each shard keeps its own counters; :func:`_gather` sums
    them (JAX's ``psum``)."""
    n = shards[0].count.shape[0]
    for k, (scene, dev, st) in enumerate(zip(scenes, devices, shards)):
        with _on(dev):
            render_chunk(scene, camera, config, key, s0, n_samples, st,
                         lanes=(k * n, n))


def render_image_sharded(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    devices=None,
    chunk_samples: Optional[int] = None,
    state: Optional[AccumState] = None,
    progress_cb=None,
    adapt_chunk_s: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, AccumState]:
    """``render_image`` across ``devices`` (default: every CUDA device,
    :func:`make_devices`): the same (linear image, packed BGRA, state),
    bit for bit; the state trimmed to the image's pixels and gathered on
    the first device.

    ``state`` may be a checkpoint of either renderer (``width*height``
    lanes, or this device count's padded lanes): it is padded and the
    render resumes at ``state.samples_done``. ``progress_cb(s_done, total,
    state)`` receives the padded state, gathered on the first device only
    when it is called; between chunks the accumulators stay on their
    devices. ``adapt_chunk_s``: ``render_image``'s."""
    devices = make_devices(devices)
    config.check_supported()
    n_dev = len(devices)
    n_pix = config.width * config.height
    n_pad = _padded_pixels(n_pix, n_dev)
    scenes, copies = [], {}
    for dev in devices:
        if dev not in copies:
            with _on(dev):
                copies[dev] = scene.to(dev)
        scenes.append(copies[dev])
    if state is None:
        state = init_accum(n_pad, devices[0])
    elif state.count.shape[0] == n_pix and n_pad != n_pix:
        zpad = lambda t: torch.cat(
            [t, torch.zeros((n_pad - n_pix,), dtype=t.dtype,
                            device=t.device)])
        state = AccumState(Vec3(*map(zpad, state.sum)),
                           Vec3(*map(zpad, state.sum_sq)), zpad(state.count),
                           state.nan_count, state.rays_cast,
                           state.samples_done)
    if state.count.shape[0] != n_pad:
        raise ValueError(f"a state of {state.count.shape[0]} lanes: the "
                         f"image has {n_pix}, padded to {n_pad}")
    shards = _split(state, devices)
    total = config.spp
    chunk = min(chunk_samples or total, total)
    s0 = state.samples_done
    first = True
    while s0 < total:
        n = min(chunk, total - s0)
        t0 = time.perf_counter()
        _render_chunk_sharded(scenes, camera, config, devices, config.seed,
                              s0, n, shards)
        s0 += n
        if adapt_chunk_s and s0 < total:
            for dev in set(devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            if first:
                first = False
            else:
                while chunk > 1 and dt > adapt_chunk_s * 1.5:
                    chunk //= 2
                    dt /= 2.0
        if progress_cb is not None:
            progress_cb(s0, total, _gather(shards))
    trimmed = trim_accum(_gather(shards), n_pix)
    return resolve(trimmed, config), finalize(trimmed, config), trimmed


def trim_accum(state: AccumState, n_pix: int) -> AccumState:
    """Drop the padding lanes (duplicates of pixel 0), so that a sharded
    state mid-render can be previewed or finalized as a one-device one."""
    if state.count.shape[0] == n_pix:
        return state
    cut = lambda t: t[:n_pix]
    return AccumState(Vec3(*map(cut, state.sum)),
                      Vec3(*map(cut, state.sum_sq)), cut(state.count),
                      state.nan_count, state.rays_cast, state.samples_done)
