"""The K1 remainder: the lane and sample orders JAX's ``render_chunk_pallas``
gives its ``pallas_call`` (pathtracer_tpu/render/pallas_backend.py:424-523),
kept as yardsticks against the kernel's own order.

Images do not depend on either order: randomness is a pure function of
(seed, pixel, sample, bounce, slot). No render takes them: on an H100 each
ran slower than the kernel's own order, or within the turns' spread of it
(PERF.md). ``chip_smoke.py`` times them and holds them bit-equal to the
kernel's own order, and tests/test_torch_order.py holds them to JAX. A
launch takes one through ``cuda_backend.render_chunk_cuda``'s ``_order``
(:func:`hook`):

- the texel sort (:func:`texel_sort_pixels`, JAX's ``_texel_sort``) on the
  combined set (:func:`sort_texels`, JAX's ``use_sort``);
- 8x4 warp tiles (:func:`tile_pixels`, JAX's ``_tile_perm_np``) on the
  brute feature variants of a scene with JAX's tiled stack
  (:func:`stack_tiles`);
- launches of at most ``SUB_CHUNK_SAMPLES`` samples (:func:`sub_chunks`).

The two pixel orders are read through a lane -> pixel table, which only
the kernel built with ``LANE_DEFINES`` reads (its ``lane_map``).
"""

from __future__ import annotations

import torch

from ..scene.camera import Camera
from ..scene.schema import Scene
from .cuda_backend import meshed, shard_tiles, textured

# the build whose combined-set and brute feature variants read a launch's
# lane -> pixel table (WaveParams::lane_pix); the default build has none
LANE_DEFINES = ("WAVE_LANE_TABLE",)
SUB_CHUNK_SAMPLES = 64  # pallas_backend.py:82


def sort_texels(scene: Scene) -> bool:
    """JAX's ``use_sort`` (pallas_backend.py:501): a combined texture set,
    whose pixels JAX orders by texel tile (:func:`texel_sort_pixels`)."""
    return bool(scene.tex_combined and scene.n_textures)


def stacked(scene: Scene) -> bool:
    """JAX's ``use_stack`` (pallas_backend.py:503): its tiled texture stack
    (``Scene.tex_stack_tiled``) outside a combined set."""
    return bool(scene.tex_stack_tiled and not scene.tex_combined
                and scene.n_textures)


def stack_tiles(scene: Scene) -> bool:
    """Whether the scene's variant is a brute feature variant (the kernel's
    ``lane_map`` without the combined set) of a scene JAX tiles for its
    stack (:510-519). These variants' own map is scanlines; every other
    base of a stack scene already walks on 8x4 tiles, or on scanlines by
    measurement."""
    return bool(stacked(scene) and scene.featured and not scene.sph_clusters
                and not textured(scene) and not meshed(scene))


def sub_chunks(scene: Scene, n_samples: int) -> list:
    """JAX's split of a chunk into launches (pallas_backend.py:501-523,
    :692-699): (sample offset, samples) each, of at most
    ``SUB_CHUNK_SAMPLES`` on a coherent scene (sphere clusters, the static
    or the streamed mesh tier) without the combined set or a stack, else
    the chunk in one; none for no samples."""
    use_sort, use_stack = sort_texels(scene), stacked(scene)
    coherent = use_sort or use_stack or bool(
        scene.sph_clusters or scene.tri_clusters or scene.tri_streamed)
    sub = (SUB_CHUNK_SAMPLES if coherent and not use_sort and not use_stack
           else n_samples)
    return [(off, min(sub, n_samples - off))
            for off in range(0, n_samples, max(sub, 1))]


def texel_sort_pixels(scene: Scene, camera: Camera, config,
                      pixels: torch.Tensor) -> torch.Tensor:
    """JAX's ``_texel_sort`` (pallas_backend.py:443-476) of ``pixels`` (a
    launch's pixel indices, in order): the same pixels ordered, stably, by
    the 8x8 texel tile of the combined set that each one's primary ray at
    its strata's centre (jitter 0.5, sample 0) fetches at level 0, the
    pixels that fetch nothing (the sky, an untextured hit) last. The
    primary hit is the plain version's (``ops/intersect.py``), as torch ops
    on ``pixels``' device."""
    from ..ops import texture
    from ..ops.intersect import intersect_scene
    from . import raygen
    n = pixels.numel()
    half = torch.full((n,), 0.5, device=pixels.device)
    zero = torch.zeros(n, dtype=torch.int64, device=pixels.device)
    rays = raygen.pinhole_rays if camera.use_pinhole else raygen.thin_lens_rays
    o, d = rays(camera, config.width, config.height, config.pp, zero, zero,
                (half, half), pixels)
    hit = intersect_scene(scene, o, d)
    x1, y1, _, _, _, _ = texture._combined_coords(
        scene, o.x + d.x * hit.t, o.y + d.y * hit.t)
    tile = (y1 >> 3) * scene.tex_tiles_x + (x1 >> 3)
    needs = (hit.mat != 0) & (scene.mat_albedo_idx[hit.mat.long()] != 0)
    key = torch.where(needs, tile, 1 << 30)
    return pixels[torch.argsort(key, stable=True)]


def tile_pixels(width: int, height: int, lo: int, hi: int,
                device) -> torch.Tensor:
    """The 8x4 warp tiles' lane -> pixel table (int32) of a launch over
    pixels ``lo .. hi-1``: the tiles ``shard_tiles`` gives, 32 lanes each
    in the kernel's own tile map (``warp_tiles``), -1 where a lane's pixel
    lies outside the image or the range."""
    tile_lo, n_tiles = shard_tiles(width, height, lo, hi)
    lane = torch.arange(n_tiles * 32, device=device)
    tile = tile_lo + (lane >> 5)
    tiles_x = (width + 7) >> 3
    x = (tile % tiles_x) * 8 + (lane & 7)
    y = (tile // tiles_x) * 4 + ((lane >> 3) & 3)
    pix = y * width + x
    ok = (x < width) & (pix >= lo) & (pix < hi)
    return torch.where(ok, pix, -1).to(torch.int32)


def applies(order: str, scene: Scene) -> bool:
    """Whether JAX gives ``scene`` this order: the texel sort on the
    combined set, the square tiles to the brute feature variants of a
    stack scene, the sub-chunks where they split a chunk."""
    if order == "texel_sort":
        return sort_texels(scene)
    if order == "stack_tiles":
        return stack_tiles(scene)
    return len(sub_chunks(scene, SUB_CHUNK_SAMPLES + 1)) > 1


def hook(order: str, scene: Scene, camera: Camera, config,
         n_samples: int) -> tuple:
    """``render_chunk_cuda``'s ``_order`` for a chunk of ``n_samples`` of
    ``scene`` in ``order`` ("texel_sort", "stack_tiles" or "sub_chunks",
    where it :func:`applies`):
    (each launch's lane -> pixel table, or None; its sample ranges, or
    None). The texel sort runs its pass on every call, as JAX pays it on
    every chunk; the tile table is made once for each launch's pixels,
    as JAX makes its permutation when it traces."""
    if not applies(order, scene):
        raise ValueError(f"JAX gives this scene no {order} order")
    device = scene.device
    if order == "texel_sort":
        return (lambda px: texel_sort_pixels(
            scene, camera, config,
            torch.arange(*px, dtype=torch.int32, device=device)), None)
    if order == "stack_tiles":
        made = {}

        def table_of(px):
            if px not in made:
                made[px] = tile_pixels(config.width, config.height, *px,
                                       device)
            return made[px]
        return table_of, None
    return None, sub_chunks(scene, n_samples)
