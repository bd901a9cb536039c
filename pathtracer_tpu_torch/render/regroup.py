"""The plain model of the kernel's block-level regroups.

``csrc/wave_kernel.cu`` runs a feature variant's bounce in
``trace_feature_grouped`` and world 1's textured lockstep bounce in
``trace_textured_grouped``, both on ``grouped_shade``: each thread of a
block of 128 intersects its own path's ray and takes a key (the feature
bounce's event; the textured bounce's estimator lobe, specular or
diffuse), and where laying the block's shading lanes out by key cuts the
number of branches its four warps run, thread k shades the k-th path of
that layout. This module computes, lane-parallel in eager torch, what the
kernel decides:

- :func:`shade_events`: each lane's event by ``trace_feature``'s rule;
- :func:`estimator_lobes`, :func:`estimator_keys`: each lane's lobe of the
  opaque estimator (mirror, GGX, cosine or light, ``shade_surface``'s
  branches) and the two-way key the textured bounce lays it out by;
- :func:`kernel_lanes`: the thread of the kernel that owns each pixel
  (scanline warps, or 8x4 pixel tiles for the BVH walks' variants);
- :func:`regroup_order`: the stable partition a block writes (each key in
  layout order, then nothing, each in thread order), or the identity where
  the block's ballots show it would not cut the branches;
- :func:`warp_branch_issue`: the shading operations the warps issue before
  and after the regroup, each warp paying, for each event it holds, its
  costliest lane;
- :func:`lockstep_tally`: the replay of a lockstep render over the
  kernel's warp map (or JAX's texel sort, :func:`texel_sort_lanes`): lane
  use with each warp running until its longest path ends and with each
  block's live paths packed into whole warps at each bounce, the four
  lobes' branch runs in place and laid out by the two-way and the
  four-way key, and the 32-byte sectors a warp's bounce-0 K9 fetch
  touches.

None of it changes a value: randomness is keyed on (pixel, sample,
bounce), so the thread that shades a path does not matter. The renders
stay those of ``render/wavefront.py`` and ``render/lockstep.py``.
"""

from __future__ import annotations

import torch

from ..ops import texture
from ..scene.schema import MAX_BOUNCE_COUNT, Scene
from ..utils.vec import gather
from .integrator import fog_flight, mip_lod
from .lockstep import render_chunk_lockstep
from .orders import texel_sort_pixels
from .renderer import init_accum

# the kernel's events (EV_* in csrc/wave_kernel.cu), in layout order
EV_SCATTER, EV_OPAQUE, EV_GLASS, EV_NONE = 0, 1, 2, 3
SHADING_EVENTS = (EV_SCATTER, EV_OPAQUE, EV_GLASS)
# the opaque estimator's lobes (shade_surface's branches, the diffuse one by
# its coin u[1]); the two-way key of the textured lockstep bounce (KEY_* in
# the kernel: the lobes 0-1 and 2-3), in layout order, EV_NONE for nothing
LOBE_MIRROR, LOBE_GGX, LOBE_COSINE, LOBE_LIGHT, LOBE_NONE = 0, 1, 2, 3, 4
LOBES = (LOBE_MIRROR, LOBE_GGX, LOBE_COSINE, LOBE_LIGHT)
KEY_SPECULAR, KEY_DIFFUSE = 0, 1
ESTIMATOR_KEYS = (KEY_SPECULAR, KEY_DIFFUSE)
BLOCK, WARP = 128, 32


def shade_events(scene: Scene, hit, u, bounce, active: torch.Tensor):
    """Each lane's event, as ``trace_feature`` picks it: nothing for a lane
    that is not active or at the depth limit; else a scatter where the
    fog's free flight ends before the hit (sky hits included), the glass
    lobe on a transmissive surface, the opaque estimator on any other
    non-emissive surface, and nothing on the sky or an emitter."""
    m = hit.mat.long()
    emit = [c[m] for c in scene.mat_emit]
    surface = (hit.mat != 0) & (emit[0] == 0) & (emit[1] == 0) & (emit[2] == 0)
    below = active & (torch.as_tensor(bounce, device=m.device)
                      < MAX_BOUNCE_COUNT - 1)
    vol = torch.zeros_like(active)
    if scene.fog_sigma_t > 0.0:
        vol = fog_flight(scene, u, hit.t)[1]
    glass = scene.mat_transmission[m] > 0.0
    ev = torch.full_like(m, EV_NONE)
    ev = torch.where(below & surface & ~glass, EV_OPAQUE, ev)
    ev = torch.where(below & surface & glass, EV_GLASS, ev)
    return torch.where(below & vol, EV_SCATTER, ev)


def estimator_lobes(scene: Scene, o, d, hit, u, bounce, active: torch.Tensor,
                    mip_scale: float = 0.0):
    """Each lane's lobe of the opaque estimator as ``shade_surface`` picks
    it (a scene without features): nothing for a lane that is not active,
    at the depth limit, or on the sky or an emitter; else specular on
    u[0] > 0.5, the mirror where the roughness (the combined set's map
    where the material has one, its level under ``mip_scale``) is below
    0.01, else GGX; diffuse by the cosine on u[1] > 0.5 (or where the scene
    samples the cosine alone), else toward the light. A back-facing lane
    keeps the lobe its coins pick: the kernel lays it out by that key."""
    m = hit.mat.long()
    emit = gather(scene.mat_emit, m)
    surface = (hit.mat != 0) & (emit.x == 0) & (emit.y == 0) & (emit.z == 0)
    shades = surface & active & (torch.as_tensor(bounce, device=m.device)
                                 < MAX_BOUNCE_COUNT - 1)
    rough = scene.mat_roughness[m]
    if scene.n_textures and scene.tex_combined and scene.use_roughness_maps:
        x = o.x + d.x * hit.t
        y = o.y + d.y * hit.t
        if mip_scale and scene.tex_mip_meta:
            cti = hit.normal.x * d.x + hit.normal.y * d.y + hit.normal.z * d.z
            cti = torch.where(cti > 0.0, -cti, cti)
            rgh = texture.bespoke_sample_combined_mip(
                scene, x, y, mip_lod(scene, hit.t, cti, mip_scale))[2]
        else:
            rgh = texture.bespoke_sample_combined(scene, x, y)[2]
        rough = torch.where(scene.mat_roughness_idx[m] != 0, rgh, rough)
    spec = torch.where(rough < 0.01, LOBE_MIRROR, LOBE_GGX)
    cosine = (u[1] > 0.5) | bool(scene.just_cosine)
    diff = torch.where(cosine, LOBE_COSINE, LOBE_LIGHT)
    lobe = torch.where(u[0] > 0.5, spec, diff)
    return torch.where(shades, lobe, LOBE_NONE)


def estimator_keys(lobes: torch.Tensor) -> torch.Tensor:
    """The two-way key of each lane's lobe: specular (mirror, GGX), diffuse
    (cosine, light) or EV_NONE."""
    return torch.where(lobes <= LOBE_GGX, KEY_SPECULAR,
                       torch.where(lobes <= LOBE_LIGHT, KEY_DIFFUSE, EV_NONE))


def coin_keys(u, bounce, alive: torch.Tensor) -> torch.Tensor:
    """The key of the block-lockstep loop (the kernel's
    ``trace_textured_grouped``, built with -DWAVE_BLOCK_LOCKSTEP), known
    before a path's ray is cast: specular for a live path whose coin u[0]
    > 0.5, and for every live path at the depth limit (nothing shades
    there, so the layout only packs the live paths), else diffuse;
    EV_NONE for no path."""
    last = torch.as_tensor(bounce, device=alive.device) >= MAX_BOUNCE_COUNT - 1
    key = torch.where((u[0] > 0.5) | last, KEY_SPECULAR, KEY_DIFFUSE)
    return torch.where(alive, key, EV_NONE)


def kernel_lanes(width: int, height: int, tiles: bool, device=None):
    """(for each pixel in row-major order, the kernel's thread that owns
    it as block * 128 + thread; the kernel's thread count). With ``tiles``
    each warp holds an 8x4 pixel tile, four tiles a block in row-major
    tile order; else each warp 32 pixels of the row-major order."""
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    if not tiles:
        n = width * height
        return (y * width + x).reshape(-1), -(-n // BLOCK) * BLOCK
    tiles_x = (width + 7) // 8
    tile = (y // 4) * tiles_x + x // 8
    lane = (tile // 4) * BLOCK + (tile % 4) * WARP + (y % 4) * 8 + x % 8
    n_tiles = tiles_x * ((height + 3) // 4)
    return lane.reshape(-1), -(-n_tiles // 4) * BLOCK


def texel_sort_lanes(scene: Scene, camera, config, device=None):
    """JAX's ``_texel_sort`` (pallas_backend.py:443) as a warp map: pixels
    ordered (stably) by the 8x8 texel tile their primary ray at the
    strata's centre (jitter 0.5, sample 0) fetches at level 0, the pixels
    that fetch nothing last (``orders.texel_sort_pixels``, the order the
    kernel's texel-sort yardstick reads), 32 a warp
    and 128 a block in that order: (for each pixel, its thread; the thread
    count), as :func:`kernel_lanes`."""
    n = config.width * config.height
    order = texel_sort_pixels(scene, camera, config,
                              torch.arange(n, device=device))
    return torch.argsort(order), -(-n // BLOCK) * BLOCK


def _by_thread(values, lanes, n_threads, fill):
    """``values`` per pixel scattered to their threads, ``fill`` where a
    thread has no pixel."""
    out = torch.full((n_threads,), fill, dtype=values.dtype,
                     device=values.device)
    out[lanes] = values
    return out


def regroup_order(events, lanes, n_threads, block: int = BLOCK,
                  keys=SHADING_EVENTS):
    """(for each pixel, the thread that shades its path; for each block,
    whether it regroups). A block regroups where laying its lanes out by
    key (``keys`` in order: scatters, then opaque, then glass by default,
    then nothing, each in thread order: a stable partition; every other
    value, above the keys, is nothing) makes its warps run fewer branches
    than in place, counted from the warps' ballots as the kernel counts
    them; else each thread shades its own path. Threads without a pixel
    hold nothing."""
    none = max(keys) + 1
    ev = _by_thread(events, lanes, n_threads, none).view(-1, block)
    ev = torch.where((ev >= 0) & (ev < none), ev, none)
    nb = ev.shape[0]
    warps = ev.view(nb, block // WARP, WARP)
    before = sum((warps == e).any(-1).sum(-1) for e in keys)
    after = torch.zeros_like(before)
    start = torch.zeros_like(before)
    for e in keys:
        c = (ev == e).sum(-1)
        span = (start + c - 1) // WARP - start // WARP + 1
        after = after + torch.where(c > 0, span, 0)
        start = start + c
    regroup = after < before
    thread = torch.arange(block, device=ev.device)
    rank = torch.argsort(torch.argsort(ev * block + thread, dim=-1), dim=-1)
    slot = torch.where(regroup[:, None], rank, thread)
    shader = (torch.arange(nb, device=ev.device)[:, None] * block
              + slot).reshape(-1)
    return shader[lanes], regroup


def _issue(ev, ops):
    """The shading operations warps issue: for each warp and each event
    it holds, the costliest of its lanes of that event."""
    ev, ops = ev.view(-1, WARP), ops.view(-1, WARP)
    total = torch.zeros((), dtype=ops.dtype, device=ops.device)
    for e in SHADING_EVENTS:
        total = total + torch.where(ev == e, ops, 0).amax(-1).sum()
    return total


def warp_branch_issue(events, lane_ops, lanes, n_threads, block: int = BLOCK):
    """The replay of one bounce: ``events`` and each lane's shading
    operations ``lane_ops`` per pixel, ``lanes`` and ``n_threads`` from
    :func:`kernel_lanes`. Returns a dict: "before", the operations the
    warps issue with each thread shading its own path; "after", with each
    block laid out by :func:`regroup_order`; "blocks", the blocks with a
    lane to shade; "regrouped", those that regroup."""
    shader, regroup = regroup_order(events, lanes, n_threads, block)
    ev = _by_thread(events, lanes, n_threads, EV_NONE)
    ops = _by_thread(lane_ops, lanes, n_threads, 0)
    ev_after = _by_thread(events, shader, n_threads, EV_NONE)
    ops_after = _by_thread(lane_ops, shader, n_threads, 0)
    shading = (ev != EV_NONE).view(-1, block).any(-1)
    return {"before": int(_issue(ev, ops)),
            "after": int(_issue(ev_after, ops_after)),
            "blocks": int(shading.sum()),
            "regrouped": int((regroup & shading).sum())}


def _runs(lobes_by_thread) -> int:
    """The lobe branches warps run: for each warp, the lobes it holds."""
    w = lobes_by_thread.view(-1, WARP)
    return int(sum((w == k).any(-1).sum() for k in LOBES))


def lockstep_tally(scene: Scene, camera, config, n_samples: int,
                   tiles: bool = False, device=None, lanes=None) -> dict:
    """The replay of ``render/lockstep.py``'s render of samples 0 ..
    n_samples-1 over the kernel's warp map (:func:`kernel_lanes`, or
    ``lanes``: another map's (lanes, thread count)): each
    bounce's live lanes (the kernel's ``++rays``) and each shading lane's
    lobe (:func:`estimator_lobes`). Returns a dict: "lane_bounces", the
    rays cast; "warp_slots", 32 lanes for each warp at each bounce where
    one of its lanes is live (each warp runs until its longest path ends);
    "block_slots", the same with each block's live paths packed into
    whole warps at each bounce; "lane_use" and "lane_use_compacted", the
    rays over those; "runs_in_place", the four lobes' branch runs summed
    over warps and bounces with each thread shading its own path;
    "runs_two_way" and "runs_four_way", with each block's shading lanes
    laid out after the intersect by the two-way key or by the four lobes
    where that cuts its warps' key branches (:func:`regroup_order`);
    "runs_coin", with each block's live paths laid out before the
    intersect by :func:`coin_keys` (the kernel's block-lockstep loop), and
    "coin_slots" and "lane_use_coin", its warps' lane slots and lane use (a
    block that lays its paths out packs them, one that does not runs its
    warps in place); "blocks" and "blocks_regrouped", the bounces' blocks
    with a lane to shade and those the two-way key lays out;
    "fetch_warps" and "fetch_sectors", the warps with a lane that fetches
    from the combined set at bounce 0 and the distinct 32-byte sectors of
    ``tex_tile`` their four corners' (A, B) pairs touch, summed, and
    "sectors_per_warp_fetch", the one over the other."""
    device = device or scene.sph_radius.device
    lanes, n_threads = lanes or kernel_lanes(config.width, config.height,
                                             tiles, device)
    tally = dict.fromkeys(("lane_bounces", "warp_slots", "block_slots",
                           "coin_slots", "runs_in_place", "runs_two_way",
                           "runs_four_way", "runs_coin", "blocks",
                           "blocks_regrouped", "fetch_warps",
                           "fetch_sectors"), 0)

    def observe(bounce, alive, o, d, hit, u):
        live = _by_thread(alive, lanes, n_threads, False)
        tally["lane_bounces"] += int(live.sum())
        tally["warp_slots"] += WARP * int(live.view(-1, WARP).any(-1).sum())
        per_block = live.view(-1, BLOCK).sum(-1)
        packed = (per_block + WARP - 1) // WARP
        tally["block_slots"] += WARP * int(packed.sum())
        shader_c, laid_c = regroup_order(coin_keys(u, bounce, alive), lanes,
                                         n_threads, keys=ESTIMATOR_KEYS)
        busy = live.view(-1, BLOCK // WARP, WARP).any(-1).sum(-1)
        tally["coin_slots"] += WARP * int(torch.where(laid_c, packed,
                                                      busy).sum())
        lobes = estimator_lobes(scene, o, d, hit, u, bounce, alive,
                                config.mip_scale)
        keys = estimator_keys(lobes)
        by_thread = _by_thread(lobes, lanes, n_threads, LOBE_NONE)
        tally["runs_in_place"] += _runs(by_thread)
        shader, regrouped = regroup_order(keys, lanes, n_threads,
                                          keys=ESTIMATOR_KEYS)
        tally["runs_two_way"] += _runs(_by_thread(lobes, shader, n_threads,
                                                  LOBE_NONE))
        tally["runs_coin"] += _runs(_by_thread(lobes, shader_c, n_threads,
                                               LOBE_NONE))
        shader4, _ = regroup_order(lobes, lanes, n_threads, keys=LOBES)
        tally["runs_four_way"] += _runs(_by_thread(lobes, shader4,
                                                   n_threads, LOBE_NONE))
        shading = (_by_thread(keys, lanes, n_threads, EV_NONE) != EV_NONE)
        shading = shading.view(-1, BLOCK).any(-1)
        tally["blocks"] += int(shading.sum())
        tally["blocks_regrouped"] += int((regrouped & shading).sum())
        if bounce == 0 and scene.n_textures and scene.tex_combined:
            fetch = (lobes != LOBE_NONE) & (scene.mat_albedo_idx[
                hit.mat.long()] != 0)
            x = o.x + d.x * hit.t
            y = o.y + d.y * hit.t
            lod = None
            if config.mip_scale and scene.tex_mip_meta:
                cti = hit.normal.x * d.x + hit.normal.y * d.y + hit.normal.z * d.z
                lod = mip_lod(scene, hit.t, torch.where(cti > 0.0, -cti, cti),
                              config.mip_scale)
            corners = texture.combined_at(scene, x, y, lod)[0]
            # a pair is 8 bytes: four to a 32-byte sector
            sectors = torch.stack([c >> 2 for c in corners], -1)
            sectors = torch.where(fetch[:, None], sectors, -1)
            by_thread = torch.full((n_threads, 4), -1, dtype=sectors.dtype,
                                   device=sectors.device)
            by_thread[lanes] = sectors
            warp = by_thread.view(-1, WARP * 4).sort(-1).values
            new = (warp[:, 1:] != warp[:, :-1]) & (warp[:, 1:] >= 0)
            distinct = new.sum(-1) + (warp[:, 0] >= 0)
            tally["fetch_warps"] += int((distinct > 0).sum())
            tally["fetch_sectors"] += int(distinct.sum())

    n_pix = config.width * config.height
    render_chunk_lockstep(scene, camera, config, config.seed, 0, n_samples,
                          init_accum(n_pix, device),
                          torch.arange(n_pix, device=device), observe=observe)
    tally["lane_use"] = tally["lane_bounces"] / max(tally["warp_slots"], 1)
    tally["lane_use_compacted"] = (tally["lane_bounces"]
                                   / max(tally["block_slots"], 1))
    tally["lane_use_coin"] = tally["lane_bounces"] / max(tally["coin_slots"], 1)
    tally["sectors_per_warp_fetch"] = (tally["fetch_sectors"]
                                       / max(tally["fetch_warps"], 1))
    return tally
