"""The plain model of the feature bounce's block-level regroup.

``csrc/wave_kernel.cu`` runs a feature variant's bounce in
``trace_feature_grouped``: each thread of a block of 128 intersects its own
path's ray and picks its event, and where laying the block's shading lanes
out by event cuts the number of branches its four warps run, thread k
shades the k-th path of that layout. This module computes, lane-parallel
in eager torch, what the kernel decides:

- :func:`shade_events`: each lane's event by ``trace_feature``'s rule;
- :func:`kernel_lanes`: the thread of the kernel that owns each pixel
  (scanline warps, or 8x4 pixel tiles for the BVH walks' variants);
- :func:`regroup_order`: the stable partition a block writes (scatters,
  then opaque, then glass, then nothing, each in thread order), or the
  identity where the block's ballots show it would not cut the branches;
- :func:`warp_branch_issue`: the shading operations the warps issue before
  and after the regroup, each warp paying, for each event it holds, its
  costliest lane.

None of it changes a value: randomness is keyed on (pixel, sample,
bounce), so the thread that shades a path does not matter. The renders
stay those of ``render/wavefront.py`` and ``render/lockstep.py``.
"""

from __future__ import annotations

import torch

from ..scene.schema import MAX_BOUNCE_COUNT, Scene
from .integrator import fog_flight

# the kernel's events (EV_* in csrc/wave_kernel.cu), in layout order
EV_SCATTER, EV_OPAQUE, EV_GLASS, EV_NONE = 0, 1, 2, 3
SHADING_EVENTS = (EV_SCATTER, EV_OPAQUE, EV_GLASS)
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


def _by_thread(values, lanes, n_threads, fill):
    """``values`` per pixel scattered to their threads, ``fill`` where a
    thread has no pixel."""
    out = torch.full((n_threads,), fill, dtype=values.dtype,
                     device=values.device)
    out[lanes] = values
    return out


def regroup_order(events, lanes, n_threads, block: int = BLOCK):
    """(for each pixel, the thread that shades its path; for each block,
    whether it regroups). A block regroups where laying its lanes out by
    event (scatters, then opaque, then glass, then nothing, each in thread
    order: a stable partition) makes its warps run fewer event branches
    than in place, counted from the warps' ballots as the kernel counts
    them; else each thread shades its own path. Threads without a pixel
    hold nothing."""
    ev = _by_thread(events, lanes, n_threads, EV_NONE).view(-1, block)
    nb = ev.shape[0]
    warps = ev.view(nb, block // WARP, WARP)
    before = sum((warps == e).any(-1).sum(-1) for e in SHADING_EVENTS)
    after = torch.zeros_like(before)
    start = torch.zeros_like(before)
    for e in SHADING_EVENTS:
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
