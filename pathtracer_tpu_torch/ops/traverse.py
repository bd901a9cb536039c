"""The uniform-grid walk over triangles (a 3D-DDA over CSR cell lists).

Counterpart of ``pathtracer_tpu/ops/traverse.py``. The reference walks a
pointer octree with a thread-local node stack (win32_main.cpp:476-526);
JAX walks the 64^3 leaf grid with a 3D-DDA instead, visiting the leaves
the octree descent would reach, and tests the triangles binned into each
visited cell (``scene/accel.py``). The binning covers every voxel of a
triangle's vertex box, so every hit lies in a visited cell that lists its
triangle. The walk stops once the next cell's entry lies past the best hit
so far, or the ray leaves the grid: the nearest hit equals the brute
sweep's.

JAX renders a scene with a grid on XLA only, so this is torch ops on the
tensors' device, not a kernel: one loop whose every step advances each
lane by one unit of work, testing one triangle of its current cell or
stepping one cell, over the lanes still marching (gathered anew when half
of them have stopped). The loop's exit test costs one host sync per step;
``STEPS`` and ``WALKS`` count the steps and the walks.
"""

from __future__ import annotations

import torch

from ..scene.accel import CELL_SIZE, GRID_MIN
from ..scene.schema import Scene
from ..utils.vec import Vec3
from .intersect import Hit, _brute_tests, _triangle_records

_BIG = 1e30

# steps of the loop and walks since the caller last set them to 0
STEPS = 0
WALKS = 0


def intersect_triangles_grid(scene: Scene, o: Vec3, d: Vec3,
                             best: Hit) -> Hit:
    """The nearest hit over the scene's triangles that beats ``best``, by
    the grid walk (traverse.py:55 in JAX, in its order of operations: the
    slab entry plus 1e-7, the next crossings, the axis chosen by ``<=``,
    a triangle taken by strict ``<``)."""
    global STEPS, WALKS
    res = scene.grid_res
    cell, gmin, gmax = CELL_SIZE, GRID_MIN, -GRID_MIN
    i32 = torch.int32

    def inv(dv):
        return 1.0 / torch.where(dv != 0.0, dv, 1e-30)

    invx, invy, invz = inv(d.x), inv(d.y), inv(d.z)
    t0x, t1x = (gmin - o.x) * invx, (gmax - o.x) * invx
    t0y, t1y = (gmin - o.y) * invy, (gmax - o.y) * invy
    t0z, t1z = (gmin - o.z) * invz, (gmax - o.z) * invz
    tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.minimum(t0z, t1z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                       torch.maximum(t0y, t1y)),
                         torch.maximum(t0z, t1z))
    in_box = (tmax >= tmin) & (tmax >= 0.0)

    t_entry = torch.clamp_min(tmin, 0.0) + 1e-7

    def voxel(ov, dv):
        p = ov + dv * t_entry
        c = torch.floor((p - gmin) / cell)
        # (lanes outside the grid may hold inf or NaN: never walked)
        c = torch.nan_to_num(c, nan=0.0).clamp(-1.0, float(res))
        return c.to(i32).clamp(0, res - 1)

    cx, cy, cz = voxel(o.x, d.x), voxel(o.y, d.y), voxel(o.z, d.z)
    step = lambda dv: torch.where(dv > 0, 1, -1).to(i32)
    stepx, stepy, stepz = step(d.x), step(d.y), step(d.z)

    def next_t(c, stp, ov, dv, iv):
        bound = gmin + (c + (stp > 0).to(i32)).to(torch.float32) * cell
        return torch.where(dv != 0.0, (bound - ov) * iv, _BIG)

    tnx = next_t(cx, stepx, o.x, d.x, invx)
    tny = next_t(cy, stepy, o.y, d.y, invy)
    tnz = next_t(cz, stepz, o.z, d.z, invz)
    delta = lambda dv, iv: torch.where(dv != 0.0, torch.abs(cell * iv), _BIG)
    tdx, tdy, tdz = delta(d.x, invx), delta(d.y, invy), delta(d.z, invz)

    starts = scene.grid_cell_start
    counts = scene.grid_cell_count
    last = scene.grid_tris.shape[0] - 1
    # each triangle's part of the test, formed once (bit-equal per test)
    records = _triangle_records(scene)
    cell_idx = ((cz * res + cy) * res + cx).long()
    cursor = starts[cell_idx]
    end = cursor + counts[cell_idx]

    # the walk runs on the lanes still marching, gathered anew whenever at
    # most half of those it holds march on; a lane's result is written
    # back when it leaves (every value of a lane depends on its own alone)
    out = Hit(best.t.clone(), best.mat.clone(),
              Vec3(*(c.clone() for c in best.normal)))
    lanes = torch.nonzero(in_box).squeeze(1)
    S = [x[lanes] for x in (
        o.x, o.y, o.z, d.x, d.y, d.z, stepx, stepy, stepz, tdx, tdy, tdz,
        tmax, cx, cy, cz, tnx, tny, tnz, cursor, end, best.t, best.mat,
        *best.normal)]
    WALKS += 1
    while len(lanes):
        (ox, oy, oz, dx, dy, dz, stepx, stepy, stepz, tdx, tdy, tdz, tmax,
         cx, cy, cz, tnx, tny, tnz, cursor, end, t, mat, nx, ny, nz) = S
        marching = torch.ones_like(cx, dtype=torch.bool)
        zero = torch.zeros_like(cx)
        while True:
            STEPS += 1
            testing = marching & (cursor < end)

            # --- test one triangle per testing lane -----------------------
            tri = scene.grid_tris[torch.clamp_max(cursor, last).long()].long()
            rec = records[tri]
            thit, hit, _, _ = _brute_tests(rec, Vec3(ox, oy, oz),
                                           Vec3(dx, dy, dz))
            take = testing & hit & (thit < t)
            t = torch.where(take, thit, t)
            mat = torch.where(take, scene.tri_mat[tri], mat)
            nx = torch.where(take, rec[:, 0], nx)
            ny = torch.where(take, rec[:, 1], ny)
            nz = torch.where(take, rec[:, 2], nz)
            cursor_new = torch.where(testing, cursor + 1, cursor)

            # --- DDA step for lanes whose cell is exhausted ----------------
            stepping = marching & ~testing
            t_enter_next = torch.minimum(torch.minimum(tnx, tny), tnz)
            ax_x = (tnx <= tny) & (tnx <= tnz)
            ax_y = ~ax_x & (tny <= tnz)
            ax_z = ~ax_x & ~ax_y
            ncx = cx + torch.where(ax_x, stepx, zero)
            ncy = cy + torch.where(ax_y, stepy, zero)
            ncz = cz + torch.where(ax_z, stepz, zero)
            inside = ((ncx >= 0) & (ncx < res) & (ncy >= 0) & (ncy < res)
                      & (ncz >= 0) & (ncz < res))
            keep_going = (stepping & inside & (t_enter_next <= t)
                          & (t_enter_next <= tmax))

            new_cell = ((ncz * res + ncy) * res + ncx).clamp(
                0, res * res * res - 1).long()
            c_start = starts[new_cell]
            marching = torch.where(stepping, keep_going, marching)
            cx = torch.where(keep_going, ncx, cx)
            cy = torch.where(keep_going, ncy, cy)
            cz = torch.where(keep_going, ncz, cz)
            tnx = torch.where(keep_going & ax_x, tnx + tdx, tnx)
            tny = torch.where(keep_going & ax_y, tny + tdy, tny)
            tnz = torch.where(keep_going & ax_z, tnz + tdz, tnz)
            cursor = torch.where(keep_going, c_start, cursor_new)
            end = torch.where(keep_going, c_start + counts[new_cell], end)
            if int(marching.sum()) <= len(lanes) // 2:
                break
        for dst, src in zip((out.t, out.mat, *out.normal),
                            (t, mat, nx, ny, nz)):
            dst[lanes] = src
        S = [x[marching] for x in (
            ox, oy, oz, dx, dy, dz, stepx, stepy, stepz, tdx, tdy, tdz, tmax,
            cx, cy, cz, tnx, tny, tnz, cursor, end, t, mat, nx, ny, nz)]
        lanes = lanes[marching]
    return out
