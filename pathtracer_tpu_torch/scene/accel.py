"""The uniform grid over triangles, flattened to CSR lists.

Counterpart of ``pathtracer_tpu/scene/accel.py``. The reference bins the
triangles into a 64^3 grid over the fixed world volume [-2.5, 2.5]^3
(GenerateAccelerationStructure, win32_main.cpp:1188-1447): each triangle
goes into every voxel of the box spanned by the voxel coordinates of its
three vertices (:1231-1382), a conservative cover, so a walk through the
voxels a ray crosses meets every triangle it can hit. The cell lists are
flattened into (cell_start, cell_count, tris), each cell's triangles in
table order, for the walk in ``ops/traverse.py``.

JAX bins through its native library when that is built, else through a
loop over the triangles in Python; both give the same arrays. The port
keeps one binning of its own, vectorised with numpy so that a mesh of a
million triangles bins in seconds, and its tests hold it equal, element
for element, to JAX's arrays. It does not load the native library.

Geometry outside the world volume raises, as the reference asserts
("triangle is out of the world bounds!", :1284-1286).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .schema import LEVELS, WORLD_SIZE

GRID_RES = 1 << LEVELS          # 64 leaves per axis
CELL_SIZE = WORLD_SIZE / GRID_RES
GRID_MIN = -WORLD_SIZE / 2.0    # the voxel lattice spans [-2.5, 2.5]^3


def voxel_coords(points: np.ndarray) -> np.ndarray:
    """floor(p / sep) + halfLeavesCount per axis (win32_main.cpp:1266-1268)."""
    half = GRID_RES >> 1
    return np.floor(points / CELL_SIZE).astype(np.int64) + half


def build_uniform_grid(triangles: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  int]:
    """Bin triangles (T, 3, 3) into the 64^3 grid: (cell_start, cell_count,
    tris) as int32 CPU tensors, and the static ``grid_res``.

    Every (triangle, cell) pair is listed in triangle order, each
    triangle's box of cells z-major, and a stable sort by cell gives each
    cell's triangles in table order: the lists JAX's loop appends."""
    tris = np.asarray(triangles, np.float32)
    T = len(tris)
    # (T, vertex, axis)
    coords = voxel_coords(tris.reshape(-1, 3)).reshape(T, 3, 3)
    if coords.min() < 0 or coords.max() >= GRID_RES:
        raise ValueError(
            "triangle is out of the world bounds! either extend the world "
            "bounds or move the triangle (cf. win32_main.cpp:1284-1286)")
    lo = coords.min(axis=1)  # (T, 3) per-axis min voxel
    ext = coords.max(axis=1) - lo + 1
    per = ext.prod(axis=1)
    first = np.cumsum(per) - per
    tri = np.repeat(np.arange(T, dtype=np.int64), per)
    k = np.arange(int(per.sum()), dtype=np.int64) - first[tri]
    ex, ey = ext[tri, 0], ext[tri, 1]
    x = lo[tri, 0] + k % ex
    y = lo[tri, 1] + (k // ex) % ey
    z = lo[tri, 2] + k // (ex * ey)
    cells = (z * GRID_RES + y) * GRID_RES + x
    ncells = GRID_RES ** 3
    counts = np.bincount(cells, minlength=ncells)
    starts = np.cumsum(counts) - counts
    refs = np.zeros(max(len(cells), 1), np.int32)
    refs[:len(cells)] = tri[np.argsort(cells, kind="stable")]
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    return as_i32(starts), as_i32(counts), as_i32(refs), GRID_RES
