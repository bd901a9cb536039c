"""Host-side sphere clustering for the culled nearest-hit walk (K5).

The port's own numpy copy of the sphere half of
``pathtracer_tpu/scene/clusters.py`` (that package imports JAX). Spheres
are grouped by binned surface-area-heuristic splits, falling back to the
longest-axis centroid median, into leaves of at most ``LEAF_SIZE``; a
sphere whose AABB spans more than ``HUGE_FRAC`` of the scene diagonal (the
r=1000 ground or sun sphere) goes to an unconditional "huge" cluster that
comes first. Leaves are ordered near-to-far from the camera. The walk
(``ops/intersect.py`` and ``csrc/wave_kernel.cu``) skips a leaf when the
ray misses its box or already has a hit nearer than the box's entry.

The permutation and the float32 bounds (rounded outward) equal the JAX
package's bit for bit; the JAX module's ``PT_*`` environment knobs are
not carried over.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Primitives per leaf cluster.
LEAF_SIZE = 96
# Tables at or below this size are swept without clusters.
CLUSTER_MIN = 64
# A primitive whose AABB diagonal exceeds this fraction of the scene
# diagonal goes to the unconditional "huge" cluster.
HUGE_FRAC = 0.3
# Within a leaf, primitives are ordered in spatially tight groups of this
# many (the JAX package's mesh record-row width); kept for the same order.
STREAM_TRIS_PER_ROW = 9


def _sah_partition(idx: np.ndarray, centroids: np.ndarray,
                   bmin: np.ndarray, bmax: np.ndarray, nbins: int = 16):
    """Binned SAH split of ``idx``: the (axis, boundary) of ``nbins`` bins
    per axis minimizing N_L*area(L) + N_R*area(R) over the primitives'
    AABBs. Returns (left, right) index arrays, or None when every axis is
    degenerate."""
    c = centroids[idx]
    lo, hi = c.min(axis=0), c.max(axis=0)
    ext = hi - lo
    best = None  # (cost, axis, boundary_bin, bins)
    for axis in range(3):
        if ext[axis] <= 0.0:
            continue
        b = np.minimum(((c[:, axis] - lo[axis]) * (nbins / ext[axis]))
                       .astype(np.int64), nbins - 1)
        counts = np.bincount(b, minlength=nbins)
        if counts.max() == len(idx):
            continue
        binmn = np.full((nbins, 3), np.inf)
        binmx = np.full((nbins, 3), -np.inf)
        np.minimum.at(binmn, b, bmin[idx])
        np.maximum.at(binmx, b, bmax[idx])
        pmn = np.minimum.accumulate(binmn, axis=0)
        pmx = np.maximum.accumulate(binmx, axis=0)
        smn = np.minimum.accumulate(binmn[::-1], axis=0)[::-1]
        smx = np.maximum.accumulate(binmx[::-1], axis=0)[::-1]
        nl = np.cumsum(counts)[:-1]
        nr = len(idx) - nl

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                          + d[:, 2] * d[:, 0])

        cost = nl * area(pmn[:-1], pmx[:-1]) + nr * area(smn[1:], smx[1:])
        cost = np.where((nl > 0) & (nr > 0), cost, np.inf)
        k = int(np.argmin(cost))
        if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
            best = (float(cost[k]), axis, k, b)
    if best is None:
        return None
    _, axis, k, b = best
    return idx[b <= k], idx[b > k]


def _bounds_of(bmin: np.ndarray, bmax: np.ndarray, idx) -> tuple:
    """Cluster AABB as float32 values rounded OUTWARD from the float64
    build math, so that rounding never shrinks a face and culls a grazing
    hit."""
    mn = np.nextafter(bmin[idx].min(axis=0).astype(np.float32),
                      np.float32(-np.inf))
    mx = np.nextafter(bmax[idx].max(axis=0).astype(np.float32),
                      np.float32(np.inf))
    return (tuple(float(v) for v in mn), tuple(float(v) for v in mx))


def _median_halves(idx: np.ndarray, centroids: np.ndarray):
    c = centroids[idx]
    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
    half = len(idx) // 2
    part = np.argpartition(c[:, axis], half)
    return idx[part[:half]], idx[part[half:]]


def build_clusters(bmin: np.ndarray, bmax: np.ndarray,
                   sort_origin=None) -> Tuple[np.ndarray, tuple]:
    """Cluster primitives by their (N, 3) AABB corners.

    Returns (order, clusters): the primitive tables are reordered as
    ``table[order]``, and ``clusters`` is a tuple of (offset, count,
    mn3 | None, mx3 | None) over the reordered tables, the huge cluster
    (bounds None) first. ``sort_origin`` (the camera position) orders the
    leaves, and the groups within each leaf, near-to-far."""
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    n = len(bmin)
    assert bmax.shape == bmin.shape and bmin.shape == (n, 3)

    scene_diag = float(np.linalg.norm(bmax.max(axis=0) - bmin.min(axis=0)))
    diag = np.linalg.norm(bmax - bmin, axis=1)
    huge = diag > HUGE_FRAC * max(scene_diag, 1e-30)
    huge_idx = np.nonzero(huge)[0]
    rest_idx = np.nonzero(~huge)[0]
    centroids = (bmin + bmax) * 0.5
    org = None if sort_origin is None else np.asarray(sort_origin, np.float64)
    leaves: list = []

    def row_order(idx: np.ndarray) -> np.ndarray:
        """Recursive median split of a leaf into groups of at most
        STREAM_TRIS_PER_ROW, near-to-far when there is an origin."""
        if len(idx) <= STREAM_TRIS_PER_ROW:
            return idx
        groups: list = []

        def sub(ii: np.ndarray):
            if len(ii) <= STREAM_TRIS_PER_ROW:
                groups.append(ii)
                return
            for half in _median_halves(ii, centroids):
                sub(half)

        sub(idx)
        if org is not None:
            groups.sort(key=lambda g: float(
                np.linalg.norm(centroids[g].mean(axis=0) - org)))
        return np.concatenate(groups)

    def split(idx: np.ndarray):
        if len(idx) <= LEAF_SIZE:
            leaves.append(row_order(idx))
            return
        lr = _sah_partition(idx, centroids, bmin, bmax)
        # reject lopsided splits (a 1-vs-N chain would recurse O(N) deep)
        if lr is None or min(len(lr[0]), len(lr[1])) < len(idx) // 16:
            lr = _median_halves(idx, centroids)
        split(lr[0])
        split(lr[1])

    if len(rest_idx):
        split(rest_idx)
    if org is not None and leaves:
        leaves.sort(key=lambda idx: float(
            np.linalg.norm(centroids[idx].mean(axis=0) - org)))

    order = (np.concatenate([huge_idx] + leaves) if (len(huge_idx) or leaves)
             else np.zeros((0,), np.int64))
    clusters = []
    off = 0
    if len(huge_idx):
        clusters.append((0, int(len(huge_idx)), None, None))
        off = int(len(huge_idx))
    for leaf in leaves:
        mn, mx = _bounds_of(bmin, bmax, leaf)
        clusters.append((off, int(len(leaf)), mn, mx))
        off += int(len(leaf))
    return order.astype(np.int64), tuple(clusters)


def sphere_bounds(centers: np.ndarray, radii: np.ndarray):
    """Per-sphere AABBs (float64) from (N, 3) centers and (N,) radii."""
    c = np.asarray(centers, np.float64)
    r = np.asarray(radii, np.float64)[:, None]
    return c - r, c + r
