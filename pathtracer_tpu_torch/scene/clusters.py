"""Host-side clustering for the culled nearest-hit walks (K5, K7).

The port's own numpy copy of ``pathtracer_tpu/scene/clusters.py`` (that
package imports JAX), for spheres and for the streamed mesh tier.
Primitives are grouped by binned surface-area-heuristic splits, falling
back to the longest-axis centroid median, into leaves of at most
``LEAF_SIZE``; a primitive whose AABB spans more than ``HUGE_FRAC`` of the
scene diagonal (the r=1000 ground or sun sphere) goes to an unconditional
"huge" cluster that comes first. Leaves are ordered near-to-far from the
camera. The walk (``ops/intersect.py``) skips a leaf when the ray misses
its box or already has a hit nearer than the box's entry.

A mesh of more than ``CLUSTER_MIN`` triangles keeps its triangles in
cluster order in the precomputed barycentric form
(:func:`triangle_precompute`); up to ``STREAM_MIN`` triangles that is the
static tier. A larger one also gets the streamed tier's tables: parent
boxes over groups of leaves (:func:`build_parents`), record rows with
their own boxes (:func:`pack_stream_clusters`) and, with UVs, the
cluster-field-major uv rows (:func:`pack_stream_uv_cfm`) or, where the
largest cluster holds more than 128 triangles, the uv rows parallel to the
record rows (:func:`pack_stream_uv`). Above ``STREAM_MAX`` triangles
(``STREAM_MAX // 2`` with UVs) a mesh takes the DMA tier, whose parents
regroup under grandparent boxes (:func:`build_parents` applied to the
parents) once there are ``GPARENT_MIN`` of them.

The permutations, records and float32 bounds (rounded outward) equal the
JAX package's bit for bit; the JAX module's ``PT_*`` environment knobs,
its field-major tier and its 128-lane parent rows are not carried over.

The card walks no table in table order: it walks a binary BVH near
first, over the streamed tier's record rows (:func:`build_stream_bvh`),
over the cluster-ordered spheres outside the huge cluster
(:func:`build_sphere_bvh`) and over the static tier's cluster-ordered
triangles outside its huge cluster (:func:`build_static_bvh`), all built
by :func:`_build_bvh`; a mesh of at most ``CLUSTER_MIN`` triangles, which
the JAX package sweeps in table order (K4t), is walked through a BVH over
its triangles' precomputed 64-byte records (:func:`build_brute_bvh`).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def triangle_bounds(tris: np.ndarray):
    """Per-triangle AABBs (float64) from (N, 3, 3) vertex arrays."""
    t = np.asarray(tris, np.float64)
    return t.min(axis=1), t.max(axis=1)


def triangle_precompute(A: np.ndarray, u: np.ndarray, v: np.ndarray) -> dict:
    """The precomputed barycentric form of each triangle, in float32 (the
    JAX package's own operation order, so the records are bit-equal):
    n = normalize(cross(u, v)), d = A . n, w = cross(u, v) / |cross(u, v)|^2,
    e1 = cross(v, w), a0 = e1 . A, e2 = cross(w, u), b0 = e2 . A; a ray
    hits the plane at alpha = e1 . p - a0, beta = e2 . p - b0."""
    A = np.asarray(A, np.float32)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    n = np.cross(u, v).astype(np.float32)
    nn = (n * n).sum(-1).astype(np.float32)
    inv_len = (1.0 / np.sqrt(np.maximum(nn, 1e-30))).astype(np.float32)
    n_unit = (n * inv_len[:, None]).astype(np.float32)
    d_coef = (A * n_unit).sum(-1).astype(np.float32)
    w = (n / np.maximum(nn, 1e-30)[:, None]).astype(np.float32)
    e1 = np.cross(v, w).astype(np.float32)
    e2 = np.cross(w, u).astype(np.float32)
    a0 = (e1 * A).sum(-1).astype(np.float32)
    b0 = (e2 * A).sum(-1).astype(np.float32)
    return dict(n=n_unit, d=d_coef, e1=e1, e2=e2, a0=a0, b0=b0)


# Leaf clusters per parent box in the streamed tier's two-level hierarchy.
PARENT_GROUP = 16
# A DMA-tier mesh with at least this many parents regroups them under
# grandparent boxes (the hierarchy's third level).
GPARENT_MIN = 64


def build_parents(clusters: tuple, group_size: Optional[int] = None,
                  sort_origin=None) -> Tuple[np.ndarray, tuple]:
    """Group leaf clusters (or parents) under boxes by longest-axis median
    splits of their centres, ``group_size`` (default ``PARENT_GROUP``) to
    a box. Returns (perm, parents): the clusters are reordered as
    ``[clusters[i] for i in perm]``, and ``parents`` is a tuple of (first
    cluster, cluster count, mn3 | None, mx3 | None) over that order, the
    huge cluster's parent (bounds None) first. ``sort_origin`` orders the
    parents, and the clusters within each, near-to-far."""
    if group_size is None:
        group_size = PARENT_GROUP
    n = len(clusters)
    huge = [i for i, c in enumerate(clusters) if c[2] is None]
    rest = [i for i, c in enumerate(clusters) if c[2] is not None]
    assert len(huge) <= 1, "at most one unconditional cluster"
    cent = np.array([[(a + b) * 0.5 for a, b in zip(clusters[i][2],
                                                    clusters[i][3])]
                     for i in rest], np.float64).reshape(len(rest), 3)
    groups: list = []

    def split(idx: np.ndarray):
        if len(idx) <= group_size:
            groups.append(idx)
            return
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        half = len(idx) // 2
        part = np.argpartition(c[:, axis], half)
        split(idx[part[:half]])
        split(idx[part[half:]])

    if rest:
        split(np.arange(len(rest)))
    if sort_origin is not None and groups:
        org = np.asarray(sort_origin, np.float64)
        groups.sort(key=lambda idx: float(
            np.linalg.norm(cent[idx].mean(axis=0) - org)))
        for g in groups:
            dist = np.linalg.norm(cent[g] - org, axis=1)
            g[:] = g[np.argsort(dist, kind="stable")]

    perm = list(huge)
    parents = [(0, 1, None, None)] if huge else []
    pos = len(huge)
    for g in groups:
        mnv = np.array([clusters[rest[i]][2] for i in g], np.float32)
        mxv = np.array([clusters[rest[i]][3] for i in g], np.float32)
        parents.append((pos, int(len(g)),
                        tuple(float(x) for x in mnv.min(axis=0)),
                        tuple(float(x) for x in mxv.max(axis=0))))
        perm.extend(rest[i] for i in g)
        pos += int(len(g))
    assert len(perm) == n
    return np.asarray(perm, np.int64), tuple(parents)


# The streamed mesh tier's tables. A cluster's triangle records fill rows
# of 128 floats, 9 records of 13 fields each (n3 d e1(3) a0 e2(3) b0 mat);
# lanes ROW_BOUNDS_LANE.. +5 of a row hold the box (mn3 mx3) of its own 9
# triangles, and a row of padding records holds the far-point box
# ROW_EMPTY_FAR, which no ray enters before its nearest hit.
STREAM_FIELDS = 13
ROW_BOUNDS_LANE = STREAM_FIELDS * STREAM_TRIS_PER_ROW  # 117
ROW_EMPTY_FAR = 3e37
# Meshes of more than STREAM_MIN triangles take the streamed tier; those
# of more than STREAM_MAX (STREAM_MAX // 2 with UVs) the DMA tier, and
# those of more than DMA_MAX none.
STREAM_MIN = 1024
STREAM_MAX = 131072
DMA_MAX = 1 << 20
# Row boxes cull in every mesh of at least this many triangles.
ROW_CULL_MIN = 1024
# The cluster-field-major uv table: 6 rows of 128 lanes per cluster.
UV_CFM_ROWS = 6


def stream_rows_per_cluster(leaf: int) -> int:
    """Record rows per cluster: every cluster pads to this many."""
    return -(-leaf // STREAM_TRIS_PER_ROW)


def pack_stream_clusters(pre: dict, mats: np.ndarray, clusters: tuple,
                         leaf: int, tri_bounds: tuple):
    """The streamed tier's (bounds, pack) tables from
    :func:`triangle_precompute`'s records in cluster order: ``bounds`` one
    (128,) row per cluster (mn3 mx3; a huge cluster +-1e30), ``pack``
    ``stream_rows_per_cluster(leaf)`` record rows per cluster (padding
    records all zero: n = 0 never hits), each row's own box from the
    (bmin, bmax) pair ``tri_bounds`` rounded outward."""
    per = STREAM_TRIS_PER_ROW
    rpc = stream_rows_per_cluster(leaf)
    recs, bounds, row_boxes = [], [], []
    for (off, cnt, mn, mx) in clusters:
        rows = np.zeros((rpc * per, STREAM_FIELDS), np.float32)
        sl = slice(off, off + cnt)
        rows[:cnt, 0:3] = pre["n"][sl]
        rows[:cnt, 3] = pre["d"][sl]
        rows[:cnt, 4:7] = pre["e1"][sl]
        rows[:cnt, 7] = pre["a0"][sl]
        rows[:cnt, 8:11] = pre["e2"][sl]
        rows[:cnt, 11] = pre["b0"][sl]
        rows[:cnt, 12] = mats[sl].astype(np.float32)
        recs.append(rows)
        for r in range(rpc):
            lo = off + r * per
            hi = min(off + (r + 1) * per, off + cnt)
            if lo >= hi:
                row_boxes.append((ROW_EMPTY_FAR,) * 6)
            else:
                rmn, rmx = _bounds_of(tri_bounds[0], tri_bounds[1],
                                      np.arange(lo, hi))
                row_boxes.append(rmn + rmx)
        if mn is None:
            mn, mx = (-1e30,) * 3, (1e30,) * 3
        brow = np.zeros((128,), np.float32)
        brow[0:3] = mn
        brow[3:6] = mx
        bounds.append(brow)
    flat = np.concatenate(recs, axis=0)
    pack = np.zeros((len(flat) // per, 128), np.float32)
    pack[:, :per * STREAM_FIELDS] = flat.reshape(-1, per * STREAM_FIELDS)
    pack[:, ROW_BOUNDS_LANE:ROW_BOUNDS_LANE + 6] = np.asarray(row_boxes,
                                                              np.float32)
    return np.stack(bounds), pack


def stream_slots(x: np.ndarray, clusters: tuple, leaf: int) -> np.ndarray:
    """Per-triangle rows ``x`` ((T, 3), cluster order) laid out as
    :func:`pack_stream_clusters` lays out their records: (rows, 9, 3), row
    ``c * rpc + r`` slot j holding triangle ``off + r * 9 + j`` of cluster
    c (zero for padding)."""
    per = STREAM_TRIS_PER_ROW
    rpc = stream_rows_per_cluster(leaf)
    out = np.zeros((len(clusters) * rpc * per, 3), np.float32)
    for ci, (off, cnt, _, _) in enumerate(clusters):
        out[ci * rpc * per:ci * rpc * per + cnt] = x[off:off + cnt]
    return out.reshape(-1, per, 3)


def pack_stream_uv_cfm(uvt: np.ndarray, clusters: tuple, leaf: int):
    """The uv table, cluster-field-major: row ``c * 6 + k``, lane ``j`` is
    field k (u0 v0 du1 dv1 du2 dv2, texel space) of cluster c's j-th
    triangle; ``uvt`` is the (T, 6) table in cluster order."""
    assert leaf <= 128, "a cluster's triangles must fit the 128 lanes"
    rows = np.zeros((max(len(clusters), 1) * UV_CFM_ROWS, 128), np.float32)
    for ci, (off, cnt, _, _) in enumerate(clusters):
        rows[ci * UV_CFM_ROWS:(ci + 1) * UV_CFM_ROWS, :cnt] = \
            uvt[off:off + cnt].T
    return rows


def pack_stream_uv(uvt: np.ndarray, clusters: tuple, leaf: int):
    """The uv rows parallel to :func:`pack_stream_clusters`' record rows,
    for a streamed UV mesh whose largest cluster exceeds the 128 lanes of
    the cluster-field-major layout: row ``c * rpc + r`` holds the six
    texel-space fields (u0 v0 du1 dv1 du2 dv2) of the same 9 triangles as
    record row r of cluster c, triangle j at lanes ``j * 6 ..`` (lanes 54-127
    zero); ``uvt`` is the (T, 6) table in cluster order."""
    per = STREAM_TRIS_PER_ROW
    rpc = stream_rows_per_cluster(leaf)
    rows = np.zeros((len(clusters) * rpc, 128), np.float32)
    for ci, (off, cnt, _, _) in enumerate(clusters):
        block = np.zeros((rpc * per, 6), np.float32)
        block[:cnt] = uvt[off:off + cnt]
        rows[ci * rpc:(ci + 1) * rpc, :per * 6] = block.reshape(rpc, per * 6)
    return rows


# The card's BVHs (csrc/wave_kernel.cu's bvh_walk, sphere_walk and
# static_walk): binary nodes over
# boxed items, built by _build_bvh. The streamed tier's is over the record
# rows: a leaf is one record row, its box its triangles' bound (every ray
# widens it by its own rounding bound), its records after the row box of
# the pack, bit for bit; a row whose box is ROW_EMPTY_FAR holds no
# triangle and is left out. The
# sphere clusters' is over the cluster-ordered spheres outside the huge
# cluster, at most SPHERE_LEAF to a leaf, a leaf's box the exact float32
# union of its spheres' boxes (each rounded outward, as _bounds_of rounds
# a cluster's). The static tier's is over its cluster-ordered triangles
# outside the huge cluster, at most STATIC_LEAF to a leaf, a leaf's box its
# triangles' bound rounded outward and padded (build_static_bvh). A node
# holds its two children's boxes, each the exact
# float32 min/max union of its own children's boxes, so a node's slab
# entry is never later than its leaves' and the walk never culls a leaf
# that the table-order walk would test with the same nearest hit.
# Node layout, 16 float32 (four 16-byte loads): the left box (mn3 mx3), the
# right box, then as int32 bits the left and right references, an inner
# node's index or BVH_LEAF | first record << 4 | record count for a leaf
# (each a finite float's bits), the count of records ahead of the leaves'
# (BVH_HUGE_WORD of the root node: the static tier's huge cluster, which
# the walk tests first; 0 elsewhere) and a zero word. An absent child (a
# one-leaf tree) is a leaf of no records with a NaN box, which no ray
# enters.
BVH_NODE_FLOATS = 16
BVH_HUGE_WORD = 14
BVH_LEAF = 1 << 30
# Triangle records: 12 float32 per triangle, three 16-byte loads
# (n.xyz d | e1.xyz a0 | e2.xyz b0), contiguous by leaf; beside them each
# record's table-order winner number (bvh_tri_k).
BVH_TRI_FLOATS = 12
# Inner levels of a root-to-leaf path at most: the kernel's near-first walk
# pushes at most one child a level, onto a stack of this many entries.
BVH_MAX_DEPTH = 24
# Subtrees of at most this many items split at the longest-axis median (the
# binned SAH's cost dominates the build there and gains little).
BVH_SAH_MIN = 16
# Spheres per leaf of the sphere BVH at most. An inner node costs the walk
# two box tests (25 FP32 operations each, four 16-byte loads) and a sphere
# test 35 (one 16-byte load): splitting a leaf of 4 into two of 2 adds a
# node's 50 operations to save at most two sphere tests' 70, so leaves of
# up to 4 keep the tree two levels shallower for little wasted testing.
SPHERE_LEAF = 4
# Triangles per leaf of the static tier's BVH at most. SPHERE_LEAF's count
# (a split adds a node's 50 operations to save at most two triangle tests'
# 94) gives 4; leaves of up to 8 took 0.971-1.016x the time of leaves of 4
# on the H100, faster on 4 of 6 cases (the 784- and 736-triangle spheres,
# alone and in fog; chip_smoke.py --parent times both in turns): fewer
# 64-byte node loads per triangle tested.
STATIC_LEAF = 8
# The static tier's leaf boxes are padded outward by this many float32
# ulps of the largest coordinate of its triangles outside the huge cluster
# (as K4t's, BRUTE_PAD_ULPS): the precomputed triangle test can report a
# grazing hit outside the triangle's own bound by its rounding ("A ray
# from far away" below), which the table-order walk's larger cluster boxes
# keep; a looser box costs only box tests, never the least (t, index).
# 2^13 ulps keep the rays of a mesh of well-shaped triangles (shape 2 to
# 10) walked out to about 100 times its largest coordinate; a ray from
# beyond far_bound walks with its boxes widened by its own bound
# (static_walk). K7's walk widens every ray's boxes so, and takes this
# padding only for the reach of its slivers' (mesh_pads).
STATIC_PAD_ULPS = 8192
# A static-tier record's key (bvh_tri_k): its cluster (tri_clusters' row)
# << STATIC_KEY_SHIFT | its cluster-order index << 1 | 1 where a hit on it
# may lie outside its cluster's box (its bound, widened by the padding,
# reaches the box's faces), which the walk then checks. The keys order as
# the indices do, so an equal t still takes the lower index.
STATIC_KEY_SHIFT = 20
# The triangles a mesh's walk sets apart (mesh_pads: degenerate slivers,
# whose test may take a hit anywhere on their plane, which every ray tests;
# then the other slivers, which a ray from beyond the far bound tests)
# follow the tree's records in bvh_tris (bvh_apart: each section's first
# record and count), in groups: a box record, BVH_TRI_FLOATS float32 (mn.xyz, the group's triangle
# count as int32 bits, mx.xyz, five zeros), then the group's triangle
# records; a box record of the groups' union comes first, its count the
# records after it. A group's box is the one the plain walk culls them by
# (the static tier's cluster box, K7's record row's box); the walks test a
# group's triangles wherever the ray enters it before its nearest hit
# before the mesh, and no group where the ray does not enter the union
# then. K7's leaves start with such a box record too: their row's box.
# The sphere BVH's boxes: each sphere's box c -+ r widened by r times this
# on every side (then rounded outward), so that a hit the sphere test takes
# a little outside the sphere, from a ray not beyond sphere_far_bound, lies
# inside its leaf's box.
SPHERE_PAD = 2.0 ** -4

# A ray from far away. A walk's box tests keep every hit the plain version
# takes only while the rounding of that hit stays inside the boxes'
# padding, and that rounding grows with the ray's |o| + |t d|. With u =
# 2^-24, B the largest coordinate of the padded boxes and |t d|_inf <=
# |o|_inf + B (the hit lies in them), K4t's hit point q = o + t d - A
# (brute_records' test) is off the exact point of its computed t by u |t d|
# + u B + 2u B; its barycentrics' crosses and dots (a few ulps of |q| <=
# 2B across each edge) push the triangle's edges out by 7u |q|, which
# moves its corners by that over the sine of their angle, 14u k B with k
# the triangle's shape (the largest 1 / sin of its angles); the plane
# test's t puts the point off the plane by 3 sqrt(3) u (|o| + B); and the
# slab test's entry (box - o) * (1 / d), three roundings, moves 3u |t d|
# along the ray: below 16u |o|_inf + 16u (1 + 2k) B. The static tier's
# precomputed test, alpha = (e1 . o - a0) + t (e1 . d), cancels the ray's
# |o| instead: its edges move by u sqrt(3) (8 |o| + 5 B), its corners by k
# times that, and with the plane and the slab as above all of it is below
# 16u (k + 1) (|o|_inf + B). A ray whose |o|_inf is at most far_bound of
# the padding has every hit the sweep or the table-order walk takes
# inside its leaf's padded box, with the slab test's margin, so the walk
# culls none; a ray from further off walks with every box widened by its
# own bound, 2^-20 (|o|_inf + (1 + 2k) B) for K4t and 2^-20 (k + 1)
# (|o|_inf + B) for the static tier (bvh_wide: the factor and the addend),
# so that it culls none either. A sliver, a triangle whose shape exceeds
# SLIVER (well-shaped meshes stay below 10), is left out of the bound: its
# test can take a hit well outside the triangle at any distance, so on a
# mesh with slivers (a lat-long sphere's pole triangles) neither the
# padded boxes nor the widened walk is exact: the static tier's walk can
# cull a sliver's hit that the table-order walk's cluster box admits, near
# or far (tests/test_torch_far_rays.py::test_static_walk_with_slivers,
# ROADMAP queue 3).
SLIVER = 32.0


def _f32_down(x: float) -> float:
    """``x`` as the largest float32 not above it (inf stays inf)."""
    f = np.float32(x)
    if float(f) > x:
        f = np.nextafter(f, np.float32(-np.inf))
    return float(f)


def _f32_up(x: float) -> float:
    """``x`` as the least float32 not below it."""
    f = np.float32(x)
    if float(f) < x:
        f = np.nextafter(f, np.float32(np.inf))
    return float(f)


def far_bound(pad: float, big: float, per_o: float, per_b: float) -> dict:
    """The far-ray constants of boxes padded by ``pad`` around coordinates
    of magnitude at most ``big``, where a hit's rounding is below u (per_o
    |o|_inf + per_b B), B = big + pad: ``bvh_far``, the largest |o|_inf
    (float32, rounded down) whose hits keep inside the boxes (negative
    where none does), and ``bvh_wide``, the widening u per_o and u per_b B
    / per_o (rounded up) whose product with |o|_inf + that addend holds a
    ray's hits at any |o|_inf."""
    u = 2.0 ** -24
    addend = per_b / per_o * (big + pad)
    return dict(bvh_far=_f32_down(pad / (per_o * u) - addend),
                bvh_wide=(_f32_up(u * per_o), _f32_up(addend)))


# no far-ray bound: every ray walks the boxes as they are
NO_FAR = dict(bvh_far=float("inf"), bvh_wide=(0.0, 0.0))


def _shapes(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Each triangle's shape (1 / sin of its smallest angle: the two longest
    edges' product over |u x v|) of the triangles with edges ``u``, ``v``
    ((n, 3)), float64; inf or NaN where u x v is 0."""
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    e = np.sort(np.stack([np.linalg.norm(x, axis=1) for x in (u, v, v - u)],
                         axis=1), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return e[:, 1] * e[:, 2] / np.linalg.norm(np.cross(u, v), axis=1)


def _shape(u: np.ndarray, v: np.ndarray) -> float:
    """The largest shape (:func:`_shapes`) of the triangles with edges
    ``u``, ``v`` that are not slivers (``SLIVER``), 1 without any."""
    k = _shapes(u, v)
    k = k[np.isfinite(k) & (k <= SLIVER)]
    return float(k.max()) if len(k) else 1.0


def mesh_pads(u: np.ndarray, v: np.ndarray, m: float, big: float):
    """The padding of each triangle (edges ``u``, ``v``, (n, 3)) of a mesh
    walked by the precomputed test (the static tier, K7), whose boxes are
    padded by ``m`` around coordinates of magnitude at most ``big``:
    (pads (n,) float64, apart (n,) bool, far_apart (n,) bool, the far-ray
    constants). A triangle of shape at most ``SLIVER`` takes ``m``, and the
    far bound and widening are :func:`far_bound`'s of ``m`` over the
    largest such shape. A sliver (shape k above ``SLIVER``) takes hits up
    to 16u (k + 1) (|o|_inf + B) outside itself ("A ray from far away"), so
    it is padded by that at the far bound, with B = 2 ``big`` (its padding
    at most ``big``), and set ``far_apart``: a ray from beyond the bound,
    whose widening holds the other triangles' hits, tests it after the
    tree. A sliver whose padding would exceed ``big`` (a degenerate
    triangle, whose test may take a hit anywhere on its plane) is set
    ``apart``: no box holds its hits, so every ray tests it after the tree
    (the groups of set-apart triangles above)."""
    u32 = 2.0 ** -24
    k = _shapes(u, v)
    ok = np.isfinite(k) & (k <= SLIVER)
    kc = float(k[ok].max()) if ok.any() else 1.0
    far = far_bound(m, big, 16.0 * (kc + 1), 16.0 * (kc + 1))
    reach = max(far["bvh_far"], 0.0) + 2.0 * big
    with np.errstate(invalid="ignore", over="ignore"):
        pads = np.where(ok, m, 16.0 * u32 * (k + 1.0) * reach)
    apart = ~ok & ~(pads <= max(big, m))
    return np.where(apart, m, pads), apart, ~ok & ~apart, far


def sphere_far_reach(r: np.ndarray) -> np.ndarray:
    """The largest distance L (float64, per radius ``r``) from a sphere's
    centre to a ray origin whose hit on the sphere keeps inside the
    sphere's box padded by ``SPHERE_PAD`` r. The sphere test
    (``ray_sphere``: rel = o - c, b = 2 rel . d, c' = rel . rel - r^2, disc
    = b^2 - 4 a c', t = (-b - sqrt(disc)) / 2a, |d| = 1) forms disc with an
    absolute error of at most 60u L^2 (b's dot product 24u L^2, b^2 4u L^2,
    rel . rel 12u L^2, the difference with r^2 4u L^2, a's rounding 12u
    L^2, 4 a c' 4u L^2), which cancels against b^2 when the sphere is small
    beside L. The hit point o + t d (exact at the computed t) then lies at
    |p - c|^2 = rho^2 + (t - t_mid)^2 = r^2 + err / 4 from the centre (rho
    the ray's distance from it, t_mid its closest approach), so at most
    r + 15u L^2 / (2r) from it, plus 4u L for rel's rounding and b's along
    the ray, and the slab test's entry 3u (L + r) along it: below 8u L^2 /
    r + 8u L + 4u r, which stays below the padding SPHERE_PAD r while L is
    at most this reach."""
    u = 2.0 ** -24
    r = np.asarray(r, np.float64)
    # 8u x^2 + 8u x + 4u <= SPHERE_PAD for x = L / r
    a, b, c = 8 * u, 8 * u, 4 * u - SPHERE_PAD
    x = (-b + np.sqrt(b * b - 4 * a * c)) / (2 * a)
    return x * r


def _ceil_log2(n: int) -> int:
    return max(0, int(n - 1).bit_length())


def _build_bvh(box: np.ndarray, leaf_size: int, leaf,
               max_depth: int = BVH_MAX_DEPTH) -> tuple:
    """Binary nodes over N items with float32 boxes ``box`` ((N, 6): mn3
    mx3). A subtree of at most ``leaf_size`` items is a leaf, made by
    ``leaf(idx)`` (the items in order; returns its reference and box, and
    lays out its records). Inner nodes split the items by binned SAH
    (:func:`_sah_partition` over the boxes' centres), at the longest-axis
    median for subtrees of at most ``BVH_SAH_MIN`` items and where a split
    would exceed ``max_depth`` inner levels. Returns (nodes ((M, 16)
    float32), the root box as six floats, the inner levels of the deepest
    path)."""
    levels = lambda n: _ceil_log2(-(-n // leaf_size))
    assert len(box) and levels(len(box)) <= max_depth
    bmin, bmax = box[:, :3].astype(np.float64), box[:, 3:].astype(np.float64)
    cent = (bmin + bmax) * 0.5
    nodes: list = []
    depth = [0]

    def node(kids):
        row = np.zeros((BVH_NODE_FLOATS,), np.float32)
        row[0:6], row[6:12] = kids[0][1], kids[1][1]
        row[12:14] = np.asarray([kids[0][0], kids[1][0]],
                                np.int32).view(np.float32)
        return row

    def build(idx: np.ndarray, level: int):
        """(reference, box) of the subtree over items ``idx``, whose root
        sits ``level`` inner levels deep (1 = the root)."""
        if len(idx) <= leaf_size:
            return leaf(idx)
        depth[0] = max(depth[0], level)
        lr = (_sah_partition(idx, cent, bmin, bmax)
              if len(idx) > BVH_SAH_MIN else None)
        if lr is None or (max(levels(len(lr[0])), levels(len(lr[1])))
                          > max_depth - level):
            lr = _median_halves(idx, cent)
        me = len(nodes)
        nodes.append(None)
        kids = [build(part, level + 1) for part in lr]
        nodes[me] = node(kids)
        both = np.stack([kids[0][1], kids[1][1]])
        return me, np.concatenate([both[:, :3].min(0), both[:, 3:].max(0)])

    if len(box) <= leaf_size:
        # one leaf: the root's second child is empty
        ref, root = leaf(np.arange(len(box)))
        empty = (ref & ~15) + ((ref & 15) << 4)  # no records, after these
        nodes.append(node([(ref, root),
                           (empty, np.full((6,), np.nan, np.float32))]))
        depth[0] = 1
    else:
        _, root = build(np.arange(len(box)), 1)
    return np.stack(nodes), tuple(float(v) for v in root), depth[0]


def _box_record(mn, mx, count: int) -> np.ndarray:
    """A group's box record (``BVH_TRI_FLOATS`` float32): mn.xyz, the
    count as int32 bits, mx.xyz, then zeros."""
    r = np.zeros((BVH_TRI_FLOATS,), np.float32)
    r[0:3], r[4:7] = mn, mx
    r[3] = np.asarray([count], np.int32).view(np.float32)[0]
    return r


def _apart_records(groups) -> tuple:
    """The set-apart groups' (records, keys), each group (box mn, box mx,
    records (c, 12), keys (c,)) as its box record and its records, after
    a box record of their boxes' union whose count is the records after
    it; an empty table without any."""
    recs, keys = [], []
    for mn, mx, r, k in groups:
        recs += [_box_record(mn, mx, len(r))[None], r]
        keys += [np.zeros((1,), np.int64), np.asarray(k, np.int64)]
    if not recs:
        return (np.zeros((0, BVH_TRI_FLOATS), np.float32),
                np.zeros((0,), np.int64))
    mn = np.min([np.float32(g[0]) for g in groups], axis=0)
    mx = np.max([np.float32(g[1]) for g in groups], axis=0)
    n = sum(len(r) for r in recs)
    return (np.concatenate([_box_record(mn, mx, n)[None]] + recs)
            .astype(np.float32),
            np.concatenate([np.zeros((1,), np.int64)] + keys))


def build_stream_bvh(pack: np.ndarray, rpc: int, uv_numbering: bool,
                     tris) -> dict:
    """The streamed tier's BVH over :func:`pack_stream_clusters`' record
    rows (``pack``, ``rpc`` rows per cluster, in table order), one leaf per
    row (:func:`_build_bvh`), ``tris`` the (A, u, v) of each record ((rows,
    9, 3) float32 each, zero for padding). A row's triangles are its
    records that can hit (a record not all zero), but for those set apart
    (:func:`mesh_pads`); each record carries its table-order winner number,
    as the kernel and the plain walks number it: ``c * UV_CFM_ROWS * 128 +
    r * 9 + j`` for slot j of row r of cluster c with the
    cluster-field-major uv rows (``uv_numbering``: its uv column), ``row *
    9 + j`` otherwise (the record, which also keys the parallel uv rows of
    :func:`pack_stream_uv`). A leaf's records start with a box record, its
    row's box as the pack holds it (a set-apart group's box record): the plain
    walk tests a row's records only where the ray enters that box (and so
    its cluster's and parents', which hold it) before its nearest hit
    before the mesh, and so does the walk. The leaf's own box is its
    triangles' float64 bound (a sliver's padded by its own bound at the
    far bound, :func:`mesh_pads` of ``STATIC_PAD_ULPS`` ulps of the mesh's
    largest coordinate) rounded outward; every ray widens every box by
    its own bound, ``bvh_wide`` (16u (k + 1) (|o|_inf + B) over the
    shapes k of the triangles that are not slivers), so that the boxes
    hold every hit the plain walk takes (a ray from beyond the far bound
    tests the slivers after the tree). The triangles set apart follow, by row, each row
    after its box record, in two sections (``bvh_apart``: every ray's,
    then a far ray's).

    Returns ``bvh_nodes`` ((M, 16) float32), ``bvh_tris`` ((T, 12)
    float32), ``bvh_tri_k`` ((T,) int32), ``bvh_root`` (the root box, mn3 +
    mx3), ``bvh_depth`` (inner levels of the deepest path), ``bvh_apart``
    (each section's first record and records) and the far-ray constants
    ``bvh_far`` and ``bvh_wide``."""
    per = STREAM_TRIS_PER_ROW
    lane = ROW_BOUNDS_LANE
    recs = pack[:, :per * STREAM_FIELDS].reshape(len(pack), per,
                                                  STREAM_FIELDS)
    a, e1, e2 = (np.asarray(x, np.float32).astype(np.float64) for x in tris)
    hit = (recs[..., :BVH_TRI_FLOATS] != 0).any(axis=2)
    hit &= (pack[:, lane] != np.float32(ROW_EMPTY_FAR))[:, None]
    corners = np.stack([a, a + e1, a + e2])
    lo, hi = corners.min(axis=0), corners.max(axis=0)
    big = float(np.abs(np.concatenate([lo[hit], hi[hit]])).max())
    m = STATIC_PAD_ULPS * float(np.spacing(np.float32(big)))
    pads = np.zeros(hit.shape)
    apart, far_apart = np.zeros(hit.shape, bool), np.zeros(hit.shape, bool)
    pads[hit], apart[hit], far_apart[hit], far = mesh_pads(
        np.asarray(tris[1], np.float32)[hit],
        np.asarray(tris[2], np.float32)[hit], m, big)
    # every ray widens its boxes by its own bound, which holds the hits of
    # every triangle but a sliver's: only a sliver's box is padded
    pads = np.where(far_apart, pads, 0.0)
    tree = hit & ~apart
    rows = np.nonzero(tree.any(axis=1))[0]
    assert int(tree.sum()) + len(rows) < (1 << 26), "leaf references overflow"
    out = lambda x, way: np.nextafter(x.astype(np.float32), np.float32(way))
    lo_p = np.where(tree[..., None], lo - pads[..., None], np.inf)
    hi_p = np.where(tree[..., None], hi + pads[..., None], -np.inf)
    box = np.concatenate([out(lo_p[rows].min(axis=1), -np.inf),
                          out(hi_p[rows].max(axis=1), np.inf)], axis=1)
    number = lambda r, j: (((r // rpc) * UV_CFM_ROWS * 128 + (r % rpc) * per)
                           if uv_numbering else r * per) + j
    out_recs, out_k = [], []
    n_recs = [0]

    def leaf(idx: np.ndarray):
        r = int(rows[idx[0]])
        j = np.nonzero(tree[r])[0]
        ref = BVH_LEAF | n_recs[0] << 4 | len(j)
        out_recs.extend([_box_record(pack[r, lane:lane + 3],
                                     pack[r, lane + 3:lane + 6], len(j))[None],
                         recs[r, j, :BVH_TRI_FLOATS]])
        out_k.extend([np.zeros((1,), np.int64), number(r, j)])
        n_recs[0] += 1 + len(j)
        return ref, box[idx[0]]

    nodes, root, depth = _build_bvh(box, 1, leaf)
    sections = [_apart_records([
        (pack[r, lane:lane + 3], pack[r, lane + 3:lane + 6],
         recs[r, j, :BVH_TRI_FLOATS], number(r, j))
        for r in np.nonzero(sel.any(axis=1))[0]
        for j in [np.nonzero(sel[r])[0]]]) for sel in (apart, far_apart)]
    n_all, n_far = (len(sec[0]) for sec in sections)
    bvh_tris = np.concatenate(out_recs + [sec[0] for sec in sections])
    return dict(bvh_nodes=nodes, bvh_tris=np.ascontiguousarray(bvh_tris),
                bvh_tri_k=np.concatenate(
                    out_k + [sec[1] for sec in sections]).astype(np.int32),
                bvh_root=root, bvh_depth=depth,
                bvh_apart=(n_recs[0], n_all, n_recs[0] + n_all, n_far), **far)


def build_sphere_bvh(centers: np.ndarray, radii: np.ndarray,
                     sph_clusters: tuple) -> dict:
    """The sphere clusters' BVH over the cluster-ordered spheres
    (``centers`` (N, 3) and ``radii`` (N,) float32, the ``csph_*`` tables)
    of every cluster but the huge one, which the walk tests first as the
    table-order walk does. Leaves hold at most ``SPHERE_LEAF`` spheres,
    contiguous; each sphere's box is its float64 centre -+ radius widened
    by ``SPHERE_PAD`` times the radius, rounded outward to float32.

    Returns ``sbvh_nodes`` ((M, 16) float32, :func:`_build_bvh`'s nodes),
    ``sbvh_sph`` ((S, 4) float32: cx cy cz r, contiguous by leaf),
    ``sbvh_idx`` ((S,) int32: each record's cluster-order index),
    ``sbvh_root`` (the root box, mn3 + mx3; () when every sphere is huge),
    ``sbvh_depth`` and ``sbvh_far``, the far path's constants, float32:
    z.xyz, the centre of the spheres' bound, and R, the least
    :func:`sphere_far_reach` less its sphere's distance from z, rounded
    down with a margin for the kernel's float32 |o - z|^2 (a ray whose
    origin lies further than R from z may take a hit outside its sphere's
    padded box: it walks the BVH with every box widened by its own bound
    below; R is negative where a sphere lies beyond its own reach of z,
    small spheres spread wide, and then every ray does, the walk comparing
    |o - z|^2 with R |R|; infinite R when every sphere is huge); then 8u / r_min, D = the
    largest |c - z| and M = D + 2 |z|_inf + r_max, each rounded up. A
    sphere's test takes a hit only from a ray that passes within r + 15u
    L^2 / (2r) of its centre (L = |o - c| <= |o - z| + D;
    :func:`sphere_far_reach`), inside the sphere's box widened by that, so
    a ray that misses a box widened by 8u (|o - z| + D)^2 / r_min, and by
    16u (|o - z| + M) for the slab test's rounding, takes no hit in it."""
    items = np.concatenate([np.arange(off, off + cnt, dtype=np.int64)
                            for off, cnt, mn, _ in sph_clusters
                            if mn is not None] or [np.zeros((0,), np.int64)])
    if not len(items):
        return dict(sbvh_nodes=np.zeros((1, BVH_NODE_FLOATS), np.float32),
                    sbvh_sph=np.zeros((1, 4), np.float32),
                    sbvh_idx=np.zeros((1,), np.int32), sbvh_root=(),
                    sbvh_depth=0,
                    sbvh_far=(0.0, 0.0, 0.0, float("inf"), 0.0, 0.0, 0.0, 0.0))
    c = np.asarray(centers, np.float32)[items]
    r = np.asarray(radii, np.float32)[items]
    lo, hi = sphere_bounds(c, r)
    z32 = ((lo.min(axis=0) + hi.max(axis=0)) * 0.5).astype(np.float32)
    dz = np.linalg.norm(c.astype(np.float64) - z32.astype(np.float64), axis=1)
    reach = (sphere_far_reach(r) - dz).min()
    u = 2.0 ** -24
    big_d = float(dz.max())
    far = (*(float(v) for v in z32), _f32_down(reach * (1.0 - 2.0 ** -16)),
           _f32_up(8 * u / float(r.min())), _f32_up(big_d),
           _f32_up(big_d + 2 * float(np.abs(z32).max()) + float(r.max())),
           0.0)
    m = SPHERE_PAD * r.astype(np.float64)[:, None]
    lo, hi = lo - m, hi + m
    box = np.concatenate(
        [np.nextafter(lo.astype(np.float32), np.float32(-np.inf)),
         np.nextafter(hi.astype(np.float32), np.float32(np.inf))], axis=1)
    order: list = []

    def leaf(idx: np.ndarray):
        ref = BVH_LEAF | len(order) << 4 | len(idx)
        order.extend(int(i) for i in idx)
        return ref, np.concatenate([box[idx, :3].min(0), box[idx, 3:].max(0)])

    nodes, root, depth = _build_bvh(box, SPHERE_LEAF, leaf)
    order = np.asarray(order, np.int64)
    return dict(sbvh_nodes=nodes,
                sbvh_sph=np.ascontiguousarray(
                    np.concatenate([c[order], r[order, None]], axis=1)),
                sbvh_idx=items[order].astype(np.int32), sbvh_root=root,
                sbvh_depth=depth, sbvh_far=far)


def build_static_bvh(pre: dict, A: np.ndarray, u: np.ndarray, v: np.ndarray,
                     tri_clusters: tuple) -> dict:
    """The static tier's BVH over its cluster-ordered triangles
    (:func:`triangle_precompute`'s records ``pre`` and the float32 vertex
    arrays ``A``, ``u``, ``v`` they were made from, all in cluster order)
    outside the huge cluster. The walk tests the huge cluster first, in
    order, as the table-order walk does: its triangles are records 0 ..
    n-1, n in the root node's ``BVH_HUGE_WORD``. Leaves hold at most
    ``STATIC_LEAF`` triangles, contiguous after them; a triangle whose
    record is all zero (a zero normal: it never hits) is left out, as
    :func:`build_stream_bvh` leaves such records out. A leaf's box is the
    float64 bound of its triangles' vertices A, A + u, A + v (the triangle
    the precomputed test sees), padded by ``STATIC_PAD_ULPS`` ulps of the
    largest coordinate of those triangles and rounded outward to float32.
    Records are :func:`build_stream_bvh`'s (n.xyz d | e1.xyz a0 | e2.xyz
    b0), bit for bit, each with its key (its cluster, cluster-order index
    and check bit, ``STATIC_KEY_SHIFT``).

    Returns ``bvh_nodes``, ``bvh_tris``, ``bvh_tri_k``, ``bvh_root`` (()
    when every triangle is huge: no ray enters it) and ``bvh_depth``, as
    :func:`build_stream_bvh` does, and ``bvh_far`` and ``bvh_wide``
    (:func:`far_bound` of the padding: a ray with a larger |o|_inf walks
    with its boxes widened and its winner's cluster box tested)."""
    assert STATIC_LEAF <= 15, "a leaf's count fits its reference's 4 bits"
    n_tri = sum(c[1] for c in tri_clusters)
    huge = [c for c in tri_clusters if c[2] is None]
    assert len(huge) <= 1 and (not huge or huge[0][0] == 0), \
        "the huge cluster comes first"
    n_huge = huge[0][1] if huge else 0
    rec = np.concatenate(
        [pre["n"][:n_tri], pre["d"][:n_tri, None], pre["e1"][:n_tri],
         pre["a0"][:n_tri, None], pre["e2"][:n_tri], pre["b0"][:n_tri, None]],
        axis=1).astype(np.float32)
    a = np.asarray(A, np.float64)[:n_tri]
    corners = np.stack([a, a + np.asarray(u, np.float64)[:n_tri],
                        a + np.asarray(v, np.float64)[:n_tri]])
    lo, hi = corners.min(axis=0), corners.max(axis=0)
    big = float(np.abs(np.concatenate([lo[n_huge:], hi[n_huge:]])).max()
                if n_tri > n_huge else 0.0)
    m = STATIC_PAD_ULPS * float(np.spacing(np.float32(big)))
    pads = np.full((n_tri,), m)
    apart, far_apart = np.zeros((n_tri,), bool), np.zeros((n_tri,), bool)
    far = NO_FAR
    if n_tri > n_huge:
        pads[n_huge:], apart[n_huge:], far_apart[n_huge:], far = mesh_pads(
            np.asarray(u)[n_huge:n_tri], np.asarray(v)[n_huge:n_tri], m, big)
    assert n_tri < 1 << (STATIC_KEY_SHIFT - 1) \
        and len(tri_clusters) < 1 << (31 - STATIC_KEY_SHIFT)
    key = np.arange(n_tri, dtype=np.int64) << 1
    groups = ([], [])  # every ray's, a far ray's
    # an all-zero record (u x v = 0: a zero normal) never hits
    can_hit = rec.any(axis=1)
    for c, (off, cnt, cmn, cmx) in enumerate(tri_clusters):
        sl = slice(off, off + cnt)
        key[sl] |= c << STATIC_KEY_SHIFT
        if cmn is not None:  # the huge cluster is always tested
            p = pads[sl, None]
            inside = ((lo[sl] - p > np.asarray(cmn)).all(axis=1)
                      & (hi[sl] + p < np.asarray(cmx)).all(axis=1))
            key[sl] |= (~inside).astype(np.int64)
            for sel, out in zip((apart, far_apart), groups):
                j = off + np.nonzero(sel[sl] & can_hit[sl])[0]
                if len(j):
                    out.append((cmn, cmx, rec[j], key[j]))
    sections = [_apart_records(g) for g in groups]
    ar = np.concatenate([sec[0] for sec in sections])
    ak = np.concatenate([sec[1] for sec in sections])
    n_all, n_far = (len(sec[0]) for sec in sections)
    items = n_huge + np.nonzero(can_hit[n_huge:] & ~apart[n_huge:])[0]
    huge_bits = np.asarray([n_huge], np.int32).view(np.float32)[0]
    if not len(items):
        nodes = np.zeros((1, BVH_NODE_FLOATS), np.float32)
        nodes[0, BVH_HUGE_WORD] = huge_bits
        tris = np.concatenate([rec[:n_huge], ar])
        k = np.concatenate([key[:n_huge], ak])
        if not len(tris):
            tris, k = np.zeros((1, BVH_TRI_FLOATS), np.float32), np.zeros(1)
        return dict(bvh_nodes=nodes, bvh_tris=tris,
                    bvh_tri_k=k.astype(np.int32), bvh_root=(), bvh_depth=0,
                    bvh_apart=(n_huge, n_all, n_huge + n_all, n_far), **far)
    out = lambda x, way: np.nextafter(x.astype(np.float32), np.float32(way))
    box = np.concatenate([out(lo[items], -np.inf), out(hi[items], np.inf)],
                         axis=1)
    order: list = []

    def leaf(idx: np.ndarray):
        sel = items[idx]
        ref = BVH_LEAF | (n_huge + len(order)) << 4 | len(idx)
        order.extend(int(i) for i in sel)
        p = pads[sel, None]
        mn, mx = (lo[sel] - p).min(axis=0), (hi[sel] + p).max(axis=0)
        return ref, np.concatenate([out(mn, -np.inf), out(mx, np.inf)])

    nodes, root, depth = _build_bvh(box, STATIC_LEAF, leaf)
    nodes[0, BVH_HUGE_WORD] = huge_bits
    keep = np.concatenate([np.arange(n_huge), np.asarray(order, np.int64)])
    return dict(bvh_nodes=nodes,
                bvh_tris=np.ascontiguousarray(np.concatenate([rec[keep], ar])),
                bvh_tri_k=np.concatenate([key[keep], ak]).astype(np.int32),
                bvh_root=root, bvh_depth=depth,
                bvh_apart=(len(keep), n_all, len(keep) + n_all, n_far), **far)


# K4t's BVH (csrc/wave_kernel.cu's brute_walk) over a mesh of at most
# CLUSTER_MIN triangles, which the JAX package sweeps in table order.
# Triangle records: 16 float32 per triangle, four 16-byte loads, with every
# value of the sweep's test (ray_planar_triangle_uv) that depends on the
# triangle alone: n_unit.xyz d | w.xyz v.z | A.xyz u.x | u.y u.z v.x v.y,
# where n_unit = normalize(cross(u, v), 1e-30), d = A . n_unit and w =
# cross(u, v) * (1 / (cross(u, v) . cross(u, v))).
BRUTE_REC_FLOATS = 16
# Triangles per leaf at most. An inner node costs the walk two box tests
# (25 FP32 operations each, four 16-byte loads) and a triangle test 63
# (four 16-byte loads), so a split saves operations only where it culls
# more than a test in four. In turns on the H100 (chip_smoke.py --parent,
# 720p 4 spp, two runs: the 40-triangle sphere through either camera and
# in fog, the everything scene, the combined set beside that sphere)
# leaves of up to 4 took 1.000-1.066x the time of leaves of 8, leaves of
# up to 12 0.987-1.069x.
BRUTE_LEAF = 8
# A mesh of at most this many triangles that can hit is not walked but swept
# in table order from its records (bvh_nodes' BVH_HUGE_WORD counts them, no
# node, a NaN root): its tree would be one leaf, whose box is the only cull
# and whose node costs two box tests and a stack beside a test of 63 FP32
# operations a triangle. Walked, the everything scene's one triangle took
# 1.088x and 1.092x the time swept (through either camera, in turns on the
# H100, chip_smoke.py --parent).
BRUTE_SWEEP_MAX = BRUTE_LEAF
# Inner levels at most: the kernel's stack holds BRUTE_MAX_DEPTH entries
# (BRUTE_STACK), in the feature variants' exchange buffer where no other
# walk's stack is there.
BRUTE_MAX_DEPTH = 8
# A leaf's box is its triangles' float64 bound padded outward by this many
# float32 ulps of the mesh's largest coordinate, then rounded outward. The
# sweep takes a hit where its float32 expressions say so: a hit point
# rounded onto the triangle's edge from outside it, by the rounding of the
# coordinates and of |o| + |t d|, which stays inside the padding for a ray
# whose |o|_inf is at most far_bound of it (2^11 ulps over 16u: 128 to 256
# times the mesh's largest coordinate, less the triangles' shape's share); a
# ray from further off walks with its boxes widened (brute_walk).
# Without the padding the walk loses winners on grazing rays
# (tests/test_torch_brute_bvh.py). A looser box costs only box tests,
# never the least (t, index).
BRUTE_PAD_ULPS = 2048


def _cross32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """utils/vec.py::cross on (N, 3) float32 rows, one rounding per
    operation in its order (np.cross may contract or reorder)."""
    x, y, z = (a[:, k] for k in range(3))
    bx, by, bz = (b[:, k] for k in range(3))
    return np.stack([y * bz - by * z, z * bx - bz * x, x * by - bx * y],
                    axis=1)


def _dot32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """utils/vec.py::dot on (N, 3) float32 rows: (x x' + y y') + z z'."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def brute_records(A: np.ndarray, u: np.ndarray, v: np.ndarray,
                  n_unit=None) -> np.ndarray:
    """K4t's precomputed records ((N, 16) float32, ``BRUTE_REC_FLOATS``'s
    layout) of the triangles A, A + u, A + v ((N, 3) each), every value
    formed elementwise in float32 in the sweep's own operation order, so
    that it equals the value the sweep computes per test bit for bit; with
    ``n_unit`` ((N, 3)) the unit normals as given (the quads' baked
    ``quad_n``, which their test reads) in place of normalize(cross(u, v),
    1e-30)."""
    f32 = np.float32
    A, u, v = (np.asarray(x, f32).reshape(-1, 3) for x in (A, u, v))
    n = _cross32(u, v)
    if n_unit is None:
        m = np.maximum(np.sqrt(_dot32(n, n)), f32(1e-30))
        n_unit = n * (f32(1.0) / m)[:, None]
    n_unit = np.asarray(n_unit, f32).reshape(-1, 3)
    # a degenerate triangle's w is inf * 0: NaN, as in the sweep (no hit)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = n * (f32(1.0) / _dot32(n, n))[:, None]
    rec = np.concatenate([n_unit, _dot32(A, n_unit)[:, None], w, v[:, 2:3],
                          A, u, v[:, 0:2]], axis=1)
    return np.ascontiguousarray(rec.astype(f32))


def build_brute_bvh(A: np.ndarray, u: np.ndarray, v: np.ndarray) -> dict:
    """K4t's BVH over the ``n`` triangles A, A + u, A + v ((n, 3) float32
    each, table order, 1 <= n <= ``CLUSTER_MIN``) that can hit: leaves of
    at most ``BRUTE_LEAF`` triangles, contiguous by leaf, each leaf's box
    the float64 bound of its triangles' vertices padded by
    ``BRUTE_PAD_ULPS`` and rounded outward (so every hit the sweep takes
    lies inside the box of its triangle's leaf), nodes as
    :func:`_build_bvh` makes them, at most ``BRUTE_MAX_DEPTH`` inner
    levels. A triangle whose w is not finite (|cross(u, v)|^2 is 0 or
    denormal) is left out: its alpha or beta is infinite or NaN, and the
    sweep never takes it. The walk takes the least (t, table index): a tie
    between triangles goes to the lower index, as the sweep's strict-<
    carry in table order gives it. At most ``BRUTE_SWEEP_MAX`` triangles
    that can hit get no tree: their records, in table order, are counted
    in the one node's ``BVH_HUGE_WORD`` and swept in order.

    Returns ``bvh_nodes``, ``bvh_tris`` ((m, 16) float32:
    :func:`brute_records`, by leaf), ``bvh_tri_k`` ((m,) int32: each
    record's table index), ``bvh_root`` (() when no triangle is walked: no
    ray enters it), ``bvh_depth`` and ``bvh_far`` and ``bvh_wide``
    (:func:`far_bound` of the padding: a ray with a larger |o|_inf walks
    with its boxes widened; no bound without a tree)."""
    assert BRUTE_LEAF <= 15, "a leaf's count fits its reference's 4 bits"
    A, u, v = (np.asarray(x, np.float32).reshape(-1, 3) for x in (A, u, v))
    assert 1 <= len(A) <= CLUSTER_MIN
    rec = brute_records(A, u, v)
    items = np.nonzero(np.isfinite(rec[:, 4:7]).all(axis=1))[0]
    if len(items) <= BRUTE_SWEEP_MAX:
        nodes = np.zeros((1, BVH_NODE_FLOATS), np.float32)
        nodes[0, BVH_HUGE_WORD] = np.asarray([len(items)],
                                             np.int32).view(np.float32)[0]
        return dict(bvh_nodes=nodes,
                    bvh_tris=np.ascontiguousarray(rec[items]) if len(items)
                    else np.zeros((1, BRUTE_REC_FLOATS), np.float32),
                    bvh_tri_k=items.astype(np.int32) if len(items)
                    else np.zeros((1,), np.int32), bvh_root=(), bvh_depth=0,
                    bvh_apart=(0, 0, 0, 0), **NO_FAR)
    a = A[items].astype(np.float64)
    corners = np.stack([a, a + u[items].astype(np.float64),
                        a + v[items].astype(np.float64)])
    lo, hi = corners.min(axis=0), corners.max(axis=0)
    big = np.abs(np.concatenate([lo, hi])).max()
    pad = BRUTE_PAD_ULPS * float(np.spacing(np.float32(big)))
    kc = _shape(u[items], v[items])
    out = lambda x, way: np.nextafter(x.astype(np.float32), np.float32(way))
    box = np.concatenate([out(lo - pad, -np.inf), out(hi + pad, np.inf)],
                         axis=1)
    order: list = []

    def leaf(idx: np.ndarray):
        ref = BVH_LEAF | len(order) << 4 | len(idx)
        order.extend(int(i) for i in items[idx])
        return ref, np.concatenate([box[idx, :3].min(0), box[idx, 3:].max(0)])

    nodes, root, depth = _build_bvh(box, BRUTE_LEAF, leaf, BRUTE_MAX_DEPTH)
    assert depth <= BRUTE_MAX_DEPTH
    order = np.asarray(order, np.int64)
    return dict(bvh_nodes=nodes, bvh_tris=np.ascontiguousarray(rec[order]),
                bvh_tri_k=order.astype(np.int32), bvh_root=root,
                bvh_depth=depth, bvh_apart=(0, 0, 0, 0),
                **far_bound(pad, big, 16.0, 16.0 * (1 + 2 * kc)))
