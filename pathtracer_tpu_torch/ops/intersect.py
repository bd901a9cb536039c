"""Batched ray-primitive intersection, lane-parallel over (N,) rays.

Counterpart of ``pathtracer_tpu/ops/intersect.py``: the analytic
intersectors and the scene sweep in the reference's category order
(spheres -> quads -> planes -> boxes) with strict-< updates, quads accepted
at the Cornell-box minHit of 0.02, and a miss reported as (t = F32_MAX,
material 0, normal 0). Each sweep is a Python loop over the table's real
rows; the JAX package's unroll and chunking are kernel shapes that give the
same nearest hit.

A scene with sphere clusters takes the clustered walk of the JAX kernel
(``_intersect_clustered_idx`` with its ``_windowed_lut`` resolve, K5 and
K6): per cluster a slab test culls the batch unless some lane is relevant,
the tests carry (t, winner index), and the winner's material and normal
are gathered once at the end. Exact float ties between different spheres
then resolve in cluster order instead of table order. The kernel walks
the clusters another way, the huge one first and then near-first over a
BVH of the other spheres; :func:`_sphere_bvh_winners` is that walk step
for step, with the same winners, which the tests and chip_smoke.py's
counters use.

In a scene JAX renders on XLA only (``Scene.off_kernel``: a grid, a mesh
above ``clusters.DMA_MAX`` triangles, a UV mesh or a bump map beside a
combined set) the triangles take JAX's XLA passes instead: the grid walk
(``ops/traverse.py``) or every triangle swept in table order, in chunks
of rays x triangles (:func:`_brute_sweep_winners`, K4t's sweep).

Triangles come last (:func:`intersect_triangles`), with the winner's
texel-space uv in a mesh-UV scene (:func:`intersect_scene_uv`). A mesh of
at most ``clusters.CLUSTER_MIN`` triangles is swept brute force (K4t):
every triangle tested with ``ray_planar_triangle``'s expressions,
strict-< in table order. Up to ``clusters.STREAM_MIN`` triangles the
static tier's cluster walk runs (K5's triangle form, K8), and above that
the streamed tier's walk (K7: parents, clusters and record rows, and in
the DMA tier grandparents above the parents); both test the precomputed
triangles and resolve the winner's normal, material and uv once. The
kernel walks both tiers another way, near-first over a BVH: of the same
record rows (:func:`_bvh_winners`), or of the static tier's triangles
outside its huge cluster, after the huge cluster in order
(:func:`_static_bvh_winners`); each replays its walk step for step, with
the same winners, which the tests and chip_smoke.py's counters use.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..scene import clusters
from ..scene.schema import (
    F32_MAX, MIN_HIT_DISTANCE, QUAD_MIN_HIT_DISTANCE, Scene, TOLERANCE,
)
from ..utils.vec import Vec3, cross, dot, gather, normalize, where as vwhere


class Hit(NamedTuple):
    """ray_payload_t (ray.hpp:137-141): SoA over the ray batch."""
    t: torch.Tensor
    mat: torch.Tensor       # int32
    normal: Vec3


def _row(v: Vec3, i: int) -> Vec3:
    return Vec3(v.x[i], v.y[i], v.z[i])


def _sphere_t(o: Vec3, d: Vec3, center: Vec3, radius,
              min_hit: float = MIN_HIT_DISTANCE):
    """The near root of RaySphereIntersect: (t, hit, o - center)."""
    rel = o - center
    a = dot(d, d)
    b = 2.0 * dot(rel, d)
    c = dot(rel, rel) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    root = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = (-b - root) / (2.0 * a)
    return t, ok & (root > TOLERANCE) & (t > min_hit), rel


def ray_sphere(o: Vec3, d: Vec3, center: Vec3, radius,
               min_hit: float = MIN_HIT_DISTANCE
               ) -> Tuple[torch.Tensor, torch.Tensor, Vec3]:
    """RaySphereIntersect (win32_main.cpp:2355-2379), near root only.
    Returns (t, hit, normal); t and normal mean something only where hit."""
    t, hit, rel = _sphere_t(o, d, center, radius, min_hit)
    return t, hit, normalize(d * t + rel, eps=1e-30)


def ray_plane(o: Vec3, d: Vec3, n: Vec3, d_coef,
              min_hit: float = MIN_HIT_DISTANCE
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RayIntersectPlane (ray_math.hpp:334-341): (t, |denom| > TOLERANCE);
    the caller applies its t > min_hit test."""
    denom = dot(n, d)
    valid = (denom < -TOLERANCE) | (denom > TOLERANCE)
    t = (d_coef - dot(n, o)) / torch.where(valid, denom, 1.0)
    return t, valid


def _planar_coords(o: Vec3, d: Vec3, t, A: Vec3, u: Vec3, v: Vec3):
    """alpha/beta parameterization shared by tri/quad (ray_math.hpp:367-372)."""
    n = cross(u, v)
    p = o + d * t - A
    w = n * torch.reciprocal(dot(n, n))
    alpha = dot(w, cross(p, v))
    beta = dot(w, cross(u, p))
    return alpha, beta


def ray_planar_quad(o: Vec3, d: Vec3, A: Vec3, u: Vec3, v: Vec3,
                    min_hit: float = QUAD_MIN_HIT_DISTANCE
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RayIntersectPlanarShape<PLANAR_QUAD> (ray_math.hpp:357-381) with the
    caller's t > min_hit acceptance (win32_main.cpp:448-451)."""
    n_unit = normalize(cross(u, v), eps=1e-30)
    d_coef = dot(A, n_unit)
    t, valid = ray_plane(o, d, n_unit, d_coef, min_hit)
    alpha, beta = _planar_coords(o, d, t, A, u, v)
    inside = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    return t, valid & inside & (t > min_hit)


def ray_planar_triangle_uv(o: Vec3, d: Vec3, A: Vec3, u: Vec3, v: Vec3,
                           min_hit: float = MIN_HIT_DISTANCE):
    """RayIntersectPlanarShape<PLANAR_TRIANGLE> with its barycentrics
    (intersect.py:97-111 in JAX): (t, hit, alpha, beta), the hitpoint being
    A + alpha*u + beta*v."""
    n_unit = normalize(cross(u, v), eps=1e-30)
    d_coef = dot(A, n_unit)
    t, valid = ray_plane(o, d, n_unit, d_coef, min_hit)
    alpha, beta = _planar_coords(o, d, t, A, u, v)
    inside = (alpha >= 0.0) & (beta >= 0.0) & ((alpha + beta) <= 1.0)
    return t, valid & inside & (t > min_hit), alpha, beta


_FACE_NORMALS = (
    (0.0, 0.0, -1.0), (0.0, 0.0, 1.0),
    (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
)


def ray_aabb_faces(o: Vec3, d: Vec3, box_min: Vec3, box_max: Vec3):
    """RayIntersectWithAABB2 (ray_math.hpp:398-482): the first of the six
    faces, in the reference's order, whose in-plane hit lies in the box
    (t >= 0, inclusive bounds). Returns (t, hit, face_idx)."""
    def face(j):
        if j in (0, 1):
            axis_o, axis_d = o.z, d.z
            coord = box_min.z if j == 0 else box_max.z
            p = lambda t: (o.x + d.x * t, o.y + d.y * t, coord)
        elif j in (2, 3):
            axis_o, axis_d = o.x, d.x
            coord = box_min.x if j == 2 else box_max.x
            p = lambda t: (coord, o.y + d.y * t, o.z + d.z * t)
        else:
            axis_o, axis_d = o.y, d.y
            coord = box_max.y if j == 4 else box_min.y
            p = lambda t: (o.x + d.x * t, coord, o.z + d.z * t)
        nonzero = axis_d != 0.0
        t = (coord - axis_o) / torch.where(nonzero, axis_d, 1.0)
        px, py, pz = p(t)
        inb = ((px >= box_min.x) & (px <= box_max.x)
               & (py >= box_min.y) & (py <= box_max.y)
               & (pz >= box_min.z) & (pz <= box_max.z))
        return t, nonzero & (t >= 0.0) & inb

    best_t = torch.zeros_like(o.x)
    best_face = torch.zeros_like(o.x, dtype=torch.int64)
    found = torch.zeros_like(o.x, dtype=torch.bool)
    for j in range(6):
        t, ok = face(j)
        take = ok & ~found
        best_t = torch.where(take, t, best_t)
        best_face = torch.where(take, j, best_face)
        found = found | ok
    return best_t, found, best_face


def _take(h: Hit, take, t, mat, n: Vec3) -> Hit:
    return Hit(torch.where(take, t, h.t), torch.where(take, mat, h.mat),
               vwhere(take, n, h.normal))


def _slab_inverse(d: Vec3) -> Vec3:
    return Vec3(*(torch.reciprocal(torch.where(c != 0.0, c, 1e-30))
                  for c in d))


def _slab(o: Vec3, inv: Vec3, mn, mx):
    """(tmin, tmax) of the ray against the box [mn, mx] (float, 0-d tensor
    or per-lane corners) with the reciprocals ``inv``; min/max propagate
    NaN, as XLA's do."""
    ts = [((lo - oc) * iv, (hi - oc) * iv)
          for lo, hi, oc, iv in zip(mn, mx, o, inv)]
    near = [torch.minimum(t0, t1) for t0, t1 in ts]
    far = [torch.maximum(t0, t1) for t0, t1 in ts]
    tmin = torch.maximum(torch.maximum(near[0], near[1]), near[2])
    tmax = torch.minimum(torch.minimum(far[0], far[1]), far[2])
    return tmin, tmax


def ray_slab_entry(o: Vec3, d: Vec3, mn, mx):
    """Slab test against one AABB given by float corners. Returns
    (t_enter, hit); a primitive hit inside the box has t >= t_enter."""
    tmin, tmax = _slab(o, _slab_inverse(d), mn, mx)
    return tmin, (tmax >= tmin) & (tmax >= 0.0)


def _intersect_spheres_clustered(scene: Scene, o: Vec3, d: Vec3,
                                 best: Hit) -> Hit:
    """K5 + K6: the cluster walk over the csph_* tables, then the winner's
    material and normal by an indexed gather (intersect.py:1066-1096)."""
    t_run = best.t
    idx_run = torch.full_like(best.mat, -1)
    for off, cnt, mn, mx in scene.sph_clusters:
        if mn is not None:
            t_enter, hb = ray_slab_entry(o, d, mn, mx)
            if not bool((hb & (t_enter < t_run)).any()):
                continue
        for i in range(off, off + cnt):
            t, hit, _ = _sphere_t(o, d, _row(scene.csph_center, i),
                                  scene.csph_radius[i])
            take = hit & (t < t_run)
            t_run = torch.where(take, t, t_run)
            idx_run = torch.where(take, i, idx_run)
    found = idx_run >= 0
    win = idx_run.clamp_min(0).long()
    c = Vec3(*(ci[win] for ci in scene.csph_center))
    n = normalize(Vec3(d.x * t_run + (o.x - c.x), d.y * t_run + (o.y - c.y),
                       d.z * t_run + (o.z - c.z)), eps=1e-30)
    return Hit(t_run, torch.where(found, scene.csph_mat[win], best.mat),
               vwhere(found, n, best.normal))


def intersect_spheres(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    if scene.sph_clusters:
        return _intersect_spheres_clustered(scene, o, d, best)
    for i in range(scene.n_spheres):
        t, hit, n = ray_sphere(o, d, _row(scene.sph_center, i),
                               scene.sph_radius[i])
        best = _take(best, hit & (t < best.t), t, scene.sph_mat[i], n)
    return best


def intersect_quads(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    for i in range(scene.n_quads):
        t, hit = ray_planar_quad(o, d, _row(scene.quad_point, i),
                                 _row(scene.quad_u, i), _row(scene.quad_v, i))
        best = _take(best, hit & (t < best.t), t, scene.quad_mat[i],
                     _row(scene.quad_n, i))
    return best


def intersect_planes(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    for i in range(scene.n_planes):
        n = _row(scene.pln_n, i)
        t, valid = ray_plane(o, d, n, scene.pln_d[i])
        take = valid & (t > MIN_HIT_DISTANCE) & (t < best.t)
        best = _take(best, take, t, scene.pln_mat[i], n)
    return best


def intersect_boxes(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    """world->aabbs loop (win32_main.cpp:529-553); no reference world
    populates it, so this loops over zero rows."""
    normals = torch.tensor(_FACE_NORMALS, dtype=torch.float32,
                           device=o.x.device)
    for i in range(scene.n_boxes):
        t, hit, face = ray_aabb_faces(o, d, _row(scene.box_min, i),
                                      _row(scene.box_max, i))
        take = hit & (t > MIN_HIT_DISTANCE) & (t < best.t)
        n = Vec3(normals[face, 0], normals[face, 1], normals[face, 2])
        best = _take(best, take, t, scene.box_mat[i], n)
    return best


def _box_relevant(o: Vec3, inv: Vec3, mn, mx, t_run):
    """``row_slab_relevant`` (intersect.py:391-410 in JAX): the ray enters
    the box [mn, mx] before ``t_run``, with the slab reciprocals ``inv``
    hoisted per ray."""
    tmin, tmax = _slab(o, inv, mn, mx)
    return (tmax >= tmin) & (tmax >= 0.0) & (tmin < t_run)


def _record_tests(rec: torch.Tensor, o: Vec3, d: Vec3):
    """``row_test``'s per-record expressions (intersect.py:446-476 in JAX)
    for (..., 13) records against rays broadcast to their leading shape:
    (normal Vec3, material, t, hit, alpha, beta); padding records (n = 0)
    never hit."""
    f = lambda k: rec[..., k]
    n = Vec3(f(0), f(1), f(2))
    e1 = Vec3(f(4), f(5), f(6))
    e2 = Vec3(f(8), f(9), f(10))
    denom = dot(n, d)
    valid = (denom < -TOLERANCE) | (denom > TOLERANCE)
    t = (f(3) - dot(n, o)) / torch.where(valid, denom, 1.0)
    alpha = (dot(e1, o) - f(7)) + t * dot(e1, d)
    beta = (dot(e2, o) - f(11)) + t * dot(e2, d)
    inside = (alpha >= 0.0) & (beta >= 0.0) & ((alpha + beta) <= 1.0)
    return n, f(12), t, valid & inside & (t > MIN_HIT_DISTANCE), alpha, beta


def _expand(ray: torch.Tensor, first: torch.Tensor, count: torch.Tensor):
    """(ray, item) pairs for every item first .. first+count-1 of each
    (ray, first, count) triple, in order."""
    count = count.long()
    total = int(count.sum())
    start = torch.cumsum(count, 0) - count
    k = torch.arange(total, device=ray.device) - start.repeat_interleave(
        count, output_size=total)
    return (ray.repeat_interleave(count, output_size=total),
            first.long().repeat_interleave(count, output_size=total) + k)


def _pairs_relevant(o: Vec3, inv: Vec3, ray, box, t_cull):
    """``_box_relevant`` of each (ray, box) pair, ``box`` (M, 6) mn3 mx3."""
    pick = lambda v: Vec3(v.x[ray], v.y[ray], v.z[ray])
    return _box_relevant(pick(o), pick(inv), box[:, 0:3].unbind(1),
                         box[:, 3:6].unbind(1), t_cull[ray])


# Rays per pass of the streamed walk's plain version (bounds its pair lists).
_STREAM_RAY_CHUNK = 1 << 16


def _stream_rows(scene: Scene, o: Vec3, inv: Vec3, t_cull, tally=None):
    """The record rows the streamed walk may visit, as (ray, row) pairs:
    grandparents (DMA tier), parents, clusters and record rows, each kept
    where the ray enters its box before ``t_cull`` (a huge parent or
    grandparent always). With ``tally`` the box tests and
    the triangle tests this takes are added to its "boxes" and "tris"."""
    dev = o.x.device
    rays = torch.arange(o.x.numel(), device=dev)
    rpc = clusters.stream_rows_per_cluster(scene.stream_leaf)
    n_box = 0

    def level(ray, item, box, huge):
        nonlocal n_box
        keep = huge[item] != 0
        test = ~keep
        n_box += int(test.sum())
        keep[test] = _pairs_relevant(o, inv, ray[test], box[item[test]],
                                     t_cull)
        return ray[keep], item[keep]

    top = len(scene.stream_gparents or scene.stream_parents)
    ray = rays.repeat_interleave(top)
    item = torch.arange(top, device=dev).repeat(rays.numel())
    if scene.stream_gparents:
        grange = scene.stream_grange.long()
        ray, item = level(ray, item, scene.stream_gbox, grange[:, 2])
        ray, item = _expand(ray, grange[item, 0], grange[item, 1])
    prange = scene.stream_prange.long()
    ray, item = level(ray, item, scene.stream_pbox, prange[:, 2])
    ray, c = _expand(ray, prange[item, 0], prange[item, 1])
    n_box += c.numel()
    keep = _pairs_relevant(o, inv, ray, scene.mtri_bounds[c, 0:6], t_cull)
    ray, c = ray[keep], c[keep]
    ray, row = _expand(ray, c * rpc, torch.full_like(c, rpc))
    if scene.stream_row_cull:
        lane = clusters.ROW_BOUNDS_LANE
        n_box += row.numel()
        keep = _pairs_relevant(o, inv, ray, scene.mtri_pack[row, lane:lane + 6],
                               t_cull)
        ray, row = ray[keep], row[keep]
    if tally is not None:
        tally["boxes"] = tally.get("boxes", 0) + n_box
        tally["tris"] = (tally.get("tris", 0)
                         + clusters.STREAM_TRIS_PER_ROW * row.numel())
    return ray, row


def _stream_winners(scene: Scene, o: Vec3, d: Vec3, t0, tally=None):
    """The streamed walk's winners for rays whose nearest hit so far is
    ``t0``: (t, winning record or -1). Records are numbered in table
    order (row * 9 + slot), which is the resident walk's visit order, so
    its strict-< carry keeps the least t and, among equal t, the least
    record: that is the winner here too, in every tier."""
    per, nf = clusters.STREAM_TRIS_PER_ROW, clusters.STREAM_FIELDS
    inv = _slab_inverse(d)
    ray, row = _stream_rows(scene, o, inv, t0, tally)
    pick = lambda v: Vec3(v.x[ray, None], v.y[ray, None], v.z[ray, None])
    rec = scene.mtri_pack[row, :per * nf].reshape(-1, per, nf)
    _, _, t, hit, _, _ = _record_tests(rec, pick(o), pick(d))
    ok = hit & (t < t0[ray, None])
    rid = row[:, None] * per + torch.arange(per, device=row.device)
    ray_ok = ray[:, None].expand_as(ok)[ok]
    t_ok, rid_ok = t[ok], rid[ok]
    t_win = t0.scatter_reduce(0, ray_ok, t_ok, "amin")
    tie = t_ok == t_win[ray_ok]
    big = torch.iinfo(torch.int64).max
    win = torch.full(t0.shape, big, dtype=torch.int64,
                     device=t0.device).scatter_reduce(
        0, ray_ok[tie], rid_ok[tie], "amin")
    return t_win, torch.where(win == big, -1, win)


def _resolve_streamed(scene: Scene, o: Vec3, d: Vec3, best: Hit, t_run, win,
                      want_uv: bool):
    """The streamed walk's resolve (:649-683, :945-963 in JAX) of the
    winners ``win`` (record numbers row * 9 + slot, or -1) at ``t_run``:
    the winner's normal and material from its record and its uv, ``u0 +
    alpha*du1 + beta*du2``, once, from its cluster-field-major uv column
    or, in the row-parallel layout (``fetch_uv``, :482-510), from lanes
    slot * 6 .. of its record row's parallel uv row. Returns (hit, uvx,
    uvy, uv_ok), uv_ok meaning a triangle won (uvx = uvy = 0 without
    ``want_uv``)."""
    per, nf = clusters.STREAM_TRIS_PER_ROW, clusters.STREAM_FIELDS
    found = win >= 0
    w = win.clamp_min(0)
    row, slot = w // per, w % per
    rec = scene.mtri_pack[row[:, None], slot[:, None] * nf
                          + torch.arange(nf, device=w.device)]
    # the winner's record test again: the same expressions and values
    n_w, mat, _, _, aw, bw = _record_tests(rec, o, d)
    h = Hit(t_run, torch.where(found, mat.to(torch.int32), best.mat),
            vwhere(found, n_w, best.normal))
    z = torch.zeros_like(t_run)
    if not want_uv:
        return h, z, z, found
    uv = scene.mtri_uvpack.reshape(-1)
    if scene.stream_uv_cfm:
        rpc = clusters.stream_rows_per_cluster(scene.stream_leaf)
        col = ((row // rpc) * clusters.UV_CFM_ROWS * 128 + (row % rpc) * per
               + slot)
        g = lambda k: uv[col + k * 128]
    else:
        col = row * 128 + slot * 6
        g = lambda k: uv[col + k]
    uvx = torch.where(found, g(0) + aw * g(2) + bw * g(4), 0.0)
    uvy = torch.where(found, g(1) + aw * g(3) + bw * g(5), 0.0)
    return h, uvx, uvy, found


def _intersect_triangles_streamed(scene: Scene, o: Vec3, d: Vec3, best: Hit,
                                  want_uv: bool, tally=None):
    """K7's plain version: the streamed tier's walk
    (``_intersect_triangles_streamed``, intersect.py:262-964 in JAX), the
    resident tier and the DMA tier with its grandparent level (:815-922),
    with or without the winner's uv.

    JAX's kernel walks each ray through grandparents, parents, clusters and
    record rows, skipping a box the ray does not enter before its running
    nearest t, and tests a row's 9 records in order with the strict-<
    carry; culling only skips boxes whose triangles could not be taken.
    This version visits, per ray, every row whose boxes the ray enters
    before its nearest sphere, quad or plane hit (:func:`_stream_rows`,
    in passes of rays), tests their records with ``row_test``'s expressions
    and keeps the least (t, record) (:func:`_stream_winners`), then
    resolves the winner (:func:`_resolve_streamed`)."""
    t_run = torch.empty_like(best.t)
    win = torch.empty_like(best.t, dtype=torch.int64)
    n = o.x.numel()
    for lo in range(0, n, _STREAM_RAY_CHUNK):
        sl = slice(lo, min(n, lo + _STREAM_RAY_CHUNK))
        part = lambda v: Vec3(v.x[sl], v.y[sl], v.z[sl])
        t_run[sl], win[sl] = _stream_winners(scene, part(o), part(d),
                                             best.t[sl], tally)
    return _resolve_streamed(scene, o, d, best, t_run, win, want_uv)


def _inf_norm(v: Vec3):
    """max(|x|, |y|, |z|) per ray."""
    return torch.maximum(torch.maximum(v.x.abs(), v.y.abs()), v.z.abs())


def _far_widen(scene: Scene, o: Vec3, tally=None, every=False):
    """K4t's and the static tier's rays from far off (|o|_inf beyond
    ``scene.bvh_far``) and their boxes' widening, ``bvh_wide[0] * (|o|_inf +
    bvh_wide[1])`` in float32 (0 for the other rays; with ``every``, K7's,
    every ray's), as ``brute_walk``, ``static_walk`` and ``stream_walk``
    form them; the far rays counted in ``tally``'s "far_rays"."""
    o_inf = _inf_norm(o)
    far = o_inf > scene.bvh_far
    a, b = (torch.tensor(v, dtype=torch.float32) for v in scene.bvh_wide)
    if tally is not None:
        tally["far_rays"] = tally.get("far_rays", 0) + int(far.sum())
    return far, torch.where(far | every, a * (o_inf + b), 0.0)


def _split_far(far, o: Vec3, d: Vec3, t0, near_fn, far_fn):
    """Each ray through ``far_fn`` where ``far``, else through ``near_fn``
    (each ``(o, d, t0)`` of its rays -> a tuple of per-ray tensors), the
    results put back in ray order."""
    if not bool(far.any()):
        return near_fn(o, d, t0)
    if bool(far.all()):
        return far_fn(o, d, t0)
    out = None
    for fn, sel in ((near_fn, ~far), (far_fn, far)):
        i = torch.nonzero(sel).reshape(-1)
        res = fn(Vec3(o.x[i], o.y[i], o.z[i]), Vec3(d.x[i], d.y[i], d.z[i]),
                 t0[i])
        if out is None:
            out = [torch.empty(t0.shape, dtype=r.dtype, device=r.device)
                   for r in res]
        for a, r in zip(out, res):
            a[i] = r
    return tuple(out)


def _bvh_record_number(scene: Scene, k):
    """A winner number of the BVH's records (``bvh_tri_k``: the uv column
    with the cluster-field-major uv rows, else row * 9 + slot) as the
    record number row * 9 + slot."""
    if not scene.stream_uv_cfm:
        return k
    per, rpc = (clusters.STREAM_TRIS_PER_ROW,
                clusters.stream_rows_per_cluster(scene.stream_leaf))
    c, kk = k // (clusters.UV_CFM_ROWS * 128), k % (clusters.UV_CFM_ROWS * 128)
    return (c * rpc + kk // per) * per + kk % per


# bvh_walk's state of a ray whose next step pops its stack
_BVH_POP = -(1 << 40)


def _bvh_walk(nodes: torch.Tensor, root: tuple, o: Vec3, d: Vec3, t_run,
              leaf, widen=None) -> int:
    """``bvh_walk`` in csrc/wave_kernel.cu, step for step, vectorised over
    the rays with a stack per ray. Each ray first tests the root box, then
    walks ``nodes`` near-first: at an inner node it tests both children's
    boxes, descends the one it enters first and pushes the other with its
    entry (the left one on an equal entry); the root, a child or a popped
    entry is skipped unless the ray enters it at or before its running
    nearest t (``_box_relevant``'s expression with ``<=``: a box entered at
    exactly that t may hold a tie with a lower number). At a leaf,
    ``leaf(i, first, count)`` tests its records first .. first+count-1 for
    the rays ``i`` and updates ``t_run`` in place. With ``widen`` (per ray)
    every box is widened by it on each side first (the far sphere walk).
    Returns the box tests."""
    dev = o.x.device
    n = o.x.numel()
    inv = _slab_inverse(d)
    kids = nodes[:, 12:14].contiguous().view(torch.int32).long()
    leaf_bit = clusters.BVH_LEAF
    box = lambda mn, mx, w: (mn, mx) if w is None else (
        tuple(m - w for m in mn), tuple(m + w for m in mx))
    t_root, x_root = _slab(o, inv, *box(root[0:3], root[3:6], widen))
    enter = (x_root >= t_root) & (x_root >= 0.0) & (t_root <= t_run)
    ref = torch.where(enter, 0, _BVH_POP)
    live = enter.clone()
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    stack_ref = torch.zeros((n, clusters.BVH_MAX_DEPTH), dtype=torch.int64,
                            device=dev)
    stack_t = torch.zeros((n, clusters.BVH_MAX_DEPTH), device=dev)
    n_box = n
    pick = lambda v, i: Vec3(v.x[i], v.y[i], v.z[i])
    while bool(live.any()):
        act = torch.nonzero(live).reshape(-1)
        r = ref[act]
        # inner nodes: both children's boxes, the nearer descended first
        i = act[(r >= 0) & (r & leaf_bit == 0)]
        if i.numel():
            nd = nodes[ref[i]]
            oi, vi, ti = pick(o, i), pick(inv, i), t_run[i]
            wi = None if widen is None else widen[i]
            tl, xl = _slab(oi, vi, *box(nd[:, 0:3].unbind(1),
                                        nd[:, 3:6].unbind(1), wi))
            tr, xr = _slab(oi, vi, *box(nd[:, 6:9].unbind(1),
                                        nd[:, 9:12].unbind(1), wi))
            okl = (xl >= tl) & (xl >= 0.0) & (tl <= ti)
            okr = (xr >= tr) & (xr >= 0.0) & (tr <= ti)
            n_box += 2 * i.numel()
            right_first = okr & (~okl | (tr < tl))
            kid = kids[ref[i]]
            push = okl & okr
            j = i[push]
            stack_ref[j, sp[j]] = torch.where(right_first, kid[:, 0],
                                              kid[:, 1])[push]
            stack_t[j, sp[j]] = torch.where(right_first, tl, tr)[push]
            sp[j] += 1
            ref[i] = torch.where(okl | okr, torch.where(
                right_first, kid[:, 1], kid[:, 0]), _BVH_POP)
        # leaves: their records against the running nearest hit
        i = act[(r >= 0) & (r & leaf_bit != 0)]
        if i.numel():
            code = ref[i]
            leaf(i, (code & (leaf_bit - 1)) >> 4, code & 15)
            ref[i] = _BVH_POP
        # pops: the top entry, taken if the ray enters it by its t
        i = act[r == _BVH_POP]
        if i.numel():
            empty = sp[i] == 0
            live[i[empty]] = False
            i = i[~empty]
            sp[i] -= 1
            ref[i] = torch.where(stack_t[i, sp[i]] <= t_run[i],
                                 stack_ref[i, sp[i]], _BVH_POP)
    return n_box


def _least_taken(ok, t, num, slots: int):
    """Per row of a leaf's (rays, slots) tests: whether any record is taken
    (``ok``), the least (t, number) of the taken records (the in-order
    carry's result) and its slot."""
    t_min = torch.where(ok, t, torch.inf).amin(dim=1)
    at_min = ok & (t == t_min[:, None])
    k_min = torch.where(at_min, num, torch.iinfo(torch.int64).max).amin(dim=1)
    slot = torch.arange(slots, device=t.device)
    s_w = torch.where(at_min & (num == k_min[:, None]), slot,
                      slots).amin(dim=1).clamp_max(slots - 1)
    return ok.any(dim=1), t_min, s_w


def _with_w(rec: torch.Tensor) -> torch.Tensor:
    """(..., 12) BVH triangle records as :func:`_record_tests`' (..., 13)
    (a zero material)."""
    return torch.cat([rec, torch.zeros_like(rec[..., :1])], -1)


def _record_walk(scene: Scene, o: Vec3, d: Vec3, t_run, win, a_win, b_win,
                 slots: int, tests=None, widen=None, rows_t0=None):
    """``bvh_walk`` over ``scene.bvh_nodes`` (:func:`_bvh_walk`), its
    winner state (t, record of ``bvh_tris`` or -1, alpha, beta) updated in
    place. A leaf's records (at most ``slots``) are tested with
    ``row_test``'s expressions (or ``tests(records, o, d)``'s, which returns
    (t, hit, alpha, beta)) and taken when t is below the running t, or
    equal to a triangle's t with a lower number (``bvh_tri_k``); with
    ``widen`` (per ray) every box widened by it. With ``rows_t0`` (K7: per
    ray, its nearest hit before the mesh) a leaf's records start with its
    record row's box record, and a ray tests them only where it enters that
    box before ``rows_t0`` (``_box_relevant``, the streamed walk's row
    cull). Returns (box tests, triangle tests)."""
    if tests is None:
        tests = lambda rec, o_, d_: _record_tests(_with_w(rec), o_, d_)[2:]
    tris, tri_k = scene.bvh_tris, scene.bvh_tri_k.long()
    slot = torch.arange(slots, device=o.x.device)
    n_tri, n_row = 0, 0
    pick = lambda v, i: Vec3(v.x[i, None], v.y[i, None], v.z[i, None])
    inv = _slab_inverse(d) if rows_t0 is not None else None

    def leaf(i, first, cnt):
        nonlocal n_tri, n_row
        if rows_t0 is not None:
            box = tris[first]
            live = _box_relevant(Vec3(o.x[i], o.y[i], o.z[i]),
                                 Vec3(inv.x[i], inv.y[i], inv.z[i]),
                                 box[:, 0:3].unbind(1), box[:, 4:7].unbind(1),
                                 rows_t0[i])
            n_row += i.numel()
            i, first, cnt = i[live], first[live] + 1, cnt[live]
        valid = slot < cnt[:, None]
        rid = torch.where(valid, first[:, None] + slot, 0)
        n_tri += int(cnt.sum())
        t, hit, alpha, beta = tests(tris[rid], pick(o, i), pick(d, i))
        ti, wi = t_run[i], win[i]
        kw = torch.where(wi >= 0, tri_k[wi.clamp_min(0)], -1)
        kr = tri_k[rid]
        ok = valid & hit & ((t < ti[:, None])
                            | ((t == ti[:, None]) & (kr < kw[:, None])))
        take, t_min, s_w = _least_taken(ok, t, kr, slots)
        g = lambda v: v.gather(1, s_w[:, None])[:, 0]
        t_run[i] = torch.where(take, t_min, ti)
        win[i] = torch.where(take, first + s_w, wi)
        a_win[i] = torch.where(take, g(alpha), a_win[i])
        b_win[i] = torch.where(take, g(beta), b_win[i])

    n_box = (_bvh_walk(scene.bvh_nodes, scene.bvh_root, o, d, t_run, leaf,
                       widen) if scene.bvh_root else 0)
    return n_box + n_row, n_tri


def _apart_groups(scene: Scene, section: int = 0):
    """The mesh walk's groups of set-apart triangles (``scene.bvh_apart``;
    scene/clusters.py, "The triangles a mesh's walk sets apart") in its
    section 0 (every ray's) or 1 (a far ray's): per group its box (mn, mx
    as float tuples), its first triangle record and its count."""
    first, n = scene.bvh_apart[2 * section:2 * section + 2]
    rec = scene.bvh_tris[first:first + n].cpu()
    out, i = [], 1  # after the groups' union
    while i < n:
        cnt = int(rec[i, 3:4].view(torch.int32))
        out.append((tuple(float(v) for v in rec[i, 0:3]),
                    tuple(float(v) for v in rec[i, 4:7]), first + i + 1, cnt))
        i += 1 + cnt
    return out


def _apart_pass(scene: Scene, o: Vec3, d: Vec3, t0, state, take: bool,
                section: int = 0, rays=None):
    """``apart_pass`` in csrc/wave_kernel.cu: each group of set-apart
    triangles of ``section`` (:func:`_apart_groups`) tested by the rays
    (those of the mask ``rays``) that enter the groups' union and its own
    box before ``t0`` (``_box_relevant``, the plain walk's cull), a
    triangle improving on the winner state ``state`` (t, record, alpha,
    beta) where it hits below its t, or at its t with a lower number
    (``bvh_tri_k``) than a triangle winner. With ``take`` the least such
    (t, number) is taken into ``state`` in place; returns (the rays where a
    triangle improved, box tests, triangle tests)."""
    t_run, win, a_win, b_win = state
    tri_k = scene.bvh_tri_k.long()
    inv = _slab_inverse(d)
    better = torch.zeros_like(t0, dtype=torch.bool)
    first, n = scene.bvh_apart[2 * section:2 * section + 2]
    if not n:
        return better, 0, 0
    pick = lambda v, i: Vec3(v.x[i], v.y[i], v.z[i])
    col = lambda v: Vec3(*(c[:, None] for c in v))
    u = scene.bvh_tris[first]
    union = _box_relevant(o, inv, u[0:3].unbind(), u[4:7].unbind(), t0)
    n_box, n_tri = o.x.numel(), 0
    if rays is not None:
        union &= rays
        n_box = int(rays.sum())
    for mn, mx, g0, cnt in _apart_groups(scene, section):
        live = union & _box_relevant(o, inv, mn, mx, t0)
        n_box += int(union.sum())
        i = torch.nonzero(live).reshape(-1)
        if not i.numel():
            continue
        n_tri += cnt * i.numel()
        _, _, t, hit, alpha, beta = _record_tests(
            _with_w(scene.bvh_tris[g0:g0 + cnt]), col(pick(o, i)),
            col(pick(d, i)))
        ti, wi = t_run[i], win[i]
        kw = torch.where(wi >= 0, tri_k[wi.clamp_min(0)], -1)
        kr = tri_k[g0:g0 + cnt][None]
        ok = hit & ((t < ti[:, None]) | ((t == ti[:, None]) & (kw[:, None] >= 0)
                                         & (kr < kw[:, None])))
        better[i] |= ok.any(dim=1)
        if take:
            got, t_min, s_w = _least_taken(ok, t, kr.expand_as(t), cnt)
            g = lambda v: v.gather(1, s_w[:, None])[:, 0]
            t_run[i] = torch.where(got, t_min, ti)
            win[i] = torch.where(got, g0 + s_w, wi)
            a_win[i] = torch.where(got, g(alpha), a_win[i])
            b_win[i] = torch.where(got, g(beta), b_win[i])
    return better, n_box, n_tri


def _winner_state(t0):
    """A walk's winner state before any triangle: (t, record -1, alpha,
    beta)."""
    return (t0.clone(), torch.full(t0.shape, -1, dtype=torch.int64,
                                   device=t0.device),
            torch.zeros_like(t0), torch.zeros_like(t0))


def _tally(tally, boxes, tris):
    if tally is not None:
        tally["boxes"] = tally.get("boxes", 0) + boxes
        tally["tris"] = tally.get("tris", 0) + tris


def _bvh_winners(scene: Scene, o: Vec3, d: Vec3, t0, tally=None):
    """The card's streamed walk (``bvh_walk`` in csrc/wave_kernel.cu,
    :func:`_record_walk`) for rays whose nearest hit so far is ``t0``: (t,
    winning record of ``bvh_tris`` or -1, its alpha, its beta). A leaf's
    records are tested where the ray enters their row's box before ``t0``,
    as the streamed walk culls rows (its clusters' and parents' boxes hold
    the row's), so the walk takes only what the streamed walk tests; every
    ray widens every box by its own bound (:func:`_far_widen`), which with
    the slivers' padded leaf boxes holds every such hit; the degenerate
    slivers are tested after the walk (:func:`_apart_pass`), and by a ray
    from beyond ``bvh_far`` the other slivers, whose padding holds their
    hits only from nearer. An equal t takes a lower table-order
    number (``bvh_tri_k``), so the winner is the least (t, number) of what
    the streamed walk tests, and a sphere, quad or plane at an equal t
    keeps its hit. With ``tally`` the box tests (the row boxes among them)
    and triangle tests of the card's walk are added to its "boxes" and
    "tris", and the rays from far off to its "far_rays"."""
    state = _winner_state(t0)
    far, widen = _far_widen(scene, o, tally, every=True)
    _tally(tally, *_record_walk(scene, o, d, *state,
                                clusters.STREAM_TRIS_PER_ROW, widen=widen,
                                rows_t0=t0))
    _tally(tally, *_apart_pass(scene, o, d, t0, state, True)[1:])
    _tally(tally, *_apart_pass(scene, o, d, t0, state, True, 1, far)[1:])
    return state


def _bvh_huge(scene: Scene) -> int:
    """The records ahead of the BVH's leaves (the static tier's huge
    cluster): the root node's ``clusters.BVH_HUGE_WORD``."""
    w = clusters.BVH_HUGE_WORD
    return int(scene.bvh_nodes[0, w:w + 1].contiguous().view(torch.int32))


def _outside_box(scene: Scene, o: Vec3, d: Vec3, t_run, key, every=False):
    """``static_walk``'s test of the winners' cluster boxes: the rays whose
    winner (its key, ``clusters.STATIC_KEY_SHIFT``; -1 for none) has the
    check bit (``every``: any winner), lies at ``t_run`` outside its
    cluster's box by 2^-18 of |o| +
    |t d| or more, and whose slab test (``_box_relevant``) finds the box not
    entered before ``t_run``; and the slab tests made."""
    check = torch.nonzero((key >= 0) & ((key & 1 == 1) | every)).reshape(-1)
    box = scene.tcl_box[key[check] >> clusters.STATIC_KEY_SHIFT]
    pick = lambda v, i: Vec3(v.x[i], v.y[i], v.z[i])
    oc, dc, tc = pick(o, check), pick(d, check), t_run[check]
    # a hit point inside the box by that much is entered before its t
    amax = lambda v: torch.maximum(torch.maximum(v.x.abs(), v.y.abs()),
                                   v.z.abs())
    m = (amax(oc) + tc * amax(dc)) * 2.0 ** -18
    q = oc + dc * tc
    inside = ((q.x - m > box[:, 0]) & (q.y - m > box[:, 1])
              & (q.z - m > box[:, 2]) & (q.x + m < box[:, 3])
              & (q.y + m < box[:, 4]) & (q.z + m < box[:, 5]))
    slab = torch.nonzero(~inside).reshape(-1)
    r = check[slab]
    inside[slab] = _box_relevant(pick(o, r), _slab_inverse(pick(d, r)),
                                 box[slab, 0:3].unbind(1),
                                 box[slab, 3:6].unbind(1), t_run[r])
    return check[~inside], slab.numel()


def _static_bvh_winners(scene: Scene, o: Vec3, d: Vec3, t0, tally=None):
    """The card's static-tier walk (``static_walk`` in csrc/wave_kernel.cu)
    step for step, for rays whose nearest hit so far is ``t0``: (t, the
    winning triangle's cluster-order index or -1, its alpha, its beta). The
    huge cluster's records (the first :func:`_bvh_huge` of ``bvh_tris``)
    are tested first, in order with the strict-< carry, as the table-order
    walk tests them; then the BVH over the other triangles is walked
    near-first (:func:`_record_walk`), an equal t taking the lower key
    (``clusters.STATIC_KEY_SHIFT``: ordered as the cluster-order index; a
    huge triangle's is lower than any other, so it keeps a tie). The winner
    is the least (t, index), which the table-order walk
    (:func:`_intersect_triangles_clustered`) finds too when the ray enters
    the winner's cluster box before its t (``_box_relevant``), as it does
    for a winner whose padded bound lies inside that box. The box of any
    other winner (its key's check bit) is tested unless its hit point lies
    inside it by 2^-18 of |o| + |t d| (more than the rounding of the point
    and of the box's slab entry), and where the ray does not enter it
    before the winner's t (a grazing hit just outside a tight box, which the
    table-order walk takes or culls by its running t at the visit), the ray
    is walked again in table order from ``t0``. A ray from further off than
    ``scene.bvh_far`` (|o|_inf, ``clusters.far_bound``: its hits' rounding
    may leave the padded boxes) walks with every box widened by its own
    bound (:func:`_far_widen`), and its winner's box is tested whatever its
    key. The degenerate slivers the tree leaves out (``scene.bvh_apart``)
    are tested where the table-order walk could test them
    (:func:`_apart_pass`), and a ray where one hits nearer than the walk's
    winner is walked again in table order too. With ``tally`` the box tests
    (those winners' boxes among them) and triangle tests of the card's walk
    are added to its "boxes" and "tris", the rays walked again in table
    order to its "table_rays" and those from far off to its "far_rays"."""
    far, widen = _far_widen(scene, o, tally)
    return _split_far(far, o, d, t0,
                      lambda o_, d_, t_: _static_near(scene, o_, d_, t_, tally),
                      lambda o_, d_, t_: _static_near(scene, o_, d_, t_, tally,
                                                      widen[far]))


def _static_near(scene: Scene, o: Vec3, d: Vec3, t0, tally=None,
                 widen=None):
    """``static_walk`` as :func:`_static_bvh_winners` runs it; with
    ``widen`` (rays from far off) every box widened by it and every
    winner's cluster box tested; the set-apart slivers tested after the
    walk in either case."""
    t_run, win, a_win, b_win = state = _winner_state(t0)
    n_huge = _bvh_huge(scene)
    if n_huge:
        col = lambda v: Vec3(*(c[:, None] for c in v))
        _, _, t, hit, alpha, beta = _record_tests(
            _with_w(scene.bvh_tris[:n_huge]), col(o), col(d))
        for j in range(n_huge):
            take = hit[:, j] & (t[:, j] < t_run)
            t_run.copy_(torch.where(take, t[:, j], t_run))
            win.copy_(torch.where(take, j, win))
            a_win.copy_(torch.where(take, alpha[:, j], a_win))
            b_win.copy_(torch.where(take, beta[:, j], b_win))
    boxes, tris = _record_walk(scene, o, d, *state, clusters.STATIC_LEAF,
                               widen=widen)
    better, a_box, a_tri = _apart_pass(scene, o, d, t0, state, False)
    if widen is not None:  # a far ray tests the other slivers too
        far_better, f_box, f_tri = _apart_pass(scene, o, d, t0, state,
                                               False, 1)
        better |= far_better
        a_box, a_tri = a_box + f_box, a_tri + f_tri
    key = torch.where(win >= 0, scene.bvh_tri_k.long()[win.clamp_min(0)], -1)
    shift = clusters.STATIC_KEY_SHIFT
    idx = torch.where(win >= 0, (key >> 1) & ((1 << (shift - 1)) - 1), -1)
    # a ray where a set-apart triangle beats the winner: walked again
    key = torch.where(better, -1, key)
    again, slabs = _outside_box(scene, o, d, t_run, key, widen is not None)
    again = torch.cat([torch.nonzero(better).reshape(-1), again])
    boxes, tris = boxes + a_box, tris + a_tri
    table = {}
    if again.numel():
        pick = lambda v: Vec3(v.x[again], v.y[again], v.z[again])
        ta, ia = _static_table_winners(scene, pick(o), pick(d), t0[again],
                                       table)
        _, _, aa, ba = _ctri_tests(scene, pick(o), pick(d), ia.clamp_min(0))
        t_run[again], idx[again], a_win[again], b_win[again] = ta, ia, aa, ba
    _tally(tally, boxes + slabs + table.get("boxes", 0),
           tris + n_huge * o.x.numel() + table.get("tris", 0))
    if tally is not None:
        tally["table_rays"] = tally.get("table_rays", 0) + again.numel()
    return t_run, idx, a_win, b_win


def _sphere_bvh_winners(scene: Scene, o: Vec3, d: Vec3, t0, tally=None):
    """The card's clustered sphere walk (``sphere_walk`` in
    csrc/wave_kernel.cu) step for step, for rays whose nearest hit so far
    is ``t0``: (t, the winning sphere's cluster-order index or -1). The
    huge cluster's spheres are tested first, in order with the strict-<
    carry, as the table-order walk tests them; then the BVH over the other
    spheres (``scene.sbvh_*``, boxes padded by ``clusters.SPHERE_PAD``) is
    walked near-first (:func:`_bvh_walk`), a leaf's spheres tested with
    ``ray_sphere``'s expressions and taken when t is below the running t,
    or equal to it with a lower cluster-order index. The winner is the
    least (t, index) over every sphere: the sphere the table-order walk's
    strict-< carry finds (``_intersect_spheres_clustered``) wherever the
    batch enters each cluster's box (JAX's rule), a huge sphere keeping a
    tie. A ray whose origin lies further than ``scene.sbvh_far``'s R from
    its z (every ray, where R is negative), whose sphere tests may take a
    hit outside the padded boxes (``clusters.sphere_far_reach``), walks with every box widened by its
    own bound e = k (L + D)^2 + 16u (L + M) (L = |o - z|; k, D and M from
    ``scene.sbvh_far``: how far outside a sphere its test takes a hit, and
    the slab test's rounding), so that no hit any sphere's test takes is
    culled. With ``tally`` the box tests and sphere tests of the card's
    walk are added to its "boxes" and "spheres", and the rays from far off
    to its "far_rays"."""
    zx, zy, zz, reach, k, big_d, big_m, _ = (_f32(v) for v in scene.sbvh_far)
    dx, dy, dz = o.x - zx, o.y - zy, o.z - zz
    s = (dx * dx + dy * dy) + dz * dz
    far = s > reach * reach.abs()  # R |R|: every ray far where R < 0
    if tally is not None:
        tally["far_rays"] = tally.get("far_rays", 0) + int(far.sum())
    dist = torch.sqrt(s)
    e = ((k * (dist + big_d)) * (dist + big_d)
         + _f32(2.0 ** -20) * (dist + big_m))
    return _sphere_walk(scene, o, d, t0, tally, torch.where(far, e, 0.0))


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _sphere_walk(scene: Scene, o: Vec3, d: Vec3, t0, tally=None,
                 widen=None):
    """``sphere_walk``'s walk, as :func:`_sphere_bvh_winners` runs it: the
    huge cluster, then the BVH, its boxes widened by ``widen`` (per ray: 0
    but for rays from far off)."""
    n = o.x.numel()
    t_run = t0.clone()
    win = torch.full((n,), -1, dtype=torch.int64, device=o.x.device)
    n_sph, n_box = 0, 0
    for off, cnt, mn, _ in scene.sph_clusters:
        if mn is not None:
            continue
        n_sph += n * cnt
        for i in range(off, off + cnt):
            t, hit, _ = _sphere_t(o, d, _row(scene.csph_center, i),
                                  scene.csph_radius[i])
            take = hit & (t < t_run)
            t_run = torch.where(take, t, t_run)
            win = torch.where(take, i, win)
    per = clusters.SPHERE_LEAF
    slot = torch.arange(per, device=o.x.device)
    sph, idx = scene.sbvh_sph, scene.sbvh_idx.long()
    pick = lambda v, i: Vec3(v.x[i, None], v.y[i, None], v.z[i, None])

    def leaf(i, first, cnt):
        nonlocal n_sph
        valid = slot < cnt[:, None]
        rid = torch.where(valid, first[:, None] + slot, 0)
        n_sph += int(cnt.sum())
        rec = sph[rid]
        t, hit, _ = _sphere_t(pick(o, i), pick(d, i),
                              Vec3(rec[..., 0], rec[..., 1], rec[..., 2]),
                              rec[..., 3])
        ti, wi = t_run[i], win[i]
        ki = idx[rid]
        ok = valid & hit & ((t < ti[:, None]) | (
            (t == ti[:, None]) & (wi[:, None] >= 0) & (ki < wi[:, None])))
        take, t_min, s_w = _least_taken(ok, t, ki, per)
        t_run[i] = torch.where(take, t_min, ti)
        win[i] = torch.where(take, ki.gather(1, s_w[:, None])[:, 0], wi)

    if scene.sbvh_root:
        n_box = _bvh_walk(scene.sbvh_nodes, scene.sbvh_root, o, d, t_run,
                          leaf, widen)
    if tally is not None:
        tally["boxes"] = tally.get("boxes", 0) + n_box
        tally["spheres"] = tally.get("spheres", 0) + n_sph
    return t_run, win


def _intersect_triangles_bvh(scene: Scene, o: Vec3, d: Vec3, best: Hit,
                             want_uv: bool, tally=None):
    """:func:`_intersect_triangles_streamed`'s function by the card's walk
    (:func:`_bvh_winners`), its winner resolved by the same code
    (:func:`_resolve_streamed`). Returns (hit, uvx, uvy, uv_ok)."""
    t_run, win, _, _ = _bvh_winners(scene, o, d, best.t, tally)
    number = scene.bvh_tri_k.long()[win.clamp_min(0)]
    rec = torch.where(win >= 0, _bvh_record_number(scene, number), -1)
    return _resolve_streamed(scene, o, d, best, t_run, rec, want_uv)


def _ctri_tests(scene: Scene, o: Vec3, d: Vec3, idx):
    """``_ctri_test_idx`` (intersect.py:1149-1170 in JAX) for the static
    tier's triangles ``idx`` (a slice or an index tensor broadcast against
    the rays): (t, hit, alpha, beta)."""
    g = lambda v: v[idx]
    n = Vec3(*map(g, scene.ctri_n))
    e1 = Vec3(*map(g, scene.ctri_e1))
    e2 = Vec3(*map(g, scene.ctri_e2))
    denom = dot(n, d)
    valid = (denom < -TOLERANCE) | (denom > TOLERANCE)
    t = (g(scene.ctri_d) - dot(n, o)) / torch.where(valid, denom, 1.0)
    alpha = (dot(e1, o) - g(scene.ctri_a0)) + t * dot(e1, d)
    beta = (dot(e2, o) - g(scene.ctri_b0)) + t * dot(e2, d)
    inside = (alpha >= 0.0) & (beta >= 0.0) & ((alpha + beta) <= 1.0)
    return t, valid & inside & (t > MIN_HIT_DISTANCE), alpha, beta


def _resolve_static(scene: Scene, best: Hit, t_run, idx, alpha, beta,
                    want_uv: bool):
    """The static tier's resolve (:1184-1195 in JAX; with ``want_uv`` K8's,
    :1309-1358) of the winners ``idx`` (cluster-order indices, or -1) at
    ``t_run``: the winner's normal and material by its index and its uv
    ``u0 + alpha*du1 + beta*du2`` from ``ctri_uv*``. Returns (hit, uvx,
    uvy, uv_ok)."""
    found = idx >= 0
    win = idx.clamp_min(0)
    h = Hit(t_run, torch.where(found, scene.ctri_mat[win], best.mat),
            vwhere(found, Vec3(*(c[win] for c in scene.ctri_n)),
                   best.normal))
    z = torch.zeros_like(t_run)
    if not want_uv:
        return h, z, z, found
    uvx = (scene.ctri_uv0u[win] + alpha * scene.ctri_uvdu1[win]
           + beta * scene.ctri_uvdu2[win])
    uvy = (scene.ctri_uv0v[win] + alpha * scene.ctri_uvdv1[win]
           + beta * scene.ctri_uvdv2[win])
    return (h, torch.where(found, uvx, 0.0), torch.where(found, uvy, 0.0),
            found)


def _intersect_triangles_clustered(scene: Scene, o: Vec3, d: Vec3,
                                   best: Hit, want_uv: bool, tally=None):
    """K5's triangle form and, with ``want_uv``, K8: the static tier's
    cluster walk (``_intersect_clustered_idx`` with ``_ctri_test_idx``,
    intersect.py:225-259 and :1149-1170 in JAX). Per cluster in table
    order, a ray tests its triangles when it enters the cluster's box
    before its running nearest t (the huge cluster always), taking the
    first least t below it: the strict-< carry of (t, index). The winner's
    normal and material are then read by its index (:1184-1195), and with
    ``want_uv`` its alpha and beta are recomputed from its covectors by
    the in-loop expressions and its uv interpolated from ``ctri_uv*``
    (:1309-1358). Returns (hit, uvx, uvy, uv_ok)."""
    t_run, idx_run = _static_table_winners(scene, o, d, best.t, tally)
    alpha = beta = None
    if want_uv:
        # the winner's test again: the same expressions on the same values
        _, _, alpha, beta = _ctri_tests(scene, o, d, idx_run.clamp_min(0))
    return _resolve_static(scene, best, t_run, idx_run, alpha, beta, want_uv)


def _static_table_winners(scene: Scene, o: Vec3, d: Vec3, t0, tally=None):
    """The table-order walk of :func:`_intersect_triangles_clustered` for
    rays whose nearest hit so far is ``t0``: (t, the winner's cluster-order
    index or -1). With ``tally`` its box and triangle tests are added to
    its "boxes" and "tris"."""
    inv = _slab_inverse(d)
    t_run = t0
    idx_run = torch.full(t0.shape, -1, dtype=torch.int64, device=t0.device)
    col = lambda v: Vec3(v.x[None], v.y[None], v.z[None])
    o1, d1 = col(o), col(d)
    for off, cnt, mn, mx in scene.tri_clusters:
        live = torch.ones_like(t_run, dtype=torch.bool)
        if mn is not None:
            live = _box_relevant(o, inv, mn, mx, t_run)
            _tally(tally, live.numel(), 0)
            if not bool(live.any()):
                continue
        _tally(tally, 0, cnt * int(live.sum()))
        sl = slice(off, off + cnt)
        t, hit, _, _ = _ctri_tests(scene, o1, d1, (sl, None))
        ok = hit & (t < t_run) & live
        t_min, j = torch.where(ok, t, torch.inf).min(dim=0)
        take = ok.any(dim=0)
        t_run = torch.where(take, t_min, t_run)
        idx_run = torch.where(take, off + j, idx_run)
    return t_run, idx_run


def _intersect_triangles_static_bvh(scene: Scene, o: Vec3, d: Vec3,
                                    best: Hit, want_uv: bool, tally=None):
    """:func:`_intersect_triangles_clustered`'s function by the card's walk
    (:func:`_static_bvh_winners`), its winner resolved by the same code
    (:func:`_resolve_static`) from the alpha and beta the walk carried.
    Returns (hit, uvx, uvy, uv_ok)."""
    t_run, idx, a_win, b_win = _static_bvh_winners(scene, o, d, best.t, tally)
    return _resolve_static(scene, best, t_run, idx, a_win, b_win, want_uv)


# rays x triangles tested at once by the chunked sweep: 2^23 pairs keep
# each of its float32 temporaries at 32 MB
SWEEP_PAIRS = 1 << 23


def _brute_sweep_winners(scene: Scene, o: Vec3, d: Vec3, t0,
                         pairs: int = SWEEP_PAIRS):
    """K4t's sweep, which is also JAX's XLA triangle pass
    (``intersect_triangles_brute``, intersect.py:1172-1216 in JAX, chunked
    by ``_scan_table_chunked``, :1033; with UVs
    ``_intersect_triangles_brute_uv``, :1261-1306), for rays whose nearest
    hit so far is ``t0``: every triangle tested with
    ``ray_planar_triangle_uv``'s expressions, the rays against a chunk of
    triangles at a time (at most ``pairs`` pairs). The least t of a chunk,
    its lowest index on a tie, is taken where it beats the run strict-<:
    the winner of a sweep in table order. Returns (t, the winner's table
    index or -1, its alpha, its beta)."""
    t_run, win, a_win, b_win = _winner_state(t0)
    n = scene.n_tris
    step = max(1, pairs // max(1, t0.numel()))
    col = lambda x: x[:, None]
    oc, dc = Vec3(*map(col, o)), Vec3(*map(col, d))
    rows = torch.arange(t0.numel(), device=t0.device)
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        A, u, v = (Vec3(*(x[None, c0:c1] for x in tab))
                   for tab in (scene.tri_a, scene.tri_u, scene.tri_v))
        t, hit, alpha, beta = ray_planar_triangle_uv(oc, dc, A, u, v)
        t = torch.where(hit, t, float("inf"))
        t_min, k = torch.min(t, dim=1)
        take = t_min < t_run
        t_run = torch.where(take, t_min, t_run)
        win = torch.where(take, k + c0, win)
        a_win = torch.where(take, alpha[rows, k], a_win)
        b_win = torch.where(take, beta[rows, k], b_win)
    return t_run, win, a_win, b_win


def _intersect_triangles_brute(scene: Scene, o: Vec3, d: Vec3, best: Hit,
                               want_uv: bool):
    """K4t's plain version: the sweep (:func:`_brute_sweep_winners`), its
    winner resolved (:func:`_resolve_brute`). Returns (hit, uvx, uvy,
    took)."""
    return _resolve_brute(scene, best, *_brute_sweep_winners(
        scene, o, d, best.t), want_uv)


def _resolve_brute(scene: Scene, best: Hit, t_run, win, alpha, beta,
                   want_uv: bool):
    """K4t's winner (its table index ``win`` or -1, at ``t_run``, with its
    ``alpha`` and ``beta``) taking its unit normal normalize(cross(u, v)),
    its material and, with ``want_uv``, its uv ``u0 + alpha*du1 +
    beta*du2``: the values the JAX sweep selects at take, by the same
    expressions on the same values. Returns (hit, uvx, uvy, took)."""
    took = win >= 0
    i = win.clamp_min(0)
    u, v = gather(scene.tri_u, i), gather(scene.tri_v, i)
    best = Hit(t_run, torch.where(took, scene.tri_mat[i], best.mat),
               vwhere(took, normalize(cross(u, v), eps=1e-30), best.normal))
    z = torch.zeros_like(t_run)
    if not want_uv:
        return best, z, z, took
    uvx = torch.where(took, scene.tri_uv0u[i] + alpha * scene.tri_uvdu1[i]
                      + beta * scene.tri_uvdu2[i], z)
    uvy = torch.where(took, scene.tri_uv0v[i] + alpha * scene.tri_uvdv1[i]
                      + beta * scene.tri_uvdv2[i], z)
    return best, uvx, uvy, took


def _brute_tests(rec: torch.Tensor, o: Vec3, d: Vec3):
    """K4t's test on precomputed records (``clusters.brute_records``, (...,
    16)) for rays broadcast to their leading shape: the sweep's expressions
    (``ray_planar_triangle_uv``) on the record's values of n_unit, d, w, A,
    u and v. Returns (t, hit, alpha, beta)."""
    col = lambda *k: Vec3(*(rec[..., j] for j in k))
    t, valid = ray_plane(o, d, col(0, 1, 2), rec[..., 3])
    q = o + d * t - col(8, 9, 10)
    w, u, v = col(4, 5, 6), col(11, 12, 13), col(14, 15, 7)
    alpha = dot(w, cross(q, v))
    beta = dot(w, cross(u, q))
    inside = (alpha >= 0.0) & (beta >= 0.0) & ((alpha + beta) <= 1.0)
    return t, valid & inside & (t > MIN_HIT_DISTANCE), alpha, beta


def _triangle_records(scene: Scene) -> torch.Tensor:
    """Every triangle's values of ``ray_planar_triangle_uv``'s test that
    depend on the triangle alone (n_unit, d, w, A, u, v), in
    ``clusters.brute_records``' layout for :func:`_brute_tests`, formed by
    the test's own torch expressions on the tensors' device, so equal to
    them bit for bit."""
    A, u, v = scene.tri_a, scene.tri_u, scene.tri_v
    n = cross(u, v)
    n_unit = normalize(n, eps=1e-30)
    w = n * torch.reciprocal(dot(n, n))
    return torch.stack([*n_unit, dot(A, n_unit), *w, v.z, *A, *u, v.x, v.y],
                       dim=1)


def _quad_record_tests(rec: torch.Tensor, o: Vec3, d: Vec3,
                       min_hit: float = QUAD_MIN_HIT_DISTANCE):
    """The kernel's quad test on its precomputed records
    (``schema.quad_records``, (..., 16), K4t's layout) for rays broadcast to
    their leading shape: ``ray_planar_quad``'s expressions on the record's
    n_unit, d, w, A, u and v. Returns (t, hit, alpha, beta)."""
    col = lambda *k: Vec3(*(rec[..., j] for j in k))
    t, valid = ray_plane(o, d, col(0, 1, 2), rec[..., 3])
    q = o + d * t - col(8, 9, 10)
    w, u, v = col(4, 5, 6), col(11, 12, 13), col(14, 15, 7)
    alpha = dot(w, cross(q, v))
    beta = dot(w, cross(u, q))
    inside = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    return t, valid & inside & (t > min_hit), alpha, beta


def _intersect_quad_records(scene: Scene, o: Vec3, d: Vec3,
                            best: Hit) -> Hit:
    """:func:`intersect_quads` by the kernel's sweep over the quads'
    records (:func:`_quad_record_tests`), each winner's normal the record's
    n_unit: the tests' twin of the card's quad sweep."""
    for i in range(scene.n_quads):
        rec = scene.quad_rec[i]
        t, hit, _, _ = _quad_record_tests(rec, o, d)
        n = Vec3(*(rec[j].expand_as(t) for j in range(3)))
        best = _take(best, hit & (t < best.t), t, scene.quad_mat[i], n)
    return best


def _brute_bvh_winners(scene: Scene, o: Vec3, d: Vec3, t0, tally=None):
    """The card's K4t walk (``brute_walk`` in csrc/wave_kernel.cu) step for
    step, for rays whose nearest hit so far is ``t0``: the BVH over a brute
    mesh (``clusters.build_brute_bvh``) walked near-first
    (:func:`_record_walk`), a leaf's records tested with the sweep's
    expressions (:func:`_brute_tests`) and taken when t is below the running
    t, or equal to a triangle's with a lower table index (``bvh_tri_k``).
    The winner is the least (t, index), which the sweep's strict-< carry in
    table order finds (:func:`_brute_sweep_winners`), and a sphere, quad or
    plane at an equal t keeps its hit. A ray from further off than
    ``scene.bvh_far`` (|o|_inf, ``clusters.far_bound``: its hits' rounding
    may leave the padded boxes) walks with every box widened by its own
    bound (:func:`_far_widen`). Returns (t, the winner's table index or -1,
    its alpha, its beta); with ``tally`` the box tests and triangle tests of
    the card's walk are added to its "boxes" and "tris", and the rays from
    far off to its "far_rays". Used by the tests and by chip_smoke.py's
    bound, never by a render. A mesh of at most ``clusters.BRUTE_SWEEP_MAX``
    triangles has no tree: its records (:func:`_bvh_huge` of them, in table
    order) are swept in order with the strict-< carry."""
    t_run, win, a_win, b_win = state = _winner_state(t0)
    n_swept = _bvh_huge(scene)
    for i in range(n_swept):
        t, hit, alpha, beta = _brute_tests(scene.bvh_tris[i], o, d)
        take = hit & (t < t_run)
        t_run.copy_(torch.where(take, t, t_run))
        win.copy_(torch.where(take, i, win))
        a_win.copy_(torch.where(take, alpha, a_win))
        b_win.copy_(torch.where(take, beta, b_win))
    _tally(tally, 0, n_swept * o.x.numel())
    if not n_swept:
        refs = scene.bvh_nodes[:, 12:14].contiguous().view(torch.int32)
        leaves = refs[refs & clusters.BVH_LEAF != 0] & 15
        _tally(tally, *_record_walk(scene, o, d, *state,
                                    int(leaves.max()) if leaves.numel() else 1,
                                    _brute_tests,
                                    _far_widen(scene, o, tally)[1]))
    idx = torch.where(win >= 0, scene.bvh_tri_k.long()[win.clamp_min(0)], -1)
    return t_run, idx, a_win, b_win


def _intersect_triangles_brute_bvh(scene: Scene, o: Vec3, d: Vec3, best: Hit,
                                   want_uv: bool):
    """:func:`_intersect_triangles_brute`'s function by the card's walk
    (:func:`_brute_bvh_winners`), its winner resolved by the same code
    (:func:`_resolve_brute`). Returns (hit, uvx, uvy, took)."""
    return _resolve_brute(scene, best, *_brute_bvh_winners(
        scene, o, d, best.t), want_uv)


def intersect_triangles(scene: Scene, o: Vec3, d: Vec3, best: Hit,
                        want_uv: bool = False, tally=None):
    """The triangle pass of the scene's tier: the brute sweep (at most
    ``clusters.CLUSTER_MIN`` triangles, K4t), the static tier's cluster
    walk (K5's triangle form, K8) or the streamed walk (K7); in a scene
    JAX renders on XLA only (``Scene.off_kernel``), the same sweep over
    every triangle, JAX's XLA pass. Returns (hit, uvx, uvy, uv_ok);
    ``tally`` (the walks) counts box and triangle tests."""
    if scene.tri_brute or scene.off_kernel:
        return _intersect_triangles_brute(scene, o, d, best, want_uv)
    if scene.tri_streamed:
        return _intersect_triangles_streamed(scene, o, d, best, want_uv,
                                             tally)
    return _intersect_triangles_clustered(scene, o, d, best, want_uv, tally)


def _miss(o: Vec3) -> Hit:
    z = torch.zeros_like(o.x)
    return Hit(torch.full_like(o.x, F32_MAX),
               torch.zeros_like(o.x, dtype=torch.int32), Vec3(z, z, z))


def _non_triangles(scene: Scene, o: Vec3, d: Vec3) -> Hit:
    best = intersect_spheres(scene, o, d, _miss(o))
    best = intersect_quads(scene, o, d, best)
    return intersect_planes(scene, o, d, best)


def intersect_scene(scene: Scene, o: Vec3, d: Vec3) -> Hit:
    """RayCastIntersect (win32_main.cpp:406-556, intersect.py:1239-1257 in
    JAX): spheres, quads, planes, the grid walk where the scene has a grid
    (``ops/traverse.py``) or else the tier's triangle pass, boxes, with
    strict-< updates; miss => (F32_MAX, mat 0, normal (0,0,0))."""
    best = _non_triangles(scene, o, d)
    if scene.n_tris:
        if scene.grid_res:
            from .traverse import intersect_triangles_grid
            best = intersect_triangles_grid(scene, o, d, best)
        else:
            best = intersect_triangles(scene, o, d, best)[0]
    return intersect_boxes(scene, o, d, best)


def intersect_scene_uv(scene: Scene, o: Vec3, d: Vec3):
    """``intersect_scene`` for a mesh-UV scene (intersect.py:1360-1390 in
    JAX): spheres, quads, planes, then the tier's triangle pass with the
    winner's uv (the sweep, as in JAX, where the scene has a grid: this
    pass has no grid walk); returns (hit, uvx, uvy, uv_ok) with the
    winning triangle's texel-space uv."""
    assert scene.n_boxes == 0, "mesh-UV scenes have no boxes"
    return intersect_triangles(scene, o, d, _non_triangles(scene, o, d),
                               want_uv=True)
