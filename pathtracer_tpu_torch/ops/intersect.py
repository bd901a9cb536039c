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
then resolve in cluster order instead of table order.

A mesh-UV scene takes :func:`intersect_scene_uv`. A mesh of at most
``clusters.CLUSTER_MIN`` triangles is swept brute force (K4t): every
triangle tested with ``ray_planar_triangle_uv``'s expressions, strict-< in
table order, the winner's uv selected at take. A larger one goes through
the streamed tier's walk (K7): parent, cluster and record-row boxes culled
per ray, the precomputed records tested strict-< in table order, and the
winner's texel-space uv resolved once at the end.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..scene import clusters
from ..scene.schema import (
    F32_MAX, MIN_HIT_DISTANCE, QUAD_MIN_HIT_DISTANCE, Scene, TOLERANCE,
)
from ..utils.vec import Vec3, cross, dot, normalize, where as vwhere


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


def _row_records(row: torch.Tensor, o: Vec3, d: Vec3):
    """``row_test``'s per-record expressions (intersect.py:446-476 in JAX)
    for the 9 records of one (128,) record row against every ray: (normal
    Vec3 and material of each record as (9, 1), then t, hit, alpha and
    beta as (9, N)); padding records (n = 0) never hit."""
    per, nf = clusters.STREAM_TRIS_PER_ROW, clusters.STREAM_FIELDS
    rec = row[:per * nf].reshape(per, nf, 1)
    f = lambda k: rec[:, k]
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


def _intersect_triangles_streamed_uv(scene: Scene, o: Vec3, d: Vec3,
                                     best: Hit):
    """K7's plain version: the streamed tier's walk with the winner's uv
    (``_intersect_triangles_streamed``, intersect.py:262-964 in JAX, resident
    tier with static parents and cluster-field-major uv rows).

    Parents, then each parent's clusters, then each cluster's record rows
    are culled per ray against its running nearest t (the kernel's
    per-thread culls; the JAX kernel's block any-reduce visits a superset,
    and culling only skips boxes a ray enters at or beyond its nearest hit).
    A row's 9 records are tested together as (9, N) tensors with the
    expressions of ``row_test`` (:446-476) and taken in row order with the
    strict-< carry of (t, normal, material as float, winner, alpha, beta).
    The winner's uv is resolved once after the walk from its cfm uv entries,
    ``u0 + alpha*du1 + beta*du2`` (:649-683). Returns (hit, uvx, uvy,
    uv_ok), uv_ok meaning a triangle won (:945-963)."""
    per = clusters.STREAM_TRIS_PER_ROW
    rpc = clusters.stream_rows_per_cluster(scene.stream_leaf)
    lane = clusters.ROW_BOUNDS_LANE
    pack, bounds = scene.mtri_pack, scene.mtri_bounds
    inv = _slab_inverse(d)
    t_run = best.t
    z = torch.zeros_like(o.x)
    nx, ny, nz, mf = z, z, z, z - 1.0
    win = torch.full_like(o.x, -1, dtype=torch.int64)
    aw, bw = z, z
    live_all = torch.ones_like(o.x, dtype=torch.bool)
    for (pstart, pcnt, pmn, pmx) in scene.stream_parents:
        p_live = (live_all if pmn is None
                  else _box_relevant(o, inv, pmn, pmx, t_run))
        for c in range(pstart, pstart + pcnt):
            brow = bounds[c]
            c_live = p_live & _box_relevant(o, inv, brow[0:3], brow[3:6],
                                            t_run)
            for r in range(rpc):
                row = pack[c * rpc + r]
                r_live = c_live
                if scene.stream_row_cull:
                    r_live = r_live & _box_relevant(
                        o, inv, row[lane:lane + 3], row[lane + 3:lane + 6],
                        t_run)
                n, mat, t, hit, alpha, beta = _row_records(row, o, d)
                hit = hit & r_live
                for jj in range(per):
                    take = hit[jj] & (t[jj] < t_run)
                    t_run = torch.where(take, t[jj], t_run)
                    nx = torch.where(take, n.x[jj], nx)
                    ny = torch.where(take, n.y[jj], ny)
                    nz = torch.where(take, n.z[jj], nz)
                    mf = torch.where(take, mat[jj], mf)
                    # the winner's column in the cfm uv rows of cluster c
                    win = torch.where(take, c * clusters.UV_CFM_ROWS * 128
                                      + r * per + jj, win)
                    aw = torch.where(take, alpha[jj], aw)
                    bw = torch.where(take, beta[jj], bw)
    found = mf >= 0.0
    uv = scene.mtri_uvpack.reshape(-1)
    g = lambda k: uv[win.clamp_min(0) + k * 128]
    uvx = torch.where(found, g(0) + aw * g(2) + bw * g(4), 0.0)
    uvy = torch.where(found, g(1) + aw * g(3) + bw * g(5), 0.0)
    h = Hit(t_run, torch.where(found, mf.to(torch.int32), best.mat),
            vwhere(found, Vec3(nx, ny, nz), best.normal))
    return h, uvx, uvy, found


def _intersect_triangles_brute_uv(scene: Scene, o: Vec3, d: Vec3,
                                  best: Hit):
    """K4t's plain version (``_intersect_triangles_brute_uv``,
    intersect.py:1261-1306 in JAX): every triangle in table order with
    ``ray_planar_triangle_uv``, taken strict-< with its unit normal and its
    uv ``u0 + alpha*du1 + beta*du2`` selected at take. Returns (hit, uvx,
    uvy, took)."""
    z = torch.zeros_like(o.x)
    uvx, uvy = z, z
    took = torch.zeros_like(o.x, dtype=torch.bool)
    for i in range(scene.n_tris):
        A, u, v = (_row(t, i) for t in (scene.tri_a, scene.tri_u, scene.tri_v))
        t, hit, alpha, beta = ray_planar_triangle_uv(o, d, A, u, v)
        take = hit & (t < best.t)
        best = _take(best, take, t, scene.tri_mat[i],
                     normalize(cross(u, v), eps=1e-30))
        uvx = torch.where(take, scene.tri_uv0u[i] + alpha * scene.tri_uvdu1[i]
                          + beta * scene.tri_uvdu2[i], uvx)
        uvy = torch.where(take, scene.tri_uv0v[i] + alpha * scene.tri_uvdv1[i]
                          + beta * scene.tri_uvdv2[i], uvy)
        took = took | take
    return best, uvx, uvy, took


def _miss(o: Vec3) -> Hit:
    z = torch.zeros_like(o.x)
    return Hit(torch.full_like(o.x, F32_MAX),
               torch.zeros_like(o.x, dtype=torch.int32), Vec3(z, z, z))


def intersect_scene(scene: Scene, o: Vec3, d: Vec3) -> Hit:
    """RayCastIntersect (win32_main.cpp:406-556) for scenes without
    triangles; miss => (F32_MAX, mat 0, normal (0,0,0))."""
    if scene.n_tris:
        raise NotImplementedError(
            "triangle meshes without UVs are not ported yet (ROADMAP queue 2 "
            "item 2); a mesh-UV scene takes intersect_scene_uv")
    best = intersect_spheres(scene, o, d, _miss(o))
    best = intersect_quads(scene, o, d, best)
    best = intersect_planes(scene, o, d, best)
    return intersect_boxes(scene, o, d, best)


def intersect_scene_uv(scene: Scene, o: Vec3, d: Vec3):
    """``intersect_scene`` for a mesh-UV scene (intersect.py:1360-1390 in
    JAX): spheres, quads, planes, then the brute triangle sweep (K4t) or
    the streamed triangle walk (K7); returns (hit, uvx, uvy, uv_ok) with
    the winning triangle's texel-space uv."""
    brute = scene.tri_brute
    if not (brute or (scene.tri_streamed and scene.stream_uv_cfm)) \
            or scene.tri_dma:
        raise NotImplementedError(
            "only the brute sweep and the resident streamed mesh tier are "
            "ported (ROADMAP queue 2 item 2)")
    assert scene.n_boxes == 0, "mesh-UV scenes have no boxes"
    best = intersect_spheres(scene, o, d, _miss(o))
    best = intersect_quads(scene, o, d, best)
    best = intersect_planes(scene, o, d, best)
    if brute:
        return _intersect_triangles_brute_uv(scene, o, d, best)
    return _intersect_triangles_streamed_uv(scene, o, d, best)
