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
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

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


def ray_slab_entry(o: Vec3, d: Vec3, mn, mx):
    """Slab test against one AABB given by float corners. Returns
    (t_enter, hit); a primitive hit inside the box has t >= t_enter.
    min/max propagate NaN, as XLA's do."""
    inv = [torch.reciprocal(torch.where(c != 0.0, c, 1e-30)) for c in d]
    ts = [((lo - oc) * iv, (hi - oc) * iv)
          for lo, hi, oc, iv in zip(mn, mx, o, inv)]
    near = [torch.minimum(t0, t1) for t0, t1 in ts]
    far = [torch.maximum(t0, t1) for t0, t1 in ts]
    tmin = torch.maximum(torch.maximum(near[0], near[1]), near[2])
    tmax = torch.minimum(torch.minimum(far[0], far[1]), far[2])
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


def intersect_scene(scene: Scene, o: Vec3, d: Vec3) -> Hit:
    """RayCastIntersect (win32_main.cpp:406-556) for scenes without
    triangles; miss => (F32_MAX, mat 0, normal (0,0,0))."""
    if scene.n_tris:
        raise NotImplementedError(
            "triangle meshes are not ported yet (ROADMAP queue 1 item 10)")
    z = torch.zeros_like(o.x)
    best = Hit(torch.full_like(o.x, F32_MAX),
               torch.zeros_like(o.x, dtype=torch.int32), Vec3(z, z, z))
    best = intersect_spheres(scene, o, d, best)
    best = intersect_quads(scene, o, d, best)
    best = intersect_planes(scene, o, d, best)
    return intersect_boxes(scene, o, d, best)
