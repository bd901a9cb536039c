"""Carry a scene or an accumulator from the JAX package into the port.

The JAX ``Scene`` and ``AccumState`` are pytrees of arrays; their leaves,
taken to numpy with ``np.asarray``, are all this module needs. It imports
neither JAX nor ``pathtracer_tpu``. A ``Vec3`` leaf arrives as a (3, N)
array (``np.asarray`` of the named tuple) or as a 3-tuple of (N,) arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..render.renderer import AccumState
from ..utils.vec import Vec3
from . import clusters
from .clusters import (
    CLUSTER_MIN, STREAM_FIELDS, STREAM_TRIS_PER_ROW, triangle_precompute,
)
from .schema import (
    CTRI_UV_FIELDS, STATIC_FIELDS, TENSOR_FIELDS, VEC_FIELDS, Scene,
    bake_quad_normals, bvh_tables, cluster_tables, mip_table, parent_tables,
    planar_tables, quad_records, sphere_bvh_tables, texture_stack,
    tri_cluster_tables,
)

# The JAX DMA tier's parent and grandparent rows and their counts (its
# static parent tuple is empty there), from which the port's descriptors
# are recovered.
JAX_PARENT_FIELDS = ("mtri_parents", "mtri_prange", "mtri_gparents",
                     "mtri_gprange")
JAX_PARENT_STATICS = ("n_stream_parents", "n_stream_gparents")
# clusters.pack_parents' box of a huge parent (always relevant)
_HUGE_LO = float(np.float32(-3e37))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _vec(a) -> Vec3:
    x, y, z = (a[0], a[1], a[2])
    return Vec3(_tensor(x), _tensor(y), _tensor(z))


def _parents_from_rows(rows, ranges, n: int) -> tuple:
    """JAX's pack_parents rows (mn3 mx3 in lanes 0-5) and (first, count)
    ranges -> the port's (first, count, mn3 | None, mx3 | None) tuple."""
    rows, ranges = np.asarray(rows, np.float32), np.asarray(ranges)
    out = []
    for i in range(n):
        mn, mx = rows[i, 0:3], rows[i, 3:6]
        box = ((None, None) if float(mn[0]) == _HUGE_LO else
               (tuple(float(v) for v in mn), tuple(float(v) for v in mx)))
        out.append((int(ranges[i, 0]), int(ranges[i, 1]), *box))
    return tuple(out)


def _record_rows(pre: dict, n: int) -> np.ndarray:
    """Precomputed triangles (``triangle_precompute``'s dict) as (n, 12)
    records n.xyz d e1.xyz a0 e2.xyz b0."""
    return np.concatenate(
        [pre[k].reshape(n, -1) for k in ("n", "d", "e1", "a0", "e2", "b0")],
        axis=1).astype(np.float32)


def _match(kw: dict, recs: np.ndarray):
    """The table-order triangles (A, u, v, each (len(recs), 3)) whose
    precomputed records are ``recs`` ((m, 12)), matched bit for bit (a
    copy of a triangle to the next copy; an all-zero record past the
    degenerate triangles, a padding slot, to zeros)."""
    n = kw["n_tris"]
    cols = lambda v: np.stack([c.numpy()[:n] for c in v], axis=1)
    A, u, v = cols(kw["tri_a"]), cols(kw["tri_u"]), cols(kw["tri_v"])
    slots: dict = {}
    for i, r in enumerate(_record_rows(triangle_precompute(A, u, v), n)):
        slots.setdefault(r.tobytes(), []).append(i)
    pick = np.asarray([(slots.get(r.tobytes()) or [-1]).pop(0)
                       for r in recs])
    zero = lambda x: np.where((pick >= 0)[:, None], x[pick.clip(0)], 0.0)
    return tuple(zero(x).astype(np.float32) for x in (A, u, v))


def _stream_tris(kw: dict):
    """``clusters.build_stream_bvh``'s triangles (A, u, v by record row and
    slot) for a streamed-tier scene's fields ``kw``, or None."""
    if not kw.get("tri_streamed"):
        return None
    pack = kw["mtri_pack"].numpy()
    per, nf = STREAM_TRIS_PER_ROW, STREAM_FIELDS
    recs = pack[:, :per * nf].reshape(-1, nf)[:, :12]
    return tuple(x.reshape(len(pack), per, 3) for x in _match(kw, recs))


def _static_bvh_args(kw: dict):
    """``clusters.build_static_bvh``'s arguments for a static-tier scene's
    fields ``kw``, or None for another tier. JAX's scene keeps no cluster
    order, so each cluster-ordered ``ctri_*`` record is matched, bit for
    bit, to the table-order triangle (``tri_a``/``tri_u``/``tri_v``) whose
    precomputed record it is (a copy of a triangle to the next copy)."""
    if not kw.get("tri_clusters") or kw.get("tri_streamed"):
        return None
    n = kw["n_tris"]
    cols = lambda v: np.stack([c.numpy()[:n] for c in v], axis=1)
    pre = {k: (cols(kw["ctri_" + k]) if k in ("n", "e1", "e2")
               else kw["ctri_" + k].numpy()[:n])
           for k in ("n", "d", "e1", "a0", "e2", "b0")}
    return (pre, *_match(kw, _record_rows(pre, n)), kw["tri_clusters"])


def _brute_bvh_args(kw: dict):
    """``clusters.build_brute_bvh``'s arguments (the table-order A, u, v)
    for a scene whose mesh JAX sweeps brute force (at most
    ``clusters.CLUSTER_MIN`` triangles), or None."""
    n = kw.get("n_tris", 0)
    if not 0 < n <= CLUSTER_MIN:
        return None
    return tuple(np.stack([c.numpy()[:n] for c in kw[k]], axis=1)
                 for k in ("tri_a", "tri_u", "tri_v"))


def scene_from_numpy(fields: dict, statics: dict) -> Scene:
    """JAX scene leaves (by field name) and statics -> a CPU port Scene.
    Fields and statics the port does not read are ignored; a missing
    ``quad_n`` (hand-built JAX scenes) is baked from ``quad_u``/``quad_v``.
    The cluster-ordered ``csph_*`` tables, the triangle and streamed-tier
    tables, the grid and the texture tables come across as they are,
    except a combined set's flat stack, which the port keeps only beside a
    UV mesh or a bump map, and the clusters of a mesh above
    ``clusters.DMA_MAX`` triangles, which it does not keep; the kernel's
    cluster, mip, parent and triangle-cluster tables are derived from the
    ``sph_clusters``, ``tex_mip_meta``, ``stream_parents`` /
    ``stream_gparents`` and ``tri_clusters`` statics, the streamed tier's
    BVH from its record rows, the static tier's from its cluster-ordered
    triangles, a brute mesh's (K4t) from its table-order triangles, the
    sphere clusters' BVH from the cluster-ordered spheres and K10's planar
    table from the flat stack. A JAX DMA-tier scene
    keeps its parents as rows (``JAX_PARENT_FIELDS``, counted by
    ``JAX_PARENT_STATICS``); the descriptors are read back from them."""
    kw = {k: _vec(fields[k]) for k in VEC_FIELDS
          if k != "quad_n" or fields.get(k) is not None}
    if "quad_n" not in kw:
        kw["quad_n"] = bake_quad_normals(kw["quad_u"], kw["quad_v"])
    kw.update(quad_records(kw["quad_point"], kw["quad_u"], kw["quad_v"],
                           kw["quad_n"]))
    kw.update({k: _tensor(fields[k]) for k in TENSOR_FIELDS})
    kw.update({k: statics[k] for k in STATIC_FIELDS if k in statics})
    kw.update(cluster_tables(kw.get("sph_clusters", ())))
    kw.update(sphere_bvh_tables(kw["csph_center"], kw["csph_radius"],
                                kw.get("sph_clusters", ())))
    kw.update(mip_table(kw.get("tex_mip_meta", ())))
    if statics.get("n_stream_parents"):
        kw["stream_parents"] = _parents_from_rows(
            fields["mtri_parents"], fields["mtri_prange"],
            statics["n_stream_parents"])
        kw["stream_gparents"] = _parents_from_rows(
            fields["mtri_gparents"], fields["mtri_gprange"],
            statics.get("n_stream_gparents", 0))
    kw.update(parent_tables(kw.get("stream_parents", ()),
                            kw.get("stream_gparents", ())))
    if kw["n_tris"] > clusters.DMA_MAX:
        # JAX clusters a mesh above the DMA tier, which no kernel walks;
        # the port keeps no clusters there (WorldBuilder.finalize)
        z = lambda dtype=torch.float32: torch.zeros((1,), dtype=dtype)
        kw.update({k: Vec3(z(), z(), z())
                   for k in ("ctri_n", "ctri_e1", "ctri_e2")},
                  **{k: z() for k in ("ctri_d", "ctri_a0", "ctri_b0",
                                      *CTRI_UV_FIELDS)},
                  ctri_mat=z(torch.int32), tri_clusters=())
    kw.update(tri_cluster_tables(kw.get("tri_clusters", ())))
    kw.update(bvh_tables(kw["mtri_pack"], kw.get("tri_streamed", False),
                         kw.get("stream_leaf", 0),
                         kw.get("stream_uv_cfm", False), _static_bvh_args(kw),
                         _brute_bvh_args(kw), _stream_tris(kw)))
    if kw.get("tex_combined") and not (kw.get("has_mesh_uvs")
                                       or kw.get("any_bump")):
        kw.update(texture_stack([], combined=True))
    kw.update(planar_tables(
        kw["tex_packed"], kw["tex_w"], kw["tex_h"], kw.get("tex_hmax", 1),
        kw.get("tex_wmax", 1), planar=bool(
            kw.get("n_textures") and not kw.get("tex_combined"))))
    return Scene(**kw)


def accum_from_numpy(fields: dict):
    """A JAX AccumState's leaves -> a CPU port AccumState (the checkpoint).
    The float32 scalar counters become the port's exact int64 counters."""
    return AccumState(
        sum=_vec(fields["sum"]),
        sum_sq=_vec(fields["sum_sq"]),
        count=_tensor(np.asarray(fields["count"], np.float32)),
        nan_count=torch.tensor(int(np.rint(fields["nan_count"])),
                               dtype=torch.int64),
        rays_cast=torch.tensor(int(np.rint(fields["rays_cast"])),
                               dtype=torch.int64),
        samples_done=int(fields["samples_done"]),
    )

