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
from .schema import (
    STATIC_FIELDS, TENSOR_FIELDS, VEC_FIELDS, Scene, bake_quad_normals,
    cluster_tables, mip_table,
)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _vec(a) -> Vec3:
    x, y, z = (a[0], a[1], a[2])
    return Vec3(_tensor(x), _tensor(y), _tensor(z))


def scene_from_numpy(fields: dict, statics: dict) -> Scene:
    """JAX scene leaves (by field name) and statics -> a CPU port Scene.
    Fields and statics the port does not read are ignored; a missing
    ``quad_n`` (hand-built JAX scenes) is baked from ``quad_u``/``quad_v``.
    The cluster-ordered ``csph_*`` tables and the combined texture tables
    come across as they are; the kernel's cluster and mip tables are
    derived from the ``sph_clusters`` and ``tex_mip_meta`` statics."""
    kw = {k: _vec(fields[k]) for k in VEC_FIELDS
          if k != "quad_n" or fields.get(k) is not None}
    if "quad_n" not in kw:
        kw["quad_n"] = bake_quad_normals(kw["quad_u"], kw["quad_v"])
    kw.update({k: _tensor(fields[k]) for k in TENSOR_FIELDS})
    kw.update({k: statics[k] for k in STATIC_FIELDS if k in statics})
    kw.update(cluster_tables(kw.get("sph_clusters", ())))
    kw.update(mip_table(kw.get("tex_mip_meta", ())))
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

