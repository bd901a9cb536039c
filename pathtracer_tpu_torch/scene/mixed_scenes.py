"""The mixed bases' scenes: where two of the kernel's bases meet.

Sphere clusters with world 1's combined texture set, with a mesh of any
tier, or with both, and the combined set with a mesh without UVs. The
scene is world 2's (its 11x11 spheres, in clusters), with world 1's
combined ground material on its plane, or world 1's (the combined set, no
clusters), plus a mesh. Dispersive glass and planar maps put the feature
bounce's dielectric and planar fetches on a mixed base.

:func:`mixed_builder` makes the same builder calls through either
package's ``worlds`` and ``textures`` modules, so the two packages'
tables compare equal. The mesh is the caller's, placed at
``MESH_AT[world]``: the tests pass small meshes, ``chip_smoke.py``
full-size ones. :func:`with_slivers` adds long thin triangles across a UV
mesh, which fill its huge cluster past 128 triangles: the streamed tier's
row-parallel uv rows, alone or beside clusters.
"""

from __future__ import annotations

import numpy as np

from . import textures as _textures
from . import worlds as _worlds
from .schema import WORLD_BRDF_TEST, WORLD_DEFAULT

# (center, radius) of a mixed scene's mesh: above world 2's grid, beside
# world 1's spheres, in view of either world's camera
MESH_AT = {WORLD_BRDF_TEST: ((2.5, 3.0, 1.0), 0.6),
           WORLD_DEFAULT: ((1.6, -2.0, 0.6), 0.6)}
GLASS = dict(albedo=(1.0, 1.0, 1.0), roughness=0.0, ior=1.5,
             transmission=1.0, dispersion=0.05)


def mixed_builder(world=WORLD_BRDF_TEST, combined=True, mesh=None,
                  mesh_material="grey", glass=False, maps=False,
                  ground_bump=0, worlds_mod=_worlds, textures_mod=_textures):
    """A mixed scene's builder and camera parameters.

    - ``world``: ``WORLD_BRDF_TEST`` (sphere clusters) or ``WORLD_DEFAULT``
      (the combined set, no clusters);
    - ``combined``: on world 2, world 1's combined ground material on its
      plane;
    - ``mesh``: ``(triangles (T, 3, 3), uvs (3T, 2) or None)``, or None. A
      mesh with UVs wears world 7's checker, one without is grey; either
      wears the combined ground material with ``mesh_material="ground"``
      (with UVs, a UV mesh beside the combined set: JAX renders it on XLA
      only);
    - ``glass``: every seventh sphere and the mesh in dispersive glass;
    - ``maps``: planar maps on the ground plane's material, world 7's
      checker as its albedo and an 8x8 height field as its bump map;
    - ``ground_bump``: one of the combined set's four maps (1-4) as the
      combined ground material's bump map, which keeps the set combined
      (JAX renders it on XLA only).
    """
    b, cp = worlds_mod.build_world(world)
    ground = next((i for i, m in enumerate(b.materials) if m.albedo_idx),
                  None)
    if world == WORLD_BRDF_TEST and combined:
        for t in textures_mod.load_bespoke_textures():
            b.add_texture(t)
        ground = b.add_material(albedo_idx=1, metalness_idx=2,
                                metal_color=(0.562, 0.565, 0.578),
                                roughness_idx=3, normal_idx=4)
        b.planes = [(n, d, ground) for n, d, _ in b.planes]
    if maps:
        m = b.materials[b.planes[0][2]]
        m.albedo_idx = b.add_texture(worlds_mod._mesh_uv_demo_texture())
        hf = np.repeat(np.random.RandomState(7).rand(8, 8, 1), 3, 2)
        m.bump_idx = b.add_texture((np.round(hf * 255.0) / 255.0)
                                   .astype(np.float32))
        m.bump_scale = 0.5
    if ground_bump:
        b.materials[ground].bump_idx = ground_bump
        b.materials[ground].bump_scale = 0.5
    glass_mat = b.add_material(**GLASS) if glass else None
    if glass:
        b.spheres = [(c, r, glass_mat if i % 7 == 3 else m)
                     for i, (c, r, m) in enumerate(b.spheres)]
    if mesh is not None:
        tris, uvs = mesh
        if glass:
            m = glass_mat
        elif mesh_material == "ground":
            m = ground
        elif uvs is not None:
            m = b.add_material(albedo=(1.0, 1.0, 1.0), roughness=0.55,
                               albedo_idx=b.add_texture(
                                   worlds_mod._mesh_uv_demo_texture()))
        else:
            m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
        b.set_mesh(np.reshape(tris, (-1, 3)),
                   np.full((3 * len(tris),), m, np.int32), uvs=uvs)
    return b, cp


def with_slivers(tris: np.ndarray, uvs: np.ndarray, n: int = 200,
                 seed: int = 0):
    """``tris`` ((T, 3, 3)) and their ``uvs`` ((3T, 2)) with ``n`` slivers
    appended: each runs from near one corner of the mesh's box to near the
    opposite one, 1e-3 of the box's diagonal wide, with random uvs in [0,
    1) at its two ends (its third corner shares the first's, so its uv
    varies along it and not across its width). Each spans more than half the diagonal, so each is a huge triangle
    (``clusters.HUGE_FRAC``), and with more than 128 of them the streamed
    tier keeps its uv rows parallel to the record rows."""
    rng = np.random.RandomState(seed)
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    ext = hi - lo
    flip = rng.rand(n, 3) < 0.5  # which corner each sliver starts from
    a = lo + ext * np.where(flip, 1.0 - 0.2 * rng.rand(n, 3),
                            0.2 * rng.rand(n, 3))
    b = lo + ext * np.where(flip, 0.2 * rng.rand(n, 3),
                            1.0 - 0.2 * rng.rand(n, 3))
    side = rng.randn(n, 3)
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    c = a + side * (1e-3 * np.linalg.norm(ext))
    slivers = np.stack([a, b, c], 1).astype(np.float32)
    ends = rng.rand(n, 2, 2)
    sliver_uvs = np.concatenate([ends, ends[:, :1]], 1).reshape(3 * n, 2)
    return (np.concatenate([tris.astype(np.float32), slivers]),
            np.concatenate([uvs, sliver_uvs]).astype(np.float32))
