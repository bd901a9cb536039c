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
full-size ones.
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
                  worlds_mod=_worlds, textures_mod=_textures):
    """A mixed scene's builder and camera parameters.

    - ``world``: ``WORLD_BRDF_TEST`` (sphere clusters) or ``WORLD_DEFAULT``
      (the combined set, no clusters);
    - ``combined``: on world 2, world 1's combined ground material on its
      plane;
    - ``mesh``: ``(triangles (T, 3, 3), uvs (3T, 2) or None)``, or None. A
      mesh with UVs wears world 7's checker; one without is grey, or in the
      combined ground material with ``mesh_material="ground"``;
    - ``glass``: every seventh sphere and the mesh in dispersive glass;
    - ``maps``: planar maps on the ground plane's material, world 7's
      checker as its albedo and an 8x8 height field as its bump map.
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
    glass_mat = b.add_material(**GLASS) if glass else None
    if glass:
        b.spheres = [(c, r, glass_mat if i % 7 == 3 else m)
                     for i, (c, r, m) in enumerate(b.spheres)]
    if mesh is not None:
        tris, uvs = mesh
        if glass:
            m = glass_mat
        elif uvs is not None:
            m = b.add_material(albedo=(1.0, 1.0, 1.0), roughness=0.55,
                               albedo_idx=b.add_texture(
                                   worlds_mod._mesh_uv_demo_texture()))
        elif mesh_material == "ground":
            m = ground
        else:
            m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
        b.set_mesh(np.reshape(tris, (-1, 3)),
                   np.full((3 * len(tris),), m, np.int32), uvs=uvs)
    return b, cp
