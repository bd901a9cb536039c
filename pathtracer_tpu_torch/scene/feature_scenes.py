"""The five feature scenes beyond the reference worlds.

A copy of ``pathtracer_tpu/scene/feature_scenes.py`` built with the port's
``WorldBuilder``: the same materials, geometry, ``RandomState`` seeds and
8-bit quantised textures, so each scene's tables equal the JAX builder's.

  bump       — a bump-mapped floor: the height fetch (K11)
  tbn        — a tilted plane with a tangent-frame normal map (K10 planar)
  fog        — world 6 in homogeneous fog: HG phase sampling and volume NEE
  dispersion — a dispersive glass sphere: per-path RGB channel refraction
  everything — fog, dispersive glass, RR, a bump floor and a UV-textured
               3-triangle mesh (the brute sweep K4t) in one scene

Each builder returns ``(scene, (pos, target, fov), config_kwargs)``; the
camera is ``camera.define_camera(pos, target, fov, width, height)``.
"""

from __future__ import annotations

import numpy as np

from .schema import WORLD_CORNELL_QUAD, WorldBuilder


def _bump_case():
    rng = np.random.RandomState(12)
    tex = np.repeat(rng.rand(16, 16, 1), 3, axis=2).astype(np.float32)
    tex = (np.round(tex * 255.0) / 255.0).astype(np.float32)
    b = WorldBuilder()
    b.add_material(emit=(0.3, 0.35, 0.45))
    light = b.add_material(emit=(6.0, 5.5, 5.0))
    b.add_sphere((3, -3, 6), 1.0, light)
    m = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.8,
                       bump_idx=b.add_texture(tex), bump_scale=0.5)
    b.add_plane((0, 0, 1), 0.0, m)
    return b.finalize(), ((0, -8, 2), (0, 0, 0), 35.0), {}


def _tbn_case():
    rng = np.random.RandomState(5)
    tex = rng.rand(16, 16, 3).astype(np.float32) * 0.4 + 0.3
    tex[..., 2] = 0.8 + 0.2 * tex[..., 2]
    tex = (np.round(tex * 255.0) / 255.0).astype(np.float32)
    b = WorldBuilder()
    b.add_material(emit=(0.25, 0.3, 0.4))
    light = b.add_material(emit=(7.0, 6.5, 6.0))
    b.add_sphere((4.0, -4.0, 8.0), 1.0, light)
    m = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.7, normal_idx=1)
    n = (0.0, -np.sin(np.pi / 4), np.cos(np.pi / 4))
    b.add_plane(n, 1.0, m)
    b.textures.append(tex)
    b.tbn_normal_maps = True
    return b.finalize(), ((0, -9, 3.0), (0, 0, 0), 35.0), {}


def _fog_case():
    from .worlds import build_world
    b, cam_d = build_world(WORLD_CORNELL_QUAD)
    b.set_fog(0.0012, albedo=(0.9, 0.9, 0.95), g=0.5)
    return b.finalize(), (cam_d.pos, cam_d.target, cam_d.fov), {}


def _dispersion_case():
    b = WorldBuilder()
    b.add_material(emit=(0.3, 0.35, 0.45))
    light = b.add_material(emit=(8.0, 7.5, 7.0))
    b.add_sphere((4, -4, 7), 1.2, light)
    glass = b.add_material(albedo=(0.95, 0.97, 1.0), ior=1.45,
                           transmission=1.0, dispersion=0.12)
    b.add_sphere((0, 0, 1.0), 1.0, glass)
    floor = b.add_material(albedo=(0.55, 0.5, 0.45), roughness=0.9)
    b.add_plane((0, 0, 1), 0.0, floor)
    return b.finalize(), ((0, -7, 2.0), (0, 0, 0.8), 35.0), {}


def _everything_case():
    rng = np.random.RandomState(12)
    b = WorldBuilder()
    b.add_material(emit=(0.3, 0.3, 0.4))
    light = b.add_material(emit=(7.0, 6.5, 6.0))
    b.add_sphere((3, -4, 6), 1.0, light)
    glass = b.add_material(albedo=(0.92, 0.95, 0.99), ior=1.4,
                           transmission=1.0, dispersion=0.1)
    b.add_sphere((-1.2, 0.5, 0.8), 0.8, glass)
    b.set_fog(0.02, albedo=(0.8, 0.85, 0.9), g=0.4)
    bump_tex = np.repeat(rng.rand(8, 8, 1), 3, 2).astype(np.float32)
    bump_tex = (np.round(bump_tex * 255.0) / 255.0).astype(np.float32)
    bm = b.add_material(albedo=(0.5, 0.45, 0.4), roughness=0.9,
                        bump_idx=b.add_texture(bump_tex), bump_scale=0.3)
    b.add_plane((0, 0, 1), 4.0, bm)
    check = (np.indices((8, 8)).sum(0) % 2)[..., None].repeat(3, 2)
    uv_tex = (np.round((check * 0.7 + 0.2) * 255.0) / 255.0
              ).astype(np.float32)
    um = b.add_material(albedo=(1.0, 0.9, 0.8),
                        albedo_idx=b.add_texture(uv_tex), roughness=0.7)
    pts = np.asarray([[-1, 0, -1], [1, 0, -1], [0, 0, 1.2]], np.float32)
    b.set_mesh(pts, np.full(3, um, np.int32),
               uvs=np.asarray([[0, 0], [2, 0], [1, 2]], np.float32))
    scene = b.finalize()
    assert (scene.any_dispersive and scene.fog_sigma_t > 0
            and scene.any_bump and scene.has_mesh_uvs)
    return scene, ((0, -8, 1), (0, 0, 0), 35.0), {
        "use_russian_roulette": True}


FEATURE_CASES = {
    "bump": _bump_case,
    "tbn": _tbn_case,
    "fog": _fog_case,
    "dispersion": _dispersion_case,
    "everything": _everything_case,
}
