"""Built-in worlds (LoadWorld, reference win32_main.cpp:1788-2074).

Counterpart of ``pathtracer_tpu/scene/worlds.py`` for the worlds whose
scenes the port covers: the Cornell box (``-w3``), the Cornell box with a
quad area light (``-w6``), the metal/roughness sphere grid (``-w2``) and
the "Ray Tracing in One Weekend" cover (``-w4``: 484 spheres from a seeded
``np.random.RandomState``, the forced thin lens). Material order, sphere
order (``spheres[0]`` is the NEE light), random draws and camera
parameters are the JAX builders', line for line. The other worlds need
textures or meshes and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .camera import Camera, define_camera
from .schema import (
    Scene, WorldBuilder,
    WORLD_DEFAULT, WORLD_BRDF_TEST, WORLD_CORNELL_BOX,
    WORLD_RAYTRACING_ONE_WEEKEND, WORLD_MARIO, WORLD_CORNELL_QUAD,
    WORLD_MESH_UV, WORLD_KIND_COUNT,
)

# World kinds not yet ported, with the ROADMAP item that brings them.
_NOT_PORTED = {
    WORLD_DEFAULT: "world 1 needs textures (ROADMAP queue 1 item 9)",
    WORLD_MARIO: "world 5 needs triangle meshes (ROADMAP queue 1 item 10)",
    WORLD_MESH_UV: "world 7 needs meshes and textures "
                   "(ROADMAP queue 1 items 9-10)",
}


@dataclasses.dataclass
class CameraParams:
    """The 'user set' camera fields before DefineCamera (win32_main.cpp:1801-1806)."""
    pos: tuple = (0.0, -10.0, 1.0)
    target: tuple = (0.0, 0.0, 0.0)
    fov: float = 45.0
    focal_distance: float = 5.0
    aperture_radius: float = 0.035
    use_pinhole: bool = True


def _add_sky(b: WorldBuilder, color) -> int:
    """AddSky (win32_main.cpp:2048-2051): emissive material at index 0."""
    return b.add_material(emit=tuple(color))


def _add_sun(b: WorldBuilder):
    """AddSunDirectionalLight (win32_main.cpp:2053-2067): the emissive sphere
    pushed FIRST so it is spheres[0], the NEE light."""
    light = b.add_material(albedo=(0, 0, 0), emit=(15.0, 15.0, 15.0))
    b.add_sphere((2000.0, 2000.0, 2000.0), 1000.0, light)


def _ground_plane(b: WorldBuilder, mat: int):
    """MakeGroundPlane (win32_main.cpp:2069-2074): n=(0,0,1), d=0."""
    b.add_plane((0.0, 0.0, 1.0), 0.0, mat)


def _rtiow_cover(b: WorldBuilder, cam: CameraParams, rtiow_seed: int):
    """win32_main.cpp:1960-2035, the RTIOW book cover, with the JAX
    package's fixed-seed layout (scene/worlds.py:270-318) in its draw
    order."""
    _add_sky(b, (1.0, 1.0, 1.0))
    ground = b.add_material(albedo=(0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1000.0), 1000.0, ground)

    rng = np.random.RandomState(rtiow_seed)
    rand = lambda: float(rng.rand())
    rand_v3 = lambda: (rand(), rand(), rand())
    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = rand()
            center = (a + 0.9 * rand(), bb + 0.9 * rand(), 0.2)
            d = np.array(center) - np.array((4.0, 0.0, 0.2))
            if float(np.sqrt((d * d).sum())) > 0.9:
                if choose < 0.8:
                    c1, c2 = rand_v3(), rand_v3()
                    m = b.add_material(
                        albedo=tuple(x * y for x, y in zip(c1, c2)))
                else:
                    # roughness = 1 - the NEW metalness, the JAX package's
                    # reading of the reference's intent (:1991-1994)
                    metalness = rand()
                    mc = rand_v3()
                    m = b.add_material(
                        metalness=metalness,
                        metal_color=(0.5 * mc[0] + 0.5, 0.5 * mc[1] + 0.5,
                                     0.5 * mc[2] + 0.5),
                        roughness=1.0 - metalness)
                b.add_sphere(center, 0.2, m)

    m2 = b.add_material(albedo=(0.4, 0.2, 0.1))
    b.add_sphere((-4.0, 0.0, 1.0), 1.0, m2)
    m3 = b.add_material(metalness=1.0, metal_color=(0.7, 0.6, 0.5),
                        roughness=0.0)
    b.add_sphere((4.0, 0.0, 1.0), 1.0, m3)

    cam.use_pinhole = False  # forced thin lens (win32_main.cpp:2030)
    cam.target = (0.0, 0.0, 0.0)
    cam.pos = (13.0, 3.0, 2.0)
    cam.fov = 20.0
    cam.focal_distance = 10.0


def build_world(kind: int, use_pinhole: bool = True,
                rtiow_seed: int = 1337) -> Tuple[WorldBuilder, CameraParams]:
    """LoadWorld for the ported worlds: the host builder and the camera
    parameters before derivation. ``rtiow_seed`` seeds world 4's layout."""
    if not (0 <= kind < WORLD_KIND_COUNT):
        raise ValueError(f"world kind {kind} out of range")
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])

    b = WorldBuilder()
    cam = CameraParams(use_pinhole=use_pinhole)

    if kind == WORLD_CORNELL_BOX:
        # win32_main.cpp:1844-1901
        _add_sky(b, (0.0, 0.0, 0.0))
        left, right, bottom, top, front, back = 0.0, 800.0, 0.0, 555.0, 0.0, 555.0
        red = b.add_material(albedo=(0.65, 0.05, 0.05))
        white = b.add_material(albedo=(0.73, 0.73, 0.73))
        green = b.add_material(albedo=(0.12, 0.45, 0.15))
        light = b.add_material(albedo=(0, 0, 0), emit=(15.0, 15.0, 15.0))

        # right wall (Z cross Y = -X)
        b.add_quad((right, bottom, front), (0, 0, top - bottom), (0, back - front, 0), green)
        # left wall (Y cross Z = X)
        b.add_quad((left, bottom, front), (0, back - front, 0), (0, 0, top - bottom), red)
        # light sphere — spheres[0], the NEE target
        b.add_sphere(((right - left) / 2.0, (back - front) / 2.0, (top - bottom) / 2.0), 65.0, light)
        # ceiling
        b.add_quad((left, front, top), (0, back - front, 0), (right - left, 0, 0), white)
        # back wall
        b.add_quad((left, back, bottom), (right - left, 0, 0), (0, 0, top - bottom), white)
        # floor
        b.add_quad((left, bottom, front), (right - left, 0, 0), (0, back - front, 0), white)

        cam.fov = 40.0
        cam.pos = ((right - left) / 2.0, front - 800.0, (top - bottom) / 2.0)
        cam.target = ((right - left) / 2.0, front, (top - bottom) / 2.0)

    elif kind == WORLD_CORNELL_QUAD:
        # -w6: the Cornell box lit by an emissive area quad under the
        # ceiling (the scene the reference's unused PdfValueQuad was
        # written for, win32_main.cpp:301-322), plus two spheres.
        _add_sky(b, (0.0, 0.0, 0.0))
        left, right, bottom, top, front, back = 0.0, 800.0, 0.0, 555.0, 0.0, 555.0
        red = b.add_material(albedo=(0.65, 0.05, 0.05))
        white = b.add_material(albedo=(0.73, 0.73, 0.73))
        green = b.add_material(albedo=(0.12, 0.45, 0.15))
        light = b.add_material(albedo=(0, 0, 0), emit=(10.0, 10.0, 10.0))

        b.add_quad((right, bottom, front), (0, 0, top - bottom), (0, back - front, 0), green)
        b.add_quad((left, bottom, front), (0, back - front, 0), (0, 0, top - bottom), red)
        cx, cy = (right - left) / 2.0, (back - front) / 2.0
        ql = b.add_quad((cx - 130.0, cy - 130.0, top - 1.0),
                        (260.0, 0.0, 0.0), (0.0, 260.0, 0.0), light)
        b.set_quad_light(ql)
        b.add_quad((left, front, top), (0, back - front, 0), (right - left, 0, 0), white)
        b.add_quad((left, back, bottom), (right - left, 0, 0), (0, 0, top - bottom), white)
        b.add_quad((left, bottom, front), (right - left, 0, 0), (0, back - front, 0), white)

        m = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
        b.add_sphere((cx - 150.0, cy + 60.0, 110.0), 110.0, m)
        m = b.add_material(metalness=0.9, metal_color=(0.8, 0.75, 0.6),
                           roughness=0.15)
        b.add_sphere((cx + 160.0, cy - 80.0, 90.0), 90.0, m)

        cam.fov = 40.0
        cam.pos = (cx, front - 800.0, (top - bottom) / 2.0)
        cam.target = (cx, front, (top - bottom) / 2.0)

    elif kind == WORLD_BRDF_TEST:
        # win32_main.cpp:1903-1928 — 11x11 metal/roughness sweep
        _add_sky(b, (65 / 255.0, 108 / 255.0, 162 / 255.0))
        _add_sun(b)
        plane_mat = b.add_material(albedo=(0.5, 0.5, 0.5))
        _ground_plane(b, plane_mat)
        color = (1.0, 0.782, 0.344)
        for i in range(11):
            for j in range(11):
                m = b.add_material(albedo=color, metalness=i / 10.0,
                                   metal_color=color, roughness=j / 10.0)
                b.add_sphere((i / 2.0, 11 / 2.0 - j / 2.0, 0.2), 0.2, m)
        cam.target = (2.5, 2.5, 0.0)
        cam.pos = (2.5, 7.0, 2.0)
        cam.fov = 50.0
        cam.focal_distance = 10.0

    elif kind == WORLD_RAYTRACING_ONE_WEEKEND:
        _rtiow_cover(b, cam, rtiow_seed)

    return b, cam


def finalize_world(kind: int, image_width: int, image_height: int,
                   use_pinhole: bool = True,
                   rtiow_seed: int = 1337) -> Tuple[Scene, Camera]:
    """Build world ``kind`` (a CPU Scene) and derive its camera for the
    given image size; ``use_pinhole=False`` selects the thin lens (world 4
    always uses it)."""
    b, cam = build_world(kind, use_pinhole=use_pinhole, rtiow_seed=rtiow_seed)
    scene = b.finalize(world_kind=kind, view_origin=cam.pos)
    camera = define_camera(
        cam.pos, cam.target, cam.fov, image_width, image_height,
        use_pinhole=cam.use_pinhole,
        focal_distance=cam.focal_distance,
        aperture_radius=cam.aperture_radius,
    )
    return scene, camera
