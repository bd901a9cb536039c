"""Camera model and derivation ("Vulkan-style" camera, ray.hpp:176-186).

A verbatim copy of pathtracer_tpu/scene/camera.py (pure Python floats);
copied, not imported, because that package imports JAX.

Reproduces DefineCamera (reference win32_main.cpp:2197-2249) exactly,
including its idiosyncrasies:
- filmWidth = tan(fov_degrees * DEG_TO_RAD) * 2 * focalLength uses the FULL
  fov in the tangent (not fov/2) — a reference quirk that is visible in
  framing and therefore preserved;
- halfFilmPixelW/H = 1/width, 1/height: "half pixel" in a film space
  stretched by factor 2 (comment at win32_main.cpp:2228-2231);
- thin-lens focal length from 1/f = 1/v + 1/b with FIXED_FOCAL_LENGTH=0.098
  (win32_main.cpp:2206-2209).

The camera is a plain dataclass of python floats: ray generation combines
its fields on the host in double and rounds each constant once to float32.
"""

from __future__ import annotations

import dataclasses
import math

from .schema import FIXED_FOCAL_LENGTH

DEG_TO_RAD = math.pi / 180.0


def _normalize3(v):
    m = math.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return (v[0] / m, v[1] / m, v[2] / m)


def _cross3(a, b):
    return (
        a[1] * b[2] - b[1] * a[2],
        a[2] * b[0] - b[2] * a[0],
        a[0] * b[1] - b[0] * a[1],
    )


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


@dataclasses.dataclass(frozen=True)
class Camera:
    """Fully derived camera (the post-DefineCamera state)."""

    fov: float
    focal_length: float
    focal_distance: float
    aperture_radius: float
    use_pinhole: bool
    film_width: float
    film_height: float
    half_film_width: float
    half_film_height: float
    half_film_pixel_w: float
    half_film_pixel_h: float
    pos: tuple
    target: tuple
    frustum_center: tuple
    axis_x: tuple
    axis_y: tuple
    axis_z: tuple


def define_camera(
    pos,
    target,
    fov: float,
    image_width: int,
    image_height: int,
    use_pinhole: bool = True,
    focal_distance: float = 5.0,
    aperture_radius: float = 0.035,
) -> Camera:
    """DefineCamera (win32_main.cpp:2197-2249) on host floats.

    Inputs mirror the "user set" parameters listed at win32_main.cpp:2199-2200.
    """
    axis_z = _normalize3(_sub3(pos, target))
    axis_x = _normalize3(_cross3((0.0, 0.0, 1.0), axis_z))
    axis_y = _normalize3(_cross3(axis_z, axis_x))

    if not use_pinhole:
        focal_length = 1.0 / (1.0 / FIXED_FOCAL_LENGTH - 1.0 / focal_distance)
    else:
        focal_length = FIXED_FOCAL_LENGTH

    film_width = math.tan(DEG_TO_RAD * fov) * 2.0 * focal_length
    film_height = film_width
    if image_width > image_height:
        film_height = film_width * image_height / image_width
    elif image_height > image_width:
        film_width = film_height * image_width / image_height

    frustum_center = (
        pos[0] - focal_length * axis_z[0],
        pos[1] - focal_length * axis_z[1],
        pos[2] - focal_length * axis_z[2],
    )

    return Camera(
        fov=fov,
        focal_length=focal_length,
        focal_distance=focal_distance,
        aperture_radius=aperture_radius,
        use_pinhole=use_pinhole,
        film_width=film_width,
        film_height=film_height,
        half_film_width=film_width / 2.0,
        half_film_height=film_height / 2.0,
        half_film_pixel_w=1.0 / image_width,
        half_film_pixel_h=1.0 / image_height,
        pos=tuple(pos),
        target=tuple(target),
        frustum_center=frustum_center,
        axis_x=axis_x,
        axis_y=axis_y,
        axis_z=axis_z,
    )
