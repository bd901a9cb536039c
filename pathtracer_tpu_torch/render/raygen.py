"""Camera ray generation: the stratified pinhole and the thin lens.

Counterpart of ``pathtracer_tpu/render/raygen.py``: the pinhole
(win32_main.cpp:1000-1074) with the reference's stratum arithmetic in a
film space stretched by 2, and the thin lens (:1087-1169) with its focal
plane from 1/f = 1/v + 1/b and the 12-entry Poisson-disk aperture indexed
by ``(ray_index2 * ray_index) % 12``. Camera fields and their products
stay Python floats (double) until they meet a tensor, where they round once
to float32, exactly where the JAX code's weakly typed constants round.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..scene.camera import Camera
from ..scene.schema import FIXED_FOCAL_LENGTH
from ..utils.vec import Vec3, normalize, sdiv, splat

# The Poisson-disk aperture samples (win32_main.cpp:1097-1110).
POISSON_DISK = (
    (0.0, 0.0),
    (-0.94201624, -0.39906216),
    (0.94558609, -0.76890725),
    (-0.094184101, -0.92938870),
    (0.34495938, 0.29387760),
    (-0.91588581, 0.45771432),
    (-0.81544232, -0.87912464),
    (-0.38277543, 0.27676845),
    (0.97484398, 0.75648379),
    (0.44323325, -0.97511554),
    (0.53742981, -0.47373420),
    (-0.26496911, -0.41893023),
)
NUM_POISSON = len(POISSON_DISK)


def pixel_frustum_coords(width: int, height: int, pixel_idx: torch.Tensor):
    """Per-pixel frustum coords in [-1, 1] for flat y-major pixel indices."""
    y = torch.div(pixel_idx, width, rounding_mode="floor").to(torch.float32)
    x = torch.remainder(pixel_idx, width).to(torch.float32)
    fy = -1.0 + sdiv(2.0 * y, float(height))
    fx = -1.0 + sdiv(2.0 * x, float(width))
    return fx, fy


def _film_point(camera: Camera, x_step, y_step) -> Vec3:
    """frustumCenter + xStep*halfFilmWidth*axisX + yStep*halfFilmHeight*axisY."""
    cx, cy, cz = camera.frustum_center
    ax, ay = camera.axis_x, camera.axis_y
    sx = x_step * camera.half_film_width
    sy = y_step * camera.half_film_height
    return Vec3(cx + sx * ax[0] + sy * ay[0],
                cy + sx * ax[1] + sy * ay[1],
                cz + sx * ax[2] + sy * ay[2])


def pinhole_rays(camera: Camera, width: int, height: int, pp: int,
                 i: torch.Tensor, j: torch.Tensor, jitter_u,
                 pixel_idx: torch.Tensor) -> Tuple[Vec3, Vec3]:
    """Rays for stratum (i, j) of the pp x pp grid, per pixel; ``i``/``j``
    are per-lane integer tensors and ``jitter_u`` two (N,) uniforms."""
    fX, fY = pixel_frustum_coords(width, height, pixel_idx)
    hpw, hph = camera.half_film_pixel_w, camera.half_film_pixel_h
    step_x = (1.0 / pp) * hpw * 2.0
    step_y = (1.0 / pp) * hph * 2.0
    fi = sdiv(i.to(torch.float32), float(pp))
    fj = sdiv(j.to(torch.float32), float(pp))
    x_step = (fX - hpw) + fi * hpw + 0.5 * step_x + (jitter_u[0] - 0.5) * step_x
    y_step = (fY - hph) + fj * hph + 0.5 * step_y + (jitter_u[1] - 0.5) * step_y
    p = _film_point(camera, x_step, y_step)
    pin = splat(camera.pos, fX)
    return pin, normalize(p - pin)


def focal_plane(camera: Camera):
    """The thin lens's focal plane n.x = d_coef (win32_main.cpp:1130-1142)
    from 1/f = 1/v + 1/b, folded in double: (n, d_coef)."""
    focal_plane_dist = 1.0 / (1.0 / FIXED_FOCAL_LENGTH
                              - 1.0 / camera.focal_length)
    az, ax, pos = camera.axis_z, camera.axis_x, camera.pos
    n = (-az[0], -az[1], -az[2])
    plane_point = [pos[k] + ax[k] + focal_plane_dist * n[k] for k in range(3)]
    return n, (n[0] * plane_point[0] + n[1] * plane_point[1]
               + n[2] * plane_point[2])


def thin_lens_rays(camera: Camera, width: int, height: int, pp: int,
                   ray_index: torch.Tensor, ray_index2: torch.Tensor, lens_u,
                   pixel_idx: torch.Tensor) -> Tuple[Vec3, Vec3]:
    """Thin-lens rays for (rayIndex, rayIndex2) = (s // pp, s % pp), per
    lane; ``lens_u`` are two (N,) uniforms keyed on (pixel, ray_index)."""
    fX, fY = pixel_frustum_coords(width, height, pixel_idx)
    off_x = fX + (2.0 * lens_u[0] - 1.0) * camera.half_film_pixel_w
    off_y = fY + (2.0 * lens_u[1] - 1.0) * camera.half_film_pixel_h
    p = _film_point(camera, off_x, off_y)
    lens_center = splat(camera.pos, fX)
    ray_dir = normalize(p - lens_center)

    n, d_coef = focal_plane(camera)
    denom = n[0] * ray_dir.x + n[1] * ray_dir.y + n[2] * ray_dir.z
    t = (d_coef - (n[0] * lens_center.x + n[1] * lens_center.y
                   + n[2] * lens_center.z)) / denom
    focal_point = lens_center + ray_dir * t

    # aperture point: disk[(rayIndex2 * rayIndex) % 12] on the lens plane
    idx = torch.remainder(ray_index2 * ray_index, NUM_POISSON).long()
    disk = torch.tensor(POISSON_DISK, dtype=torch.float32,
                        device=fX.device)[idx]
    dx = disk[:, 0] * camera.aperture_radius
    dy = disk[:, 1] * camera.aperture_radius
    axv, ayv = camera.axis_x, camera.axis_y
    o = Vec3(lens_center.x + dx * axv[0] + dy * ayv[0],
             lens_center.y + dx * axv[1] + dy * ayv[1],
             lens_center.z + dx * axv[2] + dy * ayv[2])
    return o, normalize(focal_point - o)
