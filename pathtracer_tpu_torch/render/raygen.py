"""Camera ray generation: the stratified pinhole.

Counterpart of the pinhole half of ``pathtracer_tpu/render/raygen.py``
(win32_main.cpp:1000-1074), with the reference's stratum arithmetic in a
film space stretched by 2. Camera fields and their products stay Python
floats (double) until they meet a tensor, where they round once to float32,
exactly where the JAX code's weakly typed constants round. The thin lens
waits for ROADMAP queue 1 item 3.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..scene.camera import Camera
from ..utils.vec import Vec3, normalize, sdiv, splat


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
