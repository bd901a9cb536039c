"""Color pipeline: exact linear->sRGB transfer, ACES tonemap, BGRA packing.

Counterpart of ``pathtracer_tpu/utils/color.py``; the same expressions in the
same order, so the output bytes agree (the ``pow`` may differ by an ulp
between libraries, which moves a channel by one step on rare pixels).
"""

from __future__ import annotations

import torch

from .vec import Vec3, clamp, hadamard, hadamard_div


def linear_to_srgb(L: torch.Tensor) -> torch.Tensor:
    """Piecewise linear->sRGB after clamping to [0, 1]."""
    L = torch.clamp(L, 0.0, 1.0)
    lin = L * 12.92
    gam = 1.055 * torch.pow(torch.clamp_min(L, 1e-30), 1.0 / 2.4) - 0.055
    return torch.where(L > 0.0031308, gam, lin)


def tonemap_aces(color: Vec3) -> Vec3:
    """Narkowicz ACES: clamp((c*(a*c+b)) / (e + c*(c*c+d)), 0, 1) with the
    reference's constant order (denominator e + c*(2.43*c + 0.59))."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.4
    num = hadamard(color, Vec3(color.x * a + b, color.y * a + b,
                               color.z * a + b))
    inner = hadamard(color, Vec3(color.x * c + d, color.y * c + d,
                                 color.z * c + d))
    den = Vec3(e + inner.x, e + inner.y, e + inner.z)
    return clamp(hadamard_div(num, den), 0.0, 1.0)


def bgra_pack(color: Vec3) -> torch.Tensor:
    """Tonemapped radiance -> packed 32-bit BGRA, (a<<24)|(r<<16)|(g<<8)|b
    with alpha 255 and the C float->unsigned truncation. Returned as int64
    holding uint32 values (PyTorch's uint32 lacks the shift ops)."""
    r = (255.0 * linear_to_srgb(color.x)).to(torch.int64)
    g = (255.0 * linear_to_srgb(color.y)).to(torch.int64)
    b = (255.0 * linear_to_srgb(color.z)).to(torch.int64)
    return (255 << 24) | (r << 16) | (g << 8) | b
