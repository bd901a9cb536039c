"""BSDF terms: Schlick-metal Fresnel, Hammon masking-shadowing, the
specular factor whose GGX D cancels against its sampling PDF, and Snell
refraction for the dielectric lobe. Counterpart of
``pathtracer_tpu/ops/shade.py`` (win32_main.cpp:1610-1661, 1752-1786).
"""

from __future__ import annotations

import torch

from ..scene.schema import MIN_ROUGHNESS
from ..utils.vec import Vec3, cross, dot, lerp, normalize
from .sampling import PI, burley_alpha2


def effectively_smooth(roughness: torch.Tensor) -> torch.Tensor:
    return roughness < MIN_ROUGHNESS


def schlick_metal(F0: torch.Tensor, cos_theta: torch.Tensor,
                  metalness: torch.Tensor, surface_color: Vec3) -> Vec3:
    """F0 lerped toward the metal color by metalness, then
    F0 + (1-cos)^5 (1-F0) per channel, the fifth power as multiplies."""
    vF0 = lerp(Vec3(F0, F0, F0), surface_color, metalness)
    m = 1.0 - cos_theta
    m2 = m * m
    p = m2 * m2 * m
    return Vec3(vF0.x + p * (1.0 - vF0.x), vF0.y + p * (1.0 - vF0.y),
                vF0.z + p * (1.0 - vF0.z))


def ggx_d(N: Vec3, H: Vec3, roughness: torch.Tensor) -> torch.Tensor:
    """Trowbridge-Reitz D with a2 = r^4; 1 where the denominator vanishes."""
    a2 = burley_alpha2(roughness)
    ndoth = dot(N, H)
    denom = 1.0 + ndoth * ndoth * (a2 - 1.0)
    denom = PI * denom * denom
    zero = denom == 0.0
    return torch.where(zero, 1.0, a2 / torch.where(zero, 1.0, denom))


def hammon_masking_shadowing(N: Vec3, L: Vec3, V: Vec3,
                             roughness: torch.Tensor) -> torch.Tensor:
    """Hammon's Smith-joint approximation; assumes N.L, N.V > 0."""
    a2 = burley_alpha2(roughness)
    ndotv = dot(N, V)
    ndotl = dot(N, L)
    num = 2.0 * ndotl * ndotv
    den = (ndotv * torch.sqrt(a2 + (1.0 - a2) * ndotl * ndotl)
           + ndotl * torch.sqrt(a2 + (1.0 - a2) * ndotv * ndotv))
    return num / torch.where(den == 0.0, 1.0, den)


def brdf_specular_scalar(N: Vec3, L: Vec3, V: Vec3, H: Vec3,
                         roughness: torch.Tensor) -> torch.Tensor:
    """Hammon * |H.L| / (|N.L| |H.N|); multiply into ks per channel."""
    g = hammon_masking_shadowing(N, L, V, roughness)
    denom = torch.abs(dot(N, L)) * torch.abs(dot(H, N))
    return g * torch.abs(dot(H, L)) / torch.where(denom == 0.0, 1.0, denom)


def find_refraction_direction(ray_dir: Vec3, N: Vec3, nglass: torch.Tensor):
    """Snell refraction with total-internal-reflection detection
    (win32_main.cpp:1628-1661), trig-free as in JAX: (dir, refracted). The
    air side's index is 1.008."""
    nair = 1.008
    into = dot(N, ray_dir) < 0.0
    n1 = torch.where(into, nair, nglass)
    n2 = torch.where(into, nglass, nair)
    Nf = Vec3(torch.where(into, -N.x, N.x), torch.where(into, -N.y, N.y),
              torch.where(into, -N.z, N.z))
    cos1 = torch.clamp(dot(Nf, ray_dir), -1.0, 1.0)
    sin1 = torch.sqrt(torch.clamp_min(1.0 - cos1 * cos1, 0.0))
    lhs = n1 / n2 * sin1
    ok = lhs <= 1.0
    lhs_c = torch.clamp(lhs, 0.0, 1.0)
    cos2 = torch.sqrt(torch.clamp_min(1.0 - lhs_c * lhs_c, 0.0))
    M = normalize(cross(Nf, cross(ray_dir, Nf)), eps=1e-30)
    return Vec3(cos2 * Nf.x + lhs * M.x, cos2 * Nf.y + lhs * M.y,
                cos2 * Nf.z + lhs * M.z), ok
