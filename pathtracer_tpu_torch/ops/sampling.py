"""Direction samplers, PDF evaluators and the orthonormal-basis builder.

Counterpart of ``pathtracer_tpu/ops/sampling.py`` (the reference's
RandomCosineDirectionHemisphere, RandomHalfVectorGGX, RandomToSphere,
BuildOrthonormalBasisFromW and the PdfValue family, win32_main.cpp:290-365,
2252-2353, and the Henyey-Greenstein phase function of the fog). Every
sampler takes its uniforms explicitly from the PCG4D streams. Products of
Python floats, such as ``2.0 * PI`` or the phase function's ``1 - g*g``,
are formed in double before they meet a tensor, as the JAX code folds them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.vec import (
    Vec3, cross, dot, magnitude, magnitude_squared, normalize, rdiv, sdiv,
    where,
)

PI = 3.14159265358979323846264338327


def burley_alpha2(roughness: torch.Tensor) -> torch.Tensor:
    """Disney/Burley remap: a2 = roughness^4."""
    r2 = roughness * roughness
    return r2 * r2


def cosine_hemisphere(u1: torch.Tensor, u2: torch.Tensor) -> Vec3:
    """Cosine-weighted hemisphere sample in tangent space, z >= 0."""
    phi = 2.0 * PI * u1
    sq = torch.sqrt(u2)
    return Vec3(torch.cos(phi) * sq, torch.sin(phi) * sq, torch.sqrt(1.0 - u2))


def ggx_half_vector(u1: torch.Tensor, u2: torch.Tensor,
                    roughness: torch.Tensor) -> Vec3:
    """GGX-distributed half vector in tangent space."""
    a2 = burley_alpha2(roughness)
    phi = 2.0 * PI * u1
    cos_theta = torch.sqrt((1.0 - u2) / (1.0 + u2 * (a2 - 1.0)))
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    return Vec3(torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
                cos_theta)


def to_sphere(u1, u2, sphere_center: Vec3, sphere_radius,
              origin: Vec3) -> Tuple[Vec3, torch.Tensor]:
    """Solid-angle sample toward a sphere in the frame whose +z points at
    its center. ``valid`` is False where ``origin`` is inside the sphere."""
    dist2 = magnitude_squared(origin - sphere_center)
    term1 = 1.0 - sphere_radius * sphere_radius / dist2
    valid = term1 >= 0.0
    term1c = torch.clamp_min(term1, 0.0)
    z = 1.0 + u2 * (torch.sqrt(term1c) - 1.0)
    term2 = torch.clamp_min(1.0 - z * z, 0.0)
    phi = 2.0 * PI * u1
    s = torch.sqrt(term2)
    return Vec3(torch.cos(phi) * s, torch.sin(phi) * s, z), valid


def orthonormal_basis(w: Vec3) -> Tuple[Vec3, Vec3, Vec3]:
    """(tangentX, tangentY, unit w): a = (0,1,0) if |unit_w.x| > 0.9 else
    (1,0,0); v = normalize(cross(unit_w, a)); u = cross(unit_w, v)."""
    unit_w = normalize(w)
    w_is_x = torch.abs(unit_w.x) > 0.9
    zero = torch.zeros_like(unit_w.x)
    one = torch.ones_like(unit_w.x)
    a = where(w_is_x, Vec3(zero, one, zero), Vec3(one, zero, zero))
    v = normalize(cross(unit_w, a))
    u = cross(unit_w, v)
    return u, v, unit_w


def from_tangent(t: Vec3, tx: Vec3, ty: Vec3, tz: Vec3) -> Vec3:
    """t.x*tx + t.y*ty + t.z*tz."""
    return Vec3(
        t.x * tx.x + t.y * ty.x + t.z * tz.x,
        t.x * tx.y + t.y * ty.y + t.z * tz.y,
        t.x * tx.z + t.y * ty.z + t.z * tz.z,
    )


def pdf_cosine(d: Vec3) -> torch.Tensor:
    """Cosine-hemisphere PDF of a tangent-space direction."""
    return sdiv(torch.clamp_min(d.z, 0.0), PI)


def pdf_to_sphere(hit, sphere_center: Vec3, sphere_radius,
                  origin: Vec3) -> torch.Tensor:
    """Solid-angle PDF toward a sphere; 0 where the ray misses it."""
    dist2 = magnitude_squared(origin - sphere_center)
    inner = torch.clamp_min(1.0 - sphere_radius * sphere_radius / dist2, 0.0)
    cos_theta_max = torch.sqrt(inner)
    solid_angle = 2.0 * PI * (1.0 - cos_theta_max)
    pdf = torch.where(solid_angle > 0.0,
                      torch.reciprocal(torch.clamp_min(solid_angle, 1e-30)),
                      0.0)
    return torch.where(hit, pdf, 0.0)


def pdf_quad(t, hit, d: Vec3, qu: Vec3, qv: Vec3) -> torch.Tensor:
    """Area->solid-angle PDF for a quad light: distance^2 / (cos * area),
    the reference's PdfValueQuad with its cosine divided by |N|."""
    n = cross(qu, qv)
    area = magnitude(n)
    mag = magnitude(d)
    dist2 = t * t * mag * mag
    cosine = torch.abs(dot(d, n)) / torch.clamp_min(mag * area, 1e-30)
    denom = cosine * area
    pdf = torch.where(denom > 0.0, dist2 / torch.clamp_min(denom, 1e-30), 0.0)
    return torch.where(hit, pdf, 0.0)


def sample_to_quad(u1, u2, qp: Vec3, qu: Vec3, qv: Vec3, origin: Vec3) -> Vec3:
    """Unnormalized direction from ``origin`` to qp + u1*qu + u2*qv."""
    return Vec3(
        qp.x + u1 * qu.x + u2 * qv.x - origin.x,
        qp.y + u1 * qu.y + u2 * qv.y - origin.y,
        qp.z + u1 * qu.z + u2 * qv.z - origin.z,
    )


def henyey_greenstein_sample(u1: torch.Tensor, u2: torch.Tensor,
                             g: float) -> Vec3:
    """Henyey-Greenstein sample in tangent space, +z the propagation
    direction: cos_theta = (1 + g^2 - s^2) / (2g), s = (1 - g^2) / (1 - g +
    2g*u1); for |g| < 1e-3 (chosen on the host) the isotropic 1 - 2*u1."""
    if abs(g) < 1e-3:
        cos_t = 1.0 - 2.0 * u1
    else:
        s = rdiv(1.0 - g * g, (1.0 - g) + (2.0 * g) * u1)
        cos_t = sdiv((1.0 + g * g) - s * s, 2.0 * g)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    r = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), cos_t)


def pdf_henyey_greenstein(cos_theta: torch.Tensor, g: float) -> torch.Tensor:
    """The normalised HG phase function, (1 - g^2) / (4 pi (1 + g^2 -
    2g cos_theta)^(3/2)); 1/(4 pi) for |g| < 1e-3."""
    if abs(g) < 1e-3:
        return torch.full_like(cos_theta, 1.0 / (4.0 * PI))
    denom = torch.clamp_min((1.0 + g * g) - (2.0 * g) * cos_theta, 1e-12)
    inv = torch.reciprocal(torch.sqrt(denom))
    return sdiv((1.0 - g * g) * inv * inv * inv, 4.0 * PI)


def uniform_hemisphere(u1: torch.Tensor, u2: torch.Tensor) -> Vec3:
    """Uniform hemisphere sample in tangent space, pdf 1/(2 pi): the
    reference's declared but undefined RandomDirectionHemisphere
    (win32_main.cpp:56; on no render path)."""
    z = u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)
