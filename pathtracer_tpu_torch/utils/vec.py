"""Structure-of-arrays 3-vector math over (N,) torch tensors.

Counterpart of ``pathtracer_tpu/utils/vec.py``: a ``Vec3`` holds three
same-shaped component tensors, and every op is elementwise over the batch.
Each expression keeps the JAX source's evaluation order (a dot product is
``(x*x' + y*y') + z*z'``), so that the port rounds where the reference
rounds.

Division by a Python number goes through :func:`sdiv`: PyTorch's CUDA
``div`` multiplies by the reciprocal when the divisor is a host scalar,
which is not the IEEE quotient the reference and the kernel compute. A
Python number over a tensor goes through :func:`rdiv` for the same reason.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]


class Vec3(NamedTuple):
    """A batch of 3-vectors stored as three component tensors (SoA)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, other: "Vec3") -> "Vec3":  # type: ignore[override]
        return Vec3(self.x + other.x, self.y + other.y, self.z + other.z)

    def __sub__(self, other: "Vec3") -> "Vec3":
        return Vec3(self.x - other.x, self.y - other.y, self.z - other.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s: Scalar) -> "Vec3":  # type: ignore[override]
        """Scalar (or broadcastable tensor) multiply; :func:`hadamard` is
        the elementwise vector product."""
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__


def sdiv(a: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE ``a / float32(c)`` on every device (see the module note)."""
    return a / a.new_full((), c)


def rdiv(c: float, a: torch.Tensor) -> torch.Tensor:
    """IEEE ``float32(c) / a``: PyTorch computes ``c / a`` as
    ``reciprocal(a) * c``."""
    return a.new_full((), c) / a


def splat(v, like: torch.Tensor) -> Vec3:
    """Broadcast a length-3 constant to a batch shaped like ``like``."""
    x, y, z = v
    return Vec3(torch.full_like(like, x, dtype=torch.float32),
                torch.full_like(like, y, dtype=torch.float32),
                torch.full_like(like, z, dtype=torch.float32))


def to_stacked(v: Vec3) -> torch.Tensor:
    """Vec3 -> (..., 3) stacked tensor (host I/O boundary)."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def hadamard(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.x * b.x, a.y * b.y, a.z * b.z)


def hadamard_div(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.x / b.x, a.y / b.y, a.z / b.z)


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - b.y * a.z,
        a.z * b.x - b.z * a.x,
        a.x * b.y - b.x * a.y,
    )


def magnitude_squared(a: Vec3) -> torch.Tensor:
    return a.x * a.x + a.y * a.y + a.z * a.z


def magnitude(a: Vec3) -> torch.Tensor:
    return torch.sqrt(magnitude_squared(a))


def normalize(a: Vec3, eps: float = 0.0) -> Vec3:
    """``a * (1 / max(|a|, eps))``; with ``eps == 0`` a zero vector gives
    inf/nan lanes, as in the reference."""
    m = magnitude(a)
    if eps:
        m = torch.clamp_min(m, eps)
    inv = torch.reciprocal(m)
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def lerp(a: Vec3, b: Vec3, p: Scalar) -> Vec3:
    """(1-p)*a + p*b."""
    q = 1.0 - p
    return Vec3(q * a.x + p * b.x, q * a.y + p * b.y, q * a.z + p * b.z)


def clamp(v: Vec3, lo: float, hi: float) -> Vec3:
    """Per-component ``max(lo, min(v, hi))``."""
    return Vec3(torch.clamp(v.x, lo, hi), torch.clamp(v.y, lo, hi),
                torch.clamp(v.z, lo, hi))


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    """Lane select between two Vec3 batches."""
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def gather(v: Vec3, idx: torch.Tensor) -> Vec3:
    """Index a table of vectors by an integer tensor."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])
