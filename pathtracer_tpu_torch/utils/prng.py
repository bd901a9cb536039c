"""Counter-based PCG4D random streams, bit-equal to ``pathtracer_tpu/utils/prng.py``.

Every random number is a pure function of
``(seed, pixel, sample, stream_tag, bounce, slot)``, so the port draws the
very numbers the JAX package draws, on any device and any batch shape. There
is no ``torch.Generator`` anywhere in the port.

The JAX code works in uint32 with wraparound. PyTorch's uint32 support is
partial, so the words live in int64 tensors holding values in [0, 2^32) and
every multiply and add is masked back to 32 bits. An int64 product of two
such words can wrap past 2^63, which leaves its low 32 bits intact.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TAG_JITTER = 0x0100_0000
TAG_LENS = 0x0200_0000
TAG_BOUNCE = 0x0400_0000

BOUNCE_SLOTS = 8

_M32 = 0xFFFF_FFFF
_U24 = 0xFF_FFFF
_INV_U24 = 1.0 / (1 << 24)


class PathStream(NamedTuple):
    """Per-path RNG identity: (seed, pixel, sample) as int64 tensors holding
    uint32 values."""
    seed: torch.Tensor
    pixel: torch.Tensor
    sample: torch.Tensor


def _pcg4d(a, b, c, d):
    """PCG4D mix: 4 x uint32 in -> 4 x uint32 out (JCGT 2020, listing 6)."""
    mul, inc = 1664525, 1013904223
    a = (a * mul + inc) & _M32
    b = (b * mul + inc) & _M32
    c = (c * mul + inc) & _M32
    d = (d * mul + inc) & _M32
    a = (a + ((b * d) & _M32)) & _M32
    b = (b + ((c * a) & _M32)) & _M32
    c = (c + ((a * b) & _M32)) & _M32
    d = (d + ((b * c) & _M32)) & _M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + ((b * d) & _M32)) & _M32
    b = (b + ((c * a) & _M32)) & _M32
    c = (c + ((a * b) & _M32)) & _M32
    d = (d + ((b * c) & _M32)) & _M32
    return a, b, c, d


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 uniform in [0, 1) from its top 24 bits (exact)."""
    return ((x >> 8) & _U24).to(torch.float32) * _INV_U24


def _draw4(stream: PathStream, tag) -> tuple:
    tag = torch.as_tensor(tag, dtype=torch.int64,
                          device=stream.pixel.device) & _M32
    a, b, c, d = _pcg4d(stream.seed, stream.pixel, stream.sample,
                        tag.expand_as(stream.pixel))
    return _to_unit(a), _to_unit(b), _to_unit(c), _to_unit(d)


def path_keys(key: int, pixel_idx: torch.Tensor, sample_idx) -> PathStream:
    """Path identities for a batch of pixel indices and sample indices
    (a tensor of the same shape, or one Python int)."""
    pixel = pixel_idx.to(torch.int64) & _M32
    sample = (torch.as_tensor(sample_idx, device=pixel.device)
              .to(torch.int64).expand_as(pixel)) & _M32
    seed = torch.full_like(pixel, int(key) & _M32)
    return PathStream(seed, pixel, sample)


def jitter_uniforms(stream: PathStream):
    """Two uniforms for the stratified sub-pixel jitter."""
    a, b, _, _ = _draw4(stream, TAG_JITTER)
    return a, b


def lens_uniforms(stream: PathStream):
    """Two uniforms for the thin-lens sensor offset. The caller keys the
    stream on the ray index ``s // pp``, not on the sample index."""
    a, b, _, _ = _draw4(stream, TAG_LENS)
    return a, b


def bounce_uniforms(stream: PathStream, bounce):
    """BOUNCE_SLOTS uniforms for one bounce (two PCG4D blocks). ``bounce``
    is an int or a per-lane integer tensor."""
    if isinstance(bounce, torch.Tensor):
        base = (TAG_BOUNCE + bounce.to(torch.int64) * 2) & _M32
    else:
        base = (TAG_BOUNCE + int(bounce) * 2) & _M32
    a0, a1, a2, a3 = _draw4(stream, base)
    b0, b1, b2, b3 = _draw4(stream, base + 1)
    return a0, a1, a2, a3, b0, b1, b2, b3


def normal_from_uniforms(u1, u2, stddev=1.0):
    """A Gaussian sample from two counter uniforms by Box-Muller (the
    RandomNormal role, ray_math.hpp:278-296; on no render path). ``u1`` is
    clamped away from 0, where the log is -inf."""
    u1 = torch.clamp_min(u1, 1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(u1))
    return stddev * r * torch.cos((2.0 * math.pi) * u2)
