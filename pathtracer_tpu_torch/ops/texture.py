"""The combined 4-map texture fetch (K9's plain versions), lane-parallel.

Counterpart of the combined-set functions of ``pathtracer_tpu/ops/
texture.py`` (:106-228). Reference semantics: SampleTexture
(win32_main.cpp:1680-1709) takes uv in texel units, takes abs, truncates,
clamps the fractions to [0, 1], wraps on both axes and blends bilinearly;
BespokeSampleTexture (:1675-1678) scales world-plane (u, v) by size/2.

One fetch reads the four bilinear corners of two packed words each (A =
albedo.rgb | metalness << 24, B = normal.rgb | roughness << 24;
``scene/schema.py``) and blends all eight channels with SampleTexture's
float32 expression. :func:`bespoke_sample_combined` and
:func:`bespoke_sample_combined_mip` read the flat word arrays, as JAX's
XLA render loops do. :func:`tile_corners` computes the addresses the CUDA
kernel reads instead: per corner, the ``tex_tile`` row and the lane
offset of the texel's A word (B is the next word), so one aligned 8-byte
load fetches both. The JAX kernel's distinct-tile iteration is a TPU
shape (no per-lane gather there) and has no counterpart here.

Hazards kept from JAX: ``u * (w * 0.5)`` with the constant folded in double
and rounded once; truncation toward zero; the fraction clipped to [0, 1];
the wrap is ``%`` at level 0 and ``& (w - 1)`` at mip levels, both
non-negative.
"""

from __future__ import annotations

import torch

from ..scene.schema import Scene
from ..utils.vec import Vec3

_INV255 = 1.0 / 255.0


def _unpack4(word: torch.Tensor):
    """Packed RGBX8 int32 -> (r, g, b, x) floats; & 0xFF drops the sign
    bits the >> 24 shift extends."""
    r = (word & 0xFF).to(torch.float32) * _INV255
    g = ((word >> 8) & 0xFF).to(torch.float32) * _INV255
    b = ((word >> 16) & 0xFF).to(torch.float32) * _INV255
    x = ((word >> 24) & 0xFF).to(torch.float32) * _INV255
    return r, g, b, x


def _fractions(u: torch.Tensor, v: torch.Tensor):
    """abs'd texel coordinates -> (x1, y1, s, t)."""
    x1 = u.to(torch.int32)
    y1 = v.to(torch.int32)
    s = torch.clamp(u - x1.to(u.dtype), 0.0, 1.0)
    t = torch.clamp(v - y1.to(v.dtype), 0.0, 1.0)
    return x1, y1, s, t


def _combined_coords(scene: Scene, u: torch.Tensor, v: torch.Tensor):
    """Bespoke-scale uv -> level-0 corner coordinates and fractions."""
    w, h = scene.tex_comb_w, scene.tex_comb_h
    x1, y1, s, t = _fractions(torch.abs(u * (w * 0.5)),
                              torch.abs(v * (h * 0.5)))
    x1 = x1 % w
    x2 = (x1 + 1) % w
    y1 = y1 % h
    y2 = (y1 + 1) % h
    return x1, y1, x2, y2, s, t


def _mip_select(scene: Scene, lod: torch.Tensor):
    """Per-lane (row_off, tiles_x, word_off, w, h) of each lane's level."""
    rows = scene.tex_mip.to(lod.device)[lod.long()]
    return tuple(rows[:, j] for j in range(5))


def _combined_coords_mip(scene: Scene, u: torch.Tensor, v: torch.Tensor,
                         lod: torch.Tensor):
    """:func:`_combined_coords` at each lane's pyramid level (pow2 sizes,
    so the wrap is a mask); the bespoke scale uses the level's size."""
    row_off, tiles_x, word_off, w, h = _mip_select(scene, lod)
    x1, y1, s, t = _fractions(torch.abs(u * (w.to(u.dtype) * 0.5)),
                              torch.abs(v * (h.to(v.dtype) * 0.5)))
    wm, hm = w - 1, h - 1
    x1 = x1 & wm
    x2 = (x1 + 1) & wm
    y1 = y1 & hm
    y2 = (y1 + 1) & hm
    return x1, y1, x2, y2, s, t, row_off, tiles_x, word_off, w


def _blend_combined(wa, wb, s, t):
    """Bilinear blend of the four corners' A and B words -> (albedo Vec3,
    metalness, roughness, normal Vec3), SampleTexture's expression."""

    def bilerp(c11, c12, c21, c22):
        top = (1 - s) * c11 + s * c12
        bot = (1 - s) * c21 + s * c22
        return (1 - t) * top + t * bot

    def blend4(ws):
        ch = [_unpack4(w_) for w_ in ws]
        return tuple(bilerp(ch[0][i], ch[1][i], ch[2][i], ch[3][i])
                     for i in range(4))

    ar, ag, ab, met = blend4(wa)
    nr, ng, nb, rgh = blend4(wb)
    return Vec3(ar, ag, ab), met, rgh, Vec3(nr, ng, nb)


def _flat_corners(plane, word_off, w, x1, y1, x2, y2):
    base = word_off + y1 * w
    base2 = word_off + y2 * w
    return (plane[(base + x1).long()], plane[(base + x2).long()],
            plane[(base2 + x1).long()], plane[(base2 + x2).long()])


def bespoke_sample_combined(scene: Scene, u: torch.Tensor, v: torch.Tensor):
    """The fused bespoke fetch of the combined set at level 0 from the flat
    words: (albedo Vec3, metalness, roughness, normal Vec3)."""
    x1, y1, x2, y2, s, t = _combined_coords(scene, u, v)
    w = scene.tex_comb_w
    return _blend_combined(
        _flat_corners(scene.tex_comb_a, 0, w, x1, y1, x2, y2),
        _flat_corners(scene.tex_comb_b, 0, w, x1, y1, x2, y2), s, t)


def bespoke_sample_combined_mip(scene: Scene, u: torch.Tensor,
                                v: torch.Tensor, lod: torch.Tensor):
    """The same fetch at each lane's mip level ``lod`` (level 0 leads the
    flat words, so lod 0 reads the level-0 words)."""
    x1, y1, x2, y2, s, t, _, _, word_off, w = \
        _combined_coords_mip(scene, u, v, lod)
    return _blend_combined(
        _flat_corners(scene.tex_comb_a, word_off, w, x1, y1, x2, y2),
        _flat_corners(scene.tex_comb_b, word_off, w, x1, y1, x2, y2), s, t)


def tile_corners(scene: Scene, u: torch.Tensor, v: torch.Tensor, lod=None):
    """The kernel's addressing over ``tex_tile``: for the corners (y1, x1),
    (y1, x2), (y2, x1), (y2, x2), the tile row ``row_off + (y >> 3) *
    tiles_x + (x >> 3)`` and the lane offset ``((y & 7) * 8 + (x & 7)) *
    2`` of the texel's A word; then the fractions s, t."""
    if lod is None:
        x1, y1, x2, y2, s, t = _combined_coords(scene, u, v)
        row_off, tiles_x = 0, scene.tex_tiles_x
    else:
        x1, y1, x2, y2, s, t, row_off, tiles_x, _, _ = \
            _combined_coords_mip(scene, u, v, lod)
    corners = []
    for y, x in ((y1, x1), (y1, x2), (y2, x1), (y2, x2)):
        corners.append((row_off + (y >> 3) * tiles_x + (x >> 3),
                        ((y & 7) * 8 + (x & 7)) * 2))
    return corners, s, t


def tile_words(scene: Scene, corners):
    """The (A words, B words) of each corner from ``tex_tile``."""
    flat = scene.tex_tile.reshape(-1)
    idx = [(row * 128 + off).long() for row, off in corners]
    return tuple(flat[i] for i in idx), tuple(flat[i + 1] for i in idx)
