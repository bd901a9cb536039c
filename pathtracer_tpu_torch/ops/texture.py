"""Texture fetches (the plain versions of K9, of K10's texel and planar
forms and of K11), lane-parallel.

Counterpart of the combined-set functions of ``pathtracer_tpu/ops/
texture.py`` (:106-228), of ``sample_texture`` (:52-96), the mesh-UV
fetch from the flat per-layer stack (K10's texel form: the CUDA kernel
reads the same words with four int32 loads; the JAX kernel's tiled stack
and windowed iteration are TPU shapes), of ``bespoke_sample`` (:99-103,
K10's planar form: material maps at the hit's world xy) and of the bump
map's three height samples (:461-489, K11). Reference semantics: SampleTexture
(win32_main.cpp:1680-1709) takes uv in texel units, takes abs, truncates,
clamps the fractions to [0, 1], wraps on both axes and blends bilinearly;
BespokeSampleTexture (:1675-1678) scales world-plane (u, v) by size/2.

One fetch reads the four bilinear corners of two packed words each (A =
albedo.rgb | metalness << 24, B = normal.rgb | roughness << 24;
``scene/schema.py``) and blends all eight channels with SampleTexture's
float32 expression. :func:`bespoke_sample_combined` and
:func:`bespoke_sample_combined_mip` read the flat word arrays, as JAX's
XLA render loops do. The JAX kernel's distinct-tile iteration is a TPU
shape (no per-lane gather there) and has no counterpart here.

K9 as the CUDA kernel reads it (:func:`combined_at`, :func:`combined_words`,
:func:`combined_channel`, :func:`combined_albedo`): an address step, the
corners' (A, B) word pairs from ``tex_tile`` (A at the even word, B next,
so one aligned 8-byte load fetches both) and one blend per channel, so
that the shade blends only the channels a lane reads and the dielectric
loads only the A words; its level-0 wraps by the sizes' reciprocals (a
mask for a power of two), no ``%``; bit-equal to
:func:`bespoke_sample_combined` and :func:`bespoke_sample_combined_mip`.

K10 and K11 as the CUDA kernel reads them (:func:`planar_at`,
:func:`planar_sample`, :func:`planar_maps`; the texel form
:func:`planar_texel_sample`; the bump heights :func:`planar_height3`): the
same texels from the planar table (``schema.planar_tables``: each layer at
its own size in 8x8-texel tiles, :func:`planar_word`), wrapped by a mask or
by the size's reciprocal (:func:`wrap_recip`), a lane's maps of one size
at one address; bit-equal to :func:`bespoke_sample`, :func:`sample_texture`
and :func:`bespoke_height3`, which the plain version renders with.

Hazards kept from JAX: ``u * (w * 0.5)`` with the constant folded in double
and rounded once; truncation toward zero; the fraction clipped to [0, 1];
the wrap is ``%`` at level 0 and ``& (w - 1)`` at mip levels, both
non-negative.
"""

from __future__ import annotations

import torch

from ..scene.schema import Scene, planar_recip
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


# --- K10's texel form: the flat per-layer stack ----------------------------

_I32_LIMIT = 2.0 ** 31


def _to_i32_saturating(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 toward zero, saturating, NaN -> 0: XLA's convert and
    CUDA's __float2int_rz (a bare .to(int32) is undefined out of range)."""
    i = torch.where((x > -_I32_LIMIT) & (x < _I32_LIMIT), x, 0.0)
    i = i.to(torch.int32)
    i = torch.where(x >= _I32_LIMIT, 2 ** 31 - 1, i)
    return torch.where(x <= -_I32_LIMIT, -2 ** 31, i)


def _unpack(word: torch.Tensor) -> Vec3:
    """Packed RGB8 int32 -> float Vec3 (texture.py:43-49 in JAX)."""
    r, g, b, _ = _unpack4(word)
    return Vec3(r, g, b)


def _bilerp(a, b, c, d, s, t):
    """SampleTexture's blend of one channel's four corners."""
    top = (1 - s) * a + s * b
    bot = (1 - s) * c + s * d
    return (1 - t) * top + t * bot


def _bilerp_vec3(c11: Vec3, c12: Vec3, c21: Vec3, c22: Vec3, s, t) -> Vec3:
    """SampleTexture's blend of four Vec3 corners (texture.py:78-96)."""
    return Vec3(*(_bilerp(*ch, s, t) for ch in zip(c11, c12, c21, c22)))


def sample_texture(scene: Scene, layer: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> Vec3:
    """SampleTexture over the flat stack (texture.py:52-75 in JAX): the
    0-based ``layer`` and texel-space (u, v) per lane; abs, truncation,
    fractions clipped to [0, 1], wrap by ``%`` of the layer's size, texel
    ``(layer*hmax + y)*wmax + x``, bilinear blend."""
    layer = layer.long()
    w = scene.tex_w[layer]
    h = scene.tex_h[layer]
    u = torch.abs(u)
    v = torch.abs(v)
    x1 = _to_i32_saturating(u)
    y1 = _to_i32_saturating(v)
    s = torch.clamp(u - x1.to(u.dtype), 0.0, 1.0)
    t = torch.clamp(v - y1.to(v.dtype), 0.0, 1.0)
    x1 = x1 % w
    x2 = (x1 + 1) % w
    y1 = y1 % h
    y2 = (y1 + 1) % h
    base = layer * (scene.tex_hmax * scene.tex_wmax)

    def fetch(yy, xx):
        return _unpack(scene.tex_packed[base + yy.long() * scene.tex_wmax
                                        + xx.long()])

    return _bilerp_vec3(fetch(y1, x1), fetch(y1, x2), fetch(y2, x1),
                        fetch(y2, x2), s, t)


def bespoke_sample(scene: Scene, layer: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> Vec3:
    """BespokeSampleTexture (texture.py:99-103 in JAX): world-plane (u, v)
    scaled by the layer's size/2 as ``u * w * 0.5``, then
    :func:`sample_texture`."""
    w = scene.tex_w[layer.long()].to(u.dtype)
    h = scene.tex_h[layer.long()].to(v.dtype)
    return sample_texture(scene, layer, u * w * 0.5, v * h * 0.5)


BUMP_EPS = 0.01  # the bump map's forward-difference step, world units


def bespoke_height3(scene: Scene, layer: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor):
    """The bump map's heights (h0, hx, hy): the red channel of
    :func:`bespoke_sample` at (x, y), (x + 0.01, y) and (x, y + 0.01), which
    JAX's fused fetch (texture.py:461-489) equals bit for bit."""
    return (bespoke_sample(scene, layer, x, y).x,
            bespoke_sample(scene, layer, x + BUMP_EPS, y).x,
            bespoke_sample(scene, layer, x, y + BUMP_EPS).x)


# --- K10's planar form as the CUDA kernel reads it -------------------------

def wrap_recip(x: torch.Tensor, n: torch.Tensor, m: torch.Tensor):
    """The kernel's ``wrap_mod`` on int64 tensors: ``x % n`` of a
    non-negative int32 ``x``, by a mask where ``m`` is 0 (``n`` a power of
    two), else from n's reciprocal ``m`` (``schema.planar_recip``) with one
    conditional subtract, no division."""
    r = x - ((x * m) >> 32) * n
    r = torch.where(r >= n, r - n, r)
    return torch.where(m == 0, x & (n - 1), r)


def planar_word(tiles_x, y, x):
    """Texel (y, x)'s word within its layer's 8x8 tiles (row-major tiles,
    ``tiles_x`` of them a row; ``schema.planar_tables``)."""
    return (y >> 3) * tiles_x * 64 + (y & 7) * 8 + (x >> 3) * 64 + (x & 7)


def planar_meta(scene: Scene, layer: torch.Tensor):
    """Per lane the planar table's words of its 0-based ``layer``: (word
    offset of its tiles, tiles_x, w, h, mw, mh) as int64 and (w, h) as
    float32."""
    meta = scene.planar_meta[layer.long()]
    f = meta[:, 6:8].contiguous().view(torch.float32)
    m = meta[:, :6].long()
    m[:, 4:6] &= 0xFFFF_FFFF
    return (m[:, 0] * 64, *(m[:, j] for j in range(1, 6)), f[:, 0], f[:, 1])


def _planar_axis(c: torch.Tensor, n: torch.Tensor, m: torch.Tensor):
    """One axis of the kernel's address at a texel-space coordinate ``c``
    (>= 0 or NaN) on a layer of size ``n`` with wrap constant ``m``: the
    truncation (saturating, NaN -> 0), the fraction clipped to [0, 1] and
    the two wrapped texels (x1, x1 + 1 or 0 at n)."""
    ci = _to_i32_saturating(c)
    f = torch.clamp(c - ci.to(c.dtype), 0.0, 1.0)
    c1 = wrap_recip(ci.long(), n, m)
    return c1, torch.where(c1 + 1 == n, 0, c1 + 1), f


def planar_corners(scene: Scene, layer: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor):
    """The kernel's ``planar_corners``: the address at texel-space (u, v)
    (both >= 0, or NaN) on each lane's layer, the four corners' words
    within the layer's tiles ((y1, x1), (y1, x2), (y2, x1), (y2, x2):
    ``(y >> 3) * tiles_x * 64 + (y & 7) * 8 + (x >> 3) * 64 + (x & 7)``),
    then s, t."""
    _, tiles_x, w, h, mw, mh, _, _ = planar_meta(scene, layer)
    x1, x2, s = _planar_axis(u, w, mw)
    y1, y2, t = _planar_axis(v, h, mh)
    return [planar_word(tiles_x, yy, xx)
            for yy, xx in ((y1, x1), (y1, x2), (y2, x1), (y2, x2))], s, t


def planar_at(scene: Scene, layer: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor):
    """The kernel's ``planar_at``: :func:`planar_corners` at
    BespokeSampleTexture's coordinates of the world (x, y), ``|x * w *
    0.5|`` and ``|y * h * 0.5|``."""
    wf, hf = planar_meta(scene, layer)[6:8]
    return planar_corners(scene, layer, torch.abs(x * wf * 0.5),
                          torch.abs(y * hf * 0.5))


def planar_texel(scene: Scene, layer: torch.Tensor, at) -> Vec3:
    """The kernel's ``planar_texel``: the blend of each lane's layer at the
    address ``at`` (:func:`planar_at`'s corners, s, t)."""
    corners, s, t = at
    base = planar_meta(scene, layer)[0]
    words = [_unpack(scene.planar_tile[base + c]) for c in corners]
    return _bilerp_vec3(*words, s, t)


def planar_sample(scene: Scene, layer: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> Vec3:
    """The kernel's ``fetch_planar``: :func:`bespoke_sample` read from the
    planar table, bit-equal to it."""
    return planar_texel(scene, layer, planar_at(scene, layer, x, y))


def planar_texel_sample(scene: Scene, layer: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor) -> Vec3:
    """The kernel's ``fetch_texel`` (K10's texel form): :func:`sample_texture`
    at texel-space (u, v) read from the planar table, bit-equal to it."""
    return planar_texel(scene, layer, planar_corners(
        scene, layer, torch.abs(u), torch.abs(v)))


def planar_height3(scene: Scene, layer: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor):
    """The kernel's ``fetch_height3`` (K11): :func:`bespoke_height3` read
    from the planar table, bit-equal to it. The heights at (x, y) and (x +
    0.01, y) share their row and those at (x, y) and (x, y + 0.01) their
    column, so two column and two row wraps address all 12 corners."""
    base, tiles_x, w, h, mw, mh, wf, hf = planar_meta(scene, layer)

    def column(px):
        x1, x2, s = _planar_axis(torch.abs(px * wf * 0.5), w, mw)
        return (x1 >> 3) * 64 + (x1 & 7), (x2 >> 3) * 64 + (x2 & 7), s

    def row(py):
        y1, y2, t = _planar_axis(torch.abs(py * hf * 0.5), h, mh)
        return ((y1 >> 3) * tiles_x * 64 + (y1 & 7) * 8,
                (y2 >> 3) * tiles_x * 64 + (y2 & 7) * 8, t)

    def red(c, r):
        k1, k2, s = c
        r1, r2, t = r
        return _bilerp(*(_unpack(scene.planar_tile[base + rr + kk]).x
                         for rr, kk in ((r1, k1), (r1, k2), (r2, k1),
                                        (r2, k2))), s, t)

    c0, r0 = column(x), row(y)
    return (red(c0, r0), red(column(x + BUMP_EPS), r0),
            red(c0, row(y + BUMP_EPS)))


def planar_maps(scene: Scene, layers, x: torch.Tensor, y: torch.Tensor):
    """The kernel's ``planar_maps``: several maps per lane at one world
    point (``layers``: 0-based layer tensors, -1 where a lane has no such
    map), each reusing the last address computed where its size equals
    that address's. Returns the texels (zero where a lane has no map) and
    the count of addresses each lane computed."""
    n = x.shape[0]
    aw = torch.zeros(n, dtype=torch.int64)
    ah = torch.zeros(n, dtype=torch.int64)
    at, computed, out = None, torch.zeros(n, dtype=torch.int64), []
    for layer in layers:
        has = layer >= 0
        lay = torch.clamp_min(layer, 0)
        _, _, w, h, _, _, _, _ = planar_meta(scene, lay)
        fresh_at = planar_at(scene, lay, x, y)
        fresh = has & ((w != aw) | (h != ah))
        if at is None:
            at = fresh_at
        else:
            at = ([torch.where(fresh, a, b) for a, b in zip(fresh_at[0], at[0])],
                  *(torch.where(fresh, a, b) for a, b in zip(fresh_at[1:],
                                                             at[1:])))
        aw, ah = torch.where(fresh, w, aw), torch.where(fresh, h, ah)
        computed += fresh.long()
        tex = planar_texel(scene, lay, at)
        out.append(Vec3(*(torch.where(has, c, 0.0) for c in tex)))
    return out, computed


# --- K9 as the CUDA kernel reads it: the address step and the blends -------

def combined_at(scene: Scene, u: torch.Tensor, v: torch.Tensor, lod=None):
    """The kernel's ``combined_at``: the address at world (u, v) at level 0,
    or at each lane's pyramid level ``lod``. Returns, for the corners (y1,
    x1), (y1, x2), (y2, x1), (y2, x2), the index of each texel's (A, B)
    word pair in ``tex_tile`` (``(row_off + (y >> 3) * tiles_x) * 64 + (y &
    7) * 8 + (x >> 3) * 64 + (x & 7)``), then s, t. Level 0 wraps by the
    sizes' ``planar_recip`` (:func:`wrap_recip`: a mask for a power of two,
    else the reciprocal, no division), a mip level by its mask; x2 = x1 + 1
    or 0 at w."""
    shape = u.shape
    if lod is None:
        w, h = scene.tex_comb_w, scene.tex_comb_h
        uu, vv = torch.abs(u * (w * 0.5)), torch.abs(v * (h * 0.5))
        row_off, tiles_x = 0, scene.tex_tiles_x
        full = lambda x: torch.full(shape, x, dtype=torch.int64,  # noqa: E731
                                    device=u.device)
        w, h, mw, mh = (full(w), full(h), full(planar_recip(w)),
                        full(planar_recip(h)))
    else:
        row_off, tiles_x, _, w, h = (c.long() for c in _mip_select(scene, lod))
        uu = torch.abs(u * (w.to(u.dtype) * 0.5))
        vv = torch.abs(v * (h.to(v.dtype) * 0.5))
        mw = mh = torch.zeros_like(w)
    x1, x2, s = _planar_axis(uu, w, mw)
    y1, y2, t = _planar_axis(vv, h, mh)

    def pair(y, x):
        return ((row_off + (y >> 3) * tiles_x) * 64 + (y & 7) * 8
                + (x >> 3) * 64 + (x & 7))

    return [pair(y, x) for y, x in ((y1, x1), (y1, x2), (y2, x1), (y2, x2))], s, t


def combined_words(scene: Scene, at):
    """The (A words, B words) of :func:`combined_at`'s corners: the kernel's
    four 8-byte loads from ``tex_tile`` (A at the even word, B next)."""
    flat = scene.tex_tile.reshape(-1)
    corners = at[0]
    return (tuple(flat[2 * c] for c in corners),
            tuple(flat[2 * c + 1] for c in corners))


def combined_channel(words, s, t, shift: int):
    """One channel's blend (the kernel's ``combined_ch``): the byte at
    ``shift`` of the four corners' A words (albedo R, G, B at 0, 8, 16,
    metalness at 24) or B words (normal R, G, B, roughness), unpacked and
    blended with SampleTexture's expression."""
    return _bilerp(*(((w >> shift) & 0xFF).to(torch.float32) * _INV255
                     for w in words), s, t)


def combined_albedo(scene: Scene, at) -> Vec3:
    """The kernel's ``combined_albedo``: the three albedo channels from the
    A words alone (the dielectric's fetch)."""
    flat = scene.tex_tile.reshape(-1)
    corners, s, t = at
    wa = tuple(flat[2 * c] for c in corners)
    return Vec3(*(combined_channel(wa, s, t, k) for k in (0, 8, 16)))


def combined_split(scene: Scene, u: torch.Tensor, v: torch.Tensor, lod=None):
    """The fetch as the kernel's opaque shade forms it, every channel from
    one address and its words: (albedo Vec3, metalness, roughness, normal
    Vec3), :func:`bespoke_sample_combined`'s (or its mip form's) order."""
    at = combined_at(scene, u, v, lod)
    wa, wb = combined_words(scene, at)
    _, s, t = at
    return (Vec3(*(combined_channel(wa, s, t, k) for k in (0, 8, 16))),
            combined_channel(wa, s, t, 24), combined_channel(wb, s, t, 24),
            Vec3(*(combined_channel(wb, s, t, k) for k in (0, 8, 16))))
