"""BMP (bottom-up 32-bit DIB) writer/reader, byte-identical to the reference.

A verbatim copy of pathtracer_tpu/io/bmp.py (pure numpy; it takes any
array-like, a CPU tensor included).

WriteDIBImage (win32_main.cpp:358-391) writes a packed 58-byte header
(bitmap_header_t, ray.hpp:5-28: 14-byte file header + 40-byte info header +
4 trailing bytes that are part of the struct but ignored because
BitmapOffset covers them) followed by the raw uint32 BGRA framebuffer.
With a positive Height the file is a bottom-up DIB: the first stored row is
displayed at the bottom.
"""

from __future__ import annotations

import struct

import numpy as np

_HEADER_FMT = "<HIHHIIiiHHIIiiII4B"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert _HEADER_SIZE == 58


def write_bmp(path: str, packed: np.ndarray) -> None:
    """Write a (H, W) uint32 BGRA framebuffer as the reference's BMP layout."""
    packed = np.asarray(packed, np.uint32)
    h, w = packed.shape
    pixel_bytes = packed.astype("<u4").tobytes()
    header = struct.pack(
        _HEADER_FMT,
        0x4D42,                      # 'BM'
        _HEADER_SIZE + len(pixel_bytes),
        0, 0,
        _HEADER_SIZE,                # BitmapOffset
        40,                          # info header size
        w, h,                        # positive height => bottom-up DIB
        1, 32,                       # planes, bpp
        0, 0,                        # compression, image size
        0, 0,                        # x/y pels per meter
        0, 0,                        # clr used/important
        0, 0, 0, 0,                  # trailing struct bytes
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(pixel_bytes)


def read_bmp(path: str) -> np.ndarray:
    """Read a BMP written by :func:`write_bmp` back to (H, W) uint32."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, _fsize, _r1, _r2, offset, hsize, w, h, _planes, bpp,
     *_rest) = struct.unpack_from(_HEADER_FMT, data, 0)
    if magic != 0x4D42 or bpp != 32:
        raise ValueError(f"unsupported BMP: magic={magic:#x} bpp={bpp}")
    px = np.frombuffer(data, dtype="<u4", offset=offset, count=w * abs(h))
    return px.reshape(abs(h), w).copy()


def packed_to_rgb(packed: np.ndarray) -> np.ndarray:
    """(H, W) uint32 BGRA -> (H, W, 3) uint8 RGB (for PNG export / compare)."""
    p = np.asarray(packed, np.uint32)
    r = (p >> 16) & 0xFF
    g = (p >> 8) & 0xFF
    b = p & 0xFF
    return np.stack([r, g, b], axis=-1).astype(np.uint8)
