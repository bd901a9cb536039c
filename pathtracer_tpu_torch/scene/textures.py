"""Texture loading, mip decimation and the procedural stand-ins.

The port's own copy of ``pathtracer_tpu/scene/textures.py`` (it imports
nothing of the JAX package). The float32 expressions are the JAX module's,
line for line, so the four world-1 maps are bit-equal to JAX's:

- LoadTexture (win32_main.cpp:1726-1744): 8-bit PNG -> float RGB in [0, 1];
- GenerateMipmapChain (win32_main.cpp:2307-2328): each level is the
  parent's even texels (SampleTexture's truncation at uv = (2x, 2y));
- LoadBespokeTextures (win32_main.cpp:1711-1724): the four rusty-metal maps
  (albedo, metallic, roughness, normal-ogl).

A map whose PNG is missing (or when PIL is not installed) is replaced by a
deterministic procedural stand-in, so world 1 renders with texture-driven
shading either way. The PNGs are looked up in ``res/`` at the repository
root unless the caller names another directory.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np

REFERENCE_RES_DIR = str(Path(__file__).resolve().parents[2] / "res")

BESPOKE_FILES = [
    "rusty-metal_albedo.png",
    "rusty-metal_metallic.png",
    "rusty-metal_roughness.png",
    "rusty-metal_normal-ogl.png",
]


def load_png(path: str) -> Optional[np.ndarray]:
    """Decode an image file to (H, W, 3) float32 in [0,1]; None if missing."""
    if not os.path.exists(path):
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    return arr.astype(np.float32) / 255.0


def _value_noise(size: int, seed: int, octaves: int = 4) -> np.ndarray:
    """Deterministic tileable value noise in [0,1], (size, size) float32."""
    rng = np.random.RandomState(seed)
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        res = 4 << o
        coarse = rng.rand(res, res).astype(np.float32)
        reps = size // res
        # bilinear upsample with wraparound (tileable)
        y = (np.arange(size, dtype=np.float32) / reps) % res
        x = (np.arange(size, dtype=np.float32) / reps) % res
        y0 = np.floor(y).astype(int) % res
        x0 = np.floor(x).astype(int) % res
        y1, x1 = (y0 + 1) % res, (x0 + 1) % res
        ty, tx = (y - np.floor(y))[:, None], (x - np.floor(x))[None, :]
        top = coarse[y0][:, x0] * (1 - tx) + coarse[y0][:, x1] * tx
        bot = coarse[y1][:, x0] * (1 - tx) + coarse[y1][:, x1] * tx
        out += amp * (top * (1 - ty) + bot * ty)
        total += amp
        amp *= 0.5
    return out / total


_PROCEDURAL_SEEDS = {"albedo": 101, "metallic": 202, "roughness": 303,
                     "normal": 404}


def procedural_rusty_metal(kind: str, size: int = 512) -> np.ndarray:
    """Deterministic stand-ins for the rusty-metal maps (fixed seeds)."""
    n = _value_noise(size, seed=_PROCEDURAL_SEEDS[kind])
    if kind == "albedo":
        rust = np.stack([0.45 + 0.25 * n, 0.22 + 0.12 * n, 0.12 + 0.06 * n], -1)
        metal = np.stack([0.55 + 0.1 * n] * 3, -1)
        w = np.clip((n - 0.45) * 4.0, 0.0, 1.0)[..., None]
        return (rust * (1 - w) + metal * w).astype(np.float32)
    if kind == "metallic":
        m = np.clip((n - 0.45) * 4.0, 0.0, 1.0)
        return np.repeat(m[..., None], 3, -1).astype(np.float32)
    if kind == "roughness":
        r = np.clip(0.35 + 0.55 * n, 0.0, 1.0)
        return np.repeat(r[..., None], 3, -1).astype(np.float32)
    if kind == "normal":
        # a mostly-up normal with gentle perturbation, OpenGL convention
        gy, gx = np.gradient(n)
        nx, ny = -gx * 4.0, -gy * 4.0
        nz = np.ones_like(n)
        mag = np.sqrt(nx * nx + ny * ny + nz * nz)
        enc = np.stack([nx / mag, ny / mag, nz / mag], -1) * 0.5 + 0.5
        return enc.astype(np.float32)
    raise ValueError(kind)


def quantize8(img: np.ndarray) -> np.ndarray:
    """Snap float texels to the 8-bit grid, k * (1/255) with k =
    round(t*255), as the reference's 8-bit-sourced texels are
    (win32_main.cpp:1736-1739); the packed words then unpack exactly."""
    k = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return k.astype(np.float32) * np.float32(1.0 / 255.0)


def load_bespoke_textures(res_dir: str = REFERENCE_RES_DIR) -> List[np.ndarray]:
    """The four rusty-metal maps in reference order (albedoIdx=1,
    metalnessIdx=2, roughnessIdx=3, normalIdx=4; win32_main.cpp:1814,
    1720-1723), decimated to the smallest map's size by the mip rule so
    they form the combined 2-word set (scene/schema.py)."""
    kinds = ["albedo", "metallic", "roughness", "normal"]
    out = []
    for fname, kind in zip(BESPOKE_FILES, kinds):
        img = load_png(os.path.join(res_dir, fname))
        if img is None:
            img = procedural_rusty_metal(kind)
        if img.shape[0] != img.shape[1]:
            s = min(img.shape[0], img.shape[1])
            img = img[:s, :s]
        out.append(quantize8(img))
    smallest = min(t.shape[0] for t in out)
    for i, t in enumerate(out):
        while t.shape[0] > smallest:
            t = t[::2, ::2]
        out[i] = np.ascontiguousarray(t)
    return out


def generate_mipmap_chain(tex: np.ndarray) -> List[np.ndarray]:
    """GenerateMipmapChain (win32_main.cpp:2307-2328), square textures only:
    each level is the parent's even texels."""
    assert tex.shape[0] == tex.shape[1], "square textures only"
    chain = [tex]
    size = tex.shape[0] >> 1
    while size:
        parent = chain[-1]
        chain.append(parent[::2, ::2][:size, :size].copy())
        size >>= 1
    return chain
