"""Edge-aware a-trous wavelet denoiser (post-process, opt-in).

Counterpart of ``pathtracer_tpu/render/denoise.py``: a dilated 5x5
B3-spline a-trous filter (Dammertz et al., HPG 2010) with a per-pixel
variance guide, run on the linear radiance image before the tonemap
(``renderer.finalize``, ``--denoise N``; the reference's "denoising" TODO,
win32_main.cpp:184). Pixels whose Monte-Carlo variance is high accept more
smoothing; converged pixels and colour edges keep theirs.

Each iteration is 25 edge-clamped shifts of an (H, W, 3) image, summed in
the JAX code's order, as tensor ops on whatever device the image lies.
"""

from __future__ import annotations

from typing import Optional

import torch

# B3-spline binomial taps (1 4 6 4 1)/16
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """``img`` (H, W, C) padded by ``pad`` on both spatial axes with its
    edge values (``jnp.pad(..., mode="edge")``)."""
    h, w = img.shape[0], img.shape[1]
    iy = torch.arange(-pad, h + pad, device=img.device).clamp(0, h - 1)
    ix = torch.arange(-pad, w + pad, device=img.device).clamp(0, w - 1)
    return img[iy][:, ix]


def atrous_denoise(img: torch.Tensor, var: Optional[torch.Tensor] = None,
                   iterations: int = 3, sigma_color: float = 0.35,
                   k_var: float = 4.0) -> torch.Tensor:
    """Denoise a linear (H, W, 3) float32 radiance image.

    ``var``: optional (H, W) variance of each pixel's mean estimate, which
    widens the colour-acceptance window where the estimate is still noisy
    (sigma^2 grows by ``k_var * var``); ``iterations``: a-trous levels
    (dilation 1, 2, 4, ...), 0 the identity; ``sigma_color``: the base
    colour-distance sigma in linear radiance units."""
    if iterations <= 0:
        return img
    h, w = img.shape[0], img.shape[1]
    sig2 = torch.tensor(sigma_color * sigma_color, dtype=torch.float32,
                        device=img.device)
    if var is not None:
        sig2 = sig2 + torch.tensor(k_var, dtype=torch.float32,
                                   device=img.device) * torch.clamp_min(
                                       var, 0.0)[..., None]
    inv = torch.clamp_min(sig2, 1e-8)
    out = img
    for it in range(iterations):
        d = 1 << it
        pad = 2 * d
        p = _edge_pad(out, pad)
        num = torch.zeros_like(out)
        den = torch.zeros((h, w, 1), dtype=out.dtype, device=out.device)
        for iy, hy in enumerate(_B3):
            for ix, hx in enumerate(_B3):
                dy, dx = (iy - 2) * d, (ix - 2) * d
                q = p[pad + dy:pad + dy + h, pad + dx:pad + dx + w, :]
                diff = q - out
                sq = diff * diff
                dist2 = (sq[..., 0:1] + sq[..., 1:2]) + sq[..., 2:3]
                wt = (hy * hx) * torch.exp(-dist2 / inv)
                num = num + wt * q
                den = den + wt
        out = num / den
    return out


def accum_variance(state, config) -> torch.Tensor:
    """(H, W) channel-mean variance of each pixel's mean estimate from the
    accumulator: (E[x^2] - E[x]^2) / n, clamped at 0."""
    cnt = torch.clamp_min(state.count, 1.0)
    vs = []
    for s, sq in zip(state.sum, state.sum_sq):
        mean = s / cnt
        vs.append(torch.clamp_min(sq / cnt - mean * mean, 0.0) / cnt)
    v = (vs[0] + vs[1] + vs[2]) * (1.0 / 3.0)
    return v.reshape(config.height, config.width)
