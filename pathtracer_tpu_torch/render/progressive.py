"""Progressive rendering: checkpoint and resume of the accumulator.

Counterpart of ``pathtracer_tpu/render/progressive.py``, in its file
format: a plain ``.npz`` (version 1, the same keys), written to a temporary
file and renamed into place. The accumulator is the whole render state, and
the counter-based PRNG regenerates the samples still to come exactly, so a
render resumed from a checkpoint equals the uninterrupted one. A file
written by either package resumes in the other.

The JAX package keeps ``nan_count`` and ``rays_cast`` as float32; the port
keeps them as int64, reads the JAX package's by rounding and writes its own
as int64 under the same keys, so a count above 2^24 stays exact.
"""

from __future__ import annotations

import os
import tempfile
from typing import Tuple

import numpy as np
import torch

from ..utils.vec import Vec3
from .renderer import AccumState, init_accum

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: AccumState) -> None:
    """Write the accumulator to ``path`` atomically."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".ckpt.tmp")
    os.close(fd)
    host = lambda t: t.detach().cpu().numpy()
    try:
        np.savez(
            tmp, version=_FORMAT_VERSION,
            sum_x=host(state.sum.x), sum_y=host(state.sum.y),
            sum_z=host(state.sum.z),
            sq_x=host(state.sum_sq.x), sq_y=host(state.sum_sq.y),
            sq_z=host(state.sum_sq.z),
            count=host(state.count),
            nan_count=np.int64(int(state.nan_count)),
            rays_cast=np.int64(int(state.rays_cast)),
            samples_done=np.int32(state.samples_done),
        )
        os.replace(tmp + ".npz", path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, n_pixels: int,
                    device="cuda") -> Tuple[AccumState, bool]:
    """(accumulator on ``device``, found). A missing file, another format
    version or another pixel count gives a fresh accumulator and False."""
    if not os.path.exists(path):
        return init_accum(n_pixels, device), False
    try:
        with np.load(path) as z:
            if (int(z["version"]) != _FORMAT_VERSION
                    or z["count"].shape[0] != n_pixels):
                return init_accum(n_pixels, device), False
            f32 = lambda k: torch.from_numpy(
                np.ascontiguousarray(z[k], np.float32)).to(device)
            i64 = lambda k: torch.tensor(
                int(z[k]) if z[k].dtype.kind in "iu" else int(np.rint(z[k])),
                dtype=torch.int64, device=device)
            state = AccumState(
                Vec3(f32("sum_x"), f32("sum_y"), f32("sum_z")),
                Vec3(f32("sq_x"), f32("sq_y"), f32("sq_z")),
                f32("count"), i64("nan_count"), i64("rays_cast"),
                int(z["samples_done"]))
        return state, True
    except (OSError, KeyError, ValueError):
        return init_accum(n_pixels, device), False


def samples_done(state: AccumState) -> int:
    """Whole-image samples the accumulator holds (resume bookkeeping)."""
    return int(state.samples_done)
