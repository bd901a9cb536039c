"""Image comparison tool (the ImageCompare.exe role, src/image_compare.c).

The port's copy of ``pathtracer_tpu/compare.py``, with the same metrics,
flags, messages and exit codes; it imports numpy and PIL, never JAX, so it
runs on a machine without JAX. It reproduces the reference metric
("Percentage Similarity" = mean over pixels of 1 - |c1 - c2| on RGBA/255,
image_compare.c:79-103) and adds:

- a fixed distance: the reference's Magnitude uses v.a twice and never v.r
  (image_compare.c:121-124); the default counts all four channels, and
  ``--legacy`` reproduces the reference's metric bit for bit;
- RMSE over linear [0, 1] channel values (the BASELINE.json gate);
- ``--json`` output and a ``--threshold`` pass/fail exit code.

Run: python -m pathtracer_tpu_torch.compare img1 img2 [--legacy --json
--threshold X]. It reads BMP (the renderer's layout) or anything PIL
reads; formats PIL cannot identify (Radiance HDR, Softimage PIC) go to the
native ``native/build/image_compare`` executable where it is built, found
by its path in the checkout and never rebuilt here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def load_rgba(path: str) -> np.ndarray:
    """Load an image as (H, W, 4) uint8 RGBA (stbi_load ... 4 semantics)."""
    if path.lower().endswith(".bmp"):
        try:
            from .io.bmp import read_bmp
            packed = read_bmp(path)
            r = (packed >> 16) & 0xFF
            g = (packed >> 8) & 0xFF
            b = packed & 0xFF
            a = (packed >> 24) & 0xFF
            # bottom-up DIB: flip so row 0 is the top, like stbi does for BMP
            return np.stack([r, g, b, a], -1).astype(np.uint8)[::-1]
        except ValueError:
            pass
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


def color_distance(a: np.ndarray, b: np.ndarray, legacy: bool) -> np.ndarray:
    """Per-pixel color distance on [0,1] RGBA.

    legacy=True replicates image_compare.c:121-124 exactly:
    sqrt(a*a + b*b + g*g + a*a) — alpha counted twice, red never.
    """
    d = (a.astype(np.float64) - b.astype(np.float64)) / 255.0
    dr, dg, db, da = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    if legacy:
        return np.sqrt(da * da + db * db + dg * dg + da * da)
    return np.sqrt(dr * dr + dg * dg + db * db + da * da)


def percentage_similarity(a: np.ndarray, b: np.ndarray, legacy: bool = False) -> float:
    """CompareImages (image_compare.c:79-103): mean(1 - distance) * 100."""
    return float((1.0 - color_distance(a, b, legacy)).mean() * 100.0)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE over RGB channels in [0,1] (the BASELINE.json gate metric)."""
    d = (a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)) / 255.0
    return float(np.sqrt((d * d).mean()))


_EXE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "build", "image_compare")


def compare_exe_path():
    """The native image_compare executable's path, or None where it is not
    built (``make -C native``)."""
    return _EXE_PATH if os.path.exists(_EXE_PATH) else None


def _native_fallback(args) -> int:
    """Formats PIL cannot identify (Radiance HDR, Softimage PIC) are still
    part of the reference tool's stb_image input class; delegate the whole
    comparison to the native image_compare executable, whose from-scratch
    decoders cover them, so the two tools share one answer. Returns the
    exe's exit convention (0 ok / 1 over threshold / -1 error)."""
    import subprocess

    exe = compare_exe_path()
    if exe is None:
        print("Error: unsupported image format (PIL cannot read it and the "
              "native tool is not built; run `make -C native`)")
        return -1
    cmd = [exe, args.image1, args.image2]
    if args.legacy:
        cmd.append("--legacy")
    if args.threshold is not None:
        cmd += ["--threshold", str(args.threshold)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    rc = -1 if out.returncode == 255 else out.returncode
    if args.json:
        try:
            sim = float(out.stdout.split("Percentage Similarity:")[1]
                        .split("%")[0])
            e = float(out.stdout.split("RMSE:")[1].split()[0])
        except (IndexError, ValueError):
            print(json.dumps({"error": out.stdout.strip()}))
            return rc if rc != 0 else -1
        print(json.dumps({"percentage_similarity": sim, "rmse": e,
                          "legacy": args.legacy}))
    else:
        sys.stdout.write(out.stdout)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch.compare",
        description="Compare two images and print Percentage Similarity.")
    ap.add_argument("image1")
    ap.add_argument("image2")
    ap.add_argument("--legacy", action="store_true",
                    help="replicate the reference's buggy Magnitude")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--threshold", type=float, default=None,
                    help="exit 1 if RMSE exceeds this")
    args = ap.parse_args(argv)

    for p in (args.image1, args.image2):
        if not os.path.exists(p):
            print(f"Error: '{p}' is an invalid file path")
            return -1
    from PIL import UnidentifiedImageError
    try:
        a, b = load_rgba(args.image1), load_rgba(args.image2)
    except UnidentifiedImageError:
        return _native_fallback(args)
    if a.shape[1] != b.shape[1]:
        print(f"Error: Images must have same width but they are "
              f"{a.shape[1]} and {b.shape[1]}")
        return -1
    if a.shape[0] != b.shape[0]:
        print(f"Error: Images must have same height but they are "
              f"{a.shape[0]} and {b.shape[0]}")
        return -1

    sim = percentage_similarity(a, b, legacy=args.legacy)
    e = rmse(a, b)
    if args.json:
        print(json.dumps({"percentage_similarity": sim, "rmse": e,
                          "legacy": args.legacy}))
    else:
        print(f"Percentage Similarity: {sim:f} %")
        print(f"RMSE: {e:.6f}")
    if args.threshold is not None and e > args.threshold:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
