"""Command-line application of the port — the win32_main ``main``/ParseArgs role.

Counterpart of ``pathtracer_tpu/cli.py`` for the flags the slice covers:
the reference's single-dash concatenated flags (``-w3 -p4``, ``-d`` for
the thin lens, ``-n -m -r`` to turn off the normal, metalness and
roughness maps; ``-t`` is accepted for compatibility) plus ``--size WxH
--out PATH --seed N --scene-seed N|os --rr --chunk N --mips --tbn --debug
regular|variance --device cuda|cpu``. With no ``-w`` it renders world 1,
the reference's default textured scene.
``--device`` defaults to ``cuda`` and fails without a card. Flags the port
has not reached raise and name their ROADMAP item.

Run: python -m pathtracer_tpu_torch [options]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _parse_reference_flags(argv):
    """Parse the reference's concatenated single-dash flags (-t16 -p16 -nmr)
    into (known dict, remaining argv for argparse)."""
    out = {"t": None, "p": None, "w": None, "d": False,
           "n": False, "m": False, "r": False, "h": False}
    rest = []
    for arg in argv:
        if arg.startswith("--") or not arg.startswith("-") or arg == "-":
            rest.append(arg)
            continue
        body = arg[1:]
        i = 0
        while i < len(body):
            c = body[i]
            if c in "tpw":
                j = i + 1
                while j < len(body) and (body[j].isdigit() or body[j] == "-"):
                    j += 1
                val = body[i + 1: j]
                out[c] = int(val) if val else 0
                i = j
            elif c in "dnmrh":
                out[c] = True
                i += 1
            else:
                print(f"Warning: invalid program arugment -{c}")  # sic, :2188
                i += 1
    return out, rest


# Flags of the JAX CLI that the port does not take yet -> ROADMAP item.
_NOT_PORTED = {
    "--png": "PNG output (ROADMAP queue 1 item 12)",
    "--checkpoint": "progressive checkpoints (ROADMAP queue 1 item 12)",
    "--profile": "profiler traces (ROADMAP queue 1 item 12)",
    "--single-chip": "multi-GPU rendering (ROADMAP queue 1 item 13)",
    "--mode": "the unrolled driver (ROADMAP queue 1 item 5)",
    "--preview": "progressive previews (ROADMAP queue 1 item 12)",
    "--live": "the terminal viewer (ROADMAP queue 1 item 12)",
    "--probe-pixel": "--probe-pixel (ROADMAP queue 1 item 11)",
    "--flip": "--flip (ROADMAP queue 1 item 12)",
    "--fog": "fog (ROADMAP queue 1 item 11)",
    "--denoise": "the a-trous denoiser (ROADMAP queue 1 item 11)",
    "--exposure": "the exposure multiplier (ROADMAP queue 1 item 12)",
}


def print_help():
    print("usage: python -m pathtracer_tpu_torch [options]\n")
    print("PyTorch + CUDA port of the pathtracer_tpu path tracer.\n")
    print("optional arguments:")
    print("\tt<int>  - Accepted for compatibility (reported as devices).")
    print("\tp<int>  - Set the rays to shoot per pixel (sqrt; total = p*p).")
    print("\tw<int>  - Set the world number to load. Ported:")
    print("\t\t1:\tDefault scene (textured ground; the default).\n"
          "\t\t2:\tMetal-roughness test.\n\t\t3:\tCornell box.\n"
          "\t\t4:\tRay Tracing in One Weekend book cover.\n"
          "\t\t6:\tCornell box with a quad area light.")
    print("\td       - Use the thin-lens camera (depth of field).")
    print("\tn       - Disable normal maps.")
    print("\tm       - Disable metalness maps.")
    print("\tr       - Disable roughness maps.")
    print("\th       - Print this help menu.")
    print("\nExtensions: --size WxH --out PATH --seed N --scene-seed N|os "
          "--rr --chunk N --mips --tbn --debug regular|variance "
          "--device cuda|cpu")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ref, rest = _parse_reference_flags(argv)
    if ref["h"]:
        print_help()
        return 0

    ap = argparse.ArgumentParser(prog="python -m pathtracer_tpu_torch",
                                 add_help=False)
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--out", default="test.bmp")
    ap.add_argument("--debug", default="regular")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=None,
                    help="samples per render_chunk call (default: all)")
    ap.add_argument("--rr", action="store_true",
                    help="Russian-roulette path termination (unbiased)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mips", action="store_true",
                    help="mip-mapped texture sampling (default: mip 0, the "
                         "reference's)")
    ap.add_argument("--tbn", action="store_true",
                    help="rotate normal maps into the surface's tangent "
                         "frame")
    ap.add_argument("--scene-seed", default=None, metavar="N|os",
                    help="seed of world 4's random layout (default 1337; "
                         "'os' draws one, as the reference does, and "
                         "prints it)")
    for flag in _NOT_PORTED:
        if flag.startswith("--"):
            ap.add_argument(flag, nargs="?", const=True, default=None)
    args = ap.parse_args(rest)

    for flag, what in _NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise NotImplementedError(f"{flag}: {what} is not ported yet")

    import torch

    from .io.bmp import write_bmp
    from .render.renderer import RenderConfig, render_image
    from .scene.schema import WORLD_KIND_COUNT
    from .scene.worlds import finalize_world

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain version)")
    w, h = (int(x) for x in args.size.split("x"))
    pp = max(0, min(1000, ref["p"])) if ref["p"] is not None else 4  # :2171
    world = max(0, min(WORLD_KIND_COUNT - 1, (ref["w"] or 1) - 1))   # :2181
    use_pinhole = not ref["d"]                                        # :2183
    rtiow_seed = 1337
    if args.scene_seed == "os":
        import secrets
        rtiow_seed = secrets.randbits(31)  # the reference's OS-seeded MT
        print(f"(--scene-seed os: layout seed {rtiow_seed})")
    elif args.scene_seed is not None:
        rtiow_seed = int(args.scene_seed)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"System has {n_dev} device(s).")
    print(f"Using 1 device(s): {device}.\n")

    scene, camera = finalize_world(world, w, h, use_pinhole=use_pinhole,
                                   use_normal_maps=not ref["n"],
                                   use_metalness_maps=not ref["m"],
                                   use_roughness_maps=not ref["r"],
                                   rtiow_seed=rtiow_seed)
    if args.tbn:
        scene = dataclasses.replace(scene, tbn_normal_maps=True)
    print("DefineCamera():\n===")
    print(f"camera located at c->pos = ({camera.pos[0]:f},{camera.pos[1]:f},"
          f"{camera.pos[2]:f})")
    print(f"Distance between the lens and the film plane: "
          f"{camera.focal_length:f}")
    for name in ("axis_x", "axis_y", "axis_z"):
        v = getattr(camera, name)
        print(f"c->{name.replace('_', '')}: ({v[0]:f},{v[1]:f},{v[2]:f})")
    print()

    mip_scale = 0.0
    if args.mips:
        if scene.tex_mip_meta:
            # texels per pixel at unit distance: the film pixel over the
            # lens-film distance (the bespoke w/2 texel density is folded
            # in by the integrator's footprint constant)
            mip_scale = 2.0 * camera.half_film_height / (h * camera.focal_length)
        else:
            print("(--mips: scene has no square pow2 combined texture set; "
                  "mip-0 sampling.)")

    cfg = RenderConfig(width=w, height=h, pp=pp, seed=args.seed,
                       debug_kind=args.debug,
                       use_russian_roulette=args.rr, mip_scale=mip_scale)

    def progress(s_done, s_total, st):
        if args.chunk and s_total > args.chunk:
            print(f"  {s_done}/{s_total} samples "
                  f"({int(st.rays_cast) / 1e6:.1f} Mrays)")

    t0 = time.perf_counter()
    img, packed, state = render_image(scene, camera, cfg,
                                      chunk_samples=args.chunk,
                                      progress_cb=progress, device=device)
    packed = packed.cpu().numpy()
    wall = time.perf_counter() - t0
    write_bmp(args.out, packed)

    rays = int(state.rays_cast)
    print(f"Done. Image written to {args.out}.")  # cf. :985
    print(f"[perf] {rays / wall / 1e6:.1f} Mrays/s  ({rays / 1e6:.1f} Mrays "
          f"in {wall:.2f}s on {device}, set-up and any first-use kernel "
          f"build included; {int(state.nan_count)} NaN samples masked)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
