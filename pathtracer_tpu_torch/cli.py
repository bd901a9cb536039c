"""Command-line application of the port — the win32_main ``main``/ParseArgs role.

Counterpart of ``pathtracer_tpu/cli.py``: the reference's single-dash
concatenated flags (``-w3 -p4``, ``-d`` for the thin lens, ``-n -m -r`` to
turn off the normal, metalness and roughness maps, ``-t N`` to use the first
N devices) plus ``--size WxH --out PATH --png PATH --debug KIND --seed
N --scene-seed N|os --checkpoint PATH --chunk N --profile DIR --rr --mode
auto|unrolled|wavefront --preview PATH --live --probe-pixel X,Y --exposure
F --mips --tbn --flip x|y|xy --fog SIGMA_T --fog-albedo R,G,B --fog-g G
--denoise N --device cuda|cpu --single-chip``. With no ``-w`` it renders
world 1, the reference's default textured scene; ``-w5`` renders the glTF
mesh world (``res/mario.glb``; without the file, its ground and sky) and
``-w7`` the mesh-UV world. ``--out`` writes a BMP for ``.bmp`` or no
extension and hands any other extension to PIL, as the JAX CLI does.
``--chunk`` defaults to ``min(spp, 64)`` samples per ``render_chunk`` call;
``--checkpoint`` resumes from its file and saves it after every chunk;
``--live`` adapts the chunk toward one terminal frame every ~2 s.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace to
DIR/trace.json. ``--device`` defaults to ``cuda`` and fails without a
card. As JAX's CLI does, it renders across every card
(``parallel/shard.py::render_image_sharded``), or the first N with ``-t
N``, and on one with ``--single-chip`` or when one is used; ``--device
cuda:K`` and ``--device cpu`` use that one device. The preview and
``--live`` trim the sharded state's padding lanes; ``--checkpoint`` saves
the state as the renderer hands it over, padded, as JAX's CLI does.

Run: python -m pathtracer_tpu_torch [options]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
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


def print_help():
    print("usage: python -m pathtracer_tpu_torch [options]\n")
    print("PyTorch + CUDA port of the pathtracer_tpu path tracer.\n")
    print("optional arguments:")
    print("\tt<int>  - Use the first t devices (default: all of them).")
    print("\tp<int>  - Set the rays to shoot per pixel (sqrt; total = p*p).")
    print("\tw<int>  - Set the world number to load. Ported:")
    print("\t\t1:\tDefault scene (textured ground; the default).\n"
          "\t\t2:\tMetal-roughness test.\n\t\t3:\tCornell box.\n"
          "\t\t4:\tRay Tracing in One Weekend book cover.\n"
          "\t\t5:\tglTF mesh (res/mario.glb) on a ground plane.\n"
          "\t\t6:\tCornell box with a quad area light.\n"
          "\t\t7:\tUV-mapped sphere mesh (mesh-UV texture).")
    print("\td       - Use the thin-lens camera (depth of field).")
    print("\tn       - Disable normal maps.")
    print("\tm       - Disable metalness maps.")
    print("\tr       - Disable roughness maps.")
    print("\th       - Print this help menu.")
    print("\nExtensions: --size WxH --out PATH --png PATH --debug KIND "
          "--seed N --scene-seed N|os --checkpoint PATH --chunk N "
          "--profile DIR --rr --mode auto|unrolled|wavefront --preview PATH "
          "--live --probe-pixel X,Y --exposure F --mips --tbn --flip x|y|xy "
          "--fog SIGMA_T --fog-albedo R,G,B --fog-g G --denoise N "
          "--device cuda|cpu --single-chip")


def write_image(path, packed):
    """--out by its extension (pathtracer_tpu/cli.py:325-339): ``.bmp`` or
    none writes the reference's BMP bytes; any other goes through PIL,
    which raises where PIL is missing; an extension PIL does not know
    falls back to BMP bytes at the same path."""
    from .io.bmp import packed_to_rgb, write_bmp
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext in ("bmp", ""):
        write_bmp(path, packed)
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError(
            f"--out .{ext} needs PIL, which does not import here; .bmp "
            "needs nothing") from e
    try:
        Image.fromarray(packed_to_rgb(packed)[::-1]).save(path)
    except ValueError:
        # an unknown extension must not lose a finished render
        print(f"(--out: unknown extension .{ext}; writing BMP bytes)")
        write_bmp(path, packed)


def main(argv=None, devices=None):
    """Run the CLI on ``argv``. ``devices``: the devices it may render
    across (``-t`` takes the first N of them; default: every card for
    ``--device cuda``, else the one device)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ref, rest = _parse_reference_flags(argv)
    if ref["h"]:
        print_help()
        return 0

    ap = argparse.ArgumentParser(prog="python -m pathtracer_tpu_torch",
                                 add_help=False)
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--out", default="test.bmp")
    ap.add_argument("--png", default=None)
    ap.add_argument("--debug", default="regular",
                    help="regular | primary_ray_normals | bounce_count | "
                         "termination_condition | variance")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None,
                    help="resume from this accumulator file and save it "
                         "after every chunk (the JAX package's format)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="samples per render_chunk call (default: "
                         "min(spp, 64))")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace to "
                         "DIR/trace.json")
    ap.add_argument("--rr", action="store_true",
                    help="Russian-roulette path termination (unbiased)")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "unrolled", "wavefront"])
    ap.add_argument("--preview", default=None,
                    help="write a progressive preview PNG at each --chunk "
                         "boundary (the live-viewer role, "
                         "win32_main.cpp:252-274)")
    ap.add_argument("--live", action="store_true",
                    help="draw the progressive image in the terminal each "
                         "chunk (ANSI half-blocks)")
    ap.add_argument("--exposure", type=float, default=1.0,
                    help="linear exposure multiplier before the tonemap")
    ap.add_argument("--probe-pixel", default=None, metavar="X,Y",
                    help="print mean and variance radiance of one pixel "
                         "(the DEBUG_MIDDLE_PIXEL role, "
                         "win32_main.cpp:18,1011-1014)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mips", action="store_true",
                    help="mip-mapped texture sampling (default: mip 0, the "
                         "reference's)")
    ap.add_argument("--tbn", action="store_true",
                    help="rotate normal maps into the surface's tangent "
                         "frame")
    ap.add_argument("--flip", default="", choices=["", "x", "y", "xy"],
                    help="flip the saved image along x, y or both")
    ap.add_argument("--fog", type=float, default=0.0, metavar="SIGMA_T",
                    help="global homogeneous fog's extinction coefficient, "
                         "on any world (0: no fog)")
    ap.add_argument("--fog-albedo", default="1,1,1", metavar="R,G,B",
                    help="the fog's single-scatter albedo per channel")
    ap.add_argument("--fog-g", type=float, default=0.0,
                    help="Henyey-Greenstein anisotropy in (-1, 1); 0 is "
                         "isotropic, > 0 scatters forward")
    ap.add_argument("--denoise", type=int, default=0, metavar="N",
                    help="a-trous denoiser iterations on the linear image "
                         "before the tonemap; 0: the raw estimator")
    ap.add_argument("--scene-seed", default=None, metavar="N|os",
                    help="seed of world 4's random layout (default 1337; "
                         "'os' draws one, as the reference does, and "
                         "prints it)")
    ap.add_argument("--single-chip", action="store_true",
                    help="render on the first device only, even when "
                         "several are used (no sharding)")
    args = ap.parse_args(rest)

    import torch

    from .io.bmp import packed_to_rgb
    from .parallel.shard import make_devices, render_image_sharded, trim_accum
    from .render.renderer import RenderConfig, finalize, render_image
    from .scene.schema import WORLD_KIND_COUNT
    from .scene.worlds import finalize_world
    from .utils.profiling import PhaseTimer, RenderMetrics, profiler_trace

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
    if devices is None:
        devices = (make_devices() if device.type == "cuda"
                   and device.index is None else [device])
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    if ref["t"] is not None:
        n_dev = max(1, min(ref["t"], n_dev))
    print(f"System has {len(devices)} device(s).")   # cf. :2193
    print(f"Using {n_dev} device(s).\n")             # cf. :2194
    devices = devices[:n_dev]
    device = devices[0]

    timer = PhaseTimer()
    with timer.phase("scene"):
        scene, camera = finalize_world(world, w, h, use_pinhole=use_pinhole,
                                       use_normal_maps=not ref["n"],
                                       use_metalness_maps=not ref["m"],
                                       use_roughness_maps=not ref["r"],
                                       rtiow_seed=rtiow_seed)
        if args.tbn:
            scene = dataclasses.replace(scene, tbn_normal_maps=True)
        if args.fog > 0.0:
            try:
                fog_albedo = tuple(float(v)
                                   for v in args.fog_albedo.split(","))
            except ValueError:
                fog_albedo = ()
            if len(fog_albedo) != 3:
                raise SystemExit("--fog-albedo needs R,G,B (three "
                                 "comma-separated numbers)")
            scene = dataclasses.replace(scene, fog_sigma_t=float(args.fog),
                                        fog_albedo=fog_albedo,
                                        fog_g=float(args.fog_g))
    print("DefineCamera():\n===")
    print(f"camera located at c->pos = ({camera.pos[0]:f},{camera.pos[1]:f},"
          f"{camera.pos[2]:f})")
    print(f"Distance between the lens and the film plane: "
          f"{camera.focal_length:f}")
    for name in ("axis_x", "axis_y", "axis_z"):
        v = getattr(camera, name)
        print(f"c->{name.replace('_', '')}: ({v[0]:f},{v[1]:f},{v[2]:f})")
    print(
        "The film plane is embedded in the plane defined by c->axisX and "
        "c->axisY.\n"
        "Rays are shot originating at the lens located at c->pos and \"strike "
        "a sensor on the film to develop the image\".\n"
        "The camera has a local coordinate system which is different from "
        "the world coordinate system.\n"
        "The camera is looking down the negative c->axisZ direction.\n")

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
                       debug_kind=args.debug, use_russian_roulette=args.rr,
                       mode=args.mode, exposure=args.exposure,
                       mip_scale=mip_scale, denoise=args.denoise)
    if args.chunk is None:
        args.chunk = min(cfg.spp, 64)

    state = None
    if args.checkpoint:
        from .render.progressive import load_checkpoint
        state, done = load_checkpoint(args.checkpoint, w * h, device=device)
        if done:
            print(f"Resuming from {args.checkpoint}: "
                  f"{float(state.count.max()):.0f} samples done.")

    live = None
    if args.live:
        from .io.term import LiveView, supports_color
        if supports_color():
            live = LiveView()
        else:
            print("(--live: stdout is not a color terminal; disabled)")

    def progress(s_done, s_total, st):
        if s_total > args.chunk and live is None:
            print(f"  {s_done}/{s_total} samples "
                  f"({int(st.rays_cast) / 1e6:.1f} Mrays)")
        if args.checkpoint:
            from .render.progressive import save_checkpoint
            save_checkpoint(args.checkpoint, st)
        if args.preview or live is not None:
            # the sharded state carries padding lanes mid-render
            pk = finalize(trim_accum(st, w * h), cfg).cpu().numpy()
            rgb = packed_to_rgb(pk)[::-1]
            if args.preview:
                from PIL import Image
                Image.fromarray(rgb).save(args.preview)
            if live is not None:
                live.update(rgb, status=f"  {s_done}/{s_total} samples")

    # --live: adapt the chunk toward ~2 s between frames (a slow world's
    # 64-sample chunk can run for seconds); chunking changes no result
    adapt = 2.0 if live is not None else None

    with timer.phase("render"), profiler_trace(args.profile):
        t0 = time.perf_counter()
        if args.single_chip or n_dev == 1:
            img, packed, state = render_image(
                scene, camera, cfg, chunk_samples=args.chunk, state=state,
                progress_cb=progress, device=device, adapt_chunk_s=adapt)
        else:
            img, packed, state = render_image_sharded(
                scene, camera, cfg, devices=devices,
                chunk_samples=args.chunk, state=state, progress_cb=progress,
                adapt_chunk_s=adapt)
        packed = packed.cpu().numpy()
        wall = time.perf_counter() - t0

    with timer.phase("write"):
        pk = packed
        if "x" in args.flip:
            pk = pk[:, ::-1]
        if "y" in args.flip:
            pk = pk[::-1]
        write_image(args.out, pk)
        if args.png:
            from PIL import Image
            Image.fromarray(packed_to_rgb(pk)[::-1]).save(args.png)

    if args.probe_pixel:
        px, py = (int(v) for v in args.probe_pixel.split(","))
        lin = py * w + px
        cnt = max(float(state.count[lin]), 1.0)
        mean = [float(c[lin]) / cnt for c in state.sum]
        var = [float(sq[lin]) / cnt - m * m
               for sq, m in zip(state.sum_sq, mean)]
        print(f"probe pixel ({px},{py}): mean radiance = "
              f"({mean[0]:f},{mean[1]:f},{mean[2]:f})  variance = "
              f"({var[0]:f},{var[1]:f},{var[2]:f})  samples = {cnt:.0f}")

    where = (device if args.single_chip or n_dev == 1
             else f"{n_dev} devices")
    m = RenderMetrics(rays_cast=float(int(state.rays_cast)),
                      wall_seconds=wall, width=w, height=h, spp=cfg.spp,
                      nan_samples=float(int(state.nan_count)))
    print(f"Done. Image written to {args.out}.")  # cf. :985
    print(f"[perf] {m.mrays_per_sec:.1f} Mrays/s  ({m.rays_cast / 1e6:.1f} "
          f"Mrays in {wall:.2f}s on {where}, set-up and any first-use "
          f"kernel build included; {m.nan_samples:.0f} NaN samples masked)  "
          f"{timer.report()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
