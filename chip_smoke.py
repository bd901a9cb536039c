#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (pathtracer_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and no network,
and it imports nothing of JAX.

The render kernel csrc/wave_kernel.cu has seven compile-time variants
(cuda_backend.VARIANTS), instantiations of one template in one build:
untextured, the brute sphere sweep or the clustered walk (K5/K6), each with
the pinhole or the thin-lens primary ray; textured (world 1's combined
4-map fetch, K9), the pinhole and the lens under the main sample schedule
(cuda_backend.TEXTURED_SCHEDULE) and the pinhole under the other one (K3
lockstep or K2 regen), its yardstick.

Phases (each prints its measured values on its own line; any failure raises
and the script exits non-zero):
  1. device: the card's name and power limit;
  2. build: compiles csrc/wave_kernel.cu (one nvcc), prints the seconds,
     ptxas's registers and spills for each variant and, from cuobjdump,
     the count of BSSY/BSYNC/WARPSYNC instructions in each variant's SASS
     (``--sass DIR`` also writes the full SASS there);
  3. kernel vs plain: render_chunk on CUDA tensors (the kernel) against
     render_chunk_plain (eager PyTorch) on the same inputs, gated like
     bench.py --verify (fewer than 1% of pixels with resolved |diff| > 1e-3
     and 0.1% with |diff| > 0.1, equal valid counts, rays within 0.5%):
     worlds 3 and 6 at 256x144 16 spp; worlds 4 and 2 and world 3 with the
     thin lens at 256x144 4 spp; world 1 at 256x144 4 spp under both
     schedules, with -d, --mips, --tbn and -nmr; every main path of phase
     4 at its own 1280x720 and spp; world 4 at pp=4 (16 spp, the CLI's
     default) and at pp=12 over samples 12-23, which together reach all 12
     slots of the kernel's Poisson-disk table;
  4. main paths, each through the entry point a user calls, at 1280x720
     with the launch counts set to 0 just before it and read just after:
     a. the Cornell box (-w3), 1 sample, seed 0, against the committed CPU
        oracle images/oracle_cornell_720p_1spp.npz (median |diff| < 1e-4,
        fewer than 1e-3 of pixels off by more than 1e-2); writes test.bmp;
     b. world 4 (-w4: 484 clustered spheres, thin lens), 4 spp: a finite
        image; writes test_w4.bmp;
     c. world 2 (-w2, clustered pinhole) and world 3 with -d (brute thin
        lens), 1 sample each; world 1 with -d (textured lens) and world 1
        under the other schedule, 4 samples each: finite images;
     d. the default command, cli.main(["--out", "test_w1.bmp"]): world 1,
        16 spp, through the textured kernel; a finite, non-black image;
  5. timing (CUDA events, synchronised; no speed gate): every variant and
     its plain version at 1280x720 4 spp; world 3 at 256 spp and world 1
     at 16 spp, kernel alone and end to end through render_image; worlds
     3, 6 and 4 at 64 spp; world 1 at 64 spp under both schedules,
     alternating, and with --mips; world 2 at 64 spp clustered against
     the same scene with its clusters dropped (brute), alternating;
  6. bounds: the least time the card could take for each variant's 4-spp
     launch, from FP32 operations counted off the kernel's code and the
     bytes it must move (accumulators; for world 1 also the texture
     table). For the clustered variants the slab and sphere tests are
     counted over every ray of the same 4-spp render: the plain version
     renders it, and each bounce's live rays replay the kernel's
     per-thread walk with the port's ray_slab_entry. For the textured
     variants the fetches are counted the same way: every shaded hit on a
     textured material whose path continues (a lower count).

The last two lines are the kernel table as JSON and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ORACLE = ROOT / "images" / "oracle_cornell_720p_1spp.npz"

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations (add, mul, div, sqrt, min/max, compare, select each 1;
# sin/cos 1 each) counted off csrc/wave_kernel.cu. PCG4D is integer work
# and is left out, so the bound is a lower bound.
OPS_PRIMARY = {"pinhole": 49, "lens": 82}  # primary_ray
OPS_SPHERE = 35     # ray_sphere + the t < best test
OPS_SLAB = 25       # one leaf cluster's slab test and cull (K5)
OPS_INV = 6         # the slab reciprocals, once per ray
OPS_QUAD = 80       # ray_quad + the t < best test
OPS_PLANE = 16      # ray_plane + the t > 1e-4 and t < best tests
OPS_RESOLVE = 20    # the winner's normal (K6 for clustered spheres)
OPS_EMIT = 9        # emission and the surface test, every ray
OPS_SHADE = 226     # shade_surface, diffuse branch (the common one)
# K9 in shade_surface, per textured hit: the bespoke scale and fractions
# (14), 32 texel channels unpacked (64), 8 bilinear blends (74), the normal
# decode and normalize (17), the map selects (5)
OPS_TEX = 174
BYTES_PER_PIXEL = 64  # 28 B of sums read, 36 B of sums and counters written


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


KERNEL_RE = r"wave_kernelILb([01])ELb([01])ELi([0-9])E"


def variant_of(mangled: re.Match) -> str:
    """The variant name of wave_kernel<kClustered, kThinLens, kTex>."""
    from pathtracer_tpu_torch.render import cuda_backend as cb
    clustered, lens, tex = mangled.groups()
    end = "_lens" if lens == "1" else "_pinhole"
    if tex == "0":
        return ("clustered" if clustered == "1" else "brute") + end
    sched = {"1": "lockstep", "2": "regen"}[tex]
    return "textured" + end + ("" if sched == cb.TEXTURED_SCHEDULE
                               else "_" + sched)


def ptxas_report(log: str) -> dict:
    """variant -> registers and spill bytes of its kernel, from nvcc
    -Xptxas -v output (one entry per wave_kernel instantiation)."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        m = re.search(KERNEL_RE, part)
        if m is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"(\d+) bytes spill stores", part)
        out[variant_of(m)] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spills.group(1)) if spills else None}
    return out


def sass_report(lib_path, dump_dir=None) -> dict:
    """variant -> counts of the warp-convergence instructions in its SASS
    (cuobjdump -sass of the built library): BSSY/BSYNC bracket a divergent
    region whose lanes re-join at the BSYNC; WARPSYNC is __syncwarp."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    sass = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                           "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(KERNEL_RE, part.split("\n", 1)[0])
        if m is None:
            continue
        var = variant_of(m)
        out[var] = {op: len(re.findall(rf"\b{op}\b", part))
                    for op in ("BSSY", "BSYNC", "WARPSYNC")}
        if dump_dir is not None:
            Path(dump_dir).mkdir(parents=True, exist_ok=True)
            (Path(dump_dir) / f"{var}.sass").write_text(part)
    return out


def walk_tests(scene, cam, cfg, n_samples, dev):
    """(rays, mean slab tests, mean sphere tests per ray) of the kernel's
    clustered walk over every ray of samples 0 .. n_samples-1 of ``cfg``.
    The plain version renders the same rays as the kernel (phase 3 holds
    them to it); each bounce's batch of live rays is caught on its way to
    intersect_scene and walked per ray, as a kernel thread walks it: the
    huge cluster always, a leaf only where ray_slab_entry says the ray
    enters its box before its nearest hit so far."""
    import torch
    from pathtracer_tpu_torch.ops.intersect import ray_slab_entry, ray_sphere
    from pathtracer_tpu_torch.render import cuda_backend as cb, wavefront
    from pathtracer_tpu_torch.render.renderer import init_accum
    from pathtracer_tpu_torch.utils.vec import Vec3

    tally = {"rays": 0, "slabs": 0, "spheres": 0}
    live = {}
    primary, intersect = wavefront._primary_rays, wavefront.intersect_scene

    def primary_caught(camera, config, key, pixel_idx, s):
        live["mask"] = s < n_samples  # lanes with samples left (s0 = 0)
        return primary(camera, config, key, pixel_idx, s)

    def intersect_caught(sc, o, d):
        m = live["mask"]
        lo, ld = Vec3(*(c[m] for c in o)), Vec3(*(c[m] for c in d))
        t_run = torch.full_like(lo.x, 3.4028234663852886e38)
        tally["rays"] += lo.x.numel()
        for off, cnt, mn, mx in sc.sph_clusters:
            hot = torch.ones_like(lo.x, dtype=torch.bool)
            if mn is not None:
                t_enter, hb = ray_slab_entry(lo, ld, mn, mx)
                tally["slabs"] += lo.x.numel()
                hot = hb & (t_enter < t_run)
            tally["spheres"] += cnt * int(hot.sum())
            for i in range(off, off + cnt):
                c = Vec3(*(v[i] for v in sc.csph_center))
                t, hit, _ = ray_sphere(lo, ld, c, sc.csph_radius[i])
                t_run = torch.where(hot & hit & (t < t_run), t, t_run)
        return intersect(sc, o, d)

    wavefront._primary_rays = primary_caught
    wavefront.intersect_scene = intersect_caught
    try:
        cb.render_chunk_plain(scene, cam, cfg, 0, 0, n_samples,
                              init_accum(cfg.width * cfg.height, dev))
    finally:
        wavefront._primary_rays = primary
        wavefront.intersect_scene = intersect
    n = tally["rays"]
    return n, tally["slabs"] / n, tally["spheres"] / n


def tex_fetches(scene, cam, cfg, n_samples, dev):
    """(rays, fetches) of a textured render of samples 0 .. n_samples-1:
    the plain lockstep version renders it (phase 3 holds the kernel to it),
    and each bounce's shaded lanes on a textured material whose path
    continues are counted. Lanes whose path ended re-shade their last hit
    without continuing, so they are not counted: a lower count."""
    from pathtracer_tpu_torch.render import cuda_backend as cb, lockstep
    from pathtracer_tpu_torch.render.renderer import init_accum

    tally = {"fetches": 0}
    shade = lockstep.shade_bounce

    def shade_caught(sc, o, d, hit, u, mip_scale=0.0):
        out = shade(sc, o, d, hit, u, mip_scale=mip_scale)
        tex = sc.mat_albedo_idx[hit.mat.long()] != 0
        tally["fetches"] += int((tex & out.cont).sum())
        return out

    lockstep.shade_bounce = shade_caught
    try:
        st = cb.render_chunk_plain(
            scene, cam, dataclasses.replace(cfg, schedule="lockstep"), 0, 0,
            n_samples, init_accum(cfg.width * cfg.height, dev))
    finally:
        lockstep.shade_bounce = shade
    return int(st.rays_cast), tally["fetches"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", metavar="DIR", default=None,
                    help="also write each variant's SASS to DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.io.bmp import write_bmp
    from pathtracer_tpu_torch.render import cuda_backend as cb
    from pathtracer_tpu_torch.render import renderer
    from pathtracer_tpu_torch.render.renderer import (
        RenderConfig, init_accum, render_image, resolve,
    )
    from pathtracer_tpu_torch.scene.schema import (
        WORLD_BRDF_TEST, WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD, WORLD_DEFAULT,
        WORLD_RAYTRACING_ONE_WEEKEND,
    )
    from pathtracer_tpu_torch.scene.worlds import finalize_world

    W3, W6, W2, W4, W1 = (WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD,
                          WORLD_BRDF_TEST, WORLD_RAYTRACING_ONE_WEEKEND,
                          WORLD_DEFAULT)
    OTHER = cb.OTHER_SCHEDULE
    NMR = dict(use_normal_maps=False, use_metalness_maps=False,
               use_roughness_maps=False)
    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize

    def world(kind, w, h, lens=False, brute=False, statics=None):
        scene, cam = finalize_world(kind, w, h, use_pinhole=not lens)
        scene = dataclasses.replace(scene, **(statics or {}))
        return (scene.without_clusters() if brute else scene).to(dev), cam

    def mip_scale(cam, h):
        """The CLI's --mips constant."""
        return 2.0 * cam.half_film_height / (h * cam.focal_length)

    # --- 1. device ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"phase1 device={name!r} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi)  # the card's name and power limit, as nvidia-smi reports

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    cb.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report(cb.BUILD_LOG)
    check(sorted(ptxas) == sorted(cb.VARIANTS), f"ptxas report {ptxas}")
    sass = sass_report(cb.LIB_PATH, args.sass)
    check(sorted(sass) == sorted(cb.VARIANTS), f"SASS report {sass}")
    print(f"phase2 build_s={build_s:.3f} nvcc_s={cb.BUILD_SECONDS} "
          f"ptxas={json.dumps(ptxas)}")
    print(f"phase2 sass={json.dumps(sass)}")

    # --- 3. kernel vs plain on the card ------------------------------------
    max_err = dict.fromkeys(cb.VARIANTS, 0.0)
    disk_slots = set()
    # (world, width, height, pp, first sample, samples, thin lens, options);
    # the 1280x720 cases are the main paths of phase 4
    for kind, w, h, pp, s0, n, lens, opt in (
            (W3, 256, 144, 4, 0, 16, False, {}),
            (W6, 256, 144, 4, 0, 16, False, {}),
            (W4, 256, 144, 2, 0, 4, True, {}),
            (W2, 256, 144, 2, 0, 4, False, {}),
            (W3, 256, 144, 2, 0, 4, True, {}),
            (W1, 256, 144, 2, 0, 4, False, {}),
            (W1, 256, 144, 2, 0, 4, False, {"schedule": OTHER}),
            (W1, 256, 144, 2, 0, 4, True, {}),
            (W1, 256, 144, 2, 0, 4, False, {"mips": True}),
            (W1, 256, 144, 2, 0, 4, False, {"mips": True, "schedule": OTHER}),
            (W1, 256, 144, 2, 0, 4, False, {"statics": {
                "tbn_normal_maps": True}}),
            (W1, 256, 144, 2, 0, 4, False, {"statics": NMR}),
            (W3, 1280, 720, 1, 0, 1, False, {}),
            (W4, 1280, 720, 2, 0, 4, True, {}),
            (W2, 1280, 720, 1, 0, 1, False, {}),
            (W3, 1280, 720, 1, 0, 1, True, {}),
            (W1, 1280, 720, 4, 0, 16, False, {}),
            (W1, 1280, 720, 2, 0, 4, True, {}),
            (W1, 1280, 720, 2, 0, 4, False, {"schedule": OTHER}),
            (W4, 256, 144, 4, 0, 16, True, {}),
            (W4, 128, 72, 12, 12, 12, True, {})):
        scene, cam = world(kind, w, h, lens, statics=opt.get("statics"))
        cfg = RenderConfig(w, h, pp=pp, seed=0,
                           schedule=opt.get("schedule"),
                           mip_scale=mip_scale(cam, h) if opt.get("mips")
                           else 0.0)
        var = cb.variant(scene, cam, cfg.schedule)
        k = cb.render_chunk_cuda(scene, cam, cfg, 0, s0, n,
                                 init_accum(w * h, dev))
        p = cb.render_chunk_plain(scene, cam, cfg, 0, s0, n,
                                  init_accum(w * h, dev))
        slots = sorted({(s % pp) * (s // pp) % 12 for s in range(s0, s0 + n)}
                       if lens else ())
        disk_slots.update(slots)
        sync()
        d = (resolve(k, cfg) - resolve(p, cfg)).abs().amax(dim=-1)
        f3 = float((d > 1e-3).float().mean())
        f1 = float((d > 0.1).float().mean())
        count_eq = bool(torch.equal(k.count, p.count))
        rk, rp = int(k.rays_cast), int(p.rays_cast)
        bit_eq = float((d == 0).float().mean())
        max_err[var] = max(max_err[var], float(d.max()))
        opts = {k_: v for k_, v in opt.items() if k_ != "statics"}
        opts.update(opt.get("statics") or {})
        print(f"phase3 world={kind + 1} variant={var} {w}x{h} pp={pp} "
              f"samples={s0}-{s0 + n - 1} options={opts} disk_slots={slots} "
              f"frac_gt_1e-3={f3} frac_gt_0.1={f1} bit_equal={bit_eq} "
              f"count_equal={count_eq} rays_kernel={rk} rays_plain={rp} "
              f"nan_kernel={int(k.nan_count)} nan_plain={int(p.nan_count)} "
              f"max_abs_err={float(d.max())}")
        check(f3 < 0.01 and f1 < 0.001, "kernel vs plain flip fractions")
        check(count_eq, "kernel vs plain valid counts")
        check(abs(rk - rp) <= 0.005 * rp, "kernel vs plain ray counts")
    check(disk_slots == set(range(12)), f"Poisson-disk slots {disk_slots}")

    # --- 4. the main paths at full width -------------------------------------
    w, h = 1280, 720
    launches = dict.fromkeys(cb.VARIANTS, 0)

    def reset_counts():
        cb.LAUNCHES = 0
        cb.VARIANT_LAUNCHES.update(dict.fromkeys(cb.VARIANTS, 0))

    def read_counts(var, what):
        check(cb.VARIANT_LAUNCHES[var] == cb.LAUNCHES > 0,
              f"the {what} main path launched {var}")
        launches[var] = cb.VARIANT_LAUNCHES[var]

    def main_path(kind, pp, lens=False, schedule=None):
        """render_image on the CPU-built scene, as a user calls it, with
        the launch counts read around this call alone."""
        scene, cam = finalize_world(kind, w, h, use_pinhole=not lens)
        cfg = RenderConfig(w, h, pp=pp, seed=0, schedule=schedule)
        reset_counts()
        img, packed, state = render_image(scene, cam, cfg, device="cuda")
        sync()
        var = cb.variant(scene, cam, schedule)
        read_counts(var, f"world {kind + 1}")
        img = img.cpu().numpy()
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()),
              "finite (720, 1280, 3) image")
        return var, img, packed, state

    var, img, packed, state = main_path(W3, 1)
    oracle = np.load(ORACLE)["img"]
    e = float(np.sqrt(((img - oracle) ** 2).mean()))
    dd = np.abs(img - oracle).max(axis=-1)
    med, flips = float(np.median(dd)), float((dd > 1e-2).mean())
    print(f"phase4a world=3 variant={var} launches={launches[var]} "
          f"rmse_1spp={e} rmse_over_32={e / 32.0} median_absdiff={med} "
          f"frac_gt_1e-2={flips} (gates: median < 1e-4, frac < 1e-3; "
          f"bench.py: rmse/32 < 1e-3) rays={int(state.rays_cast)} "
          f"nan={int(state.nan_count)}")
    check(med < 1e-4 and flips < 1e-3, "oracle gates")
    bmp = ROOT / "test.bmp"
    write_bmp(str(bmp), packed.cpu().numpy())
    print(f"phase4a wrote {bmp.name} bytes={bmp.stat().st_size}")

    var, img, packed, state = main_path(W4, 2)
    check(0.05 < float(img.mean()) < 2.0, "world 4 image brightness")
    bmp = ROOT / "test_w4.bmp"
    write_bmp(str(bmp), packed.cpu().numpy())
    print(f"phase4b world=4 variant={var} launches={launches[var]} spp=4 "
          f"mean={float(img.mean())} rays={int(state.rays_cast)} "
          f"nan={int(state.nan_count)} wrote {bmp.name} "
          f"bytes={bmp.stat().st_size}")
    for kind, pp, lens, schedule in ((W2, 1, False, None), (W3, 1, True, None),
                                     (W1, 2, True, None),
                                     (W1, 2, False, OTHER)):
        var, img, _, state = main_path(kind, pp, lens, schedule)
        check(float(img.mean()) > 0.0, f"world {kind + 1} not black")
        print(f"phase4c world={kind + 1} variant={var} "
              f"launches={launches[var]} spp={pp * pp} "
              f"mean={float(img.mean())} rays={int(state.rays_cast)}")

    # d. the default command: world 1, 1280x720, 16 spp, on the card
    caught = {}
    real_render_image = renderer.render_image

    def render_image_caught(*a, **k):
        caught["out"] = real_render_image(*a, **k)
        return caught["out"]

    bmp = ROOT / "test_w1.bmp"
    renderer.render_image = render_image_caught
    try:
        reset_counts()
        rc = cli.main(["--out", str(bmp)])
        sync()
    finally:
        renderer.render_image = real_render_image
    check(rc == 0 and bmp.stat().st_size == 58 + w * h * 4,
          "the default command wrote its BMP")
    read_counts("textured_pinhole", "default command's")
    img, _, state = caught["out"]
    img = img.cpu().numpy()
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
          and float(img.mean()) > 0.05, "finite, non-black world 1 image")
    print(f"phase4d default command: world=1 variant=textured_pinhole "
          f"launches={launches['textured_pinhole']} spp=16 "
          f"mean={float(img.mean())} rays={int(state.rays_cast)} "
          f"nan={int(state.nan_count)} wrote {bmp.name} "
          f"bytes={bmp.stat().st_size}")

    # --- 5. timing -----------------------------------------------------------
    def kernel_ms(scene, cam, pp, reps, **cfg_kw):
        """CUDA-event ms of each of ``reps`` launches of pp*pp samples at
        720p after one warm launch, and the rays of one launch."""
        cfg = RenderConfig(w, h, pp=pp, seed=0, **cfg_kw)
        st = init_accum(w * h, dev)
        cb.render_chunk_cuda(scene, cam, cfg, 0, 0, pp * pp, st)
        times = []
        for _ in range(reps):
            st = init_accum(w * h, dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            cb.render_chunk_cuda(scene, cam, cfg, 0, 0, pp * pp, st)
            b.record()
            sync()
            times.append(a.elapsed_time(b))
        return times, int(st.rays_cast)

    def plain_s(scene, cam, pp, **cfg_kw):
        cfg = RenderConfig(w, h, pp=pp, seed=0, **cfg_kw)
        st = init_accum(w * h, dev)
        sync()
        t = time.perf_counter()
        cb.render_chunk_plain(scene, cam, cfg, 0, 0, pp * pp, st)
        sync()
        return time.perf_counter() - t, int(st.rays_cast)

    # variant -> (world, thin lens, schedule)
    main_worlds = {"brute_pinhole": (W3, False, None),
                   "clustered_lens": (W4, True, None),
                   "clustered_pinhole": (W2, False, None),
                   "brute_lens": (W3, True, None),
                   "textured_pinhole": (W1, False, None),
                   "textured_lens": (W1, True, None),
                   f"textured_pinhole_{OTHER}": (W1, False, OTHER)}
    check(sorted(main_worlds) == sorted(cb.VARIANTS), "every variant timed")
    timed = {}
    for var, (kind, lens, schedule) in main_worlds.items():
        scene, cam = world(kind, w, h, lens)
        ks, rays = kernel_ms(scene, cam, 2, 5, schedule=schedule)
        plain_s(scene, cam, 1, schedule=schedule)  # warm
        ps, prays = plain_s(scene, cam, 2, schedule=schedule)
        timed[var] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                          cam=cam, plain_ms=1e3 * ps, schedule=schedule)
        print(f"phase5 variant={var} world={kind + 1} 720p spp=4 "
              f"kernel_ms={sorted(ks)} rays={rays} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6}")

    # world 3 at 256 spp and world 1 at 16 spp (the default command), the
    # kernel alone and end to end through render_image
    for var, pp in (("brute_pinhole", 16), ("textured_pinhole", 4)):
        scene, cam = timed[var]["scene"], timed[var]["cam"]
        (kt,), kr = kernel_ms(scene, cam, pp, 1)
        sync()
        t = time.perf_counter()
        _, packed, st = render_image(scene, cam,
                                     RenderConfig(w, h, pp=pp, seed=0),
                                     device="cuda")
        packed.cpu()
        e2e_s = time.perf_counter() - t
        print(f"phase5 world={main_worlds[var][0] + 1} variant={var} "
              f"{pp * pp}spp kernel_ms={kt} rays={kr} kernel_mrays_s="
              f"{kr / kt / 1e3} | render_image_s={e2e_s} "
              f"e2e_mrays_s={int(st.rays_cast) / e2e_s / 1e6} "
              f"kernel_share={kt / 1e3 / e2e_s}")

    # 64 spp: worlds 3 and 6 (the brute pinhole build), world 4, and
    # world 1 with --mips
    for kind, lens, mips in ((W3, False, False), (W6, False, False),
                             (W4, True, False), (W1, False, True)):
        scene, cam = world(kind, w, h, lens)
        ks, rays = kernel_ms(scene, cam, 8, 5,
                             mip_scale=mip_scale(cam, h) if mips else 0.0)
        print(f"phase5 world={kind + 1} variant={cb.variant(scene, cam)} "
              f"{'--mips ' if mips else ''}64spp kernel_ms={sorted(ks)} "
              f"rays={rays} mrays_s_median={rays / np.median(ks) / 1e3} "
              f"mrays_s_range={rays / max(ks) / 1e3}-{rays / min(ks) / 1e3}")

    # world 1 at 64 spp: the two schedules, alternating
    scene, cam = timed["textured_pinhole"]["scene"], timed[
        "textured_pinhole"]["cam"]
    main_s = cb.TEXTURED_SCHEDULE
    res = {main_s: [], OTHER: []}
    rays1 = {}
    for which in (main_s, OTHER, OTHER, main_s) * 2:
        (ms,), rays1[which] = kernel_ms(scene, cam, 8, 1, schedule=which)
        res[which].append(ms)
    spread = {k_: (max(v) - min(v)) / np.median(v) for k_, v in res.items()}
    print(f"phase5 world=1 64spp {main_s}_ms={res[main_s]} "
          f"{OTHER}_ms={res[OTHER]} rays_{main_s}={rays1[main_s]} "
          f"rays_{OTHER}={rays1[OTHER]} {main_s}_mrays_s="
          f"{rays1[main_s] / np.median(res[main_s]) / 1e3} {OTHER}_mrays_s="
          f"{rays1[OTHER] / np.median(res[OTHER]) / 1e3} "
          f"{main_s}_over_{OTHER}="
          f"{np.median(res[main_s]) / np.median(res[OTHER])} "
          f"spread={spread} | card: {smi}")

    # world 2: clustered against brute on the same scene, alternating
    clu, cam = world(W2, w, h)
    brute, _ = world(W2, w, h, brute=True)
    res = {"clustered": [], "brute": []}
    rays2 = {}
    for which in ("clustered", "brute", "brute", "clustered") * 2:
        (ms,), rays2[which] = kernel_ms(clu if which == "clustered" else brute,
                                        cam, 8, 1)
        res[which].append(ms)
    print(f"phase5 world=2 64spp clustered_ms={res['clustered']} "
          f"brute_ms={res['brute']} rays_clustered={rays2['clustered']} "
          f"rays_brute={rays2['brute']} clustered_over_brute="
          f"{np.median(res['clustered']) / np.median(res['brute'])} "
          f"| card: {smi}")

    # --- 6. bounds -------------------------------------------------------------
    table = []
    for var, tm in timed.items():
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0, schedule=tm["schedule"])
        fetches = 0
        if scene.sph_clusters:
            wrays, slabs, spheres = walk_tests(scene, cam, cfg4, 4, dev)
            check(abs(wrays - tm["rays"]) <= 0.005 * tm["rays"],
                  f"{var}: walked {wrays} rays, the kernel cast {tm['rays']}")
            isect_ops = OPS_INV + slabs * OPS_SLAB + spheres * OPS_SPHERE
        else:
            slabs, spheres = 0.0, float(scene.n_spheres)
            isect_ops = spheres * OPS_SPHERE
        if cb.textured(scene):
            frays, fetches = tex_fetches(scene, cam, cfg4, 4, dev)
            check(abs(frays - tm["rays"]) <= 0.005 * tm["rays"],
                  f"{var}: counted {frays} rays, the kernel cast {tm['rays']}")
        isect_ops += (scene.n_quads * OPS_QUAD + scene.n_planes * OPS_PLANE
                      + OPS_RESOLVE + OPS_EMIT)
        samples = w * h * 4
        rays = tm["rays"]
        # every ray intersects; each path's last ray is not shaded
        ops = (samples * OPS_PRIMARY[var.split("_")[1]] + rays * isect_ops
               + (rays - samples) * OPS_SHADE + fetches * OPS_TEX)
        nbytes = w * h * BYTES_PER_PIXEL + (
            scene.tex_tile.numel() * 4 if cb.textured(scene) else 0)
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        print(f"phase6 variant={var} slab_tests_per_ray={slabs} "
              f"sphere_tests_per_ray={spheres} tex_fetches={fetches} "
              f"ops={ops:.6e} bytes={nbytes} bound_ms={bound_ms} "
              f"bound_share={bound_ms / tm['ms']}")
        table.append({
            "name": f"wave_kernel<{var}>",
            "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            # K3 for the lockstep textured loop, K9 for the regen one
            "replaces": (
                "pathtracer_tpu/render/pallas_backend.py:483"
                if not cb.textured(scene)
                else "pathtracer_tpu/render/pallas_backend.py:306"
                if (tm["schedule"] or cb.TEXTURED_SCHEDULE) == "lockstep"
                else "pathtracer_tpu/ops/texture.py:231"),
            "launches": launches[var],
            "max_abs_err": max_err[var],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no single PyTorch call computes this
        })
    check(all(k_["launches"] > 0 for k_ in table), "every variant launched")
    print(f"phase6 total_s={time.perf_counter() - t_start}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
