#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (pathtracer_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and no network,
and it imports nothing of JAX.

The render kernel csrc/wave_kernel.cu has four compile-time variants
(cuda_backend.VARIANTS), instantiations of one template in one build: the
brute sphere sweep or the clustered walk (K5/K6), each with the pinhole or
the thin-lens primary ray.

Phases (each prints its measured values on its own line; any failure raises
and the script exits non-zero):
  1. device: the card's name and power limit;
  2. build: compiles csrc/wave_kernel.cu (one nvcc), prints the seconds
     and ptxas's registers and spills for each variant;
  3. kernel vs plain: render_chunk on CUDA tensors (the kernel) against
     render_chunk_plain (eager PyTorch) on the same inputs, gated like
     bench.py --verify (fewer than 1% of pixels with resolved |diff| > 1e-3
     and 0.1% with |diff| > 0.1, equal valid counts, rays within 0.5%):
     worlds 3 and 6 at 256x144 16 spp; worlds 4 and 2 and world 3 with the
     thin lens at 256x144 4 spp; every main path of phase 4 at its own
     1280x720 and spp; world 4 at pp=4 (16 spp, the CLI's default) and at
     pp=12 over samples 12-23, which together reach all 12 slots of the
     kernel's Poisson-disk table;
  4. main paths, each through render_image at 1280x720 with the launch
     counts set to 0 just before it and read just after:
     a. the Cornell box (-w3), 1 sample, seed 0, against the committed CPU
        oracle images/oracle_cornell_720p_1spp.npz (median |diff| < 1e-4,
        fewer than 1e-3 of pixels off by more than 1e-2); writes test.bmp;
     b. world 4 (-w4: 484 clustered spheres, thin lens), 4 spp: a finite
        image; writes test_w4.bmp;
     c. world 2 (-w2, clustered pinhole) and world 3 with -d (brute thin
        lens), 1 sample each: finite images;
  5. timing (CUDA events, synchronised; no speed gate): every variant and
     its plain version at 1280x720 4 spp; world 3 at 256 spp and end to
     end through render_image; worlds 3, 6 and 4 at 64 spp; world 2 at
     64 spp clustered against the same scene with its clusters dropped
     (brute), alternating;
  6. bounds: the least time the card could take for each variant's 4-spp
     launch, from FP32 operations counted off the kernel's code and the
     accumulator bytes. For the clustered variants the slab and sphere
     tests are counted over every ray of the same 4-spp render: the plain
     version renders it, and each bounce's live rays replay the kernel's
     per-thread walk with the port's ray_slab_entry.

The last two lines are the kernel table as JSON and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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


def ptxas_report(log: str) -> dict:
    """variant -> registers and spill bytes of its kernel, from nvcc
    -Xptxas -v output (one entry per wave_kernel<kClustered, kThinLens>)."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        m = re.search(r"wave_kernelILb([01])ELb([01])E", part)
        if m is None:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"(\d+) bytes spill stores", part)
        var = (("clustered" if m.group(1) == "1" else "brute")
               + ("_lens" if m.group(2) == "1" else "_pinhole"))
        out[var] = {"registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(spills.group(1)) if spills else None}
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


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pathtracer_tpu_torch.io.bmp import write_bmp
    from pathtracer_tpu_torch.render import cuda_backend as cb
    from pathtracer_tpu_torch.render.renderer import (
        RenderConfig, init_accum, render_image, resolve,
    )
    from pathtracer_tpu_torch.scene.schema import (
        WORLD_BRDF_TEST, WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD,
        WORLD_RAYTRACING_ONE_WEEKEND,
    )
    from pathtracer_tpu_torch.scene.worlds import finalize_world

    W3, W6, W2, W4 = (WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD, WORLD_BRDF_TEST,
                      WORLD_RAYTRACING_ONE_WEEKEND)
    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize

    def world(kind, w, h, lens=False, brute=False):
        scene, cam = finalize_world(kind, w, h, use_pinhole=not lens)
        return (scene.without_clusters() if brute else scene).to(dev), cam

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
    print(f"phase2 build_s={build_s:.3f} nvcc_s={cb.BUILD_SECONDS} "
          f"ptxas={json.dumps(ptxas)}")

    # --- 3. kernel vs plain on the card ------------------------------------
    max_err = dict.fromkeys(cb.VARIANTS, 0.0)
    disk_slots = set()
    # (world, width, height, pp, first sample, samples, thin lens); the
    # 1280x720 cases are the main paths of phase 4
    for kind, w, h, pp, s0, n, lens in (
            (W3, 256, 144, 4, 0, 16, False), (W6, 256, 144, 4, 0, 16, False),
            (W4, 256, 144, 2, 0, 4, True), (W2, 256, 144, 2, 0, 4, False),
            (W3, 256, 144, 2, 0, 4, True), (W3, 1280, 720, 1, 0, 1, False),
            (W4, 1280, 720, 2, 0, 4, True), (W2, 1280, 720, 1, 0, 1, False),
            (W3, 1280, 720, 1, 0, 1, True), (W4, 256, 144, 4, 0, 16, True),
            (W4, 128, 72, 12, 12, 12, True)):
        scene, cam = world(kind, w, h, lens)
        var = cb.variant(scene, cam)
        cfg = RenderConfig(w, h, pp=pp, seed=0)
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
        print(f"phase3 world={kind + 1} variant={var} {w}x{h} pp={pp} "
              f"samples={s0}-{s0 + n - 1} disk_slots={slots} "
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

    def main_path(kind, pp, lens=False):
        """render_image on the CPU-built scene, as a user calls it, with
        the launch counts read around this call alone."""
        scene, cam = finalize_world(kind, w, h, use_pinhole=not lens)
        cfg = RenderConfig(w, h, pp=pp, seed=0)
        cb.LAUNCHES = 0
        cb.VARIANT_LAUNCHES.update(dict.fromkeys(cb.VARIANTS, 0))
        img, packed, state = render_image(scene, cam, cfg, device="cuda")
        sync()
        var = cb.variant(scene, cam)
        check(cb.VARIANT_LAUNCHES[var] == cb.LAUNCHES > 0,
              f"the world {kind + 1} main path launched {var}")
        launches[var] = cb.VARIANT_LAUNCHES[var]
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
    for kind, lens in ((W2, False), (W3, True)):
        var, img, _, state = main_path(kind, 1, lens)
        print(f"phase4c world={kind + 1} variant={var} "
              f"launches={launches[var]} spp=1 mean={float(img.mean())} "
              f"rays={int(state.rays_cast)}")

    # --- 5. timing -----------------------------------------------------------
    def kernel_ms(scene, cam, pp, reps):
        """CUDA-event ms of each of ``reps`` launches of pp*pp samples at
        720p after one warm launch, and the rays of one launch."""
        cfg = RenderConfig(w, h, pp=pp, seed=0)
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

    def plain_s(scene, cam, pp):
        cfg = RenderConfig(w, h, pp=pp, seed=0)
        st = init_accum(w * h, dev)
        sync()
        t = time.perf_counter()
        cb.render_chunk_plain(scene, cam, cfg, 0, 0, pp * pp, st)
        sync()
        return time.perf_counter() - t, int(st.rays_cast)

    main_worlds = {"brute_pinhole": (W3, False), "clustered_lens": (W4, True),
                   "clustered_pinhole": (W2, False), "brute_lens": (W3, True)}
    timed = {}
    for var, (kind, lens) in main_worlds.items():
        scene, cam = world(kind, w, h, lens)
        ks, rays = kernel_ms(scene, cam, 2, 5)
        plain_s(scene, cam, 1)  # warm
        ps, prays = plain_s(scene, cam, 2)
        timed[var] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                          cam=cam, plain_ms=1e3 * ps)
        print(f"phase5 variant={var} world={kind + 1} 720p spp=4 "
              f"kernel_ms={sorted(ks)} rays={rays} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6}")

    # world 3 at 256 spp, kernel alone and end to end through render_image
    scene, cam = timed["brute_pinhole"]["scene"], timed["brute_pinhole"]["cam"]
    (kt,), kr = kernel_ms(scene, cam, 16, 1)
    sync()
    t = time.perf_counter()
    _, packed, st = render_image(scene, cam, RenderConfig(w, h, pp=16, seed=0),
                                 device="cuda")
    packed.cpu()
    e2e_s = time.perf_counter() - t
    print(f"phase5 world=3 256spp kernel_ms={kt} rays={kr} kernel_mrays_s="
          f"{kr / kt / 1e3} | render_image_s={e2e_s} "
          f"e2e_mrays_s={int(st.rays_cast) / e2e_s / 1e6} "
          f"kernel_share={kt / 1e3 / e2e_s}")

    # 64 spp: worlds 3 and 6 (the brute pinhole build) and world 4
    for kind, lens in ((W3, False), (W6, False), (W4, True)):
        scene, cam = world(kind, w, h, lens)
        ks, rays = kernel_ms(scene, cam, 8, 5)
        print(f"phase5 world={kind + 1} variant={cb.variant(scene, cam)} "
              f"64spp kernel_ms={sorted(ks)} rays={rays} mrays_s_median="
              f"{rays / np.median(ks) / 1e3} mrays_s_range="
              f"{rays / max(ks) / 1e3}-{rays / min(ks) / 1e3}")

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
        if scene.sph_clusters:
            wrays, slabs, spheres = walk_tests(
                scene, cam, RenderConfig(w, h, pp=2, seed=0), 4, dev)
            check(abs(wrays - tm["rays"]) <= 0.005 * tm["rays"],
                  f"{var}: walked {wrays} rays, the kernel cast {tm['rays']}")
            isect_ops = OPS_INV + slabs * OPS_SLAB + spheres * OPS_SPHERE
        else:
            slabs, spheres = 0.0, float(scene.n_spheres)
            isect_ops = spheres * OPS_SPHERE
        isect_ops += (scene.n_quads * OPS_QUAD + scene.n_planes * OPS_PLANE
                      + OPS_RESOLVE + OPS_EMIT)
        samples = w * h * 4
        rays = tm["rays"]
        # every ray intersects; each path's last ray is not shaded
        ops = (samples * OPS_PRIMARY[var.split("_")[1]] + rays * isect_ops
               + (rays - samples) * OPS_SHADE)
        nbytes = w * h * BYTES_PER_PIXEL
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        print(f"phase6 variant={var} slab_tests_per_ray={slabs} "
              f"sphere_tests_per_ray={spheres} ops={ops:.6e} bytes={nbytes} "
              f"bound_ms={bound_ms} bound_share={bound_ms / tm['ms']}")
        table.append({
            "name": f"wave_kernel<{var}>",
            "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            "replaces": "pathtracer_tpu/render/pallas_backend.py:483",
            "launches": launches[var],
            "max_abs_err": max_err[var],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no single PyTorch call computes this
        })
    check(all(k["launches"] > 0 for k in table), "every variant launched")
    print(f"phase6 total_s={time.perf_counter() - t_start}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
