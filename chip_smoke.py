#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (pathtracer_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and no network,
and it imports nothing of JAX.

Phases (each prints its measured values on its own line; any failure raises
and the script exits non-zero):
  1. device: the card's name and power limit;
  2. build: compiles csrc/wave_kernel.cu with nvcc, prints the seconds and
     ptxas's register/spill report;
  3. kernel vs plain: render_chunk on CUDA tensors (the kernel) against
     render_chunk_plain (eager PyTorch) for worlds 3 and 6 at 256x144,
     pp=4, and world 3 at the main path's 1280x720, 1 sample, gated like
     bench.py --verify: fewer than 1% of pixels with resolved |diff| > 1e-3
     and 0.1% with |diff| > 0.1, equal valid counts, rays within 0.5%;
  4. main path: render_image on the Cornell box (-w3) at 1280x720, 1 sample,
     seed 0, against the committed CPU oracle
     images/oracle_cornell_720p_1spp.npz (median |diff| < 1e-4, fewer than
     1e-3 of pixels off by more than 1e-2), with the kernel's launch count
     read around this phase alone; then finalize and write test.bmp;
  5. timing: kernel Mrays/s at 1280x720, 256 spp, the same render end to
     end through render_image, and the plain version's Mrays/s at 4 spp
     (all synchronised; no speed gate).

The last two lines are the kernel table as JSON and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ORACLE = ROOT / "images" / "oracle_cornell_720p_1spp.npz"


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
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
        WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD,
    )
    from pathtracer_tpu_torch.scene.worlds import finalize_world

    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize

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
    regs = [ln.strip() for ln in cb.BUILD_LOG.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"phase2 build_s={build_s:.3f} nvcc_s={cb.BUILD_SECONDS} "
          f"ptxas={' | '.join(regs)}")

    def chunk_pair(kind, w, h, pp, n):
        """Kernel and plain version on CUDA tensors, same inputs."""
        scene, cam = finalize_world(kind, w, h)
        scene = scene.to(dev)
        cfg = RenderConfig(w, h, pp=pp, seed=0)
        k = cb.render_chunk_cuda(scene, cam, cfg, 0, 0, n,
                                 init_accum(w * h, dev))
        p = cb.render_chunk_plain(scene, cam, cfg, 0, 0, n,
                                  init_accum(w * h, dev))
        sync()
        return cfg, k, p

    # --- 3. kernel vs plain on the card ------------------------------------
    max_err = 0.0
    for kind, w, h, pp, n in ((WORLD_CORNELL_BOX, 256, 144, 4, 16),
                              (WORLD_CORNELL_QUAD, 256, 144, 4, 16),
                              (WORLD_CORNELL_BOX, 1280, 720, 1, 1)):
        cfg, k, p = chunk_pair(kind, w, h, pp, n)
        d = (resolve(k, cfg) - resolve(p, cfg)).abs().amax(dim=-1)
        f3 = float((d > 1e-3).float().mean())
        f1 = float((d > 0.1).float().mean())
        count_eq = bool(torch.equal(k.count, p.count))
        rk, rp = int(k.rays_cast), int(p.rays_cast)
        bit_eq = float((d == 0).float().mean())
        max_err = max(max_err, float(d.max()))
        print(f"phase3 world={kind + 1} {w}x{h} spp={n} frac_gt_1e-3={f3} "
              f"frac_gt_0.1={f1} bit_equal={bit_eq} count_equal={count_eq} "
              f"rays_kernel={rk} rays_plain={rp} nan_kernel="
              f"{int(k.nan_count)} nan_plain={int(p.nan_count)} "
              f"max_abs_err={float(d.max())}")
        check(f3 < 0.01 and f1 < 0.001, "kernel vs plain flip fractions")
        check(count_eq, "kernel vs plain valid counts")
        check(abs(rk - rp) <= 0.005 * rp, "kernel vs plain ray counts")

    # --- 4. the main path at full width ------------------------------------
    w, h = 1280, 720
    scene, cam = finalize_world(WORLD_CORNELL_BOX, w, h)
    cfg = RenderConfig(w, h, pp=1, seed=0)
    cb.LAUNCHES = 0
    img, packed, state = render_image(scene, cam, cfg, device="cuda")
    sync()
    launches = cb.LAUNCHES
    check(launches > 0, "the main path launched the kernel")
    img = img.cpu().numpy()
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()),
          "finite (720, 1280, 3) image")
    oracle = np.load(ORACLE)["img"]
    e = float(np.sqrt(((img - oracle) ** 2).mean()))
    dd = np.abs(img - oracle).max(axis=-1)
    med, flips = float(np.median(dd)), float((dd > 1e-2).mean())
    print(f"phase4 launches={launches} rmse_1spp={e} rmse_over_32={e / 32.0} "
          f"median_absdiff={med} frac_gt_1e-2={flips} "
          f"(gates: median < 1e-4, frac < 1e-3; bench.py: rmse/32 < 1e-3) "
          f"rays={int(state.rays_cast)} nan={int(state.nan_count)}")
    check(med < 1e-4 and flips < 1e-3, "oracle gates")
    bmp = ROOT / "test.bmp"
    write_bmp(str(bmp), packed.cpu().numpy())
    print(f"phase4 wrote {bmp.name} bytes={bmp.stat().st_size}")

    # --- 5. timing -----------------------------------------------------------
    scene = scene.to(dev)

    def kernel_run(pp):
        st = init_accum(w * h, dev)
        sync()
        t = time.perf_counter()
        cb.render_chunk_cuda(scene, cam, RenderConfig(w, h, pp=pp, seed=0),
                             0, 0, pp * pp, st)
        sync()
        return time.perf_counter() - t, int(st.rays_cast)

    def plain_run(pp):
        st = init_accum(w * h, dev)
        sync()
        t = time.perf_counter()
        cb.render_chunk_plain(scene, cam, RenderConfig(w, h, pp=pp, seed=0),
                              0, 0, pp * pp, st)
        sync()
        return time.perf_counter() - t, int(st.rays_cast)

    kernel_run(2)  # warm
    k4 = [kernel_run(2) for _ in range(3)]  # 4 spp, as the plain run
    kt, kr = kernel_run(16)                  # 256 spp
    plain_run(1)  # warm
    pt, pr = plain_run(2)
    k4_ms = 1e3 * min(t for t, _ in k4)
    # end to end through the user's entry point: upload, one launch,
    # resolve, finalize and the copy of the packed image to the host
    cfg256 = RenderConfig(w, h, pp=16, seed=0)
    sync()
    t = time.perf_counter()
    _, packed, st = render_image(scene, cam, cfg256, device="cuda")
    packed.cpu()
    e2e_s = time.perf_counter() - t
    print(f"phase5 kernel_256spp_s={kt} rays={kr} kernel_mrays_s={kr / kt / 1e6}"
          f" | render_image_256spp_s={e2e_s} rays={int(st.rays_cast)} "
          f"e2e_mrays_s={int(st.rays_cast) / e2e_s / 1e6} "
          f"kernel_share={kt / e2e_s}"
          f" | kernel_4spp_ms={k4_ms} | plain_4spp_s={pt} rays={pr} "
          f"plain_mrays_s={pr / pt / 1e6} | card: {smi}")

    table = {"kernels": [{
        "name": "wave_kernel",
        "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
        "replaces": "pathtracer_tpu/render/pallas_backend.py:483",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k4_ms,
        "plain_ms": 1e3 * pt,
    }]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
