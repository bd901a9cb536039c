#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (pathtracer_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and no network,
and it imports nothing of JAX.

The render kernel csrc/wave_kernel.cu has fifty-five compile-time
variants (cuda_backend.VARIANTS), instantiations of one template in one
build:
untextured, the brute sphere sweep or the clustered walk (K5/K6), each with
the pinhole or the thin-lens primary ray; textured (world 1's combined
4-map fetch, K9), the pinhole and the lens under the main sample schedule
(cuda_backend.TEXTURED_SCHEDULE) and the pinhole under the other one (K3
lockstep or K2 regen), its yardstick; mesh (world 7's streamed triangle
walk K7 with the mesh-UV texel fetch K10), the pinhole and the lens under
cuda_backend.MESH_SCHEDULE and the pinhole under the other one; feature
(fog, transmission with dispersion, planar maps through K10's planar form,
bump maps through the height fetch K11, the brute triangle sweep K4t with
or without UVs), the pinhole and the lens under path regeneration; and the
mesh tiers (cuda_backend.MESH_KINDS), the pinhole and the lens under
cuda_backend.MESH_SCHEDULE: the static tier's cluster walk (K5's triangle
form) without UVs (staticplain, with the pinhole under the other schedule
as its yardstick) and with the winner's uv (K8, static), the streamed walk
without UVs (meshplain), and the DMA tier's walk with its grandparent level
with and without UVs (meshgp, meshgpplain). The feature bounce also runs on
each of the other bases, as "feat" + the base's name: sphere clusters
(featclustered, regen), the combined set (feattextured, lockstep, with its
pinhole under regen) and every mesh tier (featmesh ... featstaticplain,
lockstep, with featmesh's pinhole under regen); and the brute feature
form's pinhole also runs under lockstep (feature_pinhole_lockstep), each
yardstick of its schedule. Where two bases meet, the mixed variants
(cuda_backend.MIXED_VARIANTS, named by their parts joined with "+": sphere
clusters with the combined set, with each mesh tier, or with both, and the
combined set with each tier without UVs) carry the feature bounce under
lockstep and pick the camera at run time, one instantiation per base.

The mesh cases stand in for world 5's mario.glb, which is not in the
repository: world 5's builder without its asset (ground plane, sun, sky,
camera) plus a lat-long sphere (experiments/accel_crossover.py:51's
tessellated_sphere, a copy here) of 40 triangles without UVs (K4t), 784
(Mario's tier and size: the static tier), 19,600 (the resident streamed
tier) and 262,144 (the DMA tier with grandparents), or world 7's UV sphere
with its checker at 736 triangles (the static tier with UVs) and 99,840
(the DMA tier with UVs and grandparents). The mixed cases (MIXED_CASES,
built by scene/mixed_scenes.py) put those meshes, and world 7's UV sphere
at 1472 triangles, above world 2's clustered spheres (with world 1's
combined ground material on its plane where the variant names
"textured") or beside world 1's spheres, some with dispersive glass or
planar maps.

Phases (each prints its measured values on its own line; any failure raises
and the script exits non-zero):
  1. device: the card's name and power limit;
  2. build: compiles csrc/wave_kernel.cu (one nvcc per build part, all
     started together, and a link), prints the seconds,
     ptxas's registers and spills for each variant (and whether the
     forty-two earlier variants kept the values they were built at
     before the mixed variants came, EARLIER_PTXAS) and, from cuobjdump, the
     count of BSSY/BSYNC/WARPSYNC instructions in each variant's SASS
     (``--sass DIR`` also writes the full SASS there);
  3. kernel vs plain: render_chunk on CUDA tensors (the kernel) against
     render_chunk_plain (eager PyTorch) on the same inputs, gated like
     bench.py --verify (fewer than 1% of pixels with resolved |diff| > 1e-3
     and 0.1% with |diff| > 0.1, equal valid counts, rays within 0.5%):
     worlds 3 and 6 at 256x144 16 spp; worlds 4 and 2 and world 3 with the
     thin lens at 256x144 4 spp; world 1 at 256x144 4 spp under both
     schedules, with -d, --mips, --tbn and -nmr; world 7 at 256x144 4 spp
     under both schedules and with -d; every main path of phase 4 at its
     own 1280x720 and spp (world 7's default command, 16 spp, at 4); world
     4 at 256x144 at pp=4 (16 spp, the CLI's default) and at pp=12 over
     samples 12-23, which together reach all 12 slots of the kernel's
     Poisson-disk table;
     the five feature scenes (scene/feature_scenes.py) at 256x144 and
     1280x720, 4 spp (everything also through the thin lens), the CLI's fog
     on world 6 and on world 3 with -d, and world 1 with three planar
     512x512 maps at both sizes, through the feature variants; the six mesh
     cases at 256x144 and 1280x720, 4 spp, pinhole and thin lens (784 also
     under the other schedule), each through its tier's variant, and the
     two DMA-tier meshes bit-equal to themselves with the grandparent level
     off (the resident walk over the same parents); the feature bounce on
     the other bases at 256x144 and 1280x720, 4 spp (base_case): worlds 1
     (pinhole, lens, regen), 2 (pinhole, lens), 4, 7 (pinhole, lens, regen)
     and 6 (lockstep) in the CLI's fog, world 1's combined-set material and
     world 2's spheres as dispersive glass, planar albedo and bump maps on
     world 2 and on the 784-triangle case, every mesh case in fog through
     both cameras; the two DMA meshes in fog bit-equal to their
     resident twins; and every mixed case at 256x144 (pinhole without
     features, thin lens in the CLI's fog) and 1280x720 (thin lens
     without features, pinhole in fog), 4 spp: every mixed variant, the
     combined set with the 40-triangle mesh alone and beside clusters,
     dispersive glass on clusters, the combined set and the 784-triangle
     mesh, and planar albedo and bump maps beside clusters and that mesh;
  4. main paths, each through the entry point a user calls, at 1280x720
     with the launch counts set to 0 just before it and read just after:
     a. the Cornell box (-w3), 1 sample, seed 0, against the committed CPU
        oracle images/oracle_cornell_720p_1spp.npz (median |diff| < 1e-4,
        fewer than 1e-3 of pixels off by more than 1e-2); writes test.bmp;
     b. world 4 (-w4: 484 clustered spheres, thin lens), 4 spp: a finite
        image; writes test_w4.bmp;
     c. world 2 (-w2, clustered pinhole) and world 3 with -d (brute thin
        lens), 1 sample each; worlds 1 and 7 with -d (textured and mesh
        lens) and under their other schedule, 4 samples each: finite
        images;
     d. the default command, cli.main(["--out", "test_w1.bmp"]): world 1,
        16 spp, through the textured kernel; a finite, non-black image;
     e. cli.main(["-w7", "--out", "test_w7.bmp"]): world 7, 16 spp, through
        the mesh kernel; a finite, non-black image;
     f. the fog command, -w6 and -w3 -d with --fog 0.0012 --fog-albedo
        0.9,0.9,0.95 --fog-g 0.5, 16 spp, through the feature variants;
        finite, non-black images (test_fog_w6.bmp, test_fog_w3.bmp);
     g. the five feature scenes through render_image, 16 spp: finite,
        non-black images, each launching feature_pinhole;
     h. cli.main(["-w5", "--out", "test_w5.bmp"]): world 5, 16 spp, with
        mario.glb if res/ has it (its mesh through its tier's variant), else
        ground, sky and sun; a finite, non-black image;
     i. render_image on the 784-, 19,600- and 262,144-triangle cases, 16
        spp, and on every other mesh-tier variant's case, 4 spp: finite,
        non-black images through their variants;
     j. the fog commands, 16 spp: the default command with --fog (world 1,
        test_fog_w1.bmp), -w7, -w4 and -w2 with --fog, through the feature
        forms of their bases; finite images, non-black but world 4's (its
        only light is the sky, which fog occludes: black, as JAX's is);
     k. render_image, 4 spp, on every other new variant's case: worlds 1
        and 7 in fog through the thin lens and the other schedule, world 6
        in fog under lockstep, the mesh cases in fog through both cameras;
     l. render_image, 4 spp in one chunk, on every mixed case: one launch
        of its own variant;
  5. timing (CUDA events, synchronised; no speed gate): every variant and
     its plain version at 1280x720 4 spp; world 3 at 256 spp and world 1
     at 16 spp, kernel alone and end to end through render_image; worlds
     3, 6 and 4 at 64 spp; worlds 1 and 7 at 64 spp under both schedules,
     alternating (world 7 also end to end through render_image), and world
     1 with --mips; world 2 at 64 spp clustered against the same scene with
     its clusters dropped (brute), alternating; the feature variants and
     the parts they carry, each on the case that exercises it (world 6 and
     world 3 -d in fog; tbn: K10 planar; bump: K11; everything: K4t UV;
     dispersion: the dielectric lobe; world 1 with planar maps); every
     mesh-tier variant at 4 spp with its plain version, and each mesh case
     at 64 spp, with rays per sample and the host seconds of finalize;
     every feature form on another base at 4 spp with its plain version,
     and worlds 1, 7 and 6 in fog at 64 spp under both schedules,
     alternating; every mixed variant at 4 spp with its plain version and
     its case's host seconds of finalize;
  6. bounds: the least time the card could take for each variant's 4-spp
     launch, from FP32 operations counted off the kernel's code and the
     bytes it must move (accumulators; for worlds 1 and 7 also the texture
     and mesh tables). For the clustered variants the slab and sphere tests
     are counted over every ray of the same 4-spp render: the plain version
     renders it, and each bounce's live rays replay the kernel's per-thread
     walk with the port's ray_slab_entry. For the mesh variants the parent,
     cluster and row box tests, the triangle tests and the triangle wins
     are counted the same way, with the port's box test and record tests.
     For the mesh variants the box tests (grandparents, parents, clusters,
     rows; the static tier's clusters), the triangle tests and the triangle
     wins are counted over every ray of the same 4-spp render, the
     static tier's by its walk itself (the plain walk is the kernel's), the
     streamed tiers' against each ray's final nearest hit (the boxes it
     enters before it: a lower count than the kernel's running t gives).
     For the textured and mesh variants the fetches are counted over every
     shaded hit on a textured material (mesh: with a UV winner) whose path
     continues (a lower count). For the feature rows the plain
     regeneration loop's lanes are counted below the depth limit as a
     kernel thread evaluates them: opaque and dielectric shades, fog
     scatters, planar, height, mesh-UV and combined-set fetches; every
     ray's triangle tests and fog flight; on the other bases with the
     base's walk counted as its own rows count it; for the mixed variants
     the same tallies and both walks' tests in one pass (mixed_counts).

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
# K7 in mesh_walk, per triangle test: the three dots of denom, t and the
# two barycentrics' four (20 mul, 14 add), the sub, select and division of
# t, two subs, two muls and two adds of alpha and beta, and six compares
# with the alpha + beta add (47); per box test (parent, cluster or row) as
# OPS_SLAB; the winner's uv (4 mul, 4 add)
OPS_TRI = 47
OPS_MESH_UV = 8
# the DMA tier's walk compares an equal t's winner too (t == best), per
# triangle test; K8's resolve tests the winner again and forms its uv
OPS_TRI_GP = OPS_TRI + 1
OPS_K8_RESOLVE = OPS_TRI + OPS_MESH_UV
# K10 in shade_surface, per mesh-UV fetch: abs, int->float and fractions
# with their clamps (10), 12 channels unpacked (24), three bilinear blends
# (36), the albedo product (3)
OPS_STACK = 73
# The feature variants (fog, transmission, planar and bump maps, brute
# triangles). K4t in intersect_scene, per triangle test (ray_triangle_uv):
# the normal's cross and normalize (20), the plane's dots, test and
# division (21), the hit point (9), the barycentrics' reciprocal, crosses
# and dots (37), six compares with alpha + beta and the take (10)
OPS_TRI_BRUTE = 97
# K10 planar, per fetch_planar: the bespoke scale (6) and fetch_stack
# without the albedo product (70); for a metalness or roughness map only
# the red channel is blended (36)
OPS_PLANAR = 76
OPS_PLANAR_X = 36
# K11 and the bump, per bumped hit: three red-channel fetches with the two
# shifted points (104), the gradient and the normalize (19)
OPS_BUMP = 123
# shade_dielectric, per transmissive hit: the Fresnel and dispersion terms
# (35), Snell's refraction with its normalize (58), the albedo (11)
OPS_REFRACT = 104
# fog, per ray: the free flight and its test (6); per scatter: the phase
# sample in d's frame (92), the light's test and pdf (50), the phase pdf,
# the mixture and the weight (14)
OPS_FOG_FLIGHT = 6
OPS_FOG_SCATTER = 156
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


KERNEL_RE = (r"wave_kernelILb([01])ELb([01])ELi([0-9])ELi([0-9])ELi([0-9])"
             r"ELi([0-9])E")
# ptxas's registers and spill bytes of the forty-two variants as they
# were built before the mixed bases came (phase 2 on the H100, PERF.md's
# findings)
EARLIER_PTXAS = {"brute_pinhole": (64, 0), "brute_lens": (72, 16),
                 "clustered_pinhole": (64, 0), "clustered_lens": (64, 16),
                 "textured_pinhole": (64, 68), "textured_lens": (64, 60),
                 "textured_pinhole_regen": (87, 0), "mesh_pinhole": (56, 84),
                 "mesh_lens": (56, 88), "mesh_pinhole_regen": (64, 112),
                 "feature_pinhole": (80, 0), "feature_lens": (80, 0),
                 "meshplain_pinhole": (48, 124), "meshplain_lens": (40, 212),
                 "meshgp_pinhole": (48, 172), "meshgp_lens": (56, 88),
                 "meshgpplain_pinhole": (40, 224),
                 "meshgpplain_lens": (40, 228), "static_pinhole": (64, 60),
                 "static_lens": (64, 44), "staticplain_pinhole": (64, 28),
                 "staticplain_lens": (64, 28),
                 "staticplain_pinhole_regen": (79, 0),
                 "featclustered_lens": (72, 16),
                 "featclustered_pinhole": (72, 32), "featmesh_lens": (64, 96),
                 "featmesh_pinhole": (64, 100),
                 "featmesh_pinhole_regen": (64, 136),
                 "featmeshgp_lens": (48, 212), "featmeshgp_pinhole": (56, 140),
                 "featmeshgpplain_lens": (48, 192),
                 "featmeshgpplain_pinhole": (56, 144),
                 "featmeshplain_lens": (56, 136),
                 "featmeshplain_pinhole": (56, 140),
                 "featstatic_lens": (72, 44), "featstatic_pinhole": (64, 100),
                 "featstaticplain_lens": (72, 12),
                 "featstaticplain_pinhole": (72, 12),
                 "feattextured_lens": (80, 44),
                 "feattextured_pinhole": (80, 44),
                 "feattextured_pinhole_regen": (92, 0),
                 "feature_pinhole_lockstep": (72, 28)}


def variant_of(mangled: re.Match) -> str:
    """The variant name of wave_kernel<kClustered, kThinLens, kTex, kMesh,
    kFeat, kTri> (kFeat: 0, or the feature form's schedule)."""
    from pathtracer_tpu_torch.render import cuda_backend as cb
    clustered, lens, tex, mesh, feat, tri = mangled.groups()
    end = "_lens" if lens == "1" else "_pinhole"
    spheres = "clustered" if clustered == "1" else "brute"
    kinds = {v: k for k, v in cb.MESH_KINDS.items()}
    parts = ((["clustered"] if clustered == "1" else [])
             + (["textured"] if tex != "0" else [])
             + ([kinds[int(tri)]] if mesh != "0" else []))
    if len(parts) > 1:  # a mixed base: one instantiation, either camera
        return "+".join(parts)
    if tex != "0":
        kind, code, main = "textured", tex, cb.TEXTURED_SCHEDULE
    elif mesh != "0":
        kind, code, main = kinds[int(tri)], mesh, cb.MESH_SCHEDULE
    elif feat != "0":
        kind, code, main = spheres, feat, cb.FEATURE_SCHEDULE
    else:
        return spheres + end
    if feat != "0":
        kind = "feature" if kind == "brute" else "feat" + kind
    sched = {"1": "lockstep", "2": "regen"}[code]
    return kind + end + ("" if sched == main else "_" + sched)


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


def cluster_tally(sc, o, d, m, tally):
    """Adds the slab and sphere tests of the kernel's clustered walk over
    the rays ``m`` of (o, d) to ``tally``: the huge cluster always, a leaf
    only where ray_slab_entry says the ray enters its box before its
    nearest hit so far."""
    import torch
    from pathtracer_tpu_torch.ops.intersect import _sphere_t, ray_slab_entry
    from pathtracer_tpu_torch.utils.vec import Vec3
    far = 3.4028234663852886e38
    rows = torch.nonzero(m).reshape(-1)
    for r0 in range(0, rows.numel(), 1 << 18):  # bounded (rays, spheres)
        idx = rows[r0:r0 + (1 << 18)]
        lo, ld = Vec3(*(c[idx] for c in o)), Vec3(*(c[idx] for c in d))
        t_run = torch.full_like(lo.x, far)
        for off, cnt, mn, mx in sc.sph_clusters:
            hot = torch.ones_like(lo.x, dtype=torch.bool)
            if mn is not None:
                t_enter, hb = ray_slab_entry(lo, ld, mn, mx)
                tally["slabs"] += lo.x.numel()
                hot = hb & (t_enter < t_run)
            tally["spheres"] += cnt * int(hot.sum())
            # the cluster's nearest hit, all its spheres at once: the same
            # value as the kernel's in-order strict-< carry
            t, hit, _ = _sphere_t(
                Vec3(*(c[:, None] for c in lo)),
                Vec3(*(c[:, None] for c in ld)),
                Vec3(*(v[off:off + cnt] for v in sc.csph_center)),
                sc.csph_radius[off:off + cnt])
            t = torch.where(hit, t, far).amin(dim=1)
            t_run = torch.where(hot & (t < t_run), t, t_run)


def walk_tests(scene, cam, cfg, n_samples, dev):
    """(rays, mean slab tests, mean sphere tests per ray) of the kernel's
    clustered walk over every ray of samples 0 .. n_samples-1 of ``cfg``.
    The plain version renders the same rays as the kernel (phase 3 holds
    them to it); each bounce's batch of live rays is caught on its way to
    intersect_scene and walked per ray, as a kernel thread walks it: the
    huge cluster always, a leaf only where ray_slab_entry says the ray
    enters its box before its nearest hit so far."""
    from pathtracer_tpu_torch.render import cuda_backend as cb, wavefront
    from pathtracer_tpu_torch.render.renderer import init_accum

    tally = {"rays": 0, "slabs": 0, "spheres": 0}
    live = {}
    primary, intersect = wavefront._primary_rays, wavefront.intersect_scene

    def primary_caught(camera, config, key, pixel_idx, s):
        live["mask"] = s < n_samples  # lanes with samples left (s0 = 0)
        return primary(camera, config, key, pixel_idx, s)

    def intersect_caught(sc, o, d):
        tally["rays"] += int(live["mask"].sum())
        cluster_tally(sc, o, d, live["mask"], tally)
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

    def shade_caught(sc, o, d, hit, u, **kw):
        out = shade(sc, o, d, hit, u, **kw)
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


def mesh_tally(sc, o, d, m, tally):
    """Adds the mesh walk's box tests, triangle tests and triangle wins over
    the rays ``m`` of (o, d) to ``tally``, each ray walked again after its
    nearest sphere, quad or plane: the static tier by its own walk, which
    is the kernel's, a streamed tier against the ray's final nearest hit."""
    import torch
    from pathtracer_tpu_torch.ops import intersect as isect
    from pathtracer_tpu_torch.utils.vec import Vec3
    for lo in range(0, int(m.sum()), isect._STREAM_RAY_CHUNK):
        idx = torch.nonzero(m).reshape(-1)[lo:lo + isect._STREAM_RAY_CHUNK]
        ro, rd = Vec3(*(c[idx] for c in o)), Vec3(*(c[idx] for c in d))
        best = isect._non_triangles(sc, ro, rd)
        static = not sc.tri_streamed
        h, _, _, won = isect.intersect_triangles(
            sc, ro, rd, best, tally=tally if static else None)
        if not static:
            isect._stream_rows(sc, ro, isect._slab_inverse(rd), h.t, tally)
        tally["wins"] += int(won.sum())


def mesh_counts(scene, cam, cfg, n_samples, dev):
    """Per-ray means of a mesh variant's box tests (grandparents, parents,
    clusters and rows, or the static tier's clusters), triangle tests and
    triangle wins over every ray of samples 0 .. n_samples-1 of ``cfg``,
    the rays, and the mesh-UV texel fetches. The plain regeneration loop
    renders the same rays as the kernel (phase 3 holds them to it); each
    bounce's live rays are caught on their way to the intersect and walked
    again after the nearest sphere, quad or plane: the static tier by its
    own walk, which is the kernel's (exact counts), a streamed tier against
    each ray's final nearest hit (the boxes it enters before that hit, a
    lower count than the kernel's running t gives); each shaded hit whose
    winner is a UV triangle with an albedo map and whose path continues
    counts a fetch."""
    import torch
    from pathtracer_tpu_torch.render import wavefront
    from pathtracer_tpu_torch.render.renderer import init_accum

    tally = dict.fromkeys(("rays", "boxes", "tris", "wins", "fetches"), 0)
    live = {}
    primary, shade = wavefront._primary_rays, wavefront.shade_bounce
    walks = {k: getattr(wavefront, k)
             for k in ("intersect_scene", "intersect_scene_uv")}

    def primary_caught(camera, config, key, pixel_idx, s):
        live["mask"] = s < n_samples  # lanes with samples left (s0 = 0)
        return primary(camera, config, key, pixel_idx, s)

    def caught(name):
        def walk(sc, o, d):
            tally["rays"] += int(live["mask"].sum())
            mesh_tally(sc, o, d, live["mask"], tally)
            return walks[name](sc, o, d)
        return walk

    def shade_caught(sc, o, d, hit, u, uv=None, **kw):
        out = shade(sc, o, d, hit, u, uv=uv, **kw)
        if uv is not None:
            tex = sc.mat_albedo_idx[hit.mat.long()] != 0
            tally["fetches"] += int((live["mask"] & uv[2] & tex
                                     & out.cont).sum())
        return out

    wavefront._primary_rays = primary_caught
    for k in walks:
        setattr(wavefront, k, caught(k))
    wavefront.shade_bounce = shade_caught
    try:
        # the regeneration loop directly: both schedules cast the same rays,
        # and the thin lens has no regen instantiation for the wrapper
        n_pix = cfg.width * cfg.height
        wavefront.render_chunk_wavefront(
            scene, cam, cfg, 0, 0, n_samples, init_accum(n_pix, dev),
            torch.arange(n_pix, device=dev))
    finally:
        wavefront._primary_rays = primary
        for k, f in walks.items():
            setattr(wavefront, k, f)
        wavefront.shade_bounce = shade
    n = tally["rays"]
    return (n, tally["boxes"] / n, tally["tris"] / n, tally["wins"] / n,
            tally["fetches"])


def lat_long_sphere(nlat, nlon, radius=1.0, center=(0.0, 0.0, 1.0)):
    """experiments/accel_crossover.py:51's lat-long sphere with nlat x nlon
    quads, two triangles each, wound outward: a (T, 3, 3) soup."""
    th = np.linspace(0, np.pi, nlat + 1)
    ph = np.linspace(0, 2 * np.pi, nlon + 1)
    P = np.zeros((nlat + 1, nlon + 1, 3), np.float32)
    P[..., 0] = radius * np.outer(np.sin(th), np.cos(ph)) + center[0]
    P[..., 1] = radius * np.outer(np.sin(th), np.sin(ph)) + center[1]
    P[..., 2] = radius * np.outer(np.cos(th), np.ones_like(ph)) + center[2]
    a, b = P[:-1, :-1], P[1:, :-1]
    c, d = P[1:, 1:], P[:-1, 1:]
    return np.stack([np.stack([a, b, c], 2), np.stack([a, c, d], 2)],
                    2).reshape(-1, 3, 3)


def tessellated_sphere(n_target, radius=1.0, center=(0.0, 0.0, 1.0)):
    """accel_crossover's tessellated_sphere: 4 * nlat^2 triangles."""
    nlat = max(4, int(np.sqrt(n_target / 4.0)))
    return lat_long_sphere(nlat, 2 * nlat, radius, center)


MESH_CASES = {  # tag -> (triangles without UVs, or UV-sphere segments/rings)
    "tri40": (lambda: lat_long_sphere(4, 5), None),
    "tri784": (lambda: tessellated_sphere(800), None),
    "uv736": (None, (16, 24)),
    "tri19600": (lambda: tessellated_sphere(19600), None),
    "tri262144": (lambda: tessellated_sphere(262144), None),
    "uv99840": (None, (256, 196)),
}

# The mixed bases' cases (scene/mixed_scenes.py): case -> (mesh case or
# None, mixed_builder's options). A case named by a variant renders through
# it; "textured+brute" (the combined set with a brute mesh) through
# feattextured, "clustered+textured+brute" through clustered+textured's
# K4t sweep, and a case with a second word through its first word's
# variant, with a feature: dispersive glass on every seventh sphere and the
# mesh, or planar albedo and bump maps on the ground. A "textured+" case's
# scene is world 1 (the combined set, no clusters) with the mesh beside
# its spheres; every other is world 2 (its 11x11 spheres in clusters),
# with world 1's combined ground material on its plane where the variant
# names "textured", and the mesh above its grid. The meshes are the mesh
# cases' (and world 7's UV sphere at 1472 triangles, the streamed tier
# with UVs), moved there.
MIXED_MESHES = {**MESH_CASES, "uv1472": (None, (32, 24))}
MIXED_CASES = {
    "clustered+textured": (None, {}),
    "textured+staticplain": ("tri784", {}),
    "textured+meshplain": ("tri19600", {}),
    "textured+meshgpplain": ("tri262144", {}),
    "clustered+mesh": ("uv1472", {}),
    "clustered+meshplain": ("tri19600", {}),
    "clustered+meshgp": ("uv99840", {}),
    "clustered+meshgpplain": ("tri262144", {}),
    "clustered+static": ("uv736", {}),
    "clustered+staticplain": ("tri784", {}),
    "clustered+textured+meshplain": ("tri19600", {}),
    "clustered+textured+meshgpplain": ("tri262144",
                                       {"mesh_material": "ground"}),
    "clustered+textured+staticplain": ("tri784", {"mesh_material": "ground"}),
    "textured+brute": ("tri40", {}),
    "clustered+textured+brute": ("tri40", {}),
    "clustered+textured+staticplain glass": ("tri784", {"glass": True}),
    "clustered+staticplain maps": ("tri784", {"maps": True}),
}


def mixed_variant(case):
    """The variant a mixed case renders through (MIXED_CASES)."""
    var = case.split(" ")[0]
    return {"textured+brute": "feattextured_",
            "clustered+textured+brute": "clustered+textured"}.get(var, var)


def mixed_builder(case):
    """The builder, camera parameters and world kind of a mixed case
    (MIXED_CASES), through scene/mixed_scenes.py with the case's mesh
    generated about its place."""
    from pathtracer_tpu_torch.scene import mixed_scenes, worlds
    from pathtracer_tpu_torch.scene.schema import WORLD_BRDF_TEST, WORLD_DEFAULT
    mesh, opts = MIXED_CASES[case]
    world = WORLD_DEFAULT if case.startswith("textured+") else WORLD_BRDF_TEST
    if mesh is not None:
        (center, radius), (gen, seg) = (mixed_scenes.MESH_AT[world],
                                        MIXED_MESHES[mesh])
        if seg is None:  # the lat-long sphere about (0, 0, 1), radius 1
            tris = ((gen() - np.float32([0.0, 0.0, 1.0])) * np.float32(radius)
                    + np.float32(center))
            mesh = (tris, None)
        else:
            pts, uvs = worlds._uv_sphere_mesh(center, radius, n_seg=seg[0],
                                              n_ring=seg[1])
            mesh = (pts.reshape(-1, 3, 3), uvs)
    b, cp = mixed_scenes.mixed_builder(
        world=world, combined="textured" in case, mesh=mesh, **opts)
    return b, cp, world


FEATURE_KEYS = ("rays", "opaque", "refract", "scatter", "planar", "planar_x",
                "bump", "uv_fetch", "tex_fetch")


def feature_tally(sc, hit, u, uv, out, act, bounce, tally):
    """Adds what the feature bounce evaluates for the lanes ``act`` of one
    bounce to ``tally`` (see feature_counts)."""
    import torch
    from pathtracer_tpu_torch.scene.schema import MAX_BOUNCE_COUNT
    from pathtracer_tpu_torch.utils.vec import sdiv
    m = hit.mat.long()
    tally["rays"] += int(act.sum())
    below = act & (bounce < MAX_BOUNCE_COUNT - 1)
    em = [c[m] for c in sc.mat_emit]
    surface = (hit.mat != 0) & (em[0] == 0) & (em[1] == 0) & (em[2] == 0)
    vol = torch.zeros_like(act)
    if sc.fog_sigma_t > 0.0:
        s_fl = sdiv(-torch.log(torch.clamp_min(1.0 - u[5], 1e-30)),
                    sc.fog_sigma_t)
        vol = s_fl < hit.t
    shaded = below & surface & ~vol
    trans = sc.mat_transmission[m] > 0.0
    opaque, refract = shaded & ~trans, shaded & trans
    front = opaque & out.front_facing
    diffuse = front & (u[0] <= 0.5)
    uv_ok = uv[2] if uv is not None else torch.zeros_like(act)
    alb = sc.mat_albedo_idx[m] != 0
    albedo = (diffuse | refract) & alb
    tally["opaque"] += int(opaque.sum())
    tally["refract"] += int(refract.sum())
    tally["scatter"] += int((below & vol).sum())
    tally["uv_fetch"] += int((albedo & uv_ok).sum())
    if sc.planar_maps:
        planar = albedo & ~uv_ok
        if sc.use_normal_maps:
            planar = planar | (opaque & (sc.mat_normal_idx[m] != 0))
        tally["planar"] += int(planar.sum())
        for on, field in ((sc.use_metalness_maps, sc.mat_metalness_idx),
                          (sc.use_roughness_maps, sc.mat_roughness_idx)):
            if on:
                tally["planar_x"] += int((front & (field[m] != 0)).sum())
    if sc.any_bump and sc.n_textures:
        tally["bump"] += int((opaque & (sc.mat_bump_idx[m] != 0)).sum())
    if sc.tex_combined and sc.n_textures:
        # K9: each opaque shade and dielectric of a combined-set material
        tally["tex_fetch"] += int(((opaque | refract) & alb).sum())


def feature_counts(scene, cam, cfg, n_samples, dev):
    """What the feature kernel evaluates over every ray of samples 0 ..
    n_samples-1 of ``cfg``: rays, and below the depth limit the opaque
    shades, dielectric (refraction) shades and fog scatters, the planar
    fetches (RGB: normal and albedo maps; red only: metalness and roughness
    maps), bumped hits (K11), mesh-UV fetches and combined-set fetches
    (K9). The plain regeneration
    loop renders the same rays as the kernel (phase 3 holds them to it);
    each bounce's lanes are caught in shade_bounce with their bounce index
    and counted as a kernel thread evaluates them (only the estimator its
    coins pick)."""
    import torch
    from pathtracer_tpu_torch.render import wavefront
    from pathtracer_tpu_torch.render.renderer import init_accum
    from pathtracer_tpu_torch.utils import prng

    tally = dict.fromkeys(FEATURE_KEYS, 0)
    live = {}
    primary, draw, shade = (wavefront._primary_rays, prng.bounce_uniforms,
                            wavefront.shade_bounce)

    def primary_caught(camera, config, key, pixel_idx, s):
        live["mask"] = s < n_samples  # lanes with samples left (s0 = 0)
        return primary(camera, config, key, pixel_idx, s)

    def draw_caught(stream, bounce):
        live["bounce"] = bounce
        return draw(stream, bounce)

    def shade_caught(sc, o, d, hit, u, uv=None, **kw):
        out = shade(sc, o, d, hit, u, uv=uv, **kw)
        feature_tally(sc, hit, u, uv, out, live["mask"], live["bounce"], tally)
        return out

    wavefront._primary_rays = primary_caught
    prng.bounce_uniforms = draw_caught
    wavefront.shade_bounce = shade_caught
    try:
        n_pix = cfg.width * cfg.height
        wavefront.render_chunk_wavefront(
            scene, cam, cfg, 0, 0, n_samples, init_accum(n_pix, dev),
            torch.arange(n_pix, device=dev))
    finally:
        wavefront._primary_rays = primary
        prng.bounce_uniforms = draw
        wavefront.shade_bounce = shade
    return tally


def mixed_counts(scene, cam, cfg, n_samples, dev):
    """feature_counts' tallies of a mixed variant's render, with its bases'
    walks counted on the same rays: the clustered walk's slab and sphere
    tests (cluster_tally) and the mesh walk's box tests, triangle tests
    and wins (mesh_tally), all in one pass of the plain regeneration loop
    (both schedules cast the same rays)."""
    import torch
    from pathtracer_tpu_torch.render import cuda_backend as cb, wavefront
    from pathtracer_tpu_torch.render.renderer import init_accum
    from pathtracer_tpu_torch.utils import prng

    tally = dict.fromkeys(FEATURE_KEYS + ("slabs", "spheres", "boxes", "tris",
                                          "wins"), 0)
    live = {}
    primary, draw, shade = (wavefront._primary_rays, prng.bounce_uniforms,
                            wavefront.shade_bounce)
    walks = {k: getattr(wavefront, k)
             for k in ("intersect_scene", "intersect_scene_uv")}

    def primary_caught(camera, config, key, pixel_idx, s):
        live["mask"] = s < n_samples  # lanes with samples left (s0 = 0)
        return primary(camera, config, key, pixel_idx, s)

    def draw_caught(stream, bounce):
        live["bounce"] = bounce
        return draw(stream, bounce)

    def caught(name):
        def walk(sc, o, d):
            if sc.sph_clusters:
                cluster_tally(sc, o, d, live["mask"], tally)
            if cb.meshed(sc):
                mesh_tally(sc, o, d, live["mask"], tally)
            return walks[name](sc, o, d)
        return walk

    def shade_caught(sc, o, d, hit, u, uv=None, **kw):
        out = shade(sc, o, d, hit, u, uv=uv, **kw)
        feature_tally(sc, hit, u, uv, out, live["mask"], live["bounce"], tally)
        return out

    wavefront._primary_rays = primary_caught
    prng.bounce_uniforms = draw_caught
    wavefront.shade_bounce = shade_caught
    for k in walks:
        setattr(wavefront, k, caught(k))
    try:
        n_pix = cfg.width * cfg.height
        wavefront.render_chunk_wavefront(
            scene, cam, cfg, 0, 0, n_samples, init_accum(n_pix, dev),
            torch.arange(n_pix, device=dev))
    finally:
        wavefront._primary_rays = primary
        prng.bounce_uniforms = draw
        wavefront.shade_bounce = shade
        for k, f in walks.items():
            setattr(wavefront, k, f)
    return tally


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
    from pathtracer_tpu_torch.scene.camera import define_camera
    from pathtracer_tpu_torch.scene.feature_scenes import FEATURE_CASES
    from pathtracer_tpu_torch.scene import worlds
    from pathtracer_tpu_torch.scene.schema import (
        WORLD_BRDF_TEST, WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD, WORLD_DEFAULT,
        WORLD_MARIO, WORLD_MESH_UV, WORLD_RAYTRACING_ONE_WEEKEND,
        parent_tables,
    )
    from pathtracer_tpu_torch.scene.textures import REFERENCE_RES_DIR
    from pathtracer_tpu_torch.scene.worlds import build_world, finalize_world

    W3, W6, W2, W4, W1, W7, W5 = (WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD,
                                  WORLD_BRDF_TEST, WORLD_RAYTRACING_ONE_WEEKEND,
                                  WORLD_DEFAULT, WORLD_MESH_UV, WORLD_MARIO)
    OTHER = cb.OTHER_SCHEDULE
    MOTHER = cb.MESH_OTHER_SCHEDULE
    FOTHER = cb.FEATURE_OTHER_SCHEDULE
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

    # the CLI's --fog 0.0012 --fog-albedo 0.9,0.9,0.95 --fog-g 0.5
    FOG = {"fog_sigma_t": 0.0012, "fog_albedo": (0.9, 0.9, 0.95),
           "fog_g": 0.5}

    def feature(name, w, h, lens=False):
        """A feature scene (scene/feature_scenes.py) on the card, its camera
        at w x h and its RenderConfig options (everything: RR)."""
        scene, (pos, target, fov), cfg_kw = FEATURE_CASES[name]()
        return (scene.to(dev), define_camera(pos, target, fov, w, h,
                                             use_pinhole=not lens), cfg_kw)

    def planar_world1(w, h):
        """World 1 with three planar 512x512 maps (albedo, metalness,
        roughness) instead of the combined set: the feature kernel's
        planar fetch over a large stack."""
        b, cp = build_world(W1)
        b.textures = b.textures[:3]
        for m in b.materials:
            m.normal_idx = 0
        _, cam = finalize_world(W1, w, h)
        return b.finalize(view_origin=cp.pos).to(dev), cam

    mesh_built = {}  # tag -> (CPU scene, camera params, finalize s, card)

    def mesh_builder(tag):
        """World 5's builder without its asset plus the mesh case's mesh,
        and its camera parameters."""
        gen, seg = MESH_CASES[tag]
        b, cp = build_world(W5, res_dir=str(ROOT / "no asset here"))
        if seg is None:
            tris = gen()
            m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
            b.set_mesh(tris.reshape(-1, 3),
                       np.full((3 * len(tris),), m, np.int32))
        else:
            pts, uvs = worlds._uv_sphere_mesh((0.0, 0.0, 1.4), 1.4,
                                              n_seg=seg[0], n_ring=seg[1])
            m = b.add_material(
                albedo=(1.0, 1.0, 1.0), roughness=0.55,
                albedo_idx=b.add_texture(worlds._mesh_uv_demo_texture()))
            b.set_mesh(pts, np.full((len(pts),), m, np.int32), uvs=uvs)
        return b, cp

    def mesh_case(tag, w, h, lens=False, cpu=False):
        """(scene on the card, or on the CPU, and its camera at w x h) of a
        mesh case: world 5's builder without its asset plus the case's
        mesh, finalized once (its host seconds kept)."""
        if tag not in mesh_built:
            b, cp = mesh_builder(tag)
            t = time.perf_counter()
            scene = b.finalize(world_kind=W5, view_origin=cp.pos)
            mesh_built[tag] = (scene, cp, time.perf_counter() - t,
                               scene.to(dev))
        scene, cp, _, on_card = mesh_built[tag]
        return (scene if cpu else on_card), define_camera(
            cp.pos, cp.target, cp.fov, w, h, use_pinhole=not lens)

    def resident_twin(scene):
        """A DMA-tier scene without its grandparent level: its parents in
        table order, walked as the resident tier walks them."""
        parents = tuple(sorted(scene.stream_parents))
        return dataclasses.replace(scene, stream_gparents=(), **{
            k: v.to(dev) for k, v in parent_tables(parents).items()})

    def feature_case(tag, w, h, lens=False):
        """(scene, camera, RenderConfig options) of a feature case: a
        feature scene by name, "w6 fog" / "w3 fog" (the CLI's fog on world
        6 or 3), "w1 planar" or the 40-triangle mesh case (K4t)."""
        if tag in FEATURE_CASES:
            return feature(tag, w, h, lens)
        if tag == "w1 planar":
            return (*planar_world1(w, h), {})
        if tag in MESH_CASES:
            return (*mesh_case(tag, w, h, lens), {})
        kind = {"w6 fog": W6, "w3 fog": W3}[tag]
        return (*world(kind, w, h, lens, statics=FOG), {})

    def ground_maps(b):
        """Planar maps on the ground plane's material: world 7's checker as
        its albedo and an 8x8 height field as its bump map (K10 planar,
        K11)."""
        m = b.materials[b.planes[0][2]]
        m.albedo_idx = b.add_texture(worlds._mesh_uv_demo_texture())
        hf = np.repeat(np.random.RandomState(7).rand(8, 8, 1), 3, 2)
        m.bump_idx = b.add_texture((np.round(hf * 255.0) / 255.0)
                                   .astype(np.float32))
        m.bump_scale = 0.5

    BASE_WORLDS = {"w1": W1, "w2": W2, "w3": W3, "w4": W4, "w6": W6,
                   "w7": W7}

    def base_case(tag, w, h, lens=False):
        """(scene on the card, camera at w x h) of the feature bounce on
        another base: "<world> fog" (the CLI's fog on a world), "<mesh
        case> fog", "w1 glass" (world 1's combined-set material as
        dispersive glass), "w2 glass" (every seventh sphere of world 2),
        "w2 maps" and "tri784 maps" (planar albedo and bump maps on the
        ground plane: sphere clusters, the static tier), or "w1 planar"
        (planar_world1: three planar 512x512 maps on world 1)."""
        if tag == "w1 planar":
            return planar_world1(w, h)
        name, what = tag.split(" ")
        if what == "fog" and name in MESH_CASES:
            scene, cam = mesh_case(name, w, h, lens)
            return dataclasses.replace(scene, **FOG), cam
        if what == "fog":
            return world(BASE_WORLDS[name], w, h, lens, statics=FOG)
        if name in MESH_CASES:
            b, cp = mesh_builder(name)
            kind = W5
        else:
            kind = BASE_WORLDS[name]
            b, cp = build_world(kind)
        if what == "maps":
            ground_maps(b)
        elif kind == W2:
            g = b.add_material(albedo=(1.0, 1.0, 1.0), roughness=0.0,
                               ior=1.5, transmission=1.0, dispersion=0.05)
            b.spheres = [(c, r, g if i % 7 == 3 else m)
                         for i, (c, r, m) in enumerate(b.spheres)]
        else:
            for m in b.materials:
                if m.albedo_idx:
                    m.transmission, m.ior, m.dispersion = 1.0, 1.5, 0.05
        scene = b.finalize(world_kind=kind, view_origin=cp.pos).to(dev)
        return scene, define_camera(
            cp.pos, cp.target, cp.fov, w, h, use_pinhole=not lens,
            focal_distance=cp.focal_distance,
            aperture_radius=cp.aperture_radius)

    mixed_built = {}  # case -> (CPU scene, camera params, finalize s, card)

    def mixed_case(case, w, h, lens=False, fog=False, cpu=False):
        """(scene on the card, or on the CPU, and its camera at w x h) of a
        mixed case (MIXED_CASES), in the CLI's fog with ``fog``; finalized
        once (its host seconds kept)."""
        if case not in mixed_built:
            b, cp, kind = mixed_builder(case)
            t = time.perf_counter()
            scene = b.finalize(world_kind=kind, view_origin=cp.pos)
            mixed_built[case] = (scene, cp, time.perf_counter() - t,
                                 scene.to(dev))
        scene, cp, _, on_card = mixed_built[case]
        scene = scene if cpu else on_card
        return (dataclasses.replace(scene, **FOG) if fog else scene,
                define_camera(cp.pos, cp.target, cp.fov, w, h,
                              use_pinhole=not lens,
                              focal_distance=cp.focal_distance,
                              aperture_radius=cp.aperture_radius))

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
    kept = {v: (ptxas[v]["registers"], ptxas[v]["spill_stores"]) == rs
            for v, rs in EARLIER_PTXAS.items()}
    print(f"phase2 build_s={build_s:.3f} nvcc_s={cb.BUILD_SECONDS} "
          f"ptxas={json.dumps(ptxas)}")
    print(f"phase2 earlier_variants_kept_ptxas={json.dumps(kept)} "
          f"all_kept={all(kept.values())}")
    check(all(kept.values()), "the earlier variants kept their registers "
          "and spills")
    print("phase2 new_variants " + json.dumps(
        {v: ptxas[v] for v in cb.VARIANTS if v not in EARLIER_PTXAS}))
    print(f"phase2 sass={json.dumps(sass)}")
    new_vars = [v for v in cb.VARIANTS if v not in EARLIER_PTXAS]

    # --- 3. kernel vs plain on the card ------------------------------------
    print(f"phase3 start_s={time.perf_counter() - t_start}")
    max_err = dict.fromkeys(cb.VARIANTS, 0.0)

    def held(label, scene, cam, cfg, n, s0=0):
        """The kernel against its plain version on the same inputs under
        the verify gates, printed on one line; returns the variant and the
        largest per-pixel |diff|."""
        var = cb.variant(scene, cam, cfg.schedule)
        k = cb.render_chunk_cuda(scene, cam, cfg, 0, s0, n,
                                 init_accum(cfg.width * cfg.height, dev))
        t = time.perf_counter()
        p = cb.render_chunk_plain(scene, cam, cfg, 0, s0, n,
                                  init_accum(cfg.width * cfg.height, dev))
        sync()
        t_plain = time.perf_counter() - t
        d = (resolve(k, cfg) - resolve(p, cfg)).abs().amax(dim=-1)
        f3 = float((d > 1e-3).float().mean())
        f1 = float((d > 0.1).float().mean())
        count_eq = bool(torch.equal(k.count, p.count))
        rk, rp = int(k.rays_cast), int(p.rays_cast)
        err = float(d.max())
        max_err[var] = max(max_err[var], err)
        print(f"phase3 {label} variant={var} {cfg.width}x{cfg.height} "
              f"pp={cfg.pp} samples={s0}-{s0 + n - 1} frac_gt_1e-3={f3} "
              f"frac_gt_0.1={f1} bit_equal={float((d == 0).float().mean())} "
              f"count_equal={count_eq} rays_kernel={rk} rays_plain={rp} "
              f"nan_kernel={int(k.nan_count)} nan_plain={int(p.nan_count)} "
              f"max_abs_err={err} mean={float(resolve(k, cfg).mean())} "
              f"plain_s={t_plain}")
        check(f3 < 0.01 and f1 < 0.001, "kernel vs plain flip fractions")
        check(count_eq, "kernel vs plain valid counts")
        check(abs(rk - rp) <= 0.005 * rp, "kernel vs plain ray counts")
        return var, err

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
            (W7, 256, 144, 2, 0, 4, False, {}),
            (W7, 256, 144, 2, 0, 4, False, {"schedule": MOTHER}),
            (W7, 256, 144, 2, 0, 4, True, {}),
            (W3, 1280, 720, 1, 0, 1, False, {}),
            (W4, 1280, 720, 2, 0, 4, True, {}),
            (W2, 1280, 720, 1, 0, 1, False, {}),
            (W3, 1280, 720, 1, 0, 1, True, {}),
            (W1, 1280, 720, 4, 0, 16, False, {}),
            (W1, 1280, 720, 2, 0, 4, True, {}),
            (W1, 1280, 720, 2, 0, 4, False, {"schedule": OTHER}),
            (W7, 1280, 720, 2, 0, 4, False, {}),
            (W7, 1280, 720, 2, 0, 4, True, {}),
            (W7, 1280, 720, 2, 0, 4, False, {"schedule": MOTHER}),
            (W4, 256, 144, 4, 0, 16, True, {}),
            (W4, 128, 72, 12, 12, 12, True, {})):
        scene, cam = world(kind, w, h, lens, statics=opt.get("statics"))
        cfg = RenderConfig(w, h, pp=pp, seed=0,
                           schedule=opt.get("schedule"),
                           mip_scale=mip_scale(cam, h) if opt.get("mips")
                           else 0.0)
        slots = sorted({(s % pp) * (s // pp) % 12 for s in range(s0, s0 + n)}
                       if lens else ())
        disk_slots.update(slots)
        opts = {k_: v for k_, v in opt.items() if k_ != "statics"}
        opts.update(opt.get("statics") or {})
        held(f"world={kind + 1} options={opts} disk_slots={slots}", scene,
             cam, cfg, n, s0)
    check(disk_slots == set(range(12)), f"Poisson-disk slots {disk_slots}")

    # the feature variants: each feature scene at 256x144 and 1280x720,
    # 4 spp; the CLI's fog on world 6 and on world 3 through the thin lens;
    # world 1 with three planar maps; the mesh tiers: each case at 256x144
    # and 1280x720, 4 spp, through the pinhole and the thin lens (784 under
    # the other schedule too)
    feature_err = {}
    for tag, w, h, lens in (
            *((n, 256, 144, False) for n in FEATURE_CASES),
            ("everything", 256, 144, True),
            *((n, 1280, 720, False) for n in FEATURE_CASES),
            ("w6 fog", 1280, 720, False), ("w3 fog", 1280, 720, True),
            ("w1 planar", 256, 144, False), ("w1 planar", 1280, 720, False)):
        scene, cam, cfg_kw = feature_case(tag, w, h, lens)
        var, err = held(f"feature={tag!r} options={cfg_kw}", scene, cam,
                        RenderConfig(w, h, pp=2, seed=0, **cfg_kw), 4)
        check(var.startswith("feature"), f"{tag} takes the feature kernel")
        feature_err[tag] = max(feature_err.get(tag, 0.0), err)
    for tag, w, h, lens, sched in (
            *((t, 256, 144, ln, None) for t in MESH_CASES
              for ln in (False, True)),
            ("tri784", 256, 144, False, MOTHER),
            *((t, 1280, 720, ln, None) for t in MESH_CASES
              for ln in (False, True)),
            ("tri784", 1280, 720, False, MOTHER)):
        scene, cam = mesh_case(tag, w, h, lens)
        _, err = held(f"mesh={tag} n_tris={scene.n_tris}", scene, cam,
                      RenderConfig(w, h, pp=2, seed=0, schedule=sched), 4)
        feature_err[tag] = max(feature_err.get(tag, 0.0), err)

    # the feature bounce on the other bases (fog, transmission with
    # dispersion, planar and bump maps): each case at 256x144 and 1280x720,
    # 4 spp, through its base's feature variant, the yardstick schedules
    # too
    base_cases = (
        ("w1 fog", False, None), ("w1 fog", True, None),
        ("w1 fog", False, OTHER), ("w1 glass", False, None),
        ("w2 fog", False, None), ("w2 fog", True, None),
        ("w4 fog", True, None), ("w2 glass", False, None),
        ("w2 maps", False, None), ("w7 fog", False, None),
        ("w7 fog", True, None), ("w7 fog", False, MOTHER),
        *((f"{t} fog", ln, None) for t in MESH_CASES for ln in (False, True)),
        ("tri784 maps", False, None), ("w6 fog", False, FOTHER),
        ("w1 planar", False, FOTHER))
    feat_vars = set()
    for tag, lens, sched in base_cases:
        for w, h in ((256, 144), (1280, 720)):
            scene, cam = base_case(tag, w, h, lens)
            feat_vars.add(held(f"base={tag!r}", scene, cam, RenderConfig(
                w, h, pp=2, seed=0, schedule=sched), 4)[0])
    check(feat_vars >= {v for v in cb.VARIANTS if v.startswith("feat")
                        and not v.startswith("feature_")}
          | {f"feature_pinhole_{FOTHER}"}, "every feature base held")

    # the DMA tier's grandparent level is pure pruning: its render equals,
    # bit for bit, the resident walk's over the same parents, in fog too
    for tag in ("tri262144", "uv99840"):
        for fog, (w, h) in ((f, s_) for f in ("", " fog")
                            for s_ in ((256, 144), (1280, 720))):
            scene, cam = (base_case(tag + fog, w, h) if fog
                          else mesh_case(tag, w, h))
            flat = resident_twin(scene)
            cfg = RenderConfig(w, h, pp=2, seed=0)
            out = [cb.render_chunk_cuda(sc, cam, cfg, 0, 0, 4,
                                        init_accum(w * h, dev))
                   for sc in (scene, flat)]
            sync()
            same = (all(torch.equal(a_, b_)
                        for a_, b_ in zip(out[0].sum, out[1].sum))
                    and int(out[0].rays_cast) == int(out[1].rays_cast))
            print(f"phase3 mesh={tag}{fog} {w}x{h} grandparents "
                  f"({cb.variant(scene, cam)}, {len(scene.stream_gparents)} "
                  f"over {len(scene.stream_parents)} parents) vs none "
                  f"({cb.variant(flat, cam)}): bit_equal={same}")
            check(same, f"{tag}{fog}: the grandparent level changed the "
                  "render")

    print(f"phase3 mixed_start_s={time.perf_counter() - t_start}")
    # the mixed bases: each case against its plain version at 256x144
    # and 1280x720, 4 spp, each camera once at each size, once with no
    # feature and once in the CLI's fog: every mixed variant, the combined
    # set with a brute mesh (feattextured) and beside clusters, dispersive
    # glass and planar maps on mixed bases
    for case in MIXED_CASES:
        want = mixed_variant(case)
        for (mw, mh), lens, fog in (((256, 144), False, False),
                                    ((256, 144), True, True),
                                    ((1280, 720), True, False),
                                    ((1280, 720), False, True)):
            scene, cam = mixed_case(case, mw, mh, lens, fog)
            got, _ = held(f"mixed={case!r} lens={lens} fog={fog} "
                          f"n_tris={scene.n_tris}", scene, cam,
                          RenderConfig(mw, mh, pp=2, seed=0), 4)
            check(got == want or want.endswith("_")
                  and got.startswith(want), f"{case}'s case takes {got}")

    # --- 4. the main paths at full width -------------------------------------
    print(f"phase4 start_s={time.perf_counter() - t_start}")
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
                                     (W1, 2, False, OTHER),
                                     (W7, 2, True, None),
                                     (W7, 2, False, MOTHER)):
        var, img, _, state = main_path(kind, pp, lens, schedule)
        check(float(img.mean()) > 0.0, f"world {kind + 1} not black")
        print(f"phase4c world={kind + 1} variant={var} "
              f"launches={launches[var]} spp={pp * pp} "
              f"mean={float(img.mean())} rays={int(state.rays_cast)}")

    # d. the default command: world 1, 1280x720, 16 spp, on the card; e.
    # the world-7 command: 1280x720, 16 spp
    caught = {}
    real_render_image = renderer.render_image

    def render_image_caught(*a, **k):
        caught["out"] = real_render_image(*a, **k)
        return caught["out"]

    def command(argv, bmp):
        """cli.main(argv + ["--out", bmp]) with the launch counts set to 0
        just before it; checks the BMP's size and returns the image (numpy)
        and the accumulator render_image returned."""
        renderer.render_image = render_image_caught
        try:
            reset_counts()
            rc = cli.main(argv + ["--out", str(bmp)])
            sync()
        finally:
            renderer.render_image = real_render_image
        check(rc == 0 and bmp.stat().st_size == 58 + w * h * 4,
              f"{argv} wrote its BMP")
        img, _, state = caught["out"]
        return img.cpu().numpy(), state

    for tag, argv, var, kind in (("4d default command:", [], "textured_pinhole",
                                  W1),
                                 ("4e", ["-w7"], "mesh_pinhole", W7)):
        bmp = ROOT / f"test_w{kind + 1}.bmp"
        img, state = command(argv, bmp)
        read_counts(var, f"{argv} command's")
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.mean()) > 0.05,
              f"finite, non-black world {kind + 1} image")
        print(f"phase{tag} world={kind + 1} variant={var} "
              f"launches={launches[var]} spp=16 "
              f"mean={float(img.mean())} rays={int(state.rays_cast)} "
              f"nan={int(state.nan_count)} wrote {bmp.name} "
              f"bytes={bmp.stat().st_size}")

    # f. the fog CLI, 1280x720, 16 spp: world 6 (the quad form of the
    # volume NEE, feature_pinhole) and world 3 through the thin lens (the
    # sphere form, feature_lens)
    path_launches = {}
    fog_argv = ["--fog", "0.0012", "--fog-albedo", "0.9,0.9,0.95",
                "--fog-g", "0.5"]
    for argv, var, tag in ((["-w6"], "feature_pinhole", "w6 fog"),
                           (["-w3", "-d"], "feature_lens", "w3 fog")):
        bmp = ROOT / f"test_fog_w{argv[0][2:]}.bmp"
        img, state = command(argv + fog_argv, bmp)
        read_counts(var, f"{argv} --fog command's")
        path_launches[tag] = cb.VARIANT_LAUNCHES[var]
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.mean()) > 0.01, f"finite, non-black {tag} image")
        print(f"phase4f command={argv + fog_argv} variant={var} "
              f"launches={launches[var]} spp=16 mean={float(img.mean())} "
              f"rays={int(state.rays_cast)} nan={int(state.nan_count)} "
              f"wrote {bmp.name} bytes={bmp.stat().st_size}")

    # g. the five feature scenes through render_image, 1280x720, 16 spp
    for fname in FEATURE_CASES:
        scene, (pos, target, fov), cfg_kw = FEATURE_CASES[fname]()
        cam = define_camera(pos, target, fov, w, h)
        reset_counts()
        img, _, state = render_image(scene, cam, RenderConfig(
            w, h, pp=4, seed=0, **cfg_kw), device="cuda")
        sync()
        read_counts("feature_pinhole", f"the {fname} scene's")
        path_launches[fname] = cb.VARIANT_LAUNCHES["feature_pinhole"]
        img = img.cpu().numpy()
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.max()) > 0.0, f"finite, non-black {fname} image")
        print(f"phase4g scene={fname} variant=feature_pinhole "
              f"launches={path_launches[fname]} spp=16 options={cfg_kw} "
              f"mean={float(img.mean())} max={float(img.max())} "
              f"rays={int(state.rays_cast)} nan={int(state.nan_count)}")

    # h. the world-5 command, 1280x720, 16 spp: mario.glb where res/ has
    # it (its mesh through its tier's variant), else ground, sky and sun
    w5_scene, w5_cam = finalize_world(W5, w, h)
    var = cb.variant(w5_scene, w5_cam)
    bmp = ROOT / "test_w5.bmp"
    img, state = command(["-w5"], bmp)
    # (its variant's row keeps the count of its own main path)
    check(cb.VARIANT_LAUNCHES[var] == cb.LAUNCHES > 0,
          f"the -w5 command's main path launched {var}")
    w5_launches = cb.VARIANT_LAUNCHES[var]
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
          and float(img.mean()) > 0.01, "finite, non-black world 5 image")
    found = (Path(REFERENCE_RES_DIR) / "mario.glb").exists()
    print(f"phase4h command=-w5 mario_glb_found={found} "
          f"n_tris={w5_scene.n_tris} variant={var} launches={w5_launches} "
          f"spp=16 mean={float(img.mean())} rays={int(state.rays_cast)} "
          f"nan={int(state.nan_count)} wrote {bmp.name} "
          f"bytes={bmp.stat().st_size}")

    # i. the mesh cases through render_image, as a user calls it: the 784-,
    # 19,600- and 262,144-triangle ones at 16 spp, and every other mesh-tier
    # variant's case at 4 spp
    for tag, pp, lens, sched in (
            ("tri784", 4, False, None), ("tri19600", 4, False, None),
            ("tri262144", 4, False, None), ("uv736", 2, False, None),
            ("uv99840", 2, False, None), ("tri40", 2, False, None),
            *((t, 2, True, None) for t in ("tri784", "uv736", "tri19600",
                                           "tri262144", "uv99840")),
            ("tri784", 2, False, MOTHER)):
        scene, cam = mesh_case(tag, w, h, lens, cpu=True)
        cfg = RenderConfig(w, h, pp=pp, seed=0, schedule=sched)
        var = cb.variant(scene, cam, sched)
        reset_counts()
        img, _, state = render_image(scene, cam, cfg, device="cuda")
        sync()
        read_counts(var, f"the {tag} mesh's")
        path_launches[tag] = cb.VARIANT_LAUNCHES[var]
        img = img.cpu().numpy()
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.mean()) > 0.01, f"finite, non-black {tag} image")
        print(f"phase4i mesh={tag} n_tris={scene.n_tris} variant={var} "
              f"launches={launches[var]} spp={pp * pp} "
              f"mean={float(img.mean())} rays={int(state.rays_cast)} "
              f"nan={int(state.nan_count)}")

    # j. the fog commands, 1280x720, 16 spp: the default command (world 1,
    # the combined set under lockstep), -w7 (the streamed walk with UVs),
    # -w4 (clusters, thin lens) and -w2 (clusters, pinhole), each through
    # its base's feature variant. World 4's only light is the sky, which
    # fog occludes (every sky ray scatters), so its image is black, as
    # JAX's is.
    for argv, var in (([], "feattextured_pinhole"),
                      (["-w7"], "featmesh_pinhole"),
                      (["-w4"], "featclustered_lens"),
                      (["-w2"], "featclustered_pinhole")):
        kind = int(argv[0][2:]) if argv else 1
        bmp = ROOT / f"test_fog_w{kind}.bmp"
        img, state = command(argv + fog_argv, bmp)
        read_counts(var, f"{argv} --fog command's")
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and int(state.rays_cast) > w * h * 16,
              f"finite world {kind} image in fog")
        check(float(img.max()) == 0.0 if kind == 4 else
              float(img.mean()) > 0.01, f"world {kind} in fog: brightness")
        print(f"phase4j command={argv + fog_argv} variant={var} "
              f"launches={launches[var]} spp=16 mean={float(img.mean())} "
              f"max={float(img.max())} rays={int(state.rays_cast)} "
              f"nan={int(state.nan_count)} wrote {bmp.name} "
              f"bytes={bmp.stat().st_size}")

    # k. render_image on every other new variant's case, 4 spp: the thin
    # lens and the yardstick schedules of worlds 1, 7 and 6 in fog, and the
    # mesh cases in fog through both cameras
    for tag, lens, sched in (
            ("w1 fog", True, None), ("w1 fog", False, OTHER),
            ("w7 fog", True, None), ("w7 fog", False, MOTHER),
            ("w6 fog", False, FOTHER),
            *((f"{t} fog", ln, None) for t in MESH_CASES if t != "tri40"
              for ln in (False, True))):
        scene, cam = base_case(tag, w, h, lens)
        cfg = RenderConfig(w, h, pp=2, seed=0, schedule=sched)
        var = cb.variant(scene, cam, sched)
        reset_counts()
        img, _, state = render_image(scene, cam, cfg, device="cuda")
        sync()
        read_counts(var, f"the {tag} case's")
        img = img.cpu().numpy()
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.mean()) > 0.01, f"finite, non-black {tag} image")
        print(f"phase4k case={tag!r} variant={var} launches={launches[var]} "
              f"spp=4 mean={float(img.mean())} rays={int(state.rays_cast)} "
              f"nan={int(state.nan_count)}")
    print(f"phase4 mixed_start_s={time.perf_counter() - t_start}")
    # l. the mixed scenes through render_image, 4 spp in one chunk: one
    # launch of each scene's own variant (feattextured_pinhole for the
    # combined set with a brute mesh; its row keeps -w1 --fog's count)
    for case in MIXED_CASES:
        scene, cam = mixed_case(case, w, h, cpu=True)
        var = cb.variant(scene, cam)
        reset_counts()
        img, _, state = render_image(scene, cam, RenderConfig(w, h, pp=2,
                                                              seed=0),
                                     device="cuda")
        sync()
        check(cb.VARIANT_LAUNCHES[var] == cb.LAUNCHES == 1,
              f"{case}: one launch of {var} for its one chunk")
        if var in cb.MIXED_VARIANTS:
            launches[var] = cb.VARIANT_LAUNCHES[var]
        img = img.cpu().numpy()
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.mean()) > 0.01, f"finite, non-black {case} image")
        print(f"phase4l case={case} n_tris={scene.n_tris} "
              f"clusters={len(scene.sph_clusters)} variant={var} "
              f"launches={cb.LAUNCHES} variant_launches="
              f"{json.dumps({k_: v for k_, v in cb.VARIANT_LAUNCHES.items() if v})} "
              f"spp=4 mean={float(img.mean())} rays={int(state.rays_cast)} "
              f"nan={int(state.nan_count)}")
    check(all(launches[v] > 0 for v in new_vars), "every new variant's "
          "main path launched it")

    # --- 5. timing -----------------------------------------------------------
    print(f"phase5 start_s={time.perf_counter() - t_start}")
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

    # (each plain version ran on the same scene at 720p in phase 3: warm)
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
                   f"textured_pinhole_{OTHER}": (W1, False, OTHER),
                   "mesh_pinhole": (W7, False, None),
                   "mesh_lens": (W7, True, None),
                   f"mesh_pinhole_{MOTHER}": (W7, False, MOTHER)}
    # the feature variants, and the TPU kernels and branches they carry,
    # each timed on the case that exercises it: row -> (case, thin lens,
    # name in the kernel table, the JAX code it replaces)
    feature_rows = {
        "feature_pinhole": ("w6 fog", False, "wave_kernel<feature_pinhole>",
                            "pathtracer_tpu/render/pallas_backend.py:169"),
        "feature_lens": ("w3 fog", True, "wave_kernel<feature_lens>",
                         "pathtracer_tpu/render/pallas_backend.py:169"),
        "K10 planar": ("tbn", False,
                       "fetch_planar in wave_kernel<feature_pinhole>",
                       "pathtracer_tpu/ops/texture.py:380"),
        "K11": ("bump", False,
                "fetch_height3 in wave_kernel<feature_pinhole>",
                "pathtracer_tpu/ops/texture.py:461"),
        "K4t UV": ("everything", False,
                   "ray_triangle_uv sweep in wave_kernel<feature_pinhole>",
                   "pathtracer_tpu/ops/intersect.py:1261"),
        "K4t plain": ("tri40", False,
                      "ray_triangle_uv sweep without uv in "
                      "wave_kernel<feature_pinhole>",
                      "pathtracer_tpu/ops/intersect.py:1172"),
        "transmission": ("dispersion", False, None, None),
        "large planar stack": ("w1 planar", False, None, None),
    }
    # the mesh tiers' variants: variant -> (mesh case, thin lens, schedule,
    # the JAX code it replaces)
    tier_rows = {
        "staticplain_pinhole": ("tri784", False, None, "intersect.py:225"),
        "staticplain_lens": ("tri784", True, None, "intersect.py:225"),
        f"staticplain_pinhole_{MOTHER}": ("tri784", False, MOTHER,
                                          "intersect.py:225"),
        "static_pinhole": ("uv736", False, None, "intersect.py:1309"),
        "static_lens": ("uv736", True, None, "intersect.py:1309"),
        "meshplain_pinhole": ("tri19600", False, None, "intersect.py:262"),
        "meshplain_lens": ("tri19600", True, None, "intersect.py:262"),
        "meshgpplain_pinhole": ("tri262144", False, None, "intersect.py:815"),
        "meshgpplain_lens": ("tri262144", True, None, "intersect.py:815"),
        "meshgp_pinhole": ("uv99840", False, None, "intersect.py:815"),
        "meshgp_lens": ("uv99840", True, None, "intersect.py:815"),
    }
    # the feature bounce on the other bases: variant -> (base case, thin
    # lens, schedule, the JAX code it replaces: the loop or walk it runs in)
    new_rows = {
        "featclustered_pinhole": ("w2 fog", False, None,
                                  "ops/intersect.py:225"),
        "featclustered_lens": ("w4 fog", True, None,
                               "ops/intersect.py:225"),
        "feattextured_pinhole": ("w1 fog", False, None,
                                 "render/pallas_backend.py:306"),
        "feattextured_lens": ("w1 fog", True, None,
                              "render/pallas_backend.py:306"),
        f"feattextured_pinhole_{OTHER}": ("w1 fog", False, OTHER,
                                          "render/pallas_backend.py:169"),
        "featmesh_pinhole": ("w7 fog", False, None, "ops/intersect.py:262"),
        "featmesh_lens": ("w7 fog", True, None, "ops/intersect.py:262"),
        f"featmesh_pinhole_{MOTHER}": ("w7 fog", False, MOTHER,
                                       "ops/intersect.py:262"),
        **{f"feat{kind}_{c}": (f"{tag} fog", c == "lens", None,
                               "ops/intersect.py:" + line)
           for tag, kind, line in (("tri784", "staticplain", "225"),
                                   ("uv736", "static", "1309"),
                                   ("tri19600", "meshplain", "262"),
                                   ("tri262144", "meshgpplain", "815"),
                                   ("uv99840", "meshgp", "815"))
           for c in ("pinhole", "lens")},
        f"feature_pinhole_{FOTHER}": ("w6 fog", False, FOTHER,
                                      "render/pallas_backend.py:306"),
    }
    check(sorted([*main_worlds, "feature_pinhole", "feature_lens",
                  *tier_rows, *new_rows, *cb.MIXED_VARIANTS])
          == sorted(cb.VARIANTS), "every variant timed")
    timed = {}
    for var, (kind, lens, schedule) in main_worlds.items():
        scene, cam = world(kind, w, h, lens)
        ks, rays = kernel_ms(scene, cam, 2, 5, schedule=schedule)
        ps, prays = plain_s(scene, cam, 2, schedule=schedule)
        timed[var] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                          cam=cam, plain_ms=1e3 * ps, schedule=schedule)
        print(f"phase5 variant={var} world={kind + 1} 720p spp=4 "
              f"kernel_ms={sorted(ks)} rays={rays} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6}")

    ftimed = {}
    for row, (tag, lens, _, _) in feature_rows.items():
        scene, cam, cfg_kw = feature_case(tag, w, h, lens)
        ks, rays = kernel_ms(scene, cam, 2, 5, **cfg_kw)
        ps, prays = plain_s(scene, cam, 2, **cfg_kw)
        ftimed[row] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                           cam=cam, cfg_kw=cfg_kw, plain_ms=1e3 * ps)
        print(f"phase5 row={row!r} case={tag!r} "
              f"variant={cb.variant(scene, cam)} 720p spp=4 "
              f"kernel_ms={sorted(ks)} rays={rays} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6} "
              f"| card: {smi}")

    ttimed = {}
    for var, (tag, lens, sched, _) in tier_rows.items():
        scene, cam = mesh_case(tag, w, h, lens)
        check(cb.variant(scene, cam, sched) == var, f"{tag} takes {var}")
        ks, rays = kernel_ms(scene, cam, 2, 5, schedule=sched)
        ps, prays = plain_s(scene, cam, 2, schedule=sched)
        ttimed[var] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                           cam=cam, plain_ms=1e3 * ps, schedule=sched)
        print(f"phase5 variant={var} mesh={tag} n_tris={scene.n_tris} "
              f"finalize_s={mesh_built[tag][2]} 720p spp=4 "
              f"kernel_ms={sorted(ks)} rays={rays} "
              f"rays_per_sample={rays / (w * h * 4)} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6} "
              f"| card: {smi}")
    ntimed = {}
    for var, (tag, lens, sched, _) in new_rows.items():
        scene, cam = base_case(tag, w, h, lens)
        check(cb.variant(scene, cam, sched) == var, f"{tag} takes {var}")
        ks, rays = kernel_ms(scene, cam, 2, 5, schedule=sched)
        ps, prays = plain_s(scene, cam, 2, schedule=sched)
        ntimed[var] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                           cam=cam, plain_ms=1e3 * ps)
        print(f"phase5 variant={var} case={tag!r} 720p spp=4 "
              f"kernel_ms={sorted(ks)} rays={rays} "
              f"rays_per_sample={rays / (w * h * 4)} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6} "
              f"| card: {smi}")
    print(f"phase5 mixed_start_s={time.perf_counter() - t_start}")
    mtimed = {}
    for var in cb.MIXED_VARIANTS:
        scene, cam = mixed_case(var, w, h)
        ks, rays = kernel_ms(scene, cam, 2, 5)
        ps, prays = plain_s(scene, cam, 2)
        mtimed[var] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                           cam=cam, plain_ms=1e3 * ps)
        print(f"phase5 variant={var} n_tris={scene.n_tris} "
              f"finalize_s={mixed_built[var][2]} 720p spp=4 "
              f"kernel_ms={sorted(ks)} rays={rays} "
              f"rays_per_sample={rays / (w * h * 4)} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6} "
              f"| card: {smi}")
    # each mesh case at 64 spp through its main variant
    for tag in MESH_CASES:
        scene, cam = mesh_case(tag, w, h)
        ks, rays = kernel_ms(scene, cam, 8, 3)
        print(f"phase5 mesh={tag} n_tris={scene.n_tris} "
              f"variant={cb.variant(scene, cam)} 64spp kernel_ms={sorted(ks)} "
              f"rays={rays} rays_per_sample={rays / (w * h * 64)} "
              f"mrays_s_median={rays / np.median(ks) / 1e3} | card: {smi}")

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

    def schedules(label, scene, cam, main_s, other, e2e):
        """``scene`` at 720p 64 spp under its two schedules, four launches
        each, alternating; with ``e2e`` also one render_image under each."""
        res, rays_ = {main_s: [], other: []}, {}
        for which in (main_s, other, other, main_s) * 2:
            (ms,), rays_[which] = kernel_ms(scene, cam, 8, 1, schedule=which)
            res[which].append(ms)
        spread = {k_: (max(v) - min(v)) / np.median(v)
                  for k_, v in res.items()}
        e2e_txt = ""
        for which in (main_s, other) if e2e else ():
            sync()
            t = time.perf_counter()
            _, packed, st = render_image(
                scene, cam, RenderConfig(w, h, pp=8, seed=0, schedule=which),
                device="cuda")
            packed.cpu()
            e2e_s = time.perf_counter() - t
            e2e_txt += (f" {which}_render_image_s={e2e_s} {which}_e2e_mrays_s="
                        f"{int(st.rays_cast) / e2e_s / 1e6}")
        print(f"phase5 {label} 64spp "
              f"{main_s}_ms={res[main_s]} {other}_ms={res[other]} "
              f"rays_{main_s}={rays_[main_s]} rays_{other}={rays_[other]} "
              f"{main_s}_mrays_s="
              f"{rays_[main_s] / np.median(res[main_s]) / 1e3} "
              f"{other}_mrays_s={rays_[other] / np.median(res[other]) / 1e3} "
              f"{main_s}_over_{other}="
              f"{np.median(res[main_s]) / np.median(res[other])} "
              f"spread={spread}{e2e_txt} | card: {smi}")

    # worlds 1 and 7 at 64 spp, and in fog with world 6 (the brute feature
    # form): the two schedules, alternating
    schedules("world=1", timed["textured_pinhole"]["scene"],
              timed["textured_pinhole"]["cam"], cb.TEXTURED_SCHEDULE, OTHER,
              False)
    schedules("world=7", timed["mesh_pinhole"]["scene"],
              timed["mesh_pinhole"]["cam"], cb.MESH_SCHEDULE, MOTHER, True)
    for tag, main_s, other in (("w1 fog", cb.TEXTURED_SCHEDULE, OTHER),
                               ("w7 fog", cb.MESH_SCHEDULE, MOTHER),
                               ("w6 fog", cb.FEATURE_SCHEDULE, FOTHER),
                               ("w1 planar", cb.FEATURE_SCHEDULE, FOTHER)):
        scene, cam = base_case(tag, w, h)
        schedules(f"case={tag!r} variant={cb.variant(scene, cam)}", scene,
                  cam, main_s, other, False)

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
    print(f"phase6 start_s={time.perf_counter() - t_start}")
    table = []
    mesh_tally = {}
    for var, tm in timed.items():
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0, schedule=tm["schedule"])
        fetches, mesh_txt = 0, ""
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
        if cb.meshed(scene):
            # the lockstep yardstick casts the pinhole's rays: its counts
            if var != f"mesh_pinhole_{MOTHER}":
                mesh_tally[var] = mesh_counts(scene, cam, cfg4, 4, dev)
            mrays, boxes, tris, wins, fetches = mesh_tally[
                "mesh_lens" if var == "mesh_lens" else "mesh_pinhole"]
            check(abs(mrays - tm["rays"]) <= 0.005 * tm["rays"],
                  f"{var}: walked {mrays} rays, the kernel cast {tm['rays']}")
            isect_ops += (OPS_INV + boxes * OPS_SLAB + tris * OPS_TRI
                          + wins * OPS_MESH_UV)
            mesh_txt = (f"box_tests_per_ray={boxes} tri_tests_per_ray={tris} "
                        f"tri_wins_per_ray={wins} ")
        isect_ops += (scene.n_quads * OPS_QUAD + scene.n_planes * OPS_PLANE
                      + OPS_RESOLVE + OPS_EMIT)
        samples = w * h * 4
        rays = tm["rays"]
        # every ray intersects; each path's last ray is not shaded
        ops = (samples * OPS_PRIMARY[var.split("_")[1]] + rays * isect_ops
               + (rays - samples) * OPS_SHADE
               + fetches * (OPS_STACK if cb.meshed(scene) else OPS_TEX))
        nbytes = w * h * BYTES_PER_PIXEL + (
            scene.tex_tile.numel() * 4 if cb.textured(scene) else 0)
        if cb.meshed(scene):
            nbytes += 4 * sum(t.numel() for t in (
                scene.mtri_pack, scene.mtri_bounds, scene.mtri_uvpack,
                scene.stream_pbox, scene.stream_prange, scene.tex_packed))
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        print(f"phase6 variant={var} slab_tests_per_ray={slabs} "
              f"sphere_tests_per_ray={spheres} {mesh_txt}"
              f"tex_fetches={fetches} "
              f"ops={ops:.6e} bytes={nbytes} bound_ms={bound_ms} "
              f"bound_share={bound_ms / tm['ms']}")
        table.append({
            "name": f"wave_kernel<{var}>",
            "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            # K3 for the lockstep textured loop, K9 for the regen one; K7
            # for the mesh variants of the main schedule, K10 for the other
            "replaces": (
                "pathtracer_tpu/ops/intersect.py:262"
                if cb.meshed(scene) and tm["schedule"] is None
                else "pathtracer_tpu/ops/texture.py:391"
                if cb.meshed(scene)
                else "pathtracer_tpu/render/pallas_backend.py:483"
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
    for row, (tag, lens, kname, replaces) in feature_rows.items():
        tm = ftimed[row]
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0, **tm["cfg_kw"])
        fc = feature_counts(scene, cam, cfg4, 4, dev)
        rays = tm["rays"]
        check(abs(fc["rays"] - rays) <= 0.005 * rays,
              f"{row}: counted {fc['rays']} rays, the kernel cast {rays}")
        n_tris = scene.n_tris if scene.tri_brute else 0
        isect_ops = (scene.n_spheres * OPS_SPHERE + scene.n_quads * OPS_QUAD
                     + scene.n_planes * OPS_PLANE + n_tris * OPS_TRI_BRUTE
                     + OPS_RESOLVE + OPS_EMIT
                     + (OPS_FOG_FLIGHT if scene.fog_sigma_t > 0.0 else 0))
        samples = w * h * 4
        ops = (samples * OPS_PRIMARY["lens" if lens else "pinhole"]
               + rays * isect_ops + fc["opaque"] * OPS_SHADE
               + fc["refract"] * OPS_REFRACT
               + fc["scatter"] * OPS_FOG_SCATTER
               + fc["planar"] * OPS_PLANAR + fc["planar_x"] * OPS_PLANAR_X
               + fc["bump"] * OPS_BUMP + fc["uv_fetch"] * OPS_STACK)
        nbytes = w * h * BYTES_PER_PIXEL + 4 * (
            scene.tex_packed.numel() if scene.n_textures else 0) + 4 * 16 * n_tris
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        counts = " ".join(f"{k_}={v}" for k_, v in fc.items())
        print(f"phase6 row={row!r} case={tag!r} {counts} ops={ops:.6e} "
              f"bytes={nbytes} bound_ms={bound_ms} "
              f"bound_share={bound_ms / tm['ms']} | card: {smi}")
        if kname is None:
            continue
        var = "feature_lens" if lens else "feature_pinhole"
        table.append({
            "name": kname, "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            "replaces": replaces,
            "launches": path_launches[tag],
            "max_abs_err": (max_err[var] if row.startswith("feature")
                            else feature_err[tag]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no single PyTorch call computes this
        })
    for var, (tag, lens, sched, replaces) in tier_rows.items():
        tm = ttimed[var]
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0, schedule=sched)
        # the other schedule's yardstick casts the pinhole's rays
        base = var.replace(f"_{MOTHER}", "")
        if base not in mesh_tally:
            mesh_tally[base] = mesh_counts(scene, cam, cfg4, 4, dev)
        mrays, boxes, tris, wins, fetches = mesh_tally[base]
        rays = tm["rays"]
        check(abs(mrays - rays) <= 0.005 * rays,
              f"{var}: walked {mrays} rays, the kernel cast {rays}")
        kind = var.split("_")[0]
        tri_ops = OPS_TRI_GP if kind.startswith("meshgp") else OPS_TRI
        win_ops = (OPS_K8_RESOLVE if kind == "static" else
                   OPS_MESH_UV if scene.has_mesh_uvs else 0)
        isect_ops = (OPS_INV + boxes * OPS_SLAB + tris * tri_ops
                     + wins * win_ops + scene.n_spheres * OPS_SPHERE
                     + scene.n_quads * OPS_QUAD + scene.n_planes * OPS_PLANE
                     + OPS_RESOLVE + OPS_EMIT)
        samples = w * h * 4
        ops = (samples * OPS_PRIMARY["lens" if lens else "pinhole"]
               + rays * isect_ops + (rays - samples) * OPS_SHADE
               + fetches * OPS_STACK)
        tables = (scene.mtri_pack, scene.mtri_bounds, scene.stream_pbox,
                  scene.stream_prange, scene.stream_gbox, scene.stream_grange,
                  *((scene.mtri_uvpack, scene.tex_packed)
                    if scene.has_mesh_uvs else ())) \
            if scene.tri_streamed else (
                *scene.ctri_n, scene.ctri_d, *scene.ctri_e1, scene.ctri_a0,
                *scene.ctri_e2, scene.ctri_b0, scene.ctri_mat, scene.tcl_box,
                scene.tcl_range,
                *((scene.ctri_uv0u, scene.ctri_uv0v, scene.ctri_uvdu1,
                   scene.ctri_uvdv1, scene.ctri_uvdu2, scene.ctri_uvdv2,
                   scene.tex_packed) if scene.has_mesh_uvs else ()))
        nbytes = w * h * BYTES_PER_PIXEL + 4 * sum(t.numel() for t in tables)
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        print(f"phase6 variant={var} mesh={tag} box_tests_per_ray={boxes} "
              f"tri_tests_per_ray={tris} tri_wins_per_ray={wins} "
              f"uv_fetches={fetches} ops={ops:.6e} bytes={nbytes} "
              f"bound_ms={bound_ms} bound_share={bound_ms / tm['ms']} "
              f"| card: {smi}")
        table.append({
            "name": f"wave_kernel<{var}>", "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            "replaces": "pathtracer_tpu/ops/" + replaces,
            "launches": launches[var],
            "max_abs_err": max_err[var],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no single PyTorch call computes this
        })
    # the feature bounce on the other bases: the feature counts of each
    # case's rays, with its base's walk counted as the base's rows count it
    # (the yardsticks cast the main schedule's rays: the same counts)
    ncounts = {}
    for var, (tag, lens, sched, replaces) in new_rows.items():
        tm = ntimed[var]
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0)
        if (tag, lens) not in ncounts:
            fc = feature_counts(scene, cam, cfg4, 4, dev)
            base_txt = ""
            if scene.sph_clusters:
                _, slabs, spheres = walk_tests(scene, cam, cfg4, 4, dev)
                base_ops = OPS_INV + slabs * OPS_SLAB + spheres * OPS_SPHERE
                base_txt = (f"slab_tests_per_ray={slabs} "
                            f"sphere_tests_per_ray={spheres}")
            elif cb.meshed(scene):
                _, boxes, tris, wins, _ = mesh_counts(scene, cam, cfg4, 4, dev)
                kind = cb.mesh_kind(scene)
                win_ops = (OPS_K8_RESOLVE if kind == "static" else
                           OPS_MESH_UV if scene.has_mesh_uvs else 0)
                base_ops = (OPS_INV + boxes * OPS_SLAB + wins * win_ops
                            + tris * (OPS_TRI_GP if kind.startswith("meshgp")
                                      else OPS_TRI)
                            + scene.n_spheres * OPS_SPHERE)
                base_txt = (f"box_tests_per_ray={boxes} "
                            f"tri_tests_per_ray={tris} tri_wins_per_ray={wins}")
            else:
                n_tris = scene.n_tris if scene.tri_brute else 0
                base_ops = (scene.n_spheres * OPS_SPHERE
                            + n_tris * OPS_TRI_BRUTE)
            ncounts[(tag, lens)] = (fc, base_ops, base_txt)
        fc, base_ops, base_txt = ncounts[(tag, lens)]
        rays = tm["rays"]
        check(abs(fc["rays"] - rays) <= 0.005 * rays,
              f"{var}: counted {fc['rays']} rays, the kernel cast {rays}")
        isect_ops = (base_ops + scene.n_quads * OPS_QUAD
                     + scene.n_planes * OPS_PLANE + OPS_RESOLVE + OPS_EMIT
                     + OPS_FOG_FLIGHT * (scene.fog_sigma_t > 0.0))
        ops = (w * h * 4 * OPS_PRIMARY["lens" if lens else "pinhole"]
               + rays * isect_ops + fc["opaque"] * OPS_SHADE
               + fc["refract"] * OPS_REFRACT
               + fc["scatter"] * OPS_FOG_SCATTER
               + fc["planar"] * OPS_PLANAR + fc["planar_x"] * OPS_PLANAR_X
               + fc["bump"] * OPS_BUMP + fc["uv_fetch"] * OPS_STACK
               + fc["tex_fetch"] * OPS_TEX)
        tables = ((scene.tex_tile,) if cb.textured(scene) else
                  (scene.tex_packed,) if scene.n_textures else ())
        if scene.tri_streamed:
            tables += (scene.mtri_pack, scene.mtri_bounds, scene.stream_pbox,
                       scene.stream_prange, scene.stream_gbox,
                       scene.stream_grange,
                       *((scene.mtri_uvpack,) if scene.has_mesh_uvs else ()))
        elif cb.meshed(scene):
            tables += (*scene.ctri_n, scene.ctri_d, *scene.ctri_e1,
                       scene.ctri_a0, *scene.ctri_e2, scene.ctri_b0,
                       scene.ctri_mat, scene.tcl_box, scene.tcl_range)
        nbytes = w * h * BYTES_PER_PIXEL + 4 * sum(t.numel() for t in tables)
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        counts = " ".join(f"{k_}={v}" for k_, v in fc.items())
        print(f"phase6 variant={var} case={tag!r} {base_txt} {counts} "
              f"ops={ops:.6e} bytes={nbytes} bound_ms={bound_ms} "
              f"bound_share={bound_ms / tm['ms']} | card: {smi}")
        table.append({
            "name": f"wave_kernel<{var}>", "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            "replaces": "pathtracer_tpu/" + replaces,
            "launches": launches[var],
            "max_abs_err": max_err[var],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no single PyTorch call computes this
        })
    # the mixed bases: one pass counts the feature tallies and both walks
    print(f"phase6 mixed_start_s={time.perf_counter() - t_start}")
    for var, tm in mtimed.items():
        scene, cam = tm["scene"], tm["cam"]
        fc = mixed_counts(scene, cam, RenderConfig(w, h, pp=2, seed=0), 4, dev)
        rays = tm["rays"]
        check(abs(fc["rays"] - rays) <= 0.005 * rays,
              f"{var}: counted {fc['rays']} rays, the kernel cast {rays}")
        n_tris = scene.n_tris if scene.tri_brute else 0
        walk_ops = (fc["slabs"] * OPS_SLAB + fc["spheres"] * OPS_SPHERE
                    if scene.sph_clusters else rays * scene.n_spheres
                    * OPS_SPHERE) + rays * n_tris * OPS_TRI_BRUTE
        tables = (scene.tex_tile,) if cb.textured(scene) else ()
        if cb.meshed(scene):
            kind = cb.mesh_kind(scene)
            win_ops = (OPS_K8_RESOLVE if kind == "static" else
                       OPS_MESH_UV if scene.has_mesh_uvs else 0)
            walk_ops += (rays * OPS_INV + fc["boxes"] * OPS_SLAB
                         + fc["wins"] * win_ops + fc["tris"]
                         * (OPS_TRI_GP if kind.startswith("meshgp")
                            else OPS_TRI))
            tables += ((scene.mtri_pack, scene.mtri_bounds, scene.stream_pbox,
                        scene.stream_prange, scene.stream_gbox,
                        scene.stream_grange,
                        *((scene.mtri_uvpack,) if scene.has_mesh_uvs else ()))
                       if scene.tri_streamed else
                       (*scene.ctri_n, scene.ctri_d, *scene.ctri_e1,
                        scene.ctri_a0, *scene.ctri_e2, scene.ctri_b0,
                        scene.ctri_mat, scene.tcl_box, scene.tcl_range,
                        *((scene.ctri_uv0u, scene.ctri_uv0v, scene.ctri_uvdu1,
                           scene.ctri_uvdv1, scene.ctri_uvdu2,
                           scene.ctri_uvdv2) if scene.has_mesh_uvs else ())))
            if scene.has_mesh_uvs:
                tables += (scene.tex_packed,)
        ops = (w * h * 4 * OPS_PRIMARY["pinhole"] + walk_ops
               + rays * (OPS_INV * bool(scene.sph_clusters)
                         + scene.n_quads * OPS_QUAD
                         + scene.n_planes * OPS_PLANE + OPS_RESOLVE
                         + OPS_EMIT)
               + fc["opaque"] * OPS_SHADE + fc["refract"] * OPS_REFRACT
               + fc["scatter"] * OPS_FOG_SCATTER + fc["uv_fetch"] * OPS_STACK
               + fc["tex_fetch"] * OPS_TEX)
        nbytes = w * h * BYTES_PER_PIXEL + 4 * sum(t.numel() for t in tables)
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        counts = " ".join(f"{k_}={v}" for k_, v in fc.items())
        print(f"phase6 variant={var} {counts} ops={ops:.6e} bytes={nbytes} "
              f"bound_ms={bound_ms} bound_share={bound_ms / tm['ms']} "
              f"| card: {smi}")
        mesh = MIXED_CASES[var][0]
        table.append({
            "name": f"wave_kernel<{var}>", "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            # K3's lockstep loop with the combined set; else the mesh walk
            "replaces": "pathtracer_tpu/" + (
                "render/pallas_backend.py:306" if cb.textured(scene)
                else "ops/intersect.py:" + (
                    "1309" if mesh == "uv736" else "225" if mesh == "tri784"
                    else "262" if mesh in ("tri19600", "uv1472")
                    else "815")),
            "launches": launches[var],
            "max_abs_err": max_err[var],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no single PyTorch call computes this
        })
    check(all(k_["launches"] > 0 for k_ in table), "every variant launched")
    check(sorted({k_["name"] for k_ in table if k_["name"].endswith(">")
                  and " " not in k_["name"]})
          == sorted(f"wave_kernel<{v}>" for v in cb.VARIANTS),
          "every variant in the kernel table")
    print(f"phase6 total_s={time.perf_counter() - t_start}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
