#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (pathtracer_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and no network,
and it imports nothing of JAX. ``python3 chip_smoke.py --parent DIR`` runs
phase 1 and then, instead of the others, times the kernel of another
checkout at DIR (the parent commit, unpacked with git archive) against
this one's in turns (parent_turns: PARENT_ROWS, the Cornell main path's
rows and the rows without quads, K7's and the static tier's rows, and
this kernel against variants of its own source: SOURCE_VARIANTS).

The render kernel csrc/wave_kernel.cu has fifty-two compile-time
variants (cuda_backend.VARIANTS), instantiations of one template in one
build:
untextured, the brute sphere sweep or the clustered walk (K5/K6: the huge
cluster, then one near-first walk over a BVH of the other spheres, each
warp on an 8x4 pixel tile), each with the pinhole or the thin-lens primary
ray; textured (world 1's combined
4-map fetch, K9), the pinhole and the lens under the main sample schedule
(cuda_backend.TEXTURED_SCHEDULE) and the pinhole under the other one (K3
lockstep or K2 regen), its yardstick; mesh (world 7's streamed triangle
walk K7 with the mesh-UV texel fetch K10), the pinhole and the lens under
cuda_backend.MESH_SCHEDULE and the pinhole under the other one; feature
(fog, transmission with dispersion, planar maps through K10's planar form,
bump maps through the height fetch K11, K4t, the brute triangle sweep, as
a near-first walk over a BVH of its precomputed 64-byte records with or
without UVs), the pinhole and the lens under path regeneration; and the
mesh tiers (cuda_backend.MESH_KINDS), the pinhole and the lens under
cuda_backend.MESH_SCHEDULE: the static tier's walk (K5's triangle form:
the huge cluster, then one near-first walk over a BVH of the other
triangles, each warp on an 8x4 pixel tile; a ray whose winner lies outside
its cluster's box walks again in table order) without UVs (staticplain,
with the pinhole under the other schedule as its yardstick) and with the
winner's uv (K8, static), and the streamed walk without UVs (meshplain);
the streamed walk (K7) is one near-first walk over a BVH of the record rows
for the resident and the DMA tier alike, each warp on an 8x4 pixel tile. The feature bounce also runs on
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
The feature variants without a mesh tier (on brute or clustered spheres,
the combined set, and clusters with the combined set) carry K4t's walk
only in forms of their own, named with "_k4t" (cuda_backend.K4T_VARIANTS),
which a scene with a brute mesh takes.
Every variant with the feature bounce but textured+meshplain regroups
its shading lanes by event each bounce (regroup_shading: each block lays
its fog scatters, opaque shades and glass out in whole warps through
shared memory); the -DWAVE_NO_REGROUP build, where none does, is its
yardstick, built with -DWAVE_BLOCK_LOCKSTEP, where world 1's textured
lockstep pair runs JAX's block-lockstep loop (each bounce's live paths
laid out by lobe before the intersect) instead of the per-warp one.

The mesh cases stand in for world 5's mario.glb, which is not in the
repository: world 5's builder without its asset (ground plane, sun, sky,
camera) plus a lat-long sphere (experiments/accel_crossover.py:51's
tessellated_sphere, a copy here) of 40 triangles without UVs (K4t), 784
(Mario's tier and size: the static tier), 19,600 (the resident streamed
tier) and 262,144 (the DMA tier), or world 7's UV sphere with its checker
at 736 triangles (the static tier with UVs) and 99,840 (the DMA tier with
UVs); with 200 slivers across world 7's 1472-triangle sphere or the
99,840 one (SLIVER_CASES), the streamed tier keeps its uv rows parallel to
its record rows (K7's row-parallel uv form), resident and DMA. The mixed
cases (MIXED_CASES, built by scene/mixed_scenes.py) put those meshes, and
world 7's UV sphere at 1472 triangles (also with slivers), above world 2's
clustered spheres (with world 1's combined ground material on its plane
where the variant names "textured") or beside world 1's spheres, some with
dispersive glass or planar maps.

Phases (each prints its measured values on its own line; any failure raises
and the script exits non-zero):
  1. device: the card's name and power limit;
  2. build: compiles csrc/wave_kernel.cu (one nvcc per build part, all
     started together, and a link) and, beside it, the yardstick, the
     same source with -DWAVE_NO_REGROUP, where every feature variant
     shades each path in its own thread (the parent's code), and
     -DWAVE_BLOCK_LOCKSTEP, where world 1's textured lockstep pair runs
     the block-lockstep loop (YARDSTICK_DEFINES); prints the textured
     variants' registers, spills and blocks per SM beside the parent's
     and the block loop's, the seconds, ptxas's registers and spills for each
     variant (whether every variant without the feature bounce and the
     lens kept the registers and spills it was committed with, KEPT_PTXAS;
     every variant that can cast a lens ray beside the parent's, with
     blocks per SM, PARENT_LENS_PTXAS; the feature variants now, in the
     yardstick, which must keep them but for the variants whose code
     changed (code_changed: this build, every feature variant), and in
     the parent's, FEATURE_EARLIER_PTXAS; the feature
     variants' and the K4t forms' beside the parent's build's,
     PARENT_FEATURE_PTXAS and PARENT_FEATURE_BLOCKS, none of which may
     run fewer blocks per SM than the parent's),
     which variants regroup (regroup_shading), each variant's resident
     blocks per SM, static shared memory and registers in both builds
     (cudaOccupancyMaxActiveBlocksPerMultiprocessor; none may fall) and,
     from cuobjdump, the count of BSSY/BSYNC/WARPSYNC instructions in each
     variant's SASS (``--sass DIR`` also writes the full SASS there), and
     every variant whose code this build changed (code_changed) with its
     registers, spills and blocks per SM beside the parent's
     (PARENT_PTXAS), none with fewer blocks per SM, and the brute
     variants' stack frames beside the parent's (PARENT_STACK); the
     shade's trig (sincos_2pi) against sinf and cosf on all 2^24 values
     of u (cuda_backend.trig_check_cuda), which must agree bit for bit;
     then,
     in the background, the warp tiles' yardstick: the same source with
     -DWAVE_SCANLINE_WARPS, where each warp of the BVH walks' variants
     (the streamed walk's, the sphere clusters' and the static tier's)
     shades 32 pixels of a scanline instead of an 8x4 tile;
  3. kernel vs plain: render_chunk on CUDA tensors (the kernel) against
     render_chunk_plain (eager PyTorch) on the same inputs, gated like
     bench.py --verify (fewer than 1% of pixels with resolved |diff| > 1e-3
     and 0.1% with |diff| > 0.1, equal valid counts, rays within 0.5%;
     each line gives the bit-equal fraction and the differing pixels):
     worlds 3 and 6 at 256x144 16 spp; worlds 4 and 2 and world 3 with the
     thin lens at 256x144 4 spp; world 1 at 256x144 4 spp under both
     schedules, with -d, --mips, --tbn and -nmr; world 7 at 256x144 4 spp
     under both schedules and with -d; every main path of phase 4 at its
     own 1280x720 and spp (world 7's default command, 16 spp, at 4); world
     4 at 256x144 at pp=4 (the CLI's default, samples 0-3) and at pp=12
     over samples 12-23, which reaches all 12 slots of the kernel's
     Poisson-disk table;
     below those main paths, each case at 256x144 with 4 spp and at
     1280x720 with 1 (depth): the five feature scenes
     (scene/feature_scenes.py; everything also through the thin lens), the
     CLI's fog on world 6 and on world 3 with -d, and world 1 with three
     planar 512x512 maps at both sizes and with them cut to 500x300 (no
     power of two: the reciprocal wraps) at both sizes through both
     cameras, through the feature variants; world 1 with its combined
     set cut to 48x40 (COMBINED_CUT: K9's reciprocal wraps, no pyramid)
     through both cameras, with --mips, under the other schedule and as
     dispersive glass in fog, at both sizes; the
     six mesh cases at both sizes, pinhole and thin lens (784 also
     under the other schedule), each through its tier's variant, and the
     two sliver cases (K7's row-parallel uv rows) at 256x144 through both
     cameras and at 1280x720; the BVH walks' cases at 60x34, a size that is
     not a whole number of their 8x4 warp tiles, 4 spp (world 7, the
     19,600-, 262,144- and 99,840-triangle meshes, in fog too, world 7's
     sphere with slivers, worlds 2 and 4, world 2 in fog, the 784- and
     736-triangle static meshes through both cameras, one in fog, and three
     mixed bases); the static tier's exact ties (tie_builder: a grid and a
     copy of it in another material) at 256x144 and 60x34; K4t's exact ties
     (brute_tie_builder: 64 triangles) at 256x144 and 60x34, and the
     kernel's intersect (cuda_backend.intersect_probe_cuda) on 16,384 rays
     aimed at the edges and vertices of the 40-triangle mesh, the ties and
     the everything scene's UV triangles (edge_rays: from the camera, from
     a shell about the mesh, and grazing from 2 to 200 units away) against
     the plain sweep, t, material, normal and uv bit-equal; rays from far
     away (far_edge_rays, far_sphere_rays): the kernel's intersect against
     its plain version on 16,384 rays at the edges and vertices of the
     40-triangle sphere, of its copy scaled to 2 cm (K4t), of the 784- and
     736-triangle meshes (the static tier), moved back 10^2 to 10^5 times
     the mesh's largest coordinate, and aimed at worlds 2's and 4's spheres
     from 10^2 to 10^4 units and grazing 2-cm spheres spread over 60 units
     from near their centre (the sphere clusters), each with the count of
     rays beyond its bound (Scene.bvh_far, sbvh_far), bit-equal, and the
     2-cm sphere rendered through a 0.02-degree camera 200 units away at
     256x144 4 spp; the grazing probe (grazing_rays, moved_back): the
     kernel's intersect against its plain version on rays grazing the
     19,600-triangle sphere's triangles and at its degenerate pole
     triangles from 2 to 10^4 units (K7, two seeds) and on the 144- and
     784-triangle spheres' from 10 to 10^4 times their size (the static
     tier's slivers), bit-equal; the feature
     bounce on the other bases at both sizes
     (base_case): worlds 1
     (pinhole, lens, regen), 2 (pinhole, lens), 4, 7 (pinhole, lens, regen)
     and 6 (lockstep) in the CLI's fog, world 1's combined-set material and
     world 2's spheres as dispersive glass, planar albedo and bump maps on
     world 2 and on the 784-triangle case, every mesh case in fog through
     both cameras; and every mixed case at 256x144 with 2 spp (pinhole
     without features, thin lens in the CLI's fog) and 1280x720 (thin lens
     without features, pinhole in fog): every mixed variant, the
     combined set with the 40-triangle mesh alone and beside clusters,
     dispersive glass on clusters, the combined set and the 784-triangle
     mesh, planar albedo and bump maps beside clusters and that mesh, and
     world 7's sphere with slivers beside clusters; then the count of the
     cases whose every pixel is bit-equal, which must be all; every
     feature variant's and textured lockstep case also through the
     yardstick (the feature bounce in place, the block-lockstep loop),
     whose sums, counts and rays must equal the kernel's;
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
        of its own variant (the sliver cases run in i.);
  5. timing (CUDA events, synchronised; no speed gate): every variant and
     its plain version at 1280x720 4 spp, each row of the BVH walks (the
     streamed walk's, its variants on the DMA meshes and the sliver meshes
     too, the sphere clusters' and the static tier's) beside its earlier
     time
     (EARLIER_MS), each feature variant's row in turns with the
     -DWAVE_NO_REGROUP yardstick (each first in one half of eight
     launches; then each variant's geometric mean over its rows, and
     whether every variant regroup_shading names is the faster), world
     1's textured lockstep rows in turns with the yardstick's
     block-lockstep loop, and each other BVH
     walk's row in turns with the scanline-warp yardstick; world 3 at 256 spp and world 1
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
     are counted over every ray of the same 4-spp render twice: the plain
     version renders it, and each bounce's live rays replay the table-order
     walk with the port's ray_slab_entry (its count) and the card's walk,
     the huge cluster and the sphere BVH, step for step
     (ops/intersect.py::_sphere_bvh_winners: exact); a clustered row's
     bound counts the fewer of the two (sphere_terms), and its bound under
     the earlier definition (the table-order count) is printed beside it.
     For the mesh variants the box
     tests (grandparents, parents, clusters, rows; the static tier's
     clusters), the triangle tests and the triangle wins are counted over
     every ray of the same 4-spp render twice: by the table-order walk (the
     static tier's with its running nearest hit, as JAX walks it; the
     streamed tier's against each ray's final nearest hit, the boxes it
     enters before that hit: a lower count) and by the card's BVH walk,
     exact (ops/intersect.py::_bvh_winners and _static_bvh_winners replay
     it step for step, the static tier's rays walked again in table order
     counted too). A mesh row's bound counts the fewer of the two, over the
     tables the BVH walk reads (k7_terms, static_terms); its bound under
     the earlier definition (the table-order count over that walk's tables)
     is printed beside it.
     For the textured and mesh variants the fetches are counted over every
     shaded hit on a textured material (mesh: with a UV winner) whose path
     continues (a lower count); K9's albedo only where the lane's coin
     picks the diffuse lobe (OPS_TEX_TOP, OPS_TEX_ALBEDO). Beside the
     textured lockstep rows, the lockstep replay of samples 0-1
     (regroup.lockstep_tally: lane use in place, packed and laid out by
     coin, the four lobes' branch runs in place and laid out, the sectors
     of a warp's bounce-0 K9 fetch) over the variant's 8x4 tiles and, for
     the pinhole, scanline warps and JAX's texel sort. For the feature rows the plain
     regeneration loop's lanes are counted below the depth limit as a
     kernel thread evaluates them: opaque and dielectric shades, fog
     scatters, planar, height, mesh-UV and combined-set fetches; every
     ray's fog flight and, with a brute mesh, the box and triangle tests of
     K4t's walk, replayed step for step (ops/intersect.py::
     _brute_bvh_winners: exact), its bound the fewer of the walk's
     operations and the sweep's at OPS_TRI_BRUTE_WALK and the walk's
     tables (brute_terms), its bound under the earlier definition (the
     sweep at OPS_TRI_BRUTE) printed beside it; on the other bases and for the
     mixed variants with the bases' walks counted in the same pass
     (render_counts); and beside each feature row's bound the replay of
     its shading's warp-branch issue in place and regrouped over the
     kernel's warp map, with the share of blocks that regroup
     (render/regroup.py, issue_tally);
  7. the host layer and the unrolled driver (post_phase; files under
     chip_smoke_post/): the default command (world 1, 1280x720, -p4,
     --chunk 4) with --denoise 3 --exposure 1.5 --png --flip xy
     --probe-pixel 640,360 --checkpoint, which must launch wave_kernel once
     per chunk (LAUNCHES set to 0 just before), write a BMP and a PNG of
     the same pixels and print the accumulator's mean at the probe; the
     same render stopped after its first chunk (a progress callback saves
     the checkpoint and raises) and resumed through the CLI's
     --checkpoint, whose BMP must equal the uninterrupted one byte for
     byte, and the compare tool (python -m pathtracer_tpu_torch.compare
     --json) on the two, 100% similar; the denoiser at 720p, 3 iterations,
     on the card against the CPU on the same accumulator (relative |diff|
     < 1e-4), its ms, and checkpoint save and load ms; each debug kind and
     --mode unrolled at 1280x720, 1 spp, on worlds 1 and 3 through the CLI
     (the unrolled driver as torch ops: no launch); at 256x144 each debug
     kind on the card against the CPU, --mode unrolled against the kernel
     at 4 spp and just_importance on world 3 (the plain wavefront) on the
     card against the CPU, under bench.py --verify's gates; the unrolled
     driver's ms per sample at 720p beside the kernel's; --preview (a PNG
     at each of 4 chunks) and --profile's Chrome trace, which must name a
     wave_kernel launch.

  8. the scenes JAX renders on XLA only, as torch ops (xla_phase): a
     784-triangle mesh with the uniform grid, world 1 with a UV mesh (world
     7's sphere at 8 x 12 segments) in its combined ground material and
     world 1 with one of its maps as the ground's bump map, each through
     render_chunk at 256x144, 4 spp, on the card against the CPU (on one
     thread) under bench.py --verify's gates, none
     launching wave_kernel, with the seconds per sample and the grid
     walk's steps; a tessellated sphere of clusters.DMA_MAX + 1 triangles,
     finalized (finalize_s) and binned (build_uniform_grid's seconds),
     rendered at 16x9, 1 spp through the grid walk and through the
     chunked sweep (its peak memory) within the gates of each other, and
     its primary rays' hit or miss and material equal and t within rtol
     1e-6 between the two.
  9. rendering across devices (shard_phase): render_image_sharded over
     [cuda:0] * k, k = 2 and 7 (921,600 pixels do not divide by 7: six
     padding lanes, each a launch of pixel 0), on worlds 3, 1 and 7 at
     1280x720, 4 spp, against render_image: packed images and trimmed
     accumulators equal, rays_cast above it by at most the padding lanes'
     rays, k + padding launches of the world's variant; ms per sample
     beside the one-device render's; the CLI with -t2 over that list and
     with --single-chip, BMP bytes equal; with more than one card, world 3
     across every card.

The last two lines are the kernel table as JSON and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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
# primary_ray: the lens's lens_d - n . pos arrives folded (lens_t0), 6
# fewer than the 82 counted before; its aperture point is a shared load
OPS_PRIMARY = {"pinhole": 49, "lens": 76}
OPS_SPHERE = 35     # ray_sphere + the t < best test
OPS_SLAB = 25       # one leaf cluster's slab test and cull (K5)
OPS_INV = 6         # the slab reciprocals, once per ray
# ray_quad on a quad's record + the t < best test: the plane's dots, test
# and division (14), the hit point (9), the barycentrics' crosses and dots
# (28), four compares, t > 0.02 and t < best (6); the per-test form formed
# d = A . n, cross(u, v), its squared length, the division and w per ray
# too (80, OPS_QUAD_PER_TEST: the main path's rows' earlier bound)
OPS_QUAD = 57
OPS_QUAD_PER_TEST = 80
OPS_PLANE = 16      # ray_plane + the t > 1e-4 and t < best tests
OPS_RESOLVE = 20    # the winner's normal (K6 for clustered spheres)
OPS_EMIT = 9        # emission and the surface test, every ray
OPS_SHADE = 226     # shade_surface, diffuse branch (the common one)
# K9 in shade_surface, per textured hit: the bespoke scale and fractions
# (14), 32 texel channels unpacked (64), 8 bilinear blends (74: 9 each and
# 1 - s, 1 - t once), the normal decode and normalize (17), the map selects
# (5): 174. Split where the shade reads it (PR 18): every textured opaque
# shade blends its metalness, roughness and normal (OPS_TEX_TOP: the scale
# and fractions, 20 channels unpacked, 5 blends, the decode and the
# selects), a lane whose coin picks the diffuse lobe its albedo too
# (OPS_TEX_ALBEDO: 12 channels unpacked, 3 blends), a dielectric its
# albedo alone (OPS_TEX_GLASS: the scale and fractions, 1 - s and 1 - t,
# the albedo)
OPS_TEX = 174
OPS_TEX_TOP = 14 + 40 + 47 + 17 + 5
OPS_TEX_ALBEDO = 24 + 27
OPS_TEX_GLASS = 14 + 2 + OPS_TEX_ALBEDO
# K7 in mesh_walk, per triangle test: the three dots of denom, t and the
# two barycentrics' four (20 mul, 14 add), the sub, select and division of
# t, two subs, two muls and two adds of alpha and beta, and six compares
# with the alpha + beta add (47); per box test (parent, cluster or row) as
# OPS_SLAB; the winner's uv (4 mul, 4 add)
OPS_TRI = 47
OPS_MESH_UV = 8
# the DMA tier's walk compares an equal t's winner too (t == best), per
# triangle test; K8's resolve tested the winner again and formed its uv
# (the static rows' earlier definition, static_terms)
OPS_TRI_GP = OPS_TRI + 1
OPS_K8_RESOLVE = OPS_TRI + OPS_MESH_UV
# K10 in shade_surface, per mesh-UV fetch (fetch_texel, from the planar
# table): abs, int->float and fractions with their clamps (10), 12
# channels unpacked (24), three bilinear blends (36), the albedo product
# (3); the wraps (a mask or the size's reciprocal) are integer work
OPS_STACK = 73
# The feature variants (fog, transmission, planar and bump maps, brute
# triangles). K4t in intersect_scene, per triangle test (ray_triangle_uv):
# the normal's cross and normalize (20), the plane's dots, test and
# division (21), the hit point (9), the barycentrics' reciprocal, crosses
# and dots (37), six compares with alpha + beta and the take (10)
OPS_TRI_BRUTE = 97
# K4t on its walk (brute_walk), per triangle test on a 64-byte record: the
# plane's dots, test and division (16), the hit point (9), the
# barycentrics' crosses and dots (28), six compares with alpha + beta and
# the take (10); its boxes at OPS_SLAB, its slab reciprocals once per ray
# (OPS_INV). The sweep's count (OPS_TRI_BRUTE on every triangle) is the
# earlier definition of the K4t rows' bound (brute_terms).
OPS_TRI_BRUTE_WALK = 63
# K10 planar, per fetch_planar (a normal map, a dielectric's albedo): the
# bespoke scale (6), abs, int->float and fractions with their clamps (10),
# 12 channels unpacked (24), three bilinear blends (36); per planar_maps
# address (a hit's metalness, roughness and albedo maps, one address per
# size): the scale and fractions (16); per map there, the three channels'
# unpacking and blends (60), or the red one's for a metalness or roughness
# map (20). The wraps are integer work and are left out.
OPS_PLANAR = 76
OPS_PLANAR_ADDR = 16
OPS_PLANAR_RGB = 60
OPS_PLANAR_X = 20
# K11 and the bump, per bumped hit (fetch_height3): two columns' and two
# rows' scale, abs, int->float and clamped fraction (28: h(x, y) shares its
# row with h(x + 0.01, y) and its column with h(x, y + 0.01); six before),
# the two shifted points (2), three red-channel unpackings and blends
# (60), the gradient and the normalize (19)
OPS_BUMP = 109
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


KERNEL_RE = (r"wave_kernel(?:_grouped|_b8)?ILb([01])ELb([01])ELi([0-9])ELi([0-9])ELi([0-9])"
             r"ELi([0-9])E")
# ptxas's registers and spill bytes and the resident blocks of 128 threads
# per SM of every variant as the parent commit built them (phase 2 of its
# chip_smoke.py on the H100, H100 80GB HBM3 at 700 W), printed beside this
# build's; no feature variant may run fewer blocks
PARENT_PTXAS = {"brute_pinhole": (63, 0, 8), "brute_lens": (63, 0, 8),
    "clustered_pinhole": (56, 76, 9), "clustered_lens": (56, 76, 9),
    "textured_pinhole": (64, 60, 8), "textured_lens": (72, 0, 7),
    "textured_pinhole_regen": (72, 20, 7), "mesh_pinhole": (56, 128, 9),
    "mesh_lens": (56, 164, 9), "mesh_pinhole_regen": (72, 4, 7),
    "feature_pinhole": (64, 358, 8), "feature_lens": (64, 358, 8),
    "meshplain_pinhole": (64, 28, 8), "meshplain_lens": (64, 28, 8),
    "static_pinhole": (64, 80, 8), "static_lens": (64, 80, 8),
    "staticplain_pinhole": (56, 148, 9), "staticplain_lens": (56, 148, 9),
    "staticplain_pinhole_regen": (72, 0, 7),
    "featclustered_pinhole": (64, 370, 8), "featclustered_lens": (64, 370, 8),
    "feattextured_pinhole": (64, 220, 8), "feattextured_lens": (64, 232, 8),
    "featmesh_pinhole": (64, 364, 8), "featmesh_lens": (64, 344, 8),
    "featmeshplain_pinhole": (64, 358, 8), "featmeshplain_lens": (64, 338, 8),
    "featstatic_pinhole": (64, 364, 8), "featstatic_lens": (64, 356, 8),
    "featstaticplain_pinhole": (64, 338, 8),
    "featstaticplain_lens": (64, 362, 8),
    "feattextured_pinhole_regen": (64, 252, 8),
    "featmesh_pinhole_regen": (64, 372, 8),
    "feature_pinhole_lockstep": (64, 326, 8),
    "clustered+textured": (64, 204, 8), "textured+meshplain": (64, 104, 8),
    "textured+staticplain": (64, 208, 8), "clustered+mesh": (64, 350, 8),
    "clustered+meshplain": (64, 338, 8), "clustered+static": (64, 350, 8),
    "clustered+staticplain": (64, 342, 8),
    "clustered+textured+meshplain": (64, 200, 8),
    "clustered+textured+staticplain": (64, 200, 8),
    "feature_pinhole_k4t": (64, 370, 8), "feature_lens_k4t": (64, 370, 8),
    "featclustered_pinhole_k4t": (64, 386, 8),
    "featclustered_lens_k4t": (64, 366, 8),
    "feattextured_pinhole_k4t": (64, 262, 8),
    "feattextured_lens_k4t": (64, 274, 8),
    "feattextured_pinhole_regen_k4t": (64, 200, 8),
    "feature_pinhole_lockstep_k4t": (64, 362, 8),
    "clustered+textured_k4t": (64, 208, 8)}
# the stack frame bytes ptxas gave the brute variants in the parent's build
PARENT_STACK = {"brute_pinhole": 0, "brute_lens": 0}
PARENT_LENS_PTXAS = {v: r for v, r in PARENT_PTXAS.items()
                     if "_lens" in v and not v.startswith("feat")}
PARENT_FEATURE_PTXAS = {v: r[:2] for v, r in PARENT_PTXAS.items()
                        if v.startswith("feat") or "+" in v}
PARENT_FEATURE_BLOCKS = {v: PARENT_PTXAS[v][2] for v in PARENT_FEATURE_PTXAS}
# the registers and spill bytes this build gives the variants without the
# feature bounce and without a lens ray, which must keep them (a later
# change that moves them says so: PR 18 moved the textured ones, whose K9
# fetch it split and whose lockstep pinhole it put on 8x4 tiles); and the
# feature variants' (kFeat set: the "feat*" and "feature_*" ones and the
# mixed bases) under the parent's -DWAVE_NO_REGROUP yardstick, which those
# whose yardstick code this build left as it was (not yardstick_changed)
# must keep
KEPT_PTXAS = {"brute_pinhole": (63, 0), "clustered_pinhole": (56, 76),
    "textured_pinhole": (64, 48), "textured_pinhole_regen": (64, 96),
    "mesh_pinhole": (56, 128), "mesh_pinhole_regen": (72, 4),
    "meshplain_pinhole": (64, 28), "static_pinhole": (64, 80),
    "staticplain_pinhole": (56, 148), "staticplain_pinhole_regen": (72, 0)}
FEATURE_EARLIER_PTXAS = {"feature_pinhole": (91, 0), "feature_lens": (91, 0),
    # featclustered_lens shades in place on scanline warps there, where the
    # launch's pixel range (lane_lo, lane_hi) took two more registers (93
    # before it; 5 blocks per SM either way)
    "featclustered_pinhole": (93, 0), "featclustered_lens": (95, 0),
    "feattextured_pinhole": (72, 60), "feattextured_lens": (72, 60),
    "featmesh_pinhole": (80, 100), "featmesh_lens": (80, 100),
    "featmeshplain_pinhole": (72, 124), "featmeshplain_lens": (72, 124),
    "featstatic_pinhole": (72, 132), "featstatic_lens": (72, 132),
    "featstaticplain_pinhole": (80, 68), "featstaticplain_lens": (72, 124),
    "feattextured_pinhole_regen": (78, 0), "featmesh_pinhole_regen": (80, 92),
    "feature_pinhole_lockstep": (93, 0), "clustered+textured": (72, 56),
    "textured+meshplain": (64, 104), "textured+staticplain": (64, 120),
    "clustered+mesh": (72, 156), "clustered+meshplain": (72, 124),
    "clustered+static": (72, 148), "clustered+staticplain": (72, 132),
    "clustered+textured+meshplain": (64, 96),
    "clustered+textured+staticplain": (64, 120)}


# the feature variants without a mesh tier: each has a form with K4t's walk
# (cuda_backend.K4T_VARIANTS, named with "_k4t")
K4T_BASES = ("feature_pinhole", "feature_lens", "feature_pinhole_lockstep",
             "featclustered_pinhole", "featclustered_lens",
             "feattextured_pinhole", "feattextured_lens",
             "feattextured_pinhole_regen", "clustered+textured")


def code_changed(var: str) -> bool:
    """Whether a variant's code changed against the parent's, in this build
    and in the -DWAVE_NO_REGROUP yardstick: the textured ones (K9's fetch
    split where the shade reads it; the lockstep pair on 8x4 tiles, the
    lens and the regen pinhole at 8 blocks)."""
    return "textured" in var


def lens_variant(var: str) -> bool:
    """Whether a variant can cast a thin-lens primary ray: the "_lens"
    ones and the mixed bases (the camera picked at run time)."""
    return "_lens" in var or "+" in var


def feature_bounce(var: str) -> bool:
    """Whether a variant's bounce is the feature bounce (kFeat set: the
    feature forms and the mixed bases), the regroup's candidates."""
    return var.startswith("feat") or "+" in var


# the BVH walks' variants that map each warp to a scanline (warp_tiles)
SCANLINE_BVH = ("featclustered_lens", "featstaticplain_pinhole",
                "featstatic_lens")


# world 1's textured lockstep variants, on 8x4 tiles (warp_tiles); under
# -DWAVE_BLOCK_LOCKSTEP through the block-lockstep loop
TEXTURED_LOCKSTEP = ("textured_pinhole", "textured_lens")
# the yardstick build of phases 2, 3 and 5: every feature variant shading
# each path in its own thread, the textured lockstep pair through the
# block-lockstep loop
YARDSTICK_DEFINES = ("WAVE_NO_REGROUP", "WAVE_BLOCK_LOCKSTEP")


def warp_tiles(var: str) -> bool:
    """Whether a variant maps each warp to an 8x4 pixel tile (the kernel's
    warp_tiles), else to 32 pixels of a scanline."""
    return (walks_bvh(var) and var not in SCANLINE_BVH) or var in TEXTURED_LOCKSTEP


# PERF.md's rows of the BVH walks, K7's (the streamed mesh walk), K5's (the
# clustered sphere walk), the static tier's (K5's triangle form, K8) and
# K4t's: row (variant, and its case where the variant's main case differs;
# K4t's by their phase-5 names) -> its median 720p 4-spp kernel ms before
# its walk's BVH (the static tier's rows, and clustered+static*, before the
# static tier's; K4t's rows the sweep's), on an H100 80GB HBM3 at 700 W
# (PERF.md's table)
EARLIER_MS = {
    "K4t plain": 2.384,
    "K4t UV": 2.658,
    "clustered_pinhole": 2.350,
    "clustered_lens": 4.604,
    "featclustered_pinhole": 6.847,
    "featclustered_lens": 9.228,
    "clustered+textured": 3.789,
    "clustered+static": 4.872,
    "clustered+staticplain": 5.210,
    "clustered+textured+staticplain": 4.957,
    "staticplain_pinhole": 2.932,
    "staticplain_lens": 2.972,
    "staticplain_pinhole_regen": 3.192,
    "static_pinhole": 4.926,
    "static_lens": 4.839,
    "featstaticplain_pinhole": 5.140,
    "featstaticplain_lens": 5.212,
    "featstatic_pinhole": 6.237,
    "featstatic_lens": 6.494,
    "textured+staticplain": 3.011,
    "mesh_pinhole": 2.413,
    "mesh_lens": 2.399,
    "mesh_pinhole_regen": 2.946,
    "meshplain_pinhole": 2.594,
    "meshplain_lens": 2.808,
    "meshplain_pinhole tri262144": 4.123,
    "meshplain_lens tri262144": 3.962,
    "mesh_pinhole uv99840": 4.549,
    "mesh_lens uv99840": 4.651,
    "featmesh_pinhole": 5.028,
    "featmesh_lens": 5.802,
    "featmesh_pinhole_regen": 8.168,
    "featmeshplain_pinhole": 4.977,
    "featmeshplain_lens": 5.033,
    "featmeshplain_pinhole tri262144": 6.034,
    "featmeshplain_lens tri262144": 6.034,
    "featmesh_pinhole uv99840": 7.425,
    "featmesh_lens uv99840": 7.734,
    "textured+meshplain": 3.148,
    "textured+meshplain dma": 4.417,
    "clustered+mesh": 4.737,
    "clustered+meshplain": 5.171,
    "clustered+mesh dma": 5.830,
    "clustered+meshplain dma": 6.226,
    "clustered+textured+meshplain": 5.853,
    "clustered+textured+meshplain dma": 6.891,
}


def earlier(row: str) -> str:
    """A BVH walk's row's earlier time, for its phase-5 line ("" for
    another row)."""
    if row not in EARLIER_MS:
        return ""
    return f"earlier_ms={EARLIER_MS[row]} "


def row_name(row: str) -> str:
    """A kernel-table row's name: its variant's kernel, then its case where
    the row is not the variant's own case."""
    var, _, case = row.partition(" ")
    return f"wave_kernel<{var}>" + (f" {case}" if case else "")


def bvh_note(var: str) -> dict:
    """The kernel-table keys that mark the streamed walk (K7), the
    clustered sphere walk (K5) and the static tier's walk redesigned."""
    return ({**({"k7": "redesigned: near-first BVH walk over the record "
                       "rows, 16-byte triangle records, 8x4 warp tiles"}
                if walks_k7(var) else {}),
             **({"k5": "redesigned: the huge cluster, then a near-first BVH "
                       "walk over the other spheres, 16-byte sphere records"}
                if walks_spheres(var) else {}),
             **({"static": "redesigned: the huge cluster, then a near-first "
                           "BVH walk over the other triangles, 16-byte "
                           "triangle records, 8x4 warp tiles; a winner "
                           "outside its cluster's box walks again in table "
                           "order"}
                if walks_static(var) else {})})


def issue_text(issue) -> str:
    """A feature row's replayed warp-branch issue for its phase-6 line."""
    return (f"issue_before={issue['issue_before']} "
            f"issue_after={issue['issue_after']} "
            f"issue_after_over_before="
            f"{issue['issue_after'] / max(issue['issue_before'], 1)} "
            f"blocks_regrouped_share="
            f"{issue['blocks_regrouped'] / max(issue['blocks'], 1)}")


def regroup_note(var: str, issue, regrouped) -> dict:
    """The kernel-table keys of a feature variant's row: whether it
    regroups its shading lanes (``regrouped``: the variants that do), and
    the replay's issue ratio and share of blocks that regroup."""
    if not feature_bounce(var):
        return {}
    return {"regroup": (
        "redesigned: each block regroups its shading lanes by event (fog "
        "scatter, opaque, glass) through shared memory" if var in regrouped
        else "shades each path in its own thread (faster in turns)"),
        "issue_after_over_before": issue["issue_after"]
        / max(issue["issue_before"], 1),
        "blocks_regrouped_share": issue["blocks_regrouped"]
        / max(issue["blocks"], 1)}


def tri_test_ops(scene) -> int:
    """FP32 operations the bound counts per triangle test of a mesh: the
    table-order walk's DMA tier with grandparents compared an equal t's
    winner too, and its rows keep that count so they compare over time."""
    return OPS_TRI_GP if scene.stream_gparents else OPS_TRI


def k7_terms(scene, boxes, tris, bvh_boxes, bvh_tris):
    """The streamed walk's (K7) part of a row's bound: (FP32 operations per
    ray, bytes of the tables it reads) twice. First the bound's own: the
    fewer of the two walks' box and triangle tests per ray (the card's BVH
    walk, exact; the table-order walk's, replayed against each ray's final
    hit), at OPS_SLAB and OPS_TRI, over the tables the BVH walk and the
    resolve read. Then the earlier definition, printed beside it so that
    rows compare with earlier runs: the table-order walk's replayed count at
    tri_test_ops, over the table-order walk's tables. The winners' uv
    operations are the row's own, in neither."""
    size = lambda ts: 4 * sum(t.numel() for t in ts)
    uv = (scene.mtri_uvpack,) if scene.has_mesh_uvs else ()
    bvh = (OPS_INV + min(boxes, bvh_boxes) * OPS_SLAB
           + min(tris, bvh_tris) * OPS_TRI,
           size((scene.bvh_nodes, scene.bvh_tris, scene.bvh_tri_k,
                 scene.mtri_pack, *uv)))
    table_order = (OPS_INV + boxes * OPS_SLAB + tris * tri_test_ops(scene),
                   size((scene.mtri_pack, scene.mtri_bounds,
                         scene.stream_pbox, scene.stream_prange,
                         scene.stream_gbox, scene.stream_grange, *uv)))
    return bvh, table_order


def sphere_terms(scene, slabs, spheres, bvh_slabs, bvh_spheres):
    """The clustered sphere walk's (K5) part of a row's bound, as k7_terms
    gives the streamed walk's: the fewer of the two walks' box and sphere
    tests per ray (the card's walk, the huge cluster and the BVH, exact;
    the table-order walk's, replayed) at OPS_SLAB and OPS_SPHERE, over the
    tables the card's walk and K6's resolve read; then the table-order
    walk's count, the earlier definition, which counted no table bytes."""
    size = lambda ts: 4 * sum(t.numel() for t in ts)
    bvh = (OPS_INV + min(slabs, bvh_slabs) * OPS_SLAB
           + min(spheres, bvh_spheres) * OPS_SPHERE,
           size((scene.sbvh_nodes, scene.sbvh_sph, scene.sbvh_idx,
                 *scene.csph_center, scene.csph_radius, scene.csph_mat)))
    table_order = (OPS_INV + slabs * OPS_SLAB + spheres * OPS_SPHERE, 0)
    return bvh, table_order


def static_terms(scene, boxes, tris, bvh_boxes, bvh_tris, wins):
    """The static tier's walk's part of a row's bound, as k7_terms gives the
    streamed walk's, with the winners' resolve: the fewer of the two walks'
    box and triangle tests per ray (the card's walk, exact, its winner's
    cluster box and any walk again in table order included; the table-order
    walk's, replayed) at OPS_SLAB and OPS_TRI and, with UVs, each winner's
    uv (OPS_MESH_UV), over the tables the card's walk and the resolve read;
    then the earlier definition: the table-order count, K8's resolve
    testing the winner again (OPS_K8_RESOLVE), over the table-order walk's
    tables."""
    size = lambda ts: 4 * sum(t.numel() for t in ts)
    uv = scene.has_mesh_uvs
    uvt = ((scene.ctri_uv0u, scene.ctri_uv0v, scene.ctri_uvdu1,
            scene.ctri_uvdv1, scene.ctri_uvdu2, scene.ctri_uvdv2) if uv
           else ())
    resolve = (*scene.ctri_n, scene.ctri_mat, *uvt)
    bvh = (OPS_INV + min(boxes, bvh_boxes) * OPS_SLAB
           + min(tris, bvh_tris) * OPS_TRI + wins * (OPS_MESH_UV if uv else 0),
           size((scene.bvh_nodes, scene.bvh_tris, scene.bvh_tri_k,
                 scene.tcl_box, scene.tcl_range, *resolve)))
    table_order = (OPS_INV + boxes * OPS_SLAB + tris * OPS_TRI
                   + wins * (OPS_K8_RESOLVE if uv else 0),
                   size((scene.ctri_d, *scene.ctri_e1, scene.ctri_a0,
                         *scene.ctri_e2, scene.ctri_b0, scene.tcl_box,
                         scene.tcl_range, *resolve)))
    return bvh, table_order


def mesh_terms(scene, boxes, tris, bvh_boxes, bvh_tris, wins):
    """A mesh's walk's part of a row's bound: k7_terms' for the streamed
    tier (its winners' uv counted by the row), static_terms' for the static
    tier."""
    if scene.tri_streamed:
        return k7_terms(scene, boxes, tris, bvh_boxes, bvh_tris)
    return static_terms(scene, boxes, tris, bvh_boxes, bvh_tris, wins)


def bound(ops, nbytes):
    """(the least ms for ``ops`` FP32 operations and ``nbytes`` bytes at
    the card's peaks, and which of the two it is)."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def row_bound(ops, nbytes, rays, *walks):
    """A kernel-table row's bound from its FP32 operations and bytes, to
    which each of a BVH walk's rows ``walks`` (k7_terms' or sphere_terms'
    pairs, None for none) adds the walk's part over its ``rays``: (ms,
    "operations" or "bytes", the operations, the bytes, and the bound ms
    under the earlier definition, or None without a walk)."""
    walks = [w for w in walks if w is not None]
    if not walks:
        return (*bound(ops, nbytes), ops, nbytes, None)
    ops_new = ops + rays * sum(w[0][0] for w in walks)
    bytes_new = nbytes + sum(w[0][1] for w in walks)
    ops_old = ops + rays * sum(w[1][0] for w in walks)
    bytes_old = nbytes + sum(w[1][1] for w in walks)
    return (*bound(ops_new, bytes_new), ops_new, bytes_new,
            bound(ops_old, bytes_old)[0])


def k4t_note(k4t, boxes, tris) -> dict:
    """The kernel-table keys of a row whose variant walks a brute mesh
    (``k4t``: brute_terms' pair, None for none): K4t's walk redesigned, its
    box and triangle tests per ray (exact)."""
    if k4t is None:
        return {}
    return {"k4t": "redesigned: precomputed 64-byte triangle records, a "
                   "near-first BVH walk over them, winners the sweep's own",
            "k4t_box_tests_per_ray": boxes, "k4t_tri_tests_per_ray": tris}


def old_bound(ms) -> dict:
    """A BVH walk's row's kernel-table key for its bound under the earlier
    definition (the table-order walks' counts over their tables)."""
    return {} if ms is None else {"bound_ms_table_order": ms}


def walks_k7(var: str) -> bool:
    """Whether a variant walks the streamed tier (K7): a mesh kind that is
    not the static tier's, alone or in a mixed base."""
    return any(part.split("_")[0].removeprefix("feat") in ("mesh", "meshplain")
               for part in var.split("+"))


def walks_static(var: str) -> bool:
    """Whether a variant walks the static tier (K5's triangle form, K8),
    alone or in a mixed base."""
    return any(part.split("_")[0].removeprefix("feat")
               in ("static", "staticplain") for part in var.split("+"))


def walks_bvh(var: str) -> bool:
    """Whether a variant walks a BVH (K7's, the sphere clusters' or the
    static tier's): phase 5 times its rows against the scanline-warp
    build."""
    return walks_k7(var) or walks_spheres(var) or walks_static(var)


def walks_spheres(var: str) -> bool:
    """Whether a variant walks sphere clusters (K5), alone or in a mixed
    base."""
    return var.split("+")[0].split("_")[0].removeprefix("feat") == "clustered"


def variant_of(args) -> str:
    """The variant name of wave_kernel<kClustered, kThinLens, kTex, kMesh,
    kFeat, kTri> (kFeat: 0, or the feature form's schedule), from its six
    template arguments as digit strings."""
    from pathtracer_tpu_torch.render import cuda_backend as cb
    clustered, lens, tex, mesh, feat, tri = args
    end = "_lens" if lens == "1" else "_pinhole"
    spheres = "clustered" if clustered == "1" else "brute"
    kinds = {v: k for k, v in cb.MESH_KINDS.items()}
    parts = ((["clustered"] if clustered == "1" else [])
             + (["textured"] if tex != "0" else [])
             + ([kinds[int(tri)]] if mesh != "0" else []))
    if len(parts) > 1:  # a mixed base: one instantiation, either camera
        return "+".join(parts) + (cb.K4T_SUFFIX if tri == str(cb.K4T_TRI)
                                  else "")
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
    return (kind + end + ("" if sched == main else "_" + sched)
            + (cb.K4T_SUFFIX if tri == str(cb.K4T_TRI) else ""))


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
        stack = re.search(r"(\d+) bytes stack frame", part)
        out[variant_of(m.groups())] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spills.group(1)) if spills else None,
            "stack_frame": int(stack.group(1)) if stack else None,
            "regrouped": "wave_kernel_grouped" in part.split("'", 1)[0]}
    return out


def occupancy_report(lib) -> dict:
    """variant -> [resident blocks of 128 threads per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), static shared memory
    bytes, registers] of each instantiation in the kernel library ``lib``
    (wave_occupancy, asked for every argument tuple wave_render takes)."""
    import ctypes
    import itertools
    out, buf = {}, (ctypes.c_int * 3)()
    for args in itertools.product((0, 1), (0, 1), (0, 1, 2), (0, 1, 2),
                                  (0, 1, 2), (0, 1, 4, 5, 8)):
        if lib.wave_occupancy(*args, buf) != 0:
            continue
        clustered, lens, tex, mesh, feat, tri = args
        # a mixed base's one instantiation serves both cameras (cam_lens)
        mixed = (clustered and (tex or mesh)) or (tex and mesh)
        out[variant_of(tuple(str(a) for a in (
            clustered, 0 if mixed else lens, tex, mesh, feat, tri)))] = list(buf)
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
        var = variant_of(m.groups())
        out[var] = {op: len(re.findall(rf"\b{op}\b", part))
                    for op in ("BSSY", "BSYNC", "WARPSYNC")}
        if dump_dir is not None:
            Path(dump_dir).mkdir(parents=True, exist_ok=True)
            (Path(dump_dir) / f"{var}.sass").write_text(part)
    return out


def cluster_tally(sc, o, d, m, tally):
    """Adds the slab and sphere tests of the clustered walk over the rays
    ``m`` of (o, d) to ``tally`` twice: the table-order walk's ("slabs",
    "spheres": the huge cluster always, a leaf only where ray_slab_entry
    says the ray enters its box before its nearest hit so far) and the
    card's ("bvh_slabs", "bvh_spheres": the huge cluster, then the BVH
    walk step for step, ops/intersect.py::_sphere_bvh_winners)."""
    import torch
    from pathtracer_tpu_torch.ops.intersect import (
        _sphere_bvh_winners, _sphere_t, ray_slab_entry,
    )
    from pathtracer_tpu_torch.utils.vec import Vec3
    far = 3.4028234663852886e38
    rows = torch.nonzero(m).reshape(-1)
    for r0 in range(0, rows.numel(), 1 << 21):  # bounded stacks
        idx = rows[r0:r0 + (1 << 21)]
        counts = {}
        _sphere_bvh_winners(sc, Vec3(*(c[idx] for c in o)),
                            Vec3(*(c[idx] for c in d)),
                            torch.full_like(idx, far, dtype=o.x.dtype), counts)
        tally["bvh_slabs"] = tally.get("bvh_slabs", 0) + counts["boxes"]
        tally["bvh_spheres"] = tally.get("bvh_spheres", 0) + counts["spheres"]
        # rays from beyond the sphere BVH's reach (their boxes widened)
        tally["sph_far"] = tally.get("sph_far", 0) + counts.get("far_rays", 0)
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
    """(rays, mean slab tests and mean sphere tests per ray of the
    table-order walk, the same of the card's walk) of the clustered walk
    over every ray of samples 0 .. n_samples-1 of ``cfg``.
    The plain version renders the same rays as the kernel (phase 3 holds
    them to it); each bounce's batch of live rays is caught on its way to
    intersect_scene and walked per ray by both walks (cluster_tally)."""
    from pathtracer_tpu_torch.render import cuda_backend as cb, wavefront
    from pathtracer_tpu_torch.render.renderer import init_accum

    tally = dict.fromkeys(("rays", "slabs", "spheres", "bvh_slabs",
                           "bvh_spheres", "sph_far"), 0)
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
    return (n, tally["slabs"] / n, tally["spheres"] / n,
            tally["bvh_slabs"] / n, tally["bvh_spheres"] / n,
            tally["sph_far"])


def tex_fetches(scene, cam, cfg, n_samples, dev):
    """(rays, fetches, albedo blends) of a textured render of samples 0 ..
    n_samples-1: the plain lockstep version renders it (phase 3 holds the
    kernel to it), and each bounce's shaded lanes on a textured material
    whose path continues are counted, and those of them whose coin picks
    the diffuse lobe (u[0] <= 0.5: the albedo's blends). Lanes whose path
    ended re-shade their last hit without continuing, so they are not
    counted: a lower count."""
    from pathtracer_tpu_torch.render import cuda_backend as cb, lockstep
    from pathtracer_tpu_torch.render.renderer import init_accum

    tally = {"fetches": 0, "albedo": 0}
    shade = lockstep.shade_bounce

    def shade_caught(sc, o, d, hit, u, **kw):
        out = shade(sc, o, d, hit, u, **kw)
        fetch = (sc.mat_albedo_idx[hit.mat.long()] != 0) & out.cont
        tally["fetches"] += int(fetch.sum())
        tally["albedo"] += int((fetch & (u[0] <= 0.5)).sum())
        return out

    lockstep.shade_bounce = shade_caught
    try:
        st = cb.render_chunk_plain(
            scene, cam, dataclasses.replace(cfg, schedule="lockstep"), 0, 0,
            n_samples, init_accum(cfg.width * cfg.height, dev))
    finally:
        lockstep.shade_bounce = shade
    return int(st.rays_cast), tally["fetches"], tally["albedo"]


def mesh_tally(sc, o, d, m, tally):
    """Adds the mesh walk's box tests, triangle tests and triangle wins over
    the rays ``m`` of (o, d) to ``tally``, each ray walked again after its
    nearest sphere, quad or plane (found for all of them at once): the
    static tier by its table-order walk (JAX's count), a streamed tier
    against the ray's final nearest hit (the table-order walk's lower
    count, the bound's work), in passes of rays. The rays are also kept,
    with that nearest hit, under "bvh_rays" for bvh_tally."""
    import torch
    from pathtracer_tpu_torch.ops import intersect as isect
    from pathtracer_tpu_torch.utils.vec import Vec3
    idx = torch.nonzero(m).reshape(-1)
    ro, rd = Vec3(*(c[idx] for c in o)), Vec3(*(c[idx] for c in d))
    best = isect._non_triangles(sc, ro, rd)
    static = not sc.tri_streamed
    step = 1 << 18 if static else isect._STREAM_RAY_CHUNK
    cut = lambda v, sl: Vec3(*(c[sl] for c in v))
    for lo in range(0, idx.numel(), step):
        sl = slice(lo, lo + step)
        po, pd = cut(ro, sl), cut(rd, sl)
        h, _, _, won = isect.intersect_triangles(
            sc, po, pd, isect.Hit(best.t[sl], best.mat[sl],
                                  cut(best.normal, sl)),
            tally=tally if static else None)
        if not static:
            isect._stream_rows(sc, po, isect._slab_inverse(pd), h.t, tally)
        tally["wins"] += int(won.sum())
    tally.setdefault("bvh_rays", []).append((ro, rd, best.t))


def bvh_tally(sc, tally):
    """Adds the box and triangle tests of the card's BVH walk over the rays
    mesh_tally kept to tally's "bvh_boxes" and "bvh_tris": the walk replayed
    step for step (ops/intersect.py::_bvh_winners, or for the static tier
    _static_bvh_winners, whose rays walked again in table order go to
    "table_rays": exact counts), over all of a render's rays at once."""
    import torch
    from pathtracer_tpu_torch.ops import intersect as isect
    from pathtracer_tpu_torch.utils.vec import Vec3
    rays = tally.pop("bvh_rays", [])
    if not rays:
        return
    cat = lambda k, i: torch.cat([r[k][i] if i is not None else r[k]
                                  for r in rays])
    o = Vec3(*(cat(0, i) for i in range(3)))
    d = Vec3(*(cat(1, i) for i in range(3)))
    t0 = cat(2, None)
    counts = {}
    walk = isect._static_bvh_winners if sc.tri_static else isect._bvh_winners
    for lo in range(0, t0.numel(), 1 << 22):
        sl = slice(lo, lo + (1 << 22))
        walk(sc, Vec3(*(c[sl] for c in o)), Vec3(*(c[sl] for c in d)), t0[sl],
             counts)
    tally["bvh_boxes"] += counts["boxes"]
    tally["bvh_tris"] += counts["tris"]
    tally["table_rays"] = (tally.get("table_rays", 0)
                           + counts.get("table_rays", 0))
    # the static tier's rays from far off, which walk with their boxes
    # widened
    tally["static_far"] = (tally.get("static_far", 0)
                           + counts.get("far_rays", 0))


def brute_tally(sc, o, d, m, tally):
    """Adds the box and triangle tests of the card's K4t walk over the rays
    ``m`` of (o, d), each walked after its nearest sphere, quad or plane,
    to tally's "brute_boxes" and "brute_tris": the walk replayed step for
    step (ops/intersect.py::_brute_bvh_winners: exact counts)."""
    import torch
    from pathtracer_tpu_torch.ops import intersect as isect
    from pathtracer_tpu_torch.utils.vec import Vec3
    idx = torch.nonzero(m).reshape(-1)
    ro, rd = Vec3(*(c[idx] for c in o)), Vec3(*(c[idx] for c in d))
    counts = {}
    isect._brute_bvh_winners(sc, ro, rd, isect._non_triangles(sc, ro, rd).t,
                             counts)
    tally["brute_boxes"] += counts.get("boxes", 0)
    tally["brute_tris"] += counts.get("tris", 0)
    # rays from beyond K4t's bound, which walk with their boxes widened
    tally["brute_far"] = tally.get("brute_far", 0) + counts.get("far_rays", 0)


def brute_terms(scene, boxes, tris):
    """K4t's part of a row's bound, as k7_terms gives the streamed walk's:
    (FP32 operations per ray, bytes of the tables it reads) twice. First
    the bound's own: the fewer of the card's walk's operations (its slab
    reciprocals, ``boxes`` box tests and ``tris`` triangle tests per ray,
    exact: _brute_bvh_winners) and the sweep's (every triangle, no box),
    at OPS_SLAB and OPS_TRI_BRUTE_WALK, over the tables the walk and the
    resolve read. Then the earlier definition, printed beside it so that
    rows compare with earlier runs: the sweep's count at OPS_TRI_BRUTE over
    its 64 bytes a triangle."""
    n = scene.n_tris
    uv = ((scene.tri_uv0u, scene.tri_uv0v, scene.tri_uvdu1, scene.tri_uvdv1,
           scene.tri_uvdu2, scene.tri_uvdv2) if scene.has_mesh_uvs else ())
    size = 4 * sum(t.numel() for t in (scene.bvh_nodes, scene.bvh_tris,
                                       scene.bvh_tri_k, scene.tri_mat, *uv))
    walk = OPS_INV + boxes * OPS_SLAB + tris * OPS_TRI_BRUTE_WALK
    return ((min(walk, n * OPS_TRI_BRUTE_WALK), size),
            (n * OPS_TRI_BRUTE, 4 * 16 * n))


def mesh_counts(scene, cam, cfg, n_samples, dev):
    """The rays, per-ray means of a mesh variant's box tests (grandparents,
    parents, clusters and rows, or the static tier's clusters), triangle
    tests and triangle wins over every ray of samples 0 .. n_samples-1 of
    ``cfg``, the mesh-UV texel fetches, the per-ray box and triangle tests
    of the card's BVH walk, and the rays that walk walked again in table
    order (the static tier). The plain regeneration
    loop renders the same rays as the kernel (phase 3 holds them to it);
    each bounce's live rays are caught on their way to the intersect and
    walked again after the nearest sphere, quad or plane (mesh_tally): the
    static tier by the table-order walk (JAX's count), a streamed tier
    against each ray's final nearest hit by the table-order walk (the boxes
    it enters before that hit: a lower count), and either by the card's
    BVH walk step for step (exact); each shaded hit whose winner is a UV
    triangle with an albedo map and whose path continues counts a fetch."""
    import torch
    from pathtracer_tpu_torch.render import wavefront
    from pathtracer_tpu_torch.render.renderer import init_accum

    tally = dict.fromkeys(("rays", "boxes", "tris", "wins", "fetches",
                           "bvh_boxes", "bvh_tris", "table_rays"), 0)
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
    bvh_tally(scene, tally)
    n = tally["rays"]
    return (n, tally["boxes"] / n, tally["tris"] / n, tally["wins"] / n,
            tally["fetches"], tally["bvh_boxes"] / n, tally["bvh_tris"] / n,
            tally["table_rays"], tally.get("static_far", 0))


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
# world 7's UV sphere at 1472 triangles and at 99,840, each with 200 slivers
# across it (scene/mixed_scenes.py::with_slivers): the huge cluster holds
# 200 triangles, so the streamed tier keeps its uv rows parallel to its
# record rows, resident and in the DMA tier (K7's row-parallel uv form)
SLIVER_CASES = {"uv1472s": (32, 24), "uv99840s": (256, 196)}

# The mixed bases' cases (scene/mixed_scenes.py): case -> (mesh case or
# None, mixed_builder's options). A case named by a variant renders through
# it; a brute mesh (K4t's walk) through the K4t forms: "textured+brute"
# (the combined set) through feattextured's, "clustered+brute" (sphere
# clusters) through featclustered's, "clustered+textured+brute" through
# clustered+textured's; and a case with a second word through its first word's
# variant, with a feature: dispersive glass on every seventh sphere and the
# mesh, or planar albedo and bump maps on the ground. A "textured+" case's
# scene is world 1 (the combined set, no clusters) with the mesh beside
# its spheres; every other is world 2 (its 11x11 spheres in clusters),
# with world 1's combined ground material on its plane where the variant
# names "textured", and the mesh above its grid. The meshes are the mesh
# cases' (and world 7's UV sphere at 1472 triangles, the streamed tier
# with UVs), moved there.
MIXED_MESHES = {**MESH_CASES, "uv1472": (None, (32, 24)),
                "uv1472s": (None, SLIVER_CASES["uv1472s"])}
# the CLI's --fog 0.0012 --fog-albedo 0.9,0.9,0.95 --fog-g 0.5
FOG = {"fog_sigma_t": 0.0012, "fog_albedo": (0.9, 0.9, 0.95), "fog_g": 0.5}
# the CLI's -nmr
NMR = dict(use_normal_maps=False, use_metalness_maps=False,
           use_roughness_maps=False)
# world 1's combined set cut to a size that is no power of two (w, h): no
# pyramid (--mips renders level 0), K9's wraps by the sizes' reciprocals
COMBINED_CUT = (48, 40)


def mip_scale(cam, h):
    """The CLI's --mips constant."""
    return 2.0 * cam.half_film_height / (h * cam.focal_length)


def world1_form(b, tag):
    """World 1's builder ``b`` made into a case's form: "... cut" its four
    maps cut to COMBINED_CUT, "... glass" its combined-set material as
    dispersive glass (K9's albedo in the dielectric lobe)."""
    if "cut" in tag:
        b.textures = [t[:COMBINED_CUT[1], :COMBINED_CUT[0]].copy()
                      for t in b.textures]
    if "glass" in tag:
        for m in b.materials:
            if m.albedo_idx:
                m.transmission, m.ior, m.dispersion = 1.0, 1.5, 0.05
# world 1's three planar maps cut to a size that is no power of two (w, h)
PLANAR_CUT = {"w1 planar500": (500, 300)}
MIXED_CASES = {
    "clustered+textured": (None, {}),
    "textured+staticplain": ("tri784", {}),
    "textured+meshplain": ("tri19600", {}),
    "textured+meshplain dma": ("tri262144", {}),
    "clustered+mesh": ("uv1472", {}),
    "clustered+meshplain": ("tri19600", {}),
    "clustered+mesh dma": ("uv99840", {}),
    "clustered+mesh slivers": ("uv1472s", {}),
    "clustered+meshplain dma": ("tri262144", {}),
    "clustered+static": ("uv736", {}),
    "clustered+staticplain": ("tri784", {}),
    "clustered+textured+meshplain": ("tri19600", {}),
    "clustered+textured+meshplain dma": ("tri262144",
                                         {"mesh_material": "ground"}),
    "clustered+textured+staticplain": ("tri784", {"mesh_material": "ground"}),
    "textured+brute": ("tri40", {}),
    "clustered+brute": ("tri40", {}),
    "clustered+textured+brute": ("tri40", {}),
    "clustered+textured+staticplain glass": ("tri784", {"glass": True}),
    "clustered+staticplain maps": ("tri784", {"maps": True}),
}


def mixed_variant(case):
    """The variant a mixed case renders through (MIXED_CASES); a prefix of
    it ("..._") where the camera names the rest."""
    var = case.split(" ")[0]
    return {"textured+brute": "feattextured_",
            "clustered+brute": "featclustered_",
            "clustered+textured+brute": "clustered+textured_k4t"}.get(var, var)


def mixed_builder(case, tree=None):
    """The builder, camera parameters and world kind of a mixed case
    (MIXED_CASES), through scene/mixed_scenes.py with the case's mesh
    generated about its place; ``tree`` (load_package's) names another
    checkout's package."""
    import importlib
    tree = tree or (lambda sub: importlib.import_module(
        f"pathtracer_tpu_torch.{sub}"))
    mixed_scenes, worlds = tree("scene.mixed_scenes"), tree("scene.worlds")
    schema = tree("scene.schema")
    WORLD_BRDF_TEST, WORLD_DEFAULT = schema.WORLD_BRDF_TEST, schema.WORLD_DEFAULT
    tag, opts = MIXED_CASES[case]
    mesh = tag
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
            if tag in SLIVER_CASES:
                mesh = mixed_scenes.with_slivers(*mesh)
    b, cp = mixed_scenes.mixed_builder(
        world=world, combined="textured" in case, mesh=mesh, **opts)
    return b, cp, world


def brute_tie_builder():
    """World 5's builder without its asset plus a brute mesh (K4t) of exact
    ties, and its camera parameters: a 4 x 4 grid of 0.25-wide cells at z =
    0.5, two triangles a cell sharing their edges, and a copy of every
    triangle in a second material (64 triangles, the most K4t takes). A
    copy's record is its original's, so every hit on the grid ties two
    triangles at one t: the lower table index wins, and a wrong pick shows
    in the other colour."""
    from pathtracer_tpu_torch.scene import schema, worlds
    b, cp = worlds.build_world(schema.WORLD_MARIO,
                               res_dir=str(ROOT / "no asset here"))
    s, n, cells = 0.25, 4, []
    for i in range(n):
        for k in range(n):
            x, y = (i - n / 2) * s, (k - n / 2) * s
            a, bb, c, d = ((x, y, 0.5), (x + s, y, 0.5), (x + s, y + s, 0.5),
                           (x, y + s, 0.5))
            cells += [[a, bb, c], [a, c, d]]
    tris = np.asarray(cells + cells, np.float32)
    red = b.add_material(albedo=(0.8, 0.2, 0.2), roughness=0.6)
    green = b.add_material(albedo=(0.2, 0.8, 0.2), roughness=0.6)
    mats = np.repeat(np.asarray([red] * len(cells) + [green] * len(cells),
                                np.int32), 3)
    b.set_mesh(tris.reshape(-1, 3), mats)
    return b, cp


def edge_rays(A, u, v, eye, n, seed):
    """(n, 6) float32 rays (o.xyz d.xyz) at a brute mesh's triangles A, A +
    u, A + v ((T, 3) float64 each; not at a degenerate one): aimed at a
    vertex, an edge's midpoint or a random point of an edge, a third from
    ``eye`` (the camera), a third from a shell of radius 2 to 8 about the
    mesh, a third grazing the triangle's plane (along or across the edge,
    a normal component of 0 to 1e-3) from 2, 20 or 200 units away."""
    rng = np.random.RandomState(seed)
    B, C = A + u, A + v
    area = np.linalg.norm(np.cross(u, v), axis=1)
    pick = rng.choice(np.nonzero(area > 1e-12)[0], n)
    e = rng.randint(0, 3, n)
    corners = np.stack([A, B, C], 1)[pick]
    p0 = corners[np.arange(n), e]
    p1 = corners[np.arange(n), (e + 1) % 3]
    at = rng.choice([0.0, 0.5, -1.0], n)
    at = np.where(at < 0.0, rng.rand(n), at)[:, None]
    target = p0 + at * (p1 - p0)
    nrm = np.cross(u[pick], v[pick])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    edge = p1 - p0
    across = np.cross(nrm, edge)
    along = np.where((rng.rand(n) < 0.5)[:, None], edge, across)
    along /= np.maximum(np.linalg.norm(along, axis=1, keepdims=True), 1e-30)
    graze = along + nrm * rng.choice([0.0, 1e-5, 1e-3], (n, 1))
    graze /= np.linalg.norm(graze, axis=1, keepdims=True)
    center = (A + B + C).reshape(-1, 3).mean(0) / 3.0
    shell = rng.randn(n, 3)
    shell *= rng.uniform(2.0, 8.0, (n, 1)) / np.linalg.norm(shell, axis=1,
                                                            keepdims=True)
    which = rng.randint(0, 3, n)[:, None]
    o = np.where(which == 0, np.asarray(eye, np.float64),
                 np.where(which == 1, center + shell,
                          target - graze * rng.choice([2.0, 20.0, 200.0],
                                                      (n, 1))))
    d = target - o
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    return np.concatenate([o, d], 1).astype(np.float32)


def far_edge_rays(A, u, v, n, seed):
    """(n, 6) float32 rays at a mesh's edges and vertices (edge_rays, from
    the origin, a shell about the mesh and grazing), each moved back along
    its direction by 10^2, 10^3, 10^4 or 10^5 times the mesh's largest
    coordinate: rays from far away (scene/clusters.py, "A ray from far
    away")."""
    rays = edge_rays(A, u, v, (0.0, 0.0, 0.0), n, seed).astype(np.float64)
    big = np.abs(np.concatenate([A, A + u, A + v])).max()
    k = np.random.RandomState(seed + 1).choice([1e2, 1e3, 1e4, 1e5], n)
    rays[:, 0:3] -= rays[:, 3:6] * (k * big)[:, None]
    return rays.astype(np.float32)


def grazing_rays(tris, n, seed):
    """(n, 6) float32 rays at a mesh's triangles (tris (T, 3, 3)),
    tests/test_torch_static_bvh.py's grazing rays: at points of random
    non-degenerate triangles' edges a few ulps inside or outside them, in
    the triangle's plane along or across the edge with a normal component
    of 0 to 1e-3, from 2 units; a quarter from random points at random
    vertices; and n // 8 more at the degenerate (pole) triangles'
    vertices from 2 units (tests/test_torch_far_rays.py's pole rays)."""
    rng = np.random.RandomState(seed)
    t = tris.astype(np.float64)
    area = np.linalg.norm(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]),
                          axis=1)
    pick = rng.choice(np.nonzero(area > 1e-9)[0], n)
    e = rng.randint(0, 3, n)
    p0, p1 = t[pick, e], t[pick, (e + 1) % 3]
    nrm = np.cross(t[pick, 1] - t[pick, 0], t[pick, 2] - t[pick, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    edge = p1 - p0
    across = np.cross(nrm, edge)
    across /= np.maximum(np.linalg.norm(across, axis=1, keepdims=True), 1e-30)
    q = (p0 + rng.rand(n, 1) * edge
         + across * rng.choice([-1.0, 1.0], (n, 1)) * rng.choice(
             [0.0, 1e-7, 1e-6], (n, 1)))
    d = np.where((rng.rand(n) < 0.5)[:, None], edge, across)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    d += nrm * rng.choice([0.0, 1e-5, 1e-3], (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = q - 2.0 * d
    m = n // 4
    vo = t[pick[:m], e[:m]]
    o[:m] = vo + rng.randn(m, 3) * 2.0
    d[:m] = vo - o[:m]
    d[:m] /= np.linalg.norm(d[:m], axis=1, keepdims=True)
    rays = [np.concatenate([o, d], 1)]
    poles = np.nonzero(area <= 1e-9)[0]
    if len(poles):
        k = n // 8
        sel = rng.choice(poles, k)
        qp = t[sel, rng.randint(0, 3, k)] + rng.randn(k, 3) * 1e-3
        op = qp + rng.randn(k, 3) * 2.0
        dp = qp - op
        dp /= np.linalg.norm(dp, axis=1, keepdims=True)
        rays.append(np.concatenate([op, dp], 1))
    return np.concatenate(rays).astype(np.float32)


def moved_back(rays, dists):
    """``rays`` ((n, 6)) repeated once for each distance of ``dists``, each
    copy moved back along its direction by that distance."""
    out = []
    for dist in dists:
        r = rays.astype(np.float64)
        r[:, 0:3] -= r[:, 3:6] * dist
        out.append(r)
    return np.concatenate(out).astype(np.float32)


# the sphere clusters' far-ray cases: world -> (the centre and extent of
# the box its rays are aimed at)
FAR_SPHERES = {"w2": ((2.5, 2.5, 1.0), (6.0, 6.0, 1.0)),
               "w4": ((0.0, 0.0, 1.5), (22.0, 22.0, 2.0))}


def far_sphere_rays(center, extent, n, seed):
    """(n, 6) float32 rays aimed at random points of a box of spheres from
    10^2, 10^3 or 10^4 units away."""
    rng = np.random.RandomState(seed)
    tgt = (rng.rand(n, 3) - 0.5) * np.asarray(extent) + np.asarray(center)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = tgt - d * rng.choice([1e2, 1e3, 1e4], (n, 1))
    return np.concatenate([o, d], 1).astype(np.float32)


def small_spheres(builder, n=300, r=0.01, width=60.0, seed=3):
    """``n`` spheres of radius ``r`` spread over a ``width`` x ``width`` x 2
    slab about the origin under a sky (tests/test_torch_far_rays.py's):
    their centres (n, 3) float64 and the scene, from a WorldBuilder
    ``builder``. Most lie further from the spheres' centre than their own
    reach (scene/clusters.py::sphere_far_reach, about 362 r), so the sphere
    BVH's reach is negative: every ray walks it widened."""
    rng = np.random.RandomState(seed)
    b = builder()
    b.add_material(emit=(0.2, 0.3, 0.4))
    m = b.add_material(albedo=(0.7,) * 3)
    c = (rng.rand(n, 3) - 0.5) * np.asarray([width, width, 2.0])
    for x in c:
        b.add_sphere(tuple(float(v) for v in x), r, m)
    return c, b.finalize(view_origin=(0.0, 0.0, 0.0))


def graze_sphere_rays(c, z, r, n, seed):
    """(n, 6) float32 rays from within 9 units of ``z`` grazing spheres of
    centres ``c`` and radius ``r`` over 24 units from it, 1 to 1.15 radii
    off their centres."""
    rng = np.random.RandomState(seed)
    aim = np.nonzero(np.linalg.norm(c - z, axis=1) > 24.0)[0]
    c = c[aim[rng.randint(0, len(aim), n)]]
    o = z + (rng.rand(n, 3) - 0.5) * np.asarray([18.0, 18.0, 2.0])
    to_c = (c - o) / np.linalg.norm(c - o, axis=1, keepdims=True)
    side = rng.randn(n, 3)
    side -= (side * to_c).sum(1, keepdims=True) * to_c
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    d = c + side * (r * (1.0 + 0.15 * rng.rand(n, 1))) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([o, d], 1).astype(np.float32)


def tie_builder(tree=None):
    """World 5's builder without its asset plus a static-tier mesh of exact
    ties, and its camera parameters: a 15 x 15 grid of 0.25-wide cells at z
    = 0.5, two triangles a cell sharing their edges, and a copy of every
    triangle in a second material. A copy's record is its original's, so
    every hit on the grid ties two triangles at one t: the lower
    cluster-order index wins, and a wrong pick shows in the other colour.
    World 5's camera, 0.5 above the grid, meets its far rows at grazing
    angles. ``tree`` (load_package's) names another checkout's package."""
    import importlib
    tree = tree or (lambda sub: importlib.import_module(
        f"pathtracer_tpu_torch.{sub}"))
    b, cp = tree("scene.worlds").build_world(
        tree("scene.schema").WORLD_MARIO, res_dir=str(ROOT / "no asset here"))
    s, n, cells = 0.25, 15, []
    for i in range(n):
        for k in range(n):
            x, y = (i - n / 2) * s, (k - n / 2) * s
            a, bb, c, d = ((x, y, 0.5), (x + s, y, 0.5), (x + s, y + s, 0.5),
                           (x, y + s, 0.5))
            cells += [[a, bb, c], [a, c, d]]
    tris = np.asarray(cells + cells, np.float32)
    red = b.add_material(albedo=(0.8, 0.2, 0.2), roughness=0.6)
    green = b.add_material(albedo=(0.2, 0.8, 0.2), roughness=0.6)
    mats = np.repeat(np.asarray([red] * len(cells) + [green] * len(cells),
                                np.int32), 3)
    b.set_mesh(tris.reshape(-1, 3), mats)
    return b, cp


FEATURE_KEYS = ("rays", "opaque", "refract", "scatter", "planar",
                "planar_addr", "planar_rgb", "planar_x", "bump", "uv_fetch",
                "tex_fetch", "tex_albedo", "tex_glass")


def feature_tally(sc, hit, u, uv, out, act, bounce, tally):
    """Adds what the feature bounce evaluates for the lanes ``act`` of one
    bounce to ``tally`` (see render_counts)."""
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
        # fetch_planar: the normal map and a dielectric's albedo
        planar = refract & alb & ~uv_ok
        if sc.use_normal_maps:
            planar = planar | (opaque & (sc.mat_normal_idx[m] != 0))
        tally["planar"] += int(planar.sum())
        # planar_maps, after the back-face test: metalness, roughness and
        # the diffuse lobe's albedo, an address wherever the size changes
        aw = ah = torch.zeros_like(m)
        for sel, field, key in (
                (front & sc.use_metalness_maps, sc.mat_metalness_idx,
                 "planar_x"),
                (front & sc.use_roughness_maps, sc.mat_roughness_idx,
                 "planar_x"),
                (diffuse & ~uv_ok, sc.mat_albedo_idx, "planar_rgb")):
            layer = field[m].long()
            sel = sel & (layer != 0)
            lw = sc.tex_w[(layer - 1).clamp_min(0)].long()
            lh = sc.tex_h[(layer - 1).clamp_min(0)].long()
            new = sel & ((lw != aw) | (lh != ah))
            aw, ah = torch.where(new, lw, aw), torch.where(new, lh, ah)
            tally["planar_addr"] += int(new.sum())
            tally[key] += int(sel.sum())
    if sc.any_bump and sc.n_textures:
        tally["bump"] += int((opaque & (sc.mat_bump_idx[m] != 0)).sum())
    if sc.tex_combined and sc.n_textures:
        # K9 on a combined-set material: each opaque shade's address, words
        # and maps, its albedo where its coin picks the diffuse lobe, and
        # each dielectric's albedo alone
        tally["tex_fetch"] += int((opaque & alb).sum())
        tally["tex_albedo"] += int((opaque & alb & (u[0] <= 0.5)).sum())
        tally["tex_glass"] += int((refract & alb).sum())


def tex_ops(fc) -> int:
    """K9's FP32 operations of a feature row's counts (the split fetch)."""
    return (fc["tex_fetch"] * OPS_TEX_TOP + fc["tex_albedo"] * OPS_TEX_ALBEDO
            + fc["tex_glass"] * OPS_TEX_GLASS)


def planar_ops(fc) -> int:
    """The planar fetches' FP32 operations of a feature row's counts."""
    return (fc["planar"] * OPS_PLANAR + fc["planar_addr"] * OPS_PLANAR_ADDR
            + fc["planar_rgb"] * OPS_PLANAR_RGB
            + fc["planar_x"] * OPS_PLANAR_X)


def texture_tables(scene) -> tuple:
    """The texture tables a feature row reads outside a combined set: the
    planar table (planar, bump and mesh-UV maps)."""
    return ((scene.planar_tile,) if scene.n_textures
            and not scene.tex_combined else ())


REPLAY_KEYS = ("issue_before", "issue_after", "blocks", "blocks_regrouped")


def issue_tally(sc, hit, u, act, bounce, lanes, n_threads, tally):
    """Adds the replay of one bounce's warp-branch issue to ``tally``
    (regroup.warp_branch_issue): each lane's event and its shading
    operations (a scatter OPS_FOG_SCATTER, an opaque shade OPS_SHADE, a
    dielectric OPS_REFRACT, each with its K9 fetch on a combined-set
    material: tex_ops), the warps' issue in place and regrouped, the
    blocks with a lane to shade and those that regroup."""
    import torch
    from pathtracer_tpu_torch.render import regroup
    ev = regroup.shade_events(sc, hit, u, bounce, act)
    ops = torch.tensor((OPS_FOG_SCATTER, OPS_SHADE, OPS_REFRACT, 0),
                       device=ev.device)[ev]
    if sc.tex_combined and sc.n_textures:
        alb = sc.mat_albedo_idx[hit.mat.long()] != 0
        opaque = (ev == regroup.EV_OPAQUE) & alb
        ops = (ops + torch.where(opaque, OPS_TEX_TOP, 0)
               + torch.where(opaque & (u[0] <= 0.5), OPS_TEX_ALBEDO, 0)
               + torch.where((ev == regroup.EV_GLASS) & alb, OPS_TEX_GLASS, 0))
    r = regroup.warp_branch_issue(ev, ops, lanes, n_threads)
    for k_, key in zip(("before", "after", "blocks", "regrouped"), REPLAY_KEYS):
        tally[key] += r[k_]


def render_counts(scene, cam, cfg, n_samples, dev, tiles=False):
    """What the kernel evaluates over every ray of samples 0 .. n_samples-1
    of ``cfg``: rays, and below the depth limit the opaque shades,
    dielectric (refraction) shades and fog scatters, the planar fetches
    (RGB: normal and albedo maps; red only: metalness and roughness maps),
    bumped hits (K11), mesh-UV fetches and combined-set fetches (K9); with
    sphere clusters the clustered walk's slab and sphere tests
    (cluster_tally), with a mesh tier the mesh walk's box tests, triangle
    tests and wins (mesh_tally, bvh_tally), with a brute mesh K4t's walk's
    box and triangle tests (brute_tally); and the replay of the feature
    bounce's warp-branch issue in place and regrouped (issue_tally) over
    the kernel's warp map (8x4 tiles with ``tiles``, else scanlines), each
    iteration of the plain loop taken as one of the kernel's regen loop (a
    lockstep variant's iterations group its lanes otherwise). The plain
    regeneration loop renders the same rays as the kernel (phase 3 holds them to it; both
    schedules cast the same rays); each bounce's lanes are caught in
    shade_bounce with their bounce index and counted as a kernel thread
    evaluates them (only the estimator its coins pick), all in one pass."""
    import torch
    from pathtracer_tpu_torch.render import cuda_backend as cb, wavefront
    from pathtracer_tpu_torch.render.renderer import init_accum
    from pathtracer_tpu_torch.utils import prng

    from pathtracer_tpu_torch.render import regroup

    tally = dict.fromkeys(FEATURE_KEYS + ("slabs", "spheres", "bvh_slabs",
                                          "bvh_spheres", "boxes", "tris",
                                          "wins", "bvh_boxes", "bvh_tris",
                                          "table_rays", "brute_boxes",
                                          "brute_tris") + REPLAY_KEYS, 0)
    lanes, n_threads = regroup.kernel_lanes(cfg.width, cfg.height, tiles, dev)
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
            if sc.tri_brute:
                brute_tally(sc, o, d, live["mask"], tally)
            return walks[name](sc, o, d)
        return walk

    def shade_caught(sc, o, d, hit, u, uv=None, **kw):
        out = shade(sc, o, d, hit, u, uv=uv, **kw)
        feature_tally(sc, hit, u, uv, out, live["mask"], live["bounce"], tally)
        issue_tally(sc, hit, u, live["mask"], live["bounce"], lanes,
                    n_threads, tally)
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
    bvh_tally(scene, tally)
    return tally


def load_package(root: Path, name: str):
    """The port's package of another checkout at ``root``, imported as
    ``name`` beside this one (its modules import each other relatively):
    a function from a submodule's dotted name to the module."""
    import importlib
    import importlib.util
    pkg = root / "pathtracer_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return lambda sub: importlib.import_module(f"{name}.{sub}")


# --parent's rows: (case, thin lens, schedule); "wN" is world N ("w7": its
# 1472-triangle UV sphere; "w2", "w4": the clustered spheres), "triN" or
# "uvN" world 5's ground with MESH_CASES' or SLIVER_CASES' mesh of that
# tag, each + " fog" in the CLI's fog, "w1 planar" world 1 with three
# planar 512x512 maps ("w1 planar500": cut to 500x300), "w1 mips" world 1
# with the CLI's --mips, "w1 nmr" without its maps (-nmr), "w1 cut" with
# its combined set cut to COMBINED_CUT (no power of two: no pyramid, the
# reciprocal wraps), "w1 glass" its combined-set material as dispersive
# glass, "w2 maps" / "tri784 maps" planar albedo and bump maps on the
# ground beside sphere clusters / the static tier, a MIXED_CASES name that
# mixed case, a feature scene's name (FEATURE_CASES) that scene: world 1's
# main path (K3 with K9) through both cameras, --mips, -nmr, the cut set
# and the other schedule, then K9 in the feature and mixed variants (fog,
# glass, the mixed bases with the combined set), then rows whose code is
# unchanged: the feature bounce without K9 (w6 and w7 in fog, the
# dispersion scene), the body, K7, the static tier
PARENT_ROWS = (
    ("w1", False, None), ("w1", True, None), ("w1 mips", False, None),
    ("w1 nmr", False, None), ("w1 cut", False, None), ("w1", False, "regen"),
    ("w1 fog", False, None), ("w1 fog", True, None), ("w1 glass", False, None),
    ("clustered+textured", False, None), ("textured+staticplain", False, None),
    ("w6 fog", False, None), ("w7 fog", False, None), ("dispersion", False, None),
    ("w3", False, None), ("w2", False, None), ("w7", False, None),
    ("tri784", False, None))

# --parent's variants of this tree's kernel source, each timed in turns
# against this one on its rows: (the replacements that make it from the
# source, its rows). World 1's combined-set albedo in the opaque shade:
# "k9_top", blended above the estimator's branches in every lane, as the
# parent's fetch_combined blended all eight channels; "k9_hold", the four
# A words and the fractions held across the branches and the albedo
# blended in the diffuse lobe; "k9_again", the diffuse lobe forming the
# address again and loading the A words again (combined_albedo).
# "lens_b7": the textured lens and the regen pinhole built without the
# 8-block bound (the parent's: 72 registers, 7 blocks). "scanlines": the textured lockstep
# variants' warps on 32 pixels of a scanline (the parent's) instead of 8x4
# pixel tiles (warp_tiles).
# "block_lockstep": -DWAVE_BLOCK_LOCKSTEP, the textured lockstep variants
# through the block-lockstep loop (trace_textured_grouped) instead of the
# per-warp one. A replacement is (old, new) in the kernel source, or (the
# file under the package, old, new).
W1_ROWS = (("w1", False, None), ("w1", True, None), ("w1 mips", False, None),
           ("w1 nmr", False, None))
_TOP_ALBEDO = ("      if (!(u[0] > 0.5f)) {\n"
               "        tex_albedo = v3(combined_ch(tex_w, tex_at, false, 0), "
               "combined_ch(tex_w, tex_at, false, 8),\n"
               "                        combined_ch(tex_w, tex_at, false, 16));\n"
               "      }\n")
_HELD_ALBEDO = ("v3(combined_ch(tex_w, tex_at, false, 0), "
                "combined_ch(tex_w, tex_at, false, 8), "
                "combined_ch(tex_w, tex_at, false, 16))")
SOURCE_VARIANTS = {
    "k9_top": (
        ((_TOP_ALBEDO, _TOP_ALBEDO.replace("if (!(u[0] > 0.5f)) ", "")),),
        W1_ROWS + (("w1", False, "regen"), ("w1 fog", False, None),
                   ("clustered+textured", False, None))),
    "k9_hold": (
        ((_TOP_ALBEDO, ""),
         ("      const CombinedAt tex_at = combined_at(", "      tex_at = combined_at("),
         ("      const CombinedWords tex_w = combined_words(",
          "      tex_w = combined_words("),
         ("  V3 tex_albedo;\n", "  V3 tex_albedo;\n  CombinedAt tex_at;\n"
                            "  CombinedWords tex_w;\n"),
         ("has_tex ? tex_albedo", "has_tex ? " + _HELD_ALBEDO)),
        W1_ROWS + (("w1 fog", False, None),)),
    "k9_again": (
        ((_TOP_ALBEDO, ""),
         ("has_tex ? tex_albedo", "has_tex ? combined_albedo(p, combined_at("
          "p, hitpoint.x, hitpoint.y, hit.t, cti))")),
        W1_ROWS + (("w1 fog", False, None),)),
    "lens_b7": (
        (("  return (kTex == kTexLockstep && (kMesh != kTexNone || kFeat == 0))\n"
          "         || (kTex == kTexRegen && kFeat == 0)",
          "  return (kTex == kTexLockstep && (kMesh != kTexNone || (!kThinLens "
          "&& kFeat == 0)))"),),
        (("w1", True, None), ("w1 nmr", True, None), ("w1", False, "regen"))),
    "scanlines": (
        (("         || (kMesh != kTexNone && !static_scanlines) || textured_lockstep;",
          "         || (kMesh != kTexNone && !static_scanlines);"),),
        (("w1", False, None), ("w1", True, None), ("w1 cut", False, None))),
    "block_lockstep": (
        (("#define WAVE_HAS(part) (WAVE_PART == (part))\n",
          "#define WAVE_HAS(part) (WAVE_PART == (part))\n"
          "#define WAVE_BLOCK_LOCKSTEP\n"),),
        W1_ROWS + (("w1 cut", False, None),)),
}
# the source variants timed against the parent (the others against this
# tree)
AGAINST_PARENT = ()


def source_variant(name: str):
    """This tree's package with SOURCE_VARIANTS[name]'s replacements made
    in its kernel source (or in the file a replacement names), copied
    under pathtracer_tpu_torch/_build/ and imported beside it
    (load_package)."""
    import shutil
    pkg = ROOT / "pathtracer_tpu_torch"
    root = pkg / "_build" / "variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(pkg, root / "pathtracer_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rep in SOURCE_VARIANTS[name][0]:
        sub, old, new = rep if len(rep) == 3 else ("csrc/wave_kernel.cu", *rep)
        path = root / "pathtracer_tpu_torch" / sub
        src = path.read_text()
        check(old in src, f"{name}: {sub} holds {old!r}")
        path.write_text(src.replace(old, new))
    return load_package(root, f"variant_{name}")


def kernel_launch(tree, scene, cam, cfg, n):
    """A function that launches ``tree``'s kernel on samples 0 .. n-1 of
    ``cfg`` into accumulators of its own, and nothing else (the parameters
    formed once, as render_chunk_cuda forms them, so that CUDA events
    around it time the kernel alone; render_chunk_cuda's host work, its
    allocations and reductions, is left out)."""
    import ctypes
    import torch
    rd, cb = tree("render.renderer"), tree("render.cuda_backend")
    dev = scene.sph_radius.device
    n_pix = cfg.width * cfg.height
    state = rd.init_accum(n_pix, dev)
    nan_px = torch.zeros(n_pix, dtype=torch.int32, device=dev)
    rays_px = torch.zeros(n_pix, dtype=torch.int32, device=dev)
    params = cb._params(scene, cam, cfg, 0, 0, n, state, nan_px, rays_px)
    code = cb._SCHED_CODE.get(cb._schedule(scene, cfg.schedule), 0)
    meshed = cb.meshed(scene)
    args = (int(bool(scene.sph_clusters)), int(not cam.use_pinhole),
            code if cb.textured(scene) else 0, code if meshed else 0,
            code if scene.featured or cb.mixed(scene) else 0,
            cb.MESH_KINDS[cb.mesh_kind(scene)] if meshed
            else cb.K4T_TRI if scene.tri_brute else 0)
    lib = cb.build()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = lib.wave_render(ctypes.byref(params), *args, stream)
        check(err == 0, "kernel_launch: " + lib.wave_error_string(err).decode())
    return launch


def parent_turns(parent: Path, smi: str):
    """``--parent DIR``: the kernel of another checkout of this repository
    at DIR (the parent commit, unpacked with git archive) against this
    one's, in one process: both built at once with SOURCE_VARIANTS' builds
    of this one (and the parent's -DWAVE_NO_REGROUP yardstick), with
    ptxas's registers and spills of each variant under each build and
    their resident blocks per SM; the ms of each
    PARENT_ROWS row's kernel launch alone (kernel_launch) at 1280x720, 4
    spp, after a warm launch each, in turns (parent, this, this, parent,
    this, parent, parent, this, twice: each first in one half); the
    parent's against itself on three rows (the turns' noise); and each
    source variant against this one (or the parent's, AGAINST_PARENT) on
    its rows, in turns."""
    import importlib
    import torch
    dev = torch.device("cuda:0")
    trees = {"parent": load_package(parent.resolve(), "parent_port"),
             "this": lambda sub: importlib.import_module(
                 f"pathtracer_tpu_torch.{sub}")}
    trees.update({k: source_variant(k) for k in SOURCE_VARIANTS})

    def build(tree):
        t = time.perf_counter()
        tree("render.cuda_backend").build()
        return time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(trees) + 1) as pool:
        # the parent's -DWAVE_NO_REGROUP yardstick too, for its registers
        flat = pool.submit(trees["parent"]("render.cuda_backend").compile_library,
                           ("WAVE_NO_REGROUP",))
        secs = dict(zip(trees, pool.map(build, trees.values())))
        flat_log = flat.result()[2]
    print(f"parent build_s={json.dumps(secs)}")
    print("parent ptxas [registers, spill stores] tree=parent_no_regroup "
          + json.dumps({v: [r["registers"], r["spill_stores"]]
                        for v, r in ptxas_report(flat_log).items()}))
    for k, tree in trees.items():
        cbk = tree("render.cuda_backend")
        rep = ptxas_report(cbk.BUILD_LOG)
        occ = occupancy_report(cbk.build())
        print(f"parent ptxas [registers, spill stores, blocks per SM, "
              f"stack frame bytes] tree={k} " + json.dumps(
                  {v: [r["registers"], r["spill_stores"], occ[v][0],
                       r.get("stack_frame")]
                   for v, r in rep.items()}))

    def mesh_builder(tree, tag):
        """World 5's ground with MESH_CASES' mesh of ``tag`` (its UV sphere
        wearing world 7's checker)."""
        worlds, schema = tree("scene.worlds"), tree("scene.schema")
        b, cp = worlds.build_world(schema.WORLD_MARIO,
                                   res_dir=str(ROOT / "no asset here"))
        gen, seg = MESH_CASES.get(tag) or (None, SLIVER_CASES[tag])
        if seg is not None:
            pts, uvs = worlds._uv_sphere_mesh((0.0, 0.0, 1.4), 1.4,
                                              n_seg=seg[0], n_ring=seg[1])
            if tag in SLIVER_CASES:
                t, uvs = tree("scene.mixed_scenes").with_slivers(
                    pts.reshape(-1, 3, 3), uvs)
                pts = t.reshape(-1, 3)
            m = b.add_material(
                albedo=(1.0, 1.0, 1.0), roughness=0.55,
                albedo_idx=b.add_texture(worlds._mesh_uv_demo_texture()))
            b.set_mesh(pts, np.full((len(pts),), m, np.int32), uvs=uvs)
            return b, cp, schema.WORLD_MARIO
        m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
        tris = gen()
        b.set_mesh(tris.reshape(-1, 3), np.full((3 * len(tris),), m, np.int32))
        return b, cp, schema.WORLD_MARIO

    def case(tree, tag, lens, w, h):
        """(scene on the card, camera, RenderConfig options) of a row's
        case under ``tree``."""
        worlds, schema = tree("scene.worlds"), tree("scene.schema")
        features = tree("scene.feature_scenes").FEATURE_CASES
        camera = tree("scene.camera")
        if tag in features:
            scene, (pos, target, fov), kw = features[tag]()
            return scene.to(dev), camera.define_camera(
                pos, target, fov, w, h, use_pinhole=not lens), kw
        if tag in ("w1 cut", "w1 glass"):
            b, cp = worlds.build_world(schema.WORLD_DEFAULT)
            world1_form(b, tag)
            _, cam = worlds.finalize_world(schema.WORLD_DEFAULT, w, h,
                                           use_pinhole=not lens)
            return b.finalize(view_origin=cp.pos).to(dev), cam, {}
        if tag in ("w1 mips", "w1 nmr"):
            scene, cam = worlds.finalize_world(schema.WORLD_DEFAULT, w, h,
                                               use_pinhole=not lens)
            if tag == "w1 mips":
                return scene.to(dev), cam, {"mip_scale": mip_scale(cam, h)}
            return dataclasses.replace(scene, **NMR).to(dev), cam, {}
        if tag.startswith("w1 planar"):
            b, cp = worlds.build_world(schema.WORLD_DEFAULT)
            cut = PLANAR_CUT.get(tag)
            b.textures = [t[:cut[1], :cut[0]].copy() if cut else t
                          for t in b.textures[:3]]
            for m in b.materials:
                m.normal_idx = 0
            _, cam = worlds.finalize_world(schema.WORLD_DEFAULT, w, h,
                                           use_pinhole=not lens)
            return b.finalize(view_origin=cp.pos).to(dev), cam, {}
        if tag[0] == "w" and tag[1].isdigit() and not tag.endswith("maps"):
            scene, cam = worlds.finalize_world(int(tag[1]) - 1, w, h,
                                               use_pinhole=not lens)
            if tag.endswith("fog"):
                scene = dataclasses.replace(scene, **FOG)
            return scene.to(dev), cam, {}
        name = tag.removesuffix(" fog").removesuffix(" maps")
        if tag in MIXED_CASES:
            b, cp, kind = mixed_builder(tag, tree)
        elif name == "w2":
            kind = schema.WORLD_BRDF_TEST
            b, cp = worlds.build_world(kind)
        else:
            b, cp, kind = mesh_builder(tree, name)
        if tag.endswith(" maps"):
            # the ground's planar albedo (world 7's checker) and bump maps
            m = b.materials[b.planes[0][2]]
            m.albedo_idx = b.add_texture(worlds._mesh_uv_demo_texture())
            hf = np.repeat(np.random.RandomState(7).rand(8, 8, 1), 3, 2)
            m.bump_idx = b.add_texture((np.round(hf * 255.0) / 255.0)
                                       .astype(np.float32))
            m.bump_scale = 0.5
        scene = b.finalize(world_kind=kind, view_origin=cp.pos)
        if tag.endswith(" fog"):
            scene = dataclasses.replace(scene, **FOG)
        return scene.to(dev), camera.define_camera(
            cp.pos, cp.target, cp.fov, w, h, use_pinhole=not lens,
            focal_distance=cp.focal_distance,
            aperture_radius=cp.aperture_radius), {}

    w, h = 1280, 720

    def launcher(tree, tag, lens, sched):
        """(a warmed 720p 4-spp launch of ``tree``'s kernel alone on a case
        (kernel_launch), its variant, its rays)."""
        scene, cam, kw = case(tree, tag, lens, w, h)
        rd, cb = tree("render.renderer"), tree("render.cuda_backend")
        cfg = rd.RenderConfig(w, h, pp=2, seed=0, schedule=sched, **kw)
        st = cb.render_chunk_cuda(scene, cam, cfg, 0, 0, 4,
                                  rd.init_accum(w * h, dev))
        launch = kernel_launch(tree, scene, cam, cfg, 4)
        launch()
        return launch, cb.variant(scene, cam, sched), int(st.rays_cast)

    def in_turns(runs):
        """The ms of two launchers' kernel launches in turns (first,
        second, second, first, second, first, first, second, then the same
        again), with their medians; one launch of the first before them is
        timed and dropped (the first timed launch after the scenes' set-up
        runs faster than the rest on the H100, whichever build it is)."""
        one, two = runs
        res = {k: [] for k in runs}
        order = (one, two, two, one, two, one, one, two)
        for j, k in enumerate((one,) + order + order):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            runs[k][0]()
            b.record()
            torch.cuda.synchronize()
            if j:
                res[k].append(a.elapsed_time(b))
        rays = {k: runs[k][2] for k in runs}
        return res, rays, {k: float(np.median(v)) for k, v in res.items()}

    def turns(label, one, two, rows):
        """Each row of ``rows`` under trees ``one`` and ``two`` in turns,
        one line each."""
        for tag, lens, sched in rows:
            runs = {k: launcher(trees[k], tag, lens, sched)
                    for k in (one, two)}
            res, rays, med = in_turns(runs)
            print(f"{label} case={tag!r} lens={lens} schedule={sched} "
                  f"variant_{one}={runs[one][1]} variant_{two}={runs[two][1]} "
                  f"{one}_ms={res[one]} {two}_ms={res[two]} "
                  f"{one}_median={med[one]} {two}_median={med[two]} "
                  f"{two}_over_{one}={med[two] / med[one]} "
                  f"rays_{one}={rays[one]} rays_{two}={rays[two]} "
                  f"| card: {smi}", flush=True)

    turns("parent row", "parent", "this", PARENT_ROWS)
    # the noise of the turns: the parent's kernel against itself
    trees["parent_again"] = trees["parent"]
    turns("parent control", "parent", "parent_again",
          (("w1", False, None), ("w1 fog", False, None), ("w3", True, None)))
    for name, (_, rows) in SOURCE_VARIANTS.items():
        turns(f"parent source_variant={name}",
              "parent" if name in AGAINST_PARENT else "this", name, rows)


POST_DIR = ROOT / "chip_smoke_post"  # phase 7's files
DEBUG_KINDS = ("bounce_count", "termination_condition", "primary_ray_normals")


def run_cli(argv) -> str:
    """cli.main(argv), its standard output captured and returned."""
    import contextlib
    import io
    from pathtracer_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    check(rc == 0, f"cli {argv} exit code")
    return buf.getvalue()


def verify_gates(label, a, b, cfg, phase="phase7"):
    """bench.py --verify's gates (bench.py:378-385, as phase 3 applies
    them) between two accumulators of ``cfg``: fewer than 1% of pixels
    with resolved |diff| > 1e-3 and 0.1% with |diff| > 0.1, equal valid
    counts, rays within 0.5%; printed on one line."""
    from pathtracer_tpu_torch.render.renderer import resolve
    d = (resolve(a, cfg).cpu() - resolve(b, cfg).cpu()).abs().amax(dim=-1)
    f3 = float((d > 1e-3).float().mean())
    f1 = float((d > 0.1).float().mean())
    count_eq = bool((a.count.cpu() == b.count.cpu()).all())
    ra, rb = int(a.rays_cast), int(b.rays_cast)
    print(f"{phase} {label} {cfg.width}x{cfg.height} pp={cfg.pp} "
          f"frac_gt_1e-3={f3} frac_gt_0.1={f1} "
          f"bit_equal={float((d == 0).float().mean())} count_equal={count_eq} "
          f"rays={ra} rays_other={rb} max_abs_err={float(d.max())}")
    check(f3 < 0.01 and f1 < 0.001, f"{label}: flip fractions")
    check(count_eq, f"{label}: valid counts")
    check(abs(ra - rb) <= 0.005 * rb, f"{label}: ray counts")


def post_phase(smi: str) -> None:
    """Phase 7: the host layer and the unrolled driver on the card (see the
    module's docstring); raises on any failure."""
    import os
    import torch
    from PIL import Image
    from pathtracer_tpu_torch.io.bmp import packed_to_rgb, read_bmp
    from pathtracer_tpu_torch.render import cuda_backend as cb
    from pathtracer_tpu_torch.render.denoise import (
        accum_variance, atrous_denoise,
    )
    from pathtracer_tpu_torch.render.progressive import (
        load_checkpoint, save_checkpoint,
    )
    from pathtracer_tpu_torch.render.renderer import (
        RenderConfig, init_accum, render_chunk, render_image, resolve,
    )
    from pathtracer_tpu_torch.scene.schema import (
        WORLD_CORNELL_BOX, WORLD_DEFAULT,
    )
    from pathtracer_tpu_torch.scene.worlds import finalize_world
    from pathtracer_tpu_torch.utils.profiling import TRACE_FILE

    t7 = time.perf_counter()
    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize
    POST_DIR.mkdir(exist_ok=True)
    f = {k: POST_DIR / k for k in (
        "post.bmp", "post.png", "post.npz", "resumed.bmp", "resumed.png",
        "resume.npz", "preview.png", "profile", "preview.bmp")}
    for k in ("post.npz", "resume.npz"):
        f[k].unlink(missing_ok=True)

    # a. the default command at full width with the post-process flags
    post = ["-p4", "--chunk", "4", "--denoise", "3", "--exposure", "1.5",
            "--flip", "xy", "--probe-pixel", "640,360"]
    cb.LAUNCHES = 0
    t = time.perf_counter()
    text = run_cli(post + ["--png", f["post.png"], "--checkpoint",
                           f["post.npz"], "--out", f["post.bmp"]])
    cli_s = time.perf_counter() - t
    launches = cb.LAUNCHES
    check(launches == 4, "the default command launched wave_kernel 4 times")
    bmp_rgb = packed_to_rgb(read_bmp(str(f["post.bmp"])))[::-1]
    png_rgb = np.asarray(Image.open(f["post.png"]).convert("RGB"))
    check(np.array_equal(bmp_rgb, png_rgb), "BMP and PNG pixels equal")
    st, found = load_checkpoint(str(f["post.npz"]), 1280 * 720, device="cpu")
    check(found and st.samples_done == 16, "the checkpoint holds 16 samples")
    lin = 360 * 1280 + 640
    cnt = max(float(st.count[lin]), 1.0)
    mean = [float(c[lin]) / cnt for c in st.sum]
    probe = [ln for ln in text.splitlines() if ln.startswith("probe pixel")]
    want = (f"probe pixel (640,360): mean radiance = "
            f"({mean[0]:f},{mean[1]:f},{mean[2]:f})")
    check(len(probe) == 1 and probe[0].startswith(want),
          "the probe line's mean is the accumulator's")
    perf = [ln for ln in text.splitlines() if ln.startswith("[perf]")]
    print(f"phase7 cli argv={post} launches={launches} cli_s={cli_s} "
          f"bmp_equals_png=True {probe[0]!r} {perf[0]!r} | card: {smi}")

    # b. resume: stop after the first chunk, resume through --checkpoint
    scene, cam = finalize_world(WORLD_DEFAULT, 1280, 720)

    class Stop(Exception):
        pass

    def stop(s_done, s_total, state):
        save_checkpoint(str(f["resume.npz"]), state)
        raise Stop

    try:
        render_image(scene, cam, RenderConfig(1280, 720, pp=4, denoise=3,
                                              exposure=1.5),
                     chunk_samples=4, progress_cb=stop, device=dev)
        check(False, "the interrupted render stopped")
    except Stop:
        pass
    text = run_cli(post + ["--png", f["resumed.png"], "--checkpoint",
                           f["resume.npz"], "--out", f["resumed.bmp"]])
    resumed = "Resuming from" in text and "4 samples done" in text
    same = f["resumed.bmp"].read_bytes() == f["post.bmp"].read_bytes()
    print(f"phase7 resume resumed={resumed} bmp_byte_equal={same}")
    check(resumed and same, "the resumed render's BMP equals the "
          "uninterrupted one's")

    # c. the compare tool on the two BMPs
    out = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.compare",
         str(f["post.bmp"]), str(f["resumed.bmp"]), "--json"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"phase7 compare rc={out.returncode} {json.dumps(res)}")
    check(out.returncode == 0 and res["percentage_similarity"] == 100.0,
          "the compare tool gives 100% similarity")

    # d. the denoiser at 720p, 3 iterations: the card against the CPU
    st_card, _ = load_checkpoint(str(f["post.npz"]), 1280 * 720, device=dev)
    cfg = RenderConfig(1280, 720, pp=4)
    den = {}
    for name, state in (("cpu", st), ("cuda", st_card)):
        den[name] = atrous_denoise(resolve(state, cfg),
                                   accum_variance(state, cfg), iterations=3)
    err = float((den["cuda"].cpu() - den["cpu"]).abs().max())
    rel = float(((den["cuda"].cpu() - den["cpu"]).abs()
                 / den["cpu"].abs().clamp_min(1e-3)).max())
    ms = []
    for _ in range(5):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        atrous_denoise(resolve(st_card, cfg), accum_variance(st_card, cfg),
                       iterations=3)
        b.record()
        sync()
        ms.append(a.elapsed_time(b))
    save_ms, load_ms = [], []
    for _ in range(3):
        t = time.perf_counter()
        save_checkpoint(str(f["resume.npz"]), st_card)
        save_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        load_checkpoint(str(f["resume.npz"]), 1280 * 720, device=dev)
        sync()
        load_ms.append((time.perf_counter() - t) * 1e3)
    print(f"phase7 denoise 1280x720 iterations=3 max_abs_diff_vs_cpu={err} "
          f"max_rel_diff={rel} ms={sorted(ms)[2]} | card: {smi}")
    print(f"phase7 checkpoint 1280x720 save_ms={sorted(save_ms)[1]} "
          f"load_ms={sorted(load_ms)[1]} bytes="
          f"{f['resume.npz'].stat().st_size}")
    check(rel < 1e-4, "the denoiser on the card agrees with the CPU")

    # e. the debug kinds and --mode unrolled at full width, through the CLI
    cb.LAUNCHES = 0
    for w in ("-w1", "-w3"):
        for extra in ([["--debug", k] for k in DEBUG_KINDS]
                      + [["--mode", "unrolled"]]):
            bmp = POST_DIR / f"debug{w}_{extra[1]}.bmp"
            run_cli([w, "-p1", "--out", bmp] + extra)
            check(read_bmp(str(bmp)).max() > 0, f"{w} {extra} not black")
    print(f"phase7 debug kinds and --mode unrolled, w1 and w3, 1280x720 "
          f"1 spp: launches={cb.LAUNCHES}")
    check(cb.LAUNCHES == 0, "the unrolled driver launched no kernel")

    # f. the unrolled driver against the CPU and the kernel at 256x144
    for kind_w, tag in ((WORLD_DEFAULT, "w1"), (WORLD_CORNELL_BOX, "w3")):
        sc, cm = finalize_world(kind_w, 256, 144)
        card = sc.to(dev)
        for k in DEBUG_KINDS:
            c = RenderConfig(256, 144, pp=1, debug_kind=k)
            verify_gates(f"{tag} {k} cuda_vs_cpu",
                         render_chunk(card, cm, c, 0, 0, 1,
                                      init_accum(256 * 144, dev)),
                         render_chunk(sc, cm, c, 0, 0, 1,
                                      init_accum(256 * 144)), c)
        c = RenderConfig(256, 144, pp=2, mode="unrolled")
        verify_gates(f"{tag} unrolled_vs_kernel",
                     render_chunk(card, cm, c, 0, 0, 4,
                                  init_accum(256 * 144, dev)),
                     render_chunk(card, cm, RenderConfig(256, 144, pp=2), 0,
                                  0, 4, init_accum(256 * 144, dev)), c)
        if tag == "w3":
            c = RenderConfig(256, 144, pp=2, just_importance=True)
            verify_gates("w3 just_importance cuda_vs_cpu",
                         render_chunk(card, cm, c, 0, 0, 4,
                                      init_accum(256 * 144, dev)),
                         render_chunk(sc, cm, c, 0, 0, 4,
                                      init_accum(256 * 144)), c)

    # g. the unrolled driver's time per sample beside the kernel's, 720p
    for kind_w, tag in ((WORLD_DEFAULT, "w1"), (WORLD_CORNELL_BOX, "w3")):
        sc, cm = finalize_world(kind_w, 1280, 720)
        card = sc.to(dev)
        res = {}
        for mode in ("unrolled", "auto"):
            c = RenderConfig(1280, 720, pp=1, mode=mode)
            ts = []
            for _ in range(4):
                st_m = init_accum(1280 * 720, dev)
                sync()
                t = time.perf_counter()
                render_chunk(card, cm, c, 0, 0, 1, st_m)
                sync()
                ts.append((time.perf_counter() - t) * 1e3)
            res[mode] = sorted(ts[1:])[1]
        print(f"phase7 {tag} 1280x720 ms_per_sample unrolled={res['unrolled']} "
              f"kernel={res['auto']} ratio={res['unrolled'] / res['auto']} "
              f"| card: {smi}")

    # h. --preview at every chunk and --profile's trace
    saved = []
    orig = Image.Image.save

    def save(self, fp, *a, **k):
        saved.append(str(fp))
        return orig(self, fp, *a, **k)

    Image.Image.save = save
    try:
        run_cli(["-w3", "-p2", "--chunk", "1", "--preview", f["preview.png"],
                 "--profile", f["profile"], "--out", f["preview.bmp"]])
    finally:
        Image.Image.save = orig
    previews = saved.count(str(f["preview.png"]))
    trace = json.loads((f["profile"] / TRACE_FILE).read_text())
    kernels = [e for e in trace.get("traceEvents", [])
               if "wave_kernel" in str(e.get("name", ""))
               and str(e.get("cat", "")).lower() == "kernel"]
    print(f"phase7 preview pngs={previews} profile "
          f"trace_bytes={os.path.getsize(f['profile'] / TRACE_FILE)} "
          f"wave_kernel_events={len(kernels)} "
          f"first={kernels[0]['name'][:60] if kernels else None!r}")
    check(previews == 4, "--preview wrote a PNG at each of 4 chunks")
    check(len(kernels) > 0, "--profile's trace names a wave_kernel launch")
    print(f"phase7 total_s={time.perf_counter() - t7}")


def xla_phase(smi: str) -> None:
    """Phase 8: the scenes JAX renders on XLA only, as torch ops on the card
    (see the module's docstring); raises on any failure."""
    import torch
    from pathtracer_tpu_torch.ops import traverse
    from pathtracer_tpu_torch.ops.intersect import (
        SWEEP_PAIRS, intersect_scene,
    )
    from pathtracer_tpu_torch.render import cuda_backend as cb
    from pathtracer_tpu_torch.render.renderer import (
        RenderConfig, init_accum, kernel_renders, render_chunk,
    )
    from pathtracer_tpu_torch.render.wavefront import _primary_rays
    from pathtracer_tpu_torch.scene import accel, clusters, mixed_scenes
    from pathtracer_tpu_torch.scene.camera import define_camera
    from pathtracer_tpu_torch.scene.schema import (
        F32_MAX, WORLD_DEFAULT, WORLD_MARIO,
    )
    from pathtracer_tpu_torch.scene.worlds import _uv_sphere_mesh, build_world

    t8 = time.perf_counter()
    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize

    def grey_mesh(tris):
        b, cp = build_world(WORLD_MARIO, res_dir=str(ROOT / "no asset here"))
        m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
        b.set_mesh(tris.reshape(-1, 3), np.full((3 * len(tris),), m, np.int32))
        return b, cp

    def render(scene, cam, cfg):
        """One render_chunk of cfg.spp samples where ``scene`` lies: (the
        accumulator, seconds per sample, the DDA's steps and walks); it
        must launch no wave_kernel."""
        check(scene.off_kernel and not kernel_renders(scene, cfg),
              "the scene is routed off the kernel")
        cb.LAUNCHES = 0
        traverse.STEPS = traverse.WALKS = 0
        st = init_accum(cfg.width * cfg.height, scene.device)
        # on the CPU one thread: PyTorch's pool slows these small eager ops
        threads = torch.get_num_threads()
        if scene.device.type == "cpu":
            torch.set_num_threads(1)
        sync()
        t = time.perf_counter()
        render_chunk(scene, cam, cfg, 0, 0, cfg.spp, st)
        sync()
        dt = (time.perf_counter() - t) / cfg.spp
        torch.set_num_threads(threads)
        check(cb.LAUNCHES == 0, "no wave_kernel launch off the kernel")
        return st, dt, traverse.STEPS, traverse.WALKS

    # a. a mesh with the grid, world 1 with a UV mesh in its combined
    # ground material, world 1 with a bump map on its combined set: on the
    # card against the CPU, 256x144, 4 spp
    center, radius = mixed_scenes.MESH_AT[WORLD_DEFAULT]
    uv = _uv_sphere_mesh(center, radius, n_seg=8, n_ring=12)
    cases = {
        "grid784": lambda: grey_mesh(tessellated_sphere(800)),
        "w1 uv": lambda: mixed_scenes.mixed_builder(
            world=WORLD_DEFAULT, mesh=(uv[0].reshape(-1, 3, 3), uv[1]),
            mesh_material="ground"),
        "w1 bump": lambda: mixed_scenes.mixed_builder(world=WORLD_DEFAULT,
                                                      ground_bump=3),
    }
    cfg = RenderConfig(256, 144, pp=2)
    for tag, make in cases.items():
        b, cp = make()
        grid = (accel.build_uniform_grid(b.triangles) if tag == "grid784"
                else None)
        sc = b.finalize(world_kind=WORLD_MARIO if grid else WORLD_DEFAULT,
                        grid=grid, view_origin=cp.pos)
        cam = define_camera(cp.pos, cp.target, cp.fov, 256, 144)
        card, s_card, steps, walks = render(sc.to(dev), cam, cfg)
        cpu, s_cpu, _, _ = render(sc, cam, cfg)
        verify_gates(f"{tag} cuda_vs_cpu", card, cpu, cfg, phase="phase8")
        print(f"phase8 {tag} n_tris={sc.n_tris} grid_res={sc.grid_res} "
              f"combined={sc.tex_combined} s_per_sample={s_card} "
              f"s_per_sample_cpu={s_cpu} dda_walks={walks} "
              f"dda_steps={steps} dda_steps_per_walk={steps / max(walks, 1)} "
              f"wave_kernel_launches=0 | card: {smi}")

    # b. a tessellated sphere of DMA_MAX + 1 triangles (the last a copy of
    # one in view: an exact tie, which both passes give the lower index),
    # walked through the grid and swept in chunks on the card, 1 spp, at
    # 16x9: the walk tests one triangle a step, and a ray through a pole's
    # cells, which hold some 10^4 slivers, took 17,255 steps a walk at
    # 64x36 (about 50 s each: H100 80GB HBM3, 700 W)
    tris = tessellated_sphere(clusters.DMA_MAX)
    tris = np.concatenate([tris, tris[len(tris) // 2 - 1:len(tris) // 2]])
    check(len(tris) == clusters.DMA_MAX + 1, "DMA_MAX + 1 triangles")
    b, cp = grey_mesh(tris)
    t = time.perf_counter()
    sc = b.finalize(world_kind=WORLD_MARIO, view_origin=cp.pos)
    finalize_s = time.perf_counter() - t
    t = time.perf_counter()
    grid = accel.build_uniform_grid(b.triangles)
    grid_s = time.perf_counter() - t
    swept = sc.to(dev)
    walked = dataclasses.replace(sc, grid_cell_start=grid[0],
                                 grid_cell_count=grid[1], grid_tris=grid[2],
                                 grid_res=grid[3]).to(dev)
    cfg = RenderConfig(16, 9, pp=1)
    cam = define_camera(cp.pos, cp.target, cp.fov, 16, 9)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    sweep_st, sweep_s, _, _ = render(swept, cam, cfg)
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    grid_st, walk_s, steps, walks = render(walked, cam, cfg)
    verify_gates("dma_max+1 grid_vs_sweep", grid_st, sweep_st, cfg,
                 phase="phase8")
    pix = torch.arange(16 * 9, device=dev)
    o, d = _primary_rays(cam, cfg, 0, pix, torch.zeros_like(pix))
    hs, hg = intersect_scene(swept, o, d), intersect_scene(walked, o, d)
    hit = hs.t < F32_MAX
    rel = ((hg.t - hs.t).abs() / hs.t.abs().clamp_min(1e-30))[hit]
    print(f"phase8 dma_max+1 n_tris={sc.n_tris} finalize_s={finalize_s} "
          f"build_uniform_grid_s={grid_s} sweep_s_per_sample={sweep_s} "
          f"grid_s_per_sample={walk_s} sweep_peak_mb={peak_mb} "
          f"sweep_pairs={SWEEP_PAIRS} dda_walks={walks} dda_steps={steps} "
          f"dda_steps_per_walk={steps / max(walks, 1)} "
          f"primary_hits={int(hit.sum())} "
          f"primary_t_max_rel={float(rel.max()) if rel.numel() else 0.0} "
          f"primary_t_bit_equal={bool((hg.t == hs.t).all())} | card: {smi}")
    check(bool((hit == (hg.t < F32_MAX)).all()), "primary hit or miss equal")
    check(bool((hs.mat == hg.mat).all()), "primary materials equal")
    check(int(hit.sum()) > 0 and float(rel.max()) <= 1e-6,
          "primary t within rtol 1e-6")
    print(f"phase8 total_s={time.perf_counter() - t8}")


SHARD_WORLDS = ("w3", "w1", "w7")  # a scanline variant, the textured
# lockstep pair's pinhole and an 8x4-tile BVH walk (mesh_pinhole)
SHARD_COUNTS = (2, 7)  # 921,600 pixels do not divide by 7: padding lanes


def shard_phase(smi: str) -> None:
    """Phase 9: rendering across devices (parallel/shard.py) on the card, as
    far as one card shows it: render_image_sharded over [cuda:0] * k for
    each of SHARD_COUNTS on worlds 3, 1 and 7 at 1280x720, 4 spp, against
    render_image (packed image and trimmed accumulators equal, rays_cast
    within JAX's padding bound, every launch counted), each render's ms per
    sample (the median of three synchronised runs after one to warm up,
    set-up and finalize included) beside the one-device one; the CLI with -t2 over that list (the
    sharded branch) and with --single-chip, BMP bytes equal; where the
    machine has more than one card, world 3 across all of them. Raises on
    any failure."""
    import torch
    from pathtracer_tpu_torch.parallel.shard import (
        _padded_pixels, render_image_sharded,
    )
    from pathtracer_tpu_torch.render import cuda_backend as cb
    from pathtracer_tpu_torch.render.renderer import (
        RenderConfig, render_image,
    )
    from pathtracer_tpu_torch.scene.schema import (
        WORLD_CORNELL_BOX, WORLD_DEFAULT, WORLD_MESH_UV,
    )
    from pathtracer_tpu_torch.scene.worlds import finalize_world

    t9 = time.perf_counter()
    dev = torch.device("cuda:0")
    w, h, pp = 1280, 720, 2
    kinds = {"w3": WORLD_CORNELL_BOX, "w1": WORLD_DEFAULT,
             "w7": WORLD_MESH_UV}

    def timed(fn, runs=3):
        """fn's last result and the median of ``runs`` synchronised wall
        times over the samples, ms (after one run to warm up)."""
        fn()
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / (pp * pp))
        return out, float(np.median(times))

    def same(label, one, other, n_dev):
        (_, pk1, st1), (_, pk2, st2) = one, other
        equal = torch.equal(pk1, pk2) and all(
            torch.equal(a, b) for a, b in zip(
                [*st1.sum, *st1.sum_sq, st1.count],
                [*st2.sum, *st2.sum_sq, st2.count]))
        extra = int(st2.rays_cast) - int(st1.rays_cast)
        check(equal, f"{label}: the sharded render equals render_image")
        check(int(st1.nan_count) == int(st2.nan_count)
              and 0 <= extra <= n_dev * 4 * pp * pp,
              f"{label}: NaN count and the padding lanes' rays ({extra})")
        return extra

    scenes = {}
    for tag in SHARD_WORLDS:
        scene, cam = finalize_world(kinds[tag], w, h)
        scenes[tag] = (scene.to(dev), cam)
        cfg = RenderConfig(w, h, pp=pp)
        var = cb.variant(scenes[tag][0], cam)
        one, ms1 = timed(lambda: render_image(*scenes[tag], cfg, device=dev))
        for k in SHARD_COUNTS:
            pad = _padded_pixels(w * h, k) - w * h

            def sharded():
                # the counts of one render: set to 0 just before it
                cb.LAUNCHES = 0
                cb.VARIANT_LAUNCHES.update(
                    dict.fromkeys(cb.VARIANT_LAUNCHES, 0))
                return render_image_sharded(*scenes[tag], cfg,
                                            devices=[dev] * k)
            out, ms = timed(sharded)
            launches = cb.VARIANT_LAUNCHES[var]
            check(launches == cb.LAUNCHES == k + pad,
                  f"{tag} k={k}: {launches} launches of {var}, "
                  f"{cb.LAUNCHES} in all, for {k} shards and {pad} "
                  "padding lanes")
            extra = same(f"{tag} k={k}", one, out, k)
            print(f"phase9 {tag} {var} {w}x{h} spp={pp * pp} shards={k} "
                  f"padding_lanes={pad} launches={launches} "
                  f"equal=True extra_rays={extra} ms_per_sample={ms} "
                  f"one_device_ms_per_sample={ms1} ratio={ms / ms1} "
                  f"| card: {smi}")

    # the CLI: -t2 over a list of one card seven times (the sharded
    # branch), and --single-chip, at 1280x720 -p2: the same BMP bytes
    from pathtracer_tpu_torch import cli
    import contextlib
    import io
    outs = {}
    for tag, flag in (("t2", "-t2"), ("single", "--single-chip")):
        path = POST_DIR / f"shard_{tag}.bmp"
        POST_DIR.mkdir(exist_ok=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-w3", "-p2", flag, "--out", str(path)],
                          devices=[dev] * 7)
        check(rc == 0, f"cli {flag}")
        text = buf.getvalue()
        want = "Using 2 device(s)." if tag == "t2" else "Using 7 device(s)."
        check(want in text, f"cli {flag}: {want!r}")
        outs[tag] = path.read_bytes()
        print(f"phase9 cli {flag} bytes={len(outs[tag])} "
              f"perf={text.strip().splitlines()[-1][:120]!r}")
    check(outs["t2"] == outs["single"], "cli -t2 and --single-chip BMPs")

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cfg = RenderConfig(w, h, pp=pp)
        one, ms1 = timed(lambda: render_image(*scenes["w3"], cfg,
                                              device=dev))
        out, ms = timed(lambda: render_image_sharded(*scenes["w3"], cfg))
        same(f"w3 across {n_cards} cards", one, out, n_cards)
        print(f"phase9 w3 cards={n_cards} ms_per_sample={ms} "
              f"one_device_ms_per_sample={ms1} equal=True | card: {smi}")
    else:
        print("phase9 one card: the path across several cards ran as "
              "shards of this card only")
    print(f"phase9 total_s={time.perf_counter() - t9}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", metavar="DIR", default=None,
                    help="also write each variant's SASS to DIR")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="instead of phases 2-6, time another checkout's "
                         "kernel (DIR) against this one's (parent_turns)")
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
    from pathtracer_tpu_torch.scene import mixed_scenes, worlds
    from pathtracer_tpu_torch.scene.schema import (
        WORLD_BRDF_TEST, WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD, WORLD_DEFAULT,
        WORLD_MARIO, WORLD_MESH_UV, WORLD_RAYTRACING_ONE_WEEKEND, WorldBuilder,
    )
    from pathtracer_tpu_torch.scene.textures import REFERENCE_RES_DIR
    from pathtracer_tpu_torch.scene.worlds import build_world, finalize_world

    W3, W6, W2, W4, W1, W7, W5 = (WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD,
                                  WORLD_BRDF_TEST, WORLD_RAYTRACING_ONE_WEEKEND,
                                  WORLD_DEFAULT, WORLD_MESH_UV, WORLD_MARIO)
    OTHER = cb.OTHER_SCHEDULE
    MOTHER = cb.MESH_OTHER_SCHEDULE
    FOTHER = cb.FEATURE_OTHER_SCHEDULE
    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize

    def world(kind, w, h, lens=False, brute=False, statics=None):
        scene, cam = finalize_world(kind, w, h, use_pinhole=not lens)
        scene = dataclasses.replace(scene, **(statics or {}))
        return (scene.without_clusters() if brute else scene).to(dev), cam

    def feature(name, w, h, lens=False):
        """A feature scene (scene/feature_scenes.py) on the card, its camera
        at w x h and its RenderConfig options (everything: RR)."""
        scene, (pos, target, fov), cfg_kw = FEATURE_CASES[name]()
        return (scene.to(dev), define_camera(pos, target, fov, w, h,
                                             use_pinhole=not lens), cfg_kw)

    def planar_world1(w, h, lens=False, cut=None):
        """World 1 with three planar 512x512 maps (albedo, metalness,
        roughness) instead of the combined set: the feature kernel's
        planar fetch over a large stack; with ``cut`` (w, h) each map cut
        to that size (500x300: no power of two, the reciprocal wraps)."""
        b, cp = build_world(W1)
        b.textures = [t[:cut[1], :cut[0]].copy() if cut else t
                      for t in b.textures[:3]]
        for m in b.materials:
            m.normal_idx = 0
        _, cam = finalize_world(W1, w, h, use_pinhole=not lens)
        return b.finalize(view_origin=cp.pos).to(dev), cam

    mesh_built = {}  # tag -> (CPU scene, camera params, finalize s, card)

    def mesh_builder(tag):
        """World 5's builder without its asset plus the mesh case's mesh
        (MESH_CASES, SLIVER_CASES), and its camera parameters."""
        gen, seg = MESH_CASES.get(tag) or (None, SLIVER_CASES[tag])
        b, cp = build_world(W5, res_dir=str(ROOT / "no asset here"))
        if seg is None:
            tris = gen()
            m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
            b.set_mesh(tris.reshape(-1, 3),
                       np.full((3 * len(tris),), m, np.int32))
        else:
            pts, uvs = worlds._uv_sphere_mesh((0.0, 0.0, 1.4), 1.4,
                                              n_seg=seg[0], n_ring=seg[1])
            if tag in SLIVER_CASES:
                tris, uvs = mixed_scenes.with_slivers(pts.reshape(-1, 3, 3),
                                                      uvs)
                pts = tris.reshape(-1, 3)
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

    def feature_case(tag, w, h, lens=False):
        """(scene, camera, RenderConfig options) of a feature case: a
        feature scene by name, "w6 fog" / "w3 fog" (the CLI's fog on world
        6 or 3), "w1 planar" (planar_world1), "w1 planar500" (its maps
        cut to 500x300) or the 40-triangle mesh case (K4t)."""
        if tag in FEATURE_CASES:
            return feature(tag, w, h, lens)
        if tag.startswith("w1 planar"):
            return (*planar_world1(w, h, lens, PLANAR_CUT.get(tag)), {})
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
    FAR_KINDS = {"w2": W2, "w4": W4}

    def base_case(tag, w, h, lens=False):
        """(scene on the card, camera at w x h) of the feature bounce on
        another base: "<world> fog" (the CLI's fog on a world), "<mesh
        case> fog", "w1 glass" (world 1's combined-set material as
        dispersive glass), "w2 glass" (every seventh sphere of world 2),
        "w2 maps" and "tri784 maps" (planar albedo and bump maps on the
        ground plane: sphere clusters, the static tier), "w1 planar"
        (planar_world1: three planar 512x512 maps on world 1), a mesh case
        (MESH_CASES: the 40-triangle one is a brute mesh, K4t) or a mixed
        case (MIXED_CASES: "textured+brute" and "clustered+brute" put that
        mesh beside the combined set or sphere clusters)."""
        if tag.startswith("w1 planar"):
            return planar_world1(w, h, lens, PLANAR_CUT.get(tag))
        if tag in MESH_CASES:
            return mesh_case(tag, w, h, lens)
        if tag in MIXED_CASES:
            return mixed_case(tag, w, h, lens)
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
    if args.parent:
        parent_turns(Path(args.parent), smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # --- 2. build ----------------------------------------------------------
    # this build and the regroup's yardstick (-DWAVE_NO_REGROUP: every
    # feature variant shades each path in its own thread, the parent's
    # code; with -DWAVE_BLOCK_LOCKSTEP: world 1's textured lockstep pair
    # through the block-lockstep loop, laid out by lobe) together; then, in
    # the background, the warp tiles' yardstick (-DWAVE_SCANLINE_WARPS: each
    # warp of the BVH walks' variants on 32 pixels of a scanline)
    t0 = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(2)
    no_regroup = pool.submit(cb.compile_library, YARDSTICK_DEFINES)
    tile_lib = cb.build()
    build_s = time.perf_counter() - t0
    flat_lib, _, flat_log, flat_s = no_regroup.result()
    yardstick = pool.submit(cb.compile_library, ("WAVE_SCANLINE_WARPS",))
    ptxas = ptxas_report(cb.BUILD_LOG)
    check(sorted(ptxas) == sorted(cb.VARIANTS), f"ptxas report {ptxas}")
    flat_ptxas = ptxas_report(flat_log)
    check(sorted(flat_ptxas) == sorted(cb.VARIANTS), "the yardstick's ptxas report")
    sass = sass_report(cb.LIB_PATH, args.sass)
    check(sorted(sass) == sorted(cb.VARIANTS), f"SASS report {sass}")
    check(sorted(KEPT_PTXAS) == sorted(
              v for v in cb.VARIANTS
              if not feature_bounce(v) and not lens_variant(v))
          and sorted(PARENT_LENS_PTXAS) == sorted(
              v for v in cb.VARIANTS
              if not feature_bounce(v) and lens_variant(v))
          and sorted(FEATURE_EARLIER_PTXAS) == sorted(
              v for v in cb.VARIANTS
              if feature_bounce(v) and v not in cb.K4T_VARIANTS)
          and sorted(cb.K4T_VARIANTS) == sorted(
              v + cb.K4T_SUFFIX for v in K4T_BASES),
          "KEPT_PTXAS names every variant without the feature bounce and "
          "the lens, PARENT_LENS_PTXAS every other one without the feature "
          "bounce, FEATURE_EARLIER_PTXAS every other one but the K4t forms, "
          "K4T_BASES the K4t forms' bases")
    now = {v: (r["registers"], r["spill_stores"]) for v, r in ptxas.items()}
    flat = {v: (r["registers"], r["spill_stores"])
            for v, r in flat_ptxas.items()}
    kept = {v: now[v] == rs for v, rs in KEPT_PTXAS.items()}
    flat_kept = {v: flat[v] == rs for v, rs in FEATURE_EARLIER_PTXAS.items()
                 if not code_changed(v)}
    regrouped = sorted(v for v, r in ptxas.items() if r["regrouped"])
    print(f"phase2 build_s={build_s:.3f} nvcc_s={cb.BUILD_SECONDS} "
          f"no_regroup_build_s={flat_s} ptxas={json.dumps(ptxas)}")
    print(f"phase2 variants_kept_ptxas={json.dumps(kept)} "
          f"all_kept={all(kept.values())}")
    occ = occupancy_report(tile_lib)
    print("phase2 changed variants (code_changed): [registers, spill "
          "stores, blocks per SM] of this build and of the parent's "
          "(PARENT_PTXAS) " + json.dumps(
              {v: {"now": [*now[v], occ[v][0]], "parent": PARENT_PTXAS[v]}
               for v in cb.VARIANTS if code_changed(v)}))
    check(all(kept.values()), "the variants without the feature bounce "
          "and the lens kept their registers and spills")
    flat_occ = occupancy_report(flat_lib)
    check(sorted(v for v, r in flat_ptxas.items() if r["regrouped"])
          == sorted(TEXTURED_LOCKSTEP)
          and all(feature_bounce(v) for v in regrouped),
          "only feature variants regroup, and in the yardstick only the "
          "textured lockstep pair (the block-lockstep loop)")
    print("phase2 textured variants (K3, K9): [registers, spill stores, "
          "blocks per SM] of this build, of the parent's (PARENT_PTXAS) and, "
          "for the lockstep pair, of the block-lockstep loop (-DWAVE_BLOCK_"
          "LOCKSTEP) " + json.dumps(
              {v: {"now": [*now[v], occ[v][0]], "parent": PARENT_PTXAS[v],
                   **({"block_lockstep": [*flat[v], flat_occ[v][0]]}
                      if v in TEXTURED_LOCKSTEP else {})}
               for v in cb.VARIANTS if "textured" in v}))
    # resident blocks of 128 threads per SM, static shared bytes, registers
    check(sorted(occ) == sorted(cb.VARIANTS) == sorted(flat_occ),
          "an occupancy for every variant")
    print(f"phase2 feature variants: (registers, spill stores) of this build "
          f"and of the parent's (PARENT_FEATURE_PTXAS), resident blocks per "
          f"SM of both (PARENT_FEATURE_BLOCKS), and (registers, spill "
          f"stores) of the -DWAVE_NO_REGROUP yardstick and of the parent's "
          f"yardstick (FEATURE_EARLIER_PTXAS); code_changed: the "
          f"variant's code changed against the parent's " + json.dumps(
              {v: {"now": now[v], "parent": PARENT_FEATURE_PTXAS[v],
                   "blocks": occ[v][0], "parent_blocks":
                   PARENT_FEATURE_BLOCKS[v], "no_regroup": flat[v],
                   "no_regroup_parent": rs, "regrouped": v in regrouped,
                   "code_changed": code_changed(v)}
               for v, rs in FEATURE_EARLIER_PTXAS.items()}))
    print(f"phase2 K4t forms: (registers, spill stores) and blocks per SM "
          f"of this build and its -DWAVE_NO_REGROUP yardstick, beside the "
          f"parent's " + json.dumps(
              {v: {"now": now[v], "blocks": occ[v][0], "no_regroup": flat[v],
                   "parent": PARENT_FEATURE_PTXAS[v], "parent_blocks":
                   PARENT_FEATURE_BLOCKS[v],
                   "regrouped": v in regrouped} for v in cb.K4T_VARIANTS}))
    feat_kept = {v: now[v] == PARENT_FEATURE_PTXAS[v]
                 and occ[v][0] == PARENT_FEATURE_BLOCKS[v]
                 for v in PARENT_FEATURE_PTXAS}
    print(f"phase2 feature variants kept the parent's registers, spills and "
          f"blocks: {json.dumps(feat_kept)} "
          f"unchanged_code_all_kept="
          f"{all(k for v, k in feat_kept.items() if not code_changed(v))}")
    # every variant that can cast a lens ray, beside the parent's build
    parent_lens = {**{v: list(r) for v, r in PARENT_LENS_PTXAS.items()},
                   **{v: [*PARENT_FEATURE_PTXAS[v], PARENT_FEATURE_BLOCKS[v]]
                      for v in cb.VARIANTS
                      if feature_bounce(v) and lens_variant(v)}}
    print("phase2 lens variants: [registers, spill stores, blocks per SM] "
          "of this build and of the parent's " + json.dumps(
              {v: {"now": [*now[v], occ[v][0]], "parent": parent_lens[v]}
               for v in cb.VARIANTS if lens_variant(v)}))
    # every feature variant keeps the parent's resident blocks per SM
    fewer = {v: [occ[v][0], PARENT_FEATURE_BLOCKS[v]] for v in cb.VARIANTS
             if feature_bounce(v) and occ[v][0] < PARENT_FEATURE_BLOCKS[v]}
    check(not fewer, f"feature variants below the parent's blocks per SM: "
          f"{fewer}")
    print(f"phase2 regrouped={json.dumps(regrouped)} "
          f"yardstick_kept_earlier={all(flat_kept.values())} "
          f"{json.dumps({v: k for v, k in flat_kept.items() if not k})}")
    check(all(flat_kept.values()), "the yardstick's feature variants whose "
          "code did not change kept the parent's registers and spills")
    print("phase2 blocks_per_sm (this build, -DWAVE_NO_REGROUP): "
          + json.dumps({v: [occ[v][0], flat_occ[v][0]] for v in cb.VARIANTS}))
    print("phase2 occupancy [blocks per SM, static shared bytes, registers] "
          "this build " + json.dumps(occ) + " -DWAVE_NO_REGROUP "
          + json.dumps(flat_occ))
    check(all(occ[v][0] >= flat_occ[v][0] for v in cb.VARIANTS),
          "no variant runs fewer blocks per SM than without the regroup")
    print(f"phase2 sass={json.dumps(sass)}")
    # the main path's body: registers, spill stores and stack frame of the
    # brute variants beside the parent's build (PARENT_STACK)
    print("phase2 body [registers, spill stores, stack frame bytes, blocks "
          "per SM] of this build and of the parent's " + json.dumps(
              {v: {"now": [*now[v], ptxas[v]["stack_frame"], occ[v][0]],
                   "parent": [*PARENT_PTXAS[v][:2], PARENT_STACK[v],
                              PARENT_PTXAS[v][2]]}
               for v in PARENT_STACK}))
    fewer = {v: [occ[v][0], PARENT_PTXAS[v][2]] for v in cb.VARIANTS
             if occ[v][0] < PARENT_PTXAS[v][2]}
    check(not fewer, f"variants below the parent's blocks per SM: {fewer}")

    # --- 2b. the shade's trig against sinf and cosf -------------------------
    # sincos_2pi (one sincosf per shade, above the estimator's branches) on
    # every u1 the draws give, to_unit's 2^24 values, bit for bit
    t0 = time.perf_counter()
    bad_trig = cb.trig_check_cuda()
    sync()
    print(f"phase2 trig inputs={1 << 24} differing={bad_trig} "
          f"seconds={time.perf_counter() - t0:.3f}")
    check(bad_trig == 0, "sincos_2pi equals sinf and cosf on every u1")

    # --- 3. kernel vs plain on the card ------------------------------------
    print(f"phase3 start_s={time.perf_counter() - t_start}")
    max_err = dict.fromkeys(cb.VARIANTS, 0.0)
    differing = {}  # label -> pixels where the kernel and plain differ

    same_as_flat = {}  # label -> a variant's sums equal the yardstick's

    def held(label, scene, cam, cfg, n, s0=0):
        """The kernel against its plain version on the same inputs under
        the verify gates, printed on one line, and a feature variant's, or
        the textured lockstep pair's, sums, counts and rays against the
        yardstick's (the feature bounce in place, the block-lockstep loop),
        which must be equal; returns the variant and the largest per-pixel
        |diff|."""
        var = cb.variant(scene, cam, cfg.schedule)
        k = cb.render_chunk_cuda(scene, cam, cfg, 0, s0, n,
                                 init_accum(cfg.width * cfg.height, dev))
        flat_txt = ""
        if feature_bounce(var) or var in TEXTURED_LOCKSTEP:
            cb._lib = flat_lib
            try:
                y = cb.render_chunk_cuda(scene, cam, cfg, 0, s0, n,
                                         init_accum(cfg.width * cfg.height,
                                                    dev))
            finally:
                cb._lib = tile_lib
            same = (all(torch.equal(a, b) for a, b in zip(
                (*k.sum, *k.sum_sq, k.count), (*y.sum, *y.sum_sq, y.count)))
                and int(k.rays_cast) == int(y.rays_cast)
                and int(k.nan_count) == int(y.nan_count))
            same_as_flat[f"{label} {cfg.width}x{cfg.height} {var}"] = same
            flat_txt = f"equal_to_yardstick={same} "
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
        differing[f"{label} {cfg.width}x{cfg.height} {var}"] = int(
            (d != 0).sum())
        print(f"phase3 {label} variant={var} {cfg.width}x{cfg.height} "
              f"pp={cfg.pp} samples={s0}-{s0 + n - 1} frac_gt_1e-3={f3} "
              f"frac_gt_0.1={f1} bit_equal={float((d == 0).float().mean())} "
              f"differing_pixels={int((d != 0).sum())} "
              f"count_equal={count_eq} rays_kernel={rk} rays_plain={rp} "
              f"nan_kernel={int(k.nan_count)} nan_plain={int(p.nan_count)} "
              f"max_abs_err={err} mean={float(resolve(k, cfg).mean())} "
              f"{flat_txt}plain_s={t_plain}")
        check(f3 < 0.01 and f1 < 0.001, "kernel vs plain flip fractions")
        check(count_eq, "kernel vs plain valid counts")
        check(abs(rk - rp) <= 0.005 * rp, "kernel vs plain ray counts")
        return var, err

    def depth(w):
        """(pp, samples) of the cases below the main paths: 4 spp at
        256x144 and 60x34, 1 at 1280x720 (the plain version's time grows
        with the samples; the main paths keep their own)."""
        return (1, 1) if w == 1280 else (2, 4)

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
            (W4, 256, 144, 4, 0, 4, True, {}),
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

    # world 1 with its combined set cut to COMBINED_CUT (no power of two:
    # K9's wraps by the sizes' reciprocals; no pyramid, so --mips renders
    # level 0) through both cameras, with --mips and under the other
    # schedule, and as dispersive glass in the CLI's fog (K9's albedo in
    # the dielectric), at 256x144 with 4 spp and 1280x720 with 1
    for w, h in ((256, 144), (1280, 720)):
        pp, n = depth(w)
        for lens, opt in ((False, {}), (True, {}), (False, {"mips": True}),
                          (False, {"schedule": OTHER}), (False, {"glass": 1})):
            b, cp = build_world(W1)
            world1_form(b, "cut glass" if opt.get("glass") else "cut")
            scene = b.finalize(view_origin=cp.pos)
            if opt.get("glass"):
                scene = dataclasses.replace(scene, **FOG)
            _, cam = finalize_world(W1, w, h, use_pinhole=not lens)
            cfg = RenderConfig(w, h, pp=pp, seed=0,
                               schedule=opt.get("schedule"),
                               mip_scale=mip_scale(cam, h) if opt.get("mips")
                               else 0.0)
            held(f"world=1 cut={COMBINED_CUT} lens={lens} options={opt}",
                 scene.to(dev), cam, cfg, n)

    # the feature variants: each feature scene at 256x144 and 1280x720
    # (depth); the CLI's fog on world 6 and on world 3 through the thin
    # lens; world 1 with three planar maps; the mesh tiers: each case at
    # both sizes, through the pinhole and the thin lens (784 under the
    # other schedule too), and the sliver cases
    feature_err = {}
    for tag, w, h, lens in (
            *((n, 256, 144, False) for n in FEATURE_CASES),
            ("everything", 256, 144, True),
            *((n, 1280, 720, False) for n in FEATURE_CASES),
            ("w6 fog", 1280, 720, False), ("w3 fog", 1280, 720, True),
            ("w1 planar", 256, 144, False), ("w1 planar", 1280, 720, False),
            # maps of 500x300: the reciprocal wraps, through both cameras
            *(("w1 planar500", w_, h_, ln) for w_, h_ in ((256, 144),
                                                          (1280, 720))
              for ln in (False, True))):
        scene, cam, cfg_kw = feature_case(tag, w, h, lens)
        pp, n = depth(w)
        var, err = held(f"feature={tag!r} options={cfg_kw}", scene, cam,
                        RenderConfig(w, h, pp=pp, seed=0, **cfg_kw), n)
        check(var.startswith("feature"), f"{tag} takes the feature kernel")
        feature_err[tag] = max(feature_err.get(tag, 0.0), err)
    for tag, w, h, lens, sched in (
            *((t, 256, 144, ln, None) for t in MESH_CASES
              for ln in (False, True)),
            ("tri784", 256, 144, False, MOTHER),
            *((t, 1280, 720, ln, None) for t in MESH_CASES
              for ln in (False, True)),
            ("tri784", 1280, 720, False, MOTHER),
            # K7's row-parallel uv rows, resident and in the DMA tier
            *((t, 256, 144, ln, None) for t in SLIVER_CASES
              for ln in (False, True)),
            *((t, 1280, 720, False, None) for t in SLIVER_CASES)):
        scene, cam = mesh_case(tag, w, h, lens)
        pp, n = depth(w)
        _, err = held(f"mesh={tag} n_tris={scene.n_tris}", scene, cam,
                      RenderConfig(w, h, pp=pp, seed=0, schedule=sched), n)
        feature_err[tag] = max(feature_err.get(tag, 0.0), err)

    # the feature bounce on the other bases (fog, transmission with
    # dispersion, planar and bump maps): each case at 256x144 and 1280x720
    # (depth), through its base's feature variant, the yardstick schedules
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
        ("w1 planar", False, FOTHER),
        # K4t's forms on the other bases and schedules
        ("clustered+brute", False, None), ("clustered+brute", True, None),
        ("textured+brute", False, None), ("textured+brute", True, None),
        ("textured+brute", False, OTHER),
        ("tri40 fog", False, FOTHER))
    feat_vars = set()
    for tag, lens, sched in base_cases:
        for w, h in ((256, 144), (1280, 720)):
            scene, cam = base_case(tag, w, h, lens)
            pp, n = depth(w)
            feat_vars.add(held(f"base={tag!r}", scene, cam, RenderConfig(
                w, h, pp=pp, seed=0, schedule=sched), n)[0])
    check(feat_vars >= {v for v in cb.VARIANTS if v.startswith("feat")
                        and not v.startswith("feature_")}
          | {f"feature_pinhole_{FOTHER}"}, "every feature base held")

    # the streamed walk's 8x4 warp tiles at a size that is not a whole
    # number of tiles (60x34: ragged in x and y), 4 spp: world 7 and the
    # streamed and DMA meshes through both cameras, one in fog, and a mixed
    # base
    for tag, lens, fog in (("w7", False, False), ("w7", True, True),
                           ("tri19600", False, False),
                           ("tri262144", True, False),
                           ("uv99840", False, False),
                           ("tri19600", True, True),
                           ("uv1472s", False, False),
                           ("w2", False, False), ("w4", True, False),
                           ("w2", False, True), ("tri784", False, False),
                           ("tri784", True, True), ("uv736", False, False),
                           ("uv736", True, False)):
        if tag[0] == "w":
            scene, cam = world(BASE_WORLDS[tag], 60, 34, lens,
                               statics=FOG if fog else None)
        else:
            scene, cam = (base_case(f"{tag} fog", 60, 34, lens) if fog
                          else mesh_case(tag, 60, 34, lens))
        held(f"ragged mesh={tag} lens={lens} fog={fog}", scene, cam,
             RenderConfig(60, 34, pp=2, seed=0), 4)
    for case in ("clustered+textured+meshplain", "clustered+textured",
                 "clustered+mesh slivers"):
        scene, cam = mixed_case(case, 60, 34)
        held(f"ragged mixed={case}", scene, cam,
             RenderConfig(60, 34, pp=2, seed=0), 4)
    # the static tier's exact ties (tie_builder) through both cameras
    b, cp = tie_builder()
    tie_scene = b.finalize(world_kind=W5, view_origin=cp.pos).to(dev)
    check(tie_scene.tri_static, "the tie mesh is in the static tier")
    for (tw, th), lens in (((256, 144), False), ((60, 34), True)):
        held(f"ties n_tris={tie_scene.n_tris} lens={lens}", tie_scene,
             define_camera(cp.pos, cp.target, cp.fov, tw, th,
                           use_pinhole=not lens),
             RenderConfig(tw, th, pp=2, seed=0), 4)

    # K4t's walk: its exact ties (brute_tie_builder) through both cameras,
    # then the kernel's intersect (cuda_backend.intersect_probe_cuda)
    # against the plain sweep on the same rays aimed at the meshes' edges
    # and vertices (edge_rays): t, material, normal and uv bit-equal
    b, cp = brute_tie_builder()
    btie = b.finalize(world_kind=W5, view_origin=cp.pos).to(dev)
    check(btie.tri_brute and btie.n_tris == 64, "the tie mesh is brute")
    for (tw, th), lens in (((256, 144), False), ((60, 34), True)):
        held(f"brute ties n_tris={btie.n_tris} lens={lens}", btie,
             define_camera(cp.pos, cp.target, cp.fov, tw, th,
                           use_pinhole=not lens),
             RenderConfig(tw, th, pp=2, seed=0), 4)
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.utils.vec import Vec3
    probe = {}
    for tag, pscene, eye in (
            ("tri40", mesh_case("tri40", 16, 16)[0], mesh_built["tri40"][1].pos),
            ("brute ties", btie, cp.pos),
            ("everything", feature("everything", 16, 16)[0],
             FEATURE_CASES["everything"]()[1][0])):
        nt = pscene.n_tris
        A, u, v = (np.stack([c[:nt].cpu().numpy() for c in t], 1)
                   .astype(np.float64)
                   for t in (pscene.tri_a, pscene.tri_u, pscene.tri_v))
        rays = torch.from_numpy(edge_rays(A, u, v, eye, 16384, 5)).to(dev)
        kt, km, kn, ku, kv, kok = cb.intersect_probe_cuda(pscene, rays)
        pt, pm, pn, pu, pv, pok = cb.intersect_probe_plain(pscene, rays)
        bits = lambda x: x.contiguous().view(torch.int32)
        same = ((bits(kt) == bits(pt)) & (km == pm)
                & (bits(kn) == bits(pn)).all(1) & (bits(ku) == bits(pu))
                & (bits(kv) == bits(pv)) & (kok == pok))
        ro, rd = Vec3(*rays[:, 0:3].T), Vec3(*rays[:, 3:6].T)
        tri_won = int((pt < tint._non_triangles(pscene, ro, rd).t).sum())
        probe[tag] = bool(same.all())
        print(f"phase3 k4t_probe case={tag!r} n_tris={nt} rays={len(rays)} "
              f"triangle_winners={tri_won} bit_equal={int(same.sum())} "
              f"differing={int((~same).sum())}")
    check(all(probe.values()), "K4t's walk bit-equal to the plain sweep on "
          "rays aimed at the meshes' edges and vertices")

    # rays from far away (scene/clusters.py, "A ray from far away"): the
    # kernel's intersect against its plain version, t, material, normal and
    # uv bit-equal, on rays at the meshes' edges and vertices moved back 10^2
    # to 10^5 times their largest coordinate (K4t: the 40-triangle sphere
    # and its 2-cm copy; the static tier: the 784- and 736-triangle meshes)
    # and on rays aimed at worlds 2's and 4's spheres from 10^2 to 10^4
    # units and grazing 2-cm spheres spread over 60 units from near their
    # centre, where the reach is negative (the sphere clusters); then a
    # render of the 2-cm sphere through a 0.02-degree camera 200 units
    # away, whose primary rays all come from beyond K4t's bound and its
    # bounces from near the mesh
    b, _ = build_world(W5, res_dir=str(ROOT / "no asset here"))
    small = (lat_long_sphere(4, 5) * np.float32(0.01)).astype(np.float32)
    m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
    b.set_mesh(small.reshape(-1, 3), np.full((3 * len(small),), m, np.int32))
    far_eye = (-141.42, -141.42, 1.0)
    small_scene = b.finalize(world_kind=W5, view_origin=far_eye).to(dev)
    check(small_scene.tri_brute, "the 2-cm sphere is a brute mesh")
    far = {}
    far_cases = [(t, mesh_case(t, 16, 16)[0])
                 for t in ("tri40", "tri784", "uv736")]
    far_cases.insert(1, ("tri40 x0.01", small_scene))
    far_cases += [(t, world(FAR_KINDS[t], 16, 16)[0]) for t in FAR_SPHERES]
    spread, spread_scene = small_spheres(WorldBuilder)
    spread_tag = "2-cm spheres over 60 units"
    far_cases.append((spread_tag, spread_scene.to(dev)))
    check(spread_scene.sbvh_far[3] < 0, "the spread spheres' reach is negative")
    for tag, pscene in far_cases:
        if tag in FAR_SPHERES or tag == spread_tag:
            z, reach = np.float32(pscene.sbvh_far[:3]), pscene.sbvh_far[3]
            rays = (far_sphere_rays(*FAR_SPHERES[tag], 16384, 7)
                    if tag in FAR_SPHERES
                    else graze_sphere_rays(spread, z, 0.01, 16384, 7))
            s = np.linalg.norm(rays[:, 0:3] - z, axis=1)
            beyond = int((s > reach).sum())
        else:
            nt = pscene.n_tris
            A, u, v = (np.stack([c[:nt].cpu().numpy() for c in t], 1)
                       .astype(np.float64)
                       for t in (pscene.tri_a, pscene.tri_u, pscene.tri_v))
            rays = far_edge_rays(A, u, v, 16384, 7)
            beyond = int((np.abs(rays[:, 0:3]).max(1) > pscene.bvh_far).sum())
        rays = torch.from_numpy(rays).to(dev)
        kt, km, kn, ku, kv, kok = cb.intersect_probe_cuda(pscene, rays)
        pt, pm, pn, pu, pv, pok = cb.intersect_probe_plain(pscene, rays)
        bits = lambda x: x.contiguous().view(torch.int32)
        same = ((bits(kt) == bits(pt)) & (km == pm)
                & (bits(kn) == bits(pn)).all(1) & (bits(ku) == bits(pu))
                & (bits(kv) == bits(pv)) & (kok == pok))
        far[tag] = bool(same.all())
        print(f"phase3 far_probe case={tag!r} rays={len(rays)} "
              f"beyond_bound={beyond} hits={int((pt < 3e38).sum())} "
              f"bit_equal={int(same.sum())} differing={int((~same).sum())}")
    check(all(far.values()), "the walks bit-equal to their plain versions "
          "on rays from far away")
    # K7's grazing rays and the static tier's slivers (ROADMAP queue 3):
    # the kernel's intersect against the plain walks on rays grazing the
    # 19,600-triangle sphere's triangles and at its degenerate pole
    # triangles, from 2 units and moved back 10^2 to 10^4 units (two
    # seeds), and on the 144- and 784-triangle spheres, whose pole slivers
    # the static tier sets apart, moved back 10 to 10^4 times their largest
    # coordinate
    b, _ = build_world(W5, res_dir=str(ROOT / "no asset here"))
    tri144 = tessellated_sphere(144)
    m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
    b.set_mesh(tri144.reshape(-1, 3), np.full((3 * len(tri144),), m, np.int32))
    s144 = b.finalize(world_kind=W5, view_origin=(0.0, 0.0, 0.0)).to(dev)
    grazing = {}
    for tag, pscene, tris, dists in (
            ("k7 tri19600 seed 5", mesh_case("tri19600", 16, 16)[0],
             tessellated_sphere(19600), (0.0, 1e2, 1e3, 1e4)),
            ("k7 tri19600 seed 7", mesh_case("tri19600", 16, 16)[0],
             tessellated_sphere(19600), (0.0, 1e2, 1e3, 1e4)),
            ("static tri144", s144, tri144, (10.0, 1e2, 1e3, 1e4)),
            ("static tri784", mesh_case("tri784", 16, 16)[0],
             tessellated_sphere(800), (10.0, 1e2, 1e3, 1e4))):
        big = 1.0 if tag.startswith("k7") else float(np.abs(tris).max())
        seed = 7 if tag.endswith("7") else 5
        rays = moved_back(grazing_rays(tris, 2048, seed),
                          tuple(x * big for x in dists))
        beyond = int((np.abs(rays[:, 0:3]).max(1) > pscene.bvh_far).sum())
        rays = torch.from_numpy(rays).to(dev)
        kt, km, kn, ku, kv, kok = cb.intersect_probe_cuda(pscene, rays)
        pt, pm, pn, pu, pv, pok = cb.intersect_probe_plain(pscene, rays)
        bits = lambda x: x.contiguous().view(torch.int32)
        same = ((bits(kt) == bits(pt)) & (km == pm)
                & (bits(kn) == bits(pn)).all(1) & (bits(ku) == bits(pu))
                & (bits(kv) == bits(pv)) & (kok == pok))
        grazing[tag] = bool(same.all())
        print(f"phase3 grazing_probe case={tag!r} rays={len(rays)} "
              f"set_apart={pscene.bvh_apart[1]} beyond_bound={beyond} "
              f"hits={int((pt < 3e38).sum())} bit_equal={int(same.sum())} "
              f"differing={int((~same).sum())}")
    check(all(grazing.values()), "K7 and the static tier bit-equal to their "
          "plain walks on grazing rays and at slivers")
    held("far tri40 x0.01 from 200 units", small_scene,
         define_camera(far_eye, (0.0, 0.0, 0.01), 0.02, 256, 144),
         RenderConfig(256, 144, pp=2, seed=0), 4)

    print(f"phase3 mixed_start_s={time.perf_counter() - t_start}")
    # the mixed bases: each case against its plain version at 256x144
    # and 1280x720 (depth; 2 spp at 256x144, to keep the run within its
    # time), each camera once at each size, once with no feature and once
    # in the CLI's fog: every mixed variant, the combined set with a brute
    # mesh (feattextured) and beside clusters, dispersive glass and planar
    # maps on mixed bases
    for case in MIXED_CASES:
        want = mixed_variant(case)
        for (mw, mh), lens, fog in (((256, 144), False, False),
                                    ((256, 144), True, True),
                                    ((1280, 720), True, False),
                                    ((1280, 720), False, True)):
            scene, cam = mixed_case(case, mw, mh, lens, fog)
            pp, n = depth(mw)
            n = min(n, 2)
            got, _ = held(f"mixed={case!r} lens={lens} fog={fog} "
                          f"n_tris={scene.n_tris}", scene, cam,
                          RenderConfig(mw, mh, pp=pp, seed=0), n)
            check(got == want or want.endswith("_")
                  and got.startswith(want), f"{case}'s case takes {got}")
    # the cases of the BVH walks (a variant with sphere clusters, or one
    # that walks the streamed or the static tier) with every pixel bit-equal
    bvh = {k: v for k, v in differing.items() if walks_bvh(k.split(" ")[-1])}
    print(f"phase3 bvh_walk_cases={len(bvh)} "
          f"bit_equal={sum(v == 0 for v in bvh.values())} "
          f"not_bit_equal={json.dumps({k: v for k, v in differing.items() if v})} "
          f"all_cases={len(differing)} "
          f"all_bit_equal={sum(v == 0 for v in differing.values())}")
    # the feature variants' and the textured lockstep pair's cases: this
    # kernel and the yardstick
    print(f"phase3 yardstick_cases={len(same_as_flat)} "
          f"equal_to_yardstick={sum(same_as_flat.values())} "
          f"regrouped_cases={sum(k.split(' ')[-1] in regrouped for k in same_as_flat)} "
          f"differing={json.dumps([k for k, v in same_as_flat.items() if not v])}")
    check(all(same_as_flat.values()), "every feature and textured lockstep "
          "case equal to the yardstick (YARDSTICK_DEFINES)")
    check(all(v == 0 for v in differing.values()),
          "every case bit-equal to its plain version")

    # --- 4. the main paths at full width -------------------------------------
    print(f"phase4 start_s={time.perf_counter() - t_start}")
    w, h = 1280, 720
    launches = dict.fromkeys(cb.VARIANTS, 0)
    case_launches = {}  # (variant, case) -> launches of that case's path

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
        fvar = cb.variant(scene, cam)
        reset_counts()
        img, _, state = render_image(scene, cam, RenderConfig(
            w, h, pp=4, seed=0, **cfg_kw), device="cuda")
        sync()
        read_counts(fvar, f"the {fname} scene's")
        path_launches[fname] = cb.VARIANT_LAUNCHES[fvar]
        img = img.cpu().numpy()
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.max()) > 0.0, f"finite, non-black {fname} image")
        print(f"phase4g scene={fname} variant={fvar} "
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
            *((t, 2, False, None) for t in SLIVER_CASES),
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
        case_launches[(var, tag)] = cb.VARIANT_LAUNCHES[var]
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
    # lens and the yardstick schedules of worlds 1, 7 and 6 in fog, the
    # mesh cases in fog through both cameras, and K4t's forms on the other
    # bases and schedules (the 40-triangle mesh beside sphere clusters and
    # beside the combined set)
    for tag, lens, sched in (
            ("w1 fog", True, None), ("w1 fog", False, OTHER),
            ("w7 fog", True, None), ("w7 fog", False, MOTHER),
            ("w6 fog", False, FOTHER),
            *((f"{t} fog", ln, None) for t in MESH_CASES
              for ln in (False, True)),
            ("tri40 fog", False, FOTHER), ("clustered+brute", True, None),
            ("textured+brute", True, None),
            ("textured+brute", False, OTHER)):
        scene, cam = base_case(tag, w, h, lens)
        cfg = RenderConfig(w, h, pp=2, seed=0, schedule=sched)
        var = cb.variant(scene, cam, sched)
        reset_counts()
        img, _, state = render_image(scene, cam, cfg, device="cuda")
        sync()
        read_counts(var, f"the {tag} case's")
        case_launches[(var, tag)] = cb.VARIANT_LAUNCHES[var]
        img = img.cpu().numpy()
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.mean()) > 0.01, f"finite, non-black {tag} image")
        print(f"phase4k case={tag!r} variant={var} launches={launches[var]} "
              f"spp=4 mean={float(img.mean())} rays={int(state.rays_cast)} "
              f"nan={int(state.nan_count)}")
    print(f"phase4 mixed_start_s={time.perf_counter() - t_start}")
    # l. the mixed scenes through render_image, 4 spp in one chunk: one
    # launch of each scene's own variant (K4t's forms for a brute mesh)
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
        if var in cb.MIXED_VARIANTS or not launches[var]:
            launches[var] = cb.VARIANT_LAUNCHES[var]
        case_launches[(var, case)] = cb.VARIANT_LAUNCHES[var]
        img = img.cpu().numpy()
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
              and float(img.mean()) > 0.01, f"finite, non-black {case} image")
        print(f"phase4l case={case} n_tris={scene.n_tris} "
              f"clusters={len(scene.sph_clusters)} variant={var} "
              f"launches={cb.LAUNCHES} variant_launches="
              f"{json.dumps({k_: v for k_, v in cb.VARIANT_LAUNCHES.items() if v})} "
              f"spp=4 mean={float(img.mean())} rays={int(state.rays_cast)} "
              f"nan={int(state.nan_count)}")
    check(all(launches[v] > 0 for v in cb.VARIANTS), "every variant's main "
          "path launched it")

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

    scan_lib, _, _, scan_build_s = yardstick.result()
    pool.shutdown()
    print(f"phase5 scanline_yardstick_build_s={scan_build_s}")
    warps = {}  # BVH row -> (median ms with 8x4 tiles, with scanline warps)
    turns = {}  # feature row -> (median ms, with -DWAVE_NO_REGROUP)
    blocks = {}  # textured lockstep row -> (median ms, -DWAVE_BLOCK_LOCKSTEP)

    def row_ms(row, scene, cam, var=None, **cfg_kw):
        """A row's kernel ms at 720p, 4 spp, and its rays: five launches
        after a warm one (kernel_ms); for a feature variant's row, this
        build and the -DWAVE_NO_REGROUP yardstick, for another row of a BVH
        walk (the streamed walk, K7, the sphere clusters', K5, or the
        static tier's) this build and the scanline-warp yardstick, in turns
        after a warm launch each and a launch of this build whose time is
        dropped (this, yardstick, yardstick, this, yardstick, this, this,
        yardstick: each first in one half), the
        yardstick's times and whether its sums equal this build's given as
        text for the row's line; ``var``: the row's variant where the row
        is not named by it."""
        var = var or row.split(" ")[0]
        if feature_bounce(var):
            other, lib = "no_regroup", flat_lib
        elif var in TEXTURED_LOCKSTEP:
            other, lib = "block_lockstep", flat_lib
        elif walks_bvh(var):
            other, lib = "scanline", scan_lib
        else:
            return (*kernel_ms(scene, cam, 2, 5, **cfg_kw), "")
        cfg = RenderConfig(w, h, pp=2, seed=0, **cfg_kw)
        libs = {"this": tile_lib, other: lib}
        res, sums = {"this": [], other: []}, {}
        try:
            for which in libs:
                cb._lib = libs[which]
                cb.render_chunk_cuda(scene, cam, cfg, 0, 0, 4,
                                     init_accum(w * h, dev))
            # the first timed launch is dropped, as in_turns drops it
            for j, which in enumerate(("this", "this", other, other, "this",
                                       other, "this", "this", other)):
                cb._lib = libs[which]
                st = init_accum(w * h, dev)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                cb.render_chunk_cuda(scene, cam, cfg, 0, 0, 4, st)
                b.record()
                sync()
                if j:
                    res[which].append(a.elapsed_time(b))
                sums[which] = st
        finally:
            cb._lib = tile_lib
        t_med, o_med = np.median(res["this"]), np.median(res[other])
        if other == "scanline":
            warps[row] = (t_med, o_med)
        elif other == "block_lockstep":
            blocks[row] = (t_med, o_med)
        else:
            turns[row] = (var, t_med, o_med)
        same = all(torch.equal(x, y) for x, y in zip(
            (*sums["this"].sum, sums["this"].count),
            (*sums[other].sum, sums[other].count)))
        return res["this"], int(sums["this"].rays_cast), (
            f"{other}_ms={sorted(res[other])} "
            f"this_over_{other}={t_med / o_med} "
            f"{other}_sums_equal={same} ")

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
                   "wave_kernel<feature_pinhole_k4t> everything",
                   "pathtracer_tpu/ops/intersect.py:1261"),
        "K4t plain": ("tri40", False, "wave_kernel<feature_pinhole_k4t>",
                      "pathtracer_tpu/ops/intersect.py:1172"),
        "transmission": ("dispersion", False, None, None),
        "large planar stack": ("w1 planar", False, None, None),
    }
    # the mesh tiers' variants: variant -> (mesh case, thin lens, schedule,
    # the JAX code it replaces)
    tier_rows = {
        # K7's row-parallel uv form: the fetch_uv branch over
        # clusters.pack_stream_uv's rows, resident and in the DMA tier
        "mesh_pinhole uv1472s": ("uv1472s", False, None, "intersect.py:482"),
        "mesh_pinhole uv99840s": ("uv99840s", False, None,
                                  "intersect.py:482"),
        "staticplain_pinhole": ("tri784", False, None, "intersect.py:225"),
        "staticplain_lens": ("tri784", True, None, "intersect.py:225"),
        f"staticplain_pinhole_{MOTHER}": ("tri784", False, MOTHER,
                                          "intersect.py:225"),
        "static_pinhole": ("uv736", False, None, "intersect.py:1309"),
        "static_lens": ("uv736", True, None, "intersect.py:1309"),
        "meshplain_pinhole": ("tri19600", False, None, "intersect.py:262"),
        "meshplain_lens": ("tri19600", True, None, "intersect.py:262"),
        "meshplain_pinhole tri262144": ("tri262144", False, None,
                                        "intersect.py:815"),
        "meshplain_lens tri262144": ("tri262144", True, None,
                                     "intersect.py:815"),
        "mesh_pinhole uv99840": ("uv99840", False, None, "intersect.py:815"),
        "mesh_lens uv99840": ("uv99840", True, None, "intersect.py:815"),
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
        **{f"feat{kind}_{c}{label}": (f"{tag} fog", c == "lens", None,
                                      "ops/intersect.py:" + line)
           for tag, kind, line, label in (
               ("tri784", "staticplain", "225", ""),
               ("uv736", "static", "1309", ""),
               ("tri19600", "meshplain", "262", ""),
               ("tri262144", "meshplain", "815", " tri262144"),
               ("uv99840", "mesh", "815", " uv99840"))
           for c in ("pinhole", "lens")},
        f"feature_pinhole_{FOTHER}": ("w6 fog", False, FOTHER,
                                      "render/pallas_backend.py:306"),
        # K4t's forms on the other bases and schedules (the 40-triangle
        # mesh alone, beside sphere clusters, beside the combined set)
        "feature_lens_k4t": ("tri40", True, None, "ops/intersect.py:1172"),
        f"feature_pinhole_{FOTHER}_k4t": ("tri40", False, FOTHER,
                                          "ops/intersect.py:1172"),
        **{f"feat{base}_{c}_k4t": (f"{base}+brute", c == "lens", None,
                                   "ops/intersect.py:1172")
           for base in ("clustered", "textured") for c in ("pinhole", "lens")},
        f"feattextured_pinhole_{OTHER}_k4t": ("textured+brute", False, OTHER,
                                              "ops/intersect.py:1172"),
    }
    # the mixed rows: each variant on its case, the DMA tier's cases, and
    # the mixed base with a brute mesh (K4t's form)
    mixed_rows = (*cb.MIXED_VARIANTS,
                  *(c for c in MIXED_CASES if c.endswith(" dma")),
                  "clustered+textured+brute")
    check(sorted({r.split(" ")[0] for r in (
        *main_worlds, "feature_pinhole", "feature_lens", "feature_pinhole_k4t",
        *tier_rows, *new_rows, *map(mixed_variant, mixed_rows))})
        == sorted(cb.VARIANTS), "every variant timed")
    timed = {}
    for var, (kind, lens, schedule) in main_worlds.items():
        scene, cam = world(kind, w, h, lens)
        ks, rays, warp_txt = row_ms(var, scene, cam, schedule=schedule)
        ps, prays = plain_s(scene, cam, 2, schedule=schedule)
        timed[var] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                          cam=cam, plain_ms=1e3 * ps, schedule=schedule)
        print(f"phase5 variant={var} world={kind + 1} 720p spp=4 "
              f"{earlier(var)}kernel_ms={sorted(ks)} {warp_txt}rays={rays} "
              f"kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6}")

    ftimed = {}
    for row, (tag, lens, _, _) in feature_rows.items():
        scene, cam, cfg_kw = feature_case(tag, w, h, lens)
        ks, rays, turn_txt = row_ms(row, scene, cam, cb.variant(scene, cam),
                                    **cfg_kw)
        ps, prays = plain_s(scene, cam, 2, **cfg_kw)
        ftimed[row] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                           cam=cam, cfg_kw=cfg_kw, plain_ms=1e3 * ps)
        print(f"phase5 row={row!r} case={tag!r} "
              f"variant={cb.variant(scene, cam)} 720p spp=4 {earlier(row)}"
              f"kernel_ms={sorted(ks)} {turn_txt}rays={rays} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6} "
              f"| card: {smi}")

    ttimed = {}
    for row, (tag, lens, sched, _) in tier_rows.items():
        var = row.split(" ")[0]
        scene, cam = mesh_case(tag, w, h, lens)
        check(cb.variant(scene, cam, sched) == var, f"{tag} takes {var}")
        ks, rays, warp_txt = row_ms(row, scene, cam, schedule=sched)
        ps, prays = plain_s(scene, cam, 2, schedule=sched)
        ttimed[row] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                           cam=cam, plain_ms=1e3 * ps, schedule=sched)
        print(f"phase5 variant={var} row={row!r} mesh={tag} "
              f"n_tris={scene.n_tris} dma={scene.tri_dma} "
              f"bvh_depth={scene.bvh_depth} finalize_s={mesh_built[tag][2]} "
              f"720p spp=4 {earlier(row)}"
              f"kernel_ms={sorted(ks)} {warp_txt}rays={rays} "
              f"rays_per_sample={rays / (w * h * 4)} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6} "
              f"| card: {smi}")
    ntimed = {}
    for row, (tag, lens, sched, _) in new_rows.items():
        var = row.split(" ")[0]
        scene, cam = base_case(tag, w, h, lens)
        check(cb.variant(scene, cam, sched) == var, f"{tag} takes {var}")
        ks, rays, warp_txt = row_ms(row, scene, cam, schedule=sched)
        ps, prays = plain_s(scene, cam, 2, schedule=sched)
        ntimed[row] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                           cam=cam, plain_ms=1e3 * ps)
        print(f"phase5 variant={var} row={row!r} case={tag!r} 720p spp=4 "
              f"{earlier(row)}"
              f"kernel_ms={sorted(ks)} {warp_txt}rays={rays} "
              f"rays_per_sample={rays / (w * h * 4)} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6} "
              f"| card: {smi}")
    print(f"phase5 mixed_start_s={time.perf_counter() - t_start}")
    mtimed = {}
    for row in mixed_rows:
        scene, cam = mixed_case(row, w, h)
        ks, rays, warp_txt = row_ms(row, scene, cam, cb.variant(scene, cam))
        ps, prays = plain_s(scene, cam, 2)
        mtimed[row] = dict(ms=float(np.median(ks)), rays=rays, scene=scene,
                           cam=cam, plain_ms=1e3 * ps)
        print(f"phase5 variant={cb.variant(scene, cam)} row={row!r} "
              f"n_tris={scene.n_tris} dma={scene.tri_dma} "
              f"finalize_s={mixed_built[row][2]} 720p spp=4 {earlier(row)}"
              f"kernel_ms={sorted(ks)} {warp_txt}rays={rays} "
              f"rays_per_sample={rays / (w * h * 4)} kernel_mrays_s="
              f"{rays / np.median(ks) / 1e3} plain_ms={1e3 * ps} "
              f"plain_rays={prays} plain_mrays_s={prays / ps / 1e6} "
              f"| card: {smi}")
    # the regroup's turns: each feature variant's rows, this build over the
    # -DWAVE_NO_REGROUP yardstick, and the geometric mean of its rows
    by_var = {}
    for var, t_, o_ in turns.values():
        by_var.setdefault(var, []).append(t_ / o_)
    gmean = {v: float(np.exp(np.mean(np.log(r)))) for v, r in by_var.items()}
    check(sorted(gmean) == sorted(v for v in cb.VARIANTS if feature_bounce(v)),
          "every feature variant timed against the yardstick")
    faster = sorted(v for v, g in gmean.items() if g < 1.0)
    print(f"phase5 regroup rows={len(turns)} "
          f"this_over_no_regroup={json.dumps({r: t_ / o_ for r, (_, t_, o_) in turns.items()})} "
          f"by_variant={json.dumps(gmean)} faster={json.dumps(faster)} "
          f"regrouped={json.dumps(regrouped)} "
          f"regrouped_all_faster={all(gmean[v] < 1.0 for v in regrouped)} "
          f"| card: {smi}")
    # K3's yardstick: world 1's textured lockstep rows, this build's
    # per-warp loop over the block-lockstep loop laid out by lobe
    check(sorted(blocks) == sorted(TEXTURED_LOCKSTEP),
          "the textured lockstep pair timed against the block-lockstep loop")
    print(f"phase5 block_lockstep rows={len(blocks)} this_over_block_lockstep="
          f"{json.dumps({r: t_ / o_ for r, (t_, o_) in blocks.items()})} "
          f"| card: {smi}")
    for walk, of in (("k7", walks_k7), ("k5", walks_spheres),
                     ("static", walks_static)):
        ratios = {r: t / s_ for r, (t, s_) in warps.items()
                  if of(r.split(" ")[0])}
        print(f"phase5 warp_tiles walk={walk} rows={len(ratios)} "
              f"tiles_faster={sum(v < 1.0 for v in ratios.values())} "
              f"median_tiles_over_scanline="
              f"{np.median(list(ratios.values()))} "
              f"tiles_over_scanline={json.dumps(ratios)} | card: {smi}")
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

    def k3_replay(var, scene, cam):
        """The replay of a textured lockstep row's samples 0-1 at 720p
        (regroup.lockstep_tally), printed beside its row: over the
        variant's warp map and, for the pinhole, over scanline warps and
        JAX's texel sort: lane use in place, packed and laid out by coin
        (the block-lockstep loop), the four lobes' branch runs in place and
        laid out, the sectors of a warp's bounce-0 K9 fetch."""
        from pathtracer_tpu_torch.render import regroup
        cfg2 = RenderConfig(w, h, pp=2, seed=0)
        maps = {"tiles" if warp_tiles(var) else "scanlines": {
            "tiles": warp_tiles(var)}}
        if var == "textured_pinhole":
            maps["scanlines"] = {"tiles": False}
            maps["texel_sort"] = {"lanes": regroup.texel_sort_lanes(
                scene, cam, cfg2, dev)}
        for name, kw in maps.items():
            t_ = regroup.lockstep_tally(scene, cam, cfg2, 2, device=dev, **kw)
            print(f"phase6 k3_replay variant={var} warp_map={name} 720p "
                  f"samples=0-1 lane_use={t_['lane_use']} "
                  f"lane_use_packed={t_['lane_use_compacted']} "
                  f"lane_use_coin_layout={t_['lane_use_coin']} "
                  f"runs_in_place={t_['runs_in_place']} "
                  f"runs_two_way={t_['runs_two_way']} "
                  f"runs_four_way={t_['runs_four_way']} "
                  f"runs_coin_layout={t_['runs_coin']} "
                  f"two_way_over_in_place="
                  f"{t_['runs_two_way'] / t_['runs_in_place']} "
                  f"four_way_over_in_place="
                  f"{t_['runs_four_way'] / t_['runs_in_place']} "
                  f"blocks={t_['blocks']} "
                  f"blocks_regrouped={t_['blocks_regrouped']} "
                  f"sectors_per_warp_fetch={t_['sectors_per_warp_fetch']} "
                  f"rays={t_['lane_bounces']}")

    table = []
    mesh_tally = {}
    for var, tm in timed.items():
        t_row = time.perf_counter()
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0, schedule=tm["schedule"])
        fetches, albedo, mesh_txt, k7, sph, sph_txt = 0, 0, "", None, None, ""
        if scene.sph_clusters:
            wrays, slabs, spheres, bvh_slabs, bvh_spheres, sph_far = \
                walk_tests(scene, cam, cfg4, 4, dev)
            check(abs(wrays - tm["rays"]) <= 0.005 * tm["rays"],
                  f"{var}: walked {wrays} rays, the kernel cast {tm['rays']}")
            sph = sphere_terms(scene, slabs, spheres, bvh_slabs, bvh_spheres)
            sph_txt = (f"bvh_slab_tests_per_ray={bvh_slabs} "
                       f"bvh_sphere_tests_per_ray={bvh_spheres} "
                       f"far_rays={sph_far} ")
            isect_ops = 0.0
        else:
            slabs, spheres = 0.0, float(scene.n_spheres)
            isect_ops = spheres * OPS_SPHERE
        if cb.textured(scene):
            frays, fetches, albedo = tex_fetches(scene, cam, cfg4, 4, dev)
            check(abs(frays - tm["rays"]) <= 0.005 * tm["rays"],
                  f"{var}: counted {frays} rays, the kernel cast {tm['rays']}")
        if cb.meshed(scene):
            # the lockstep yardstick casts the pinhole's rays: its counts
            if var != f"mesh_pinhole_{MOTHER}":
                mesh_tally[var] = mesh_counts(scene, cam, cfg4, 4, dev)
            mrays, boxes, tris, wins, fetches, bvh_boxes, bvh_tris, _, _ = \
                mesh_tally["mesh_lens" if var == "mesh_lens"
                           else "mesh_pinhole"]
            check(abs(mrays - tm["rays"]) <= 0.005 * tm["rays"],
                  f"{var}: walked {mrays} rays, the kernel cast {tm['rays']}")
            k7 = k7_terms(scene, boxes, tris, bvh_boxes, bvh_tris)
            isect_ops += wins * OPS_MESH_UV
            mesh_txt = (f"box_tests_per_ray={boxes} tri_tests_per_ray={tris} "
                        f"tri_wins_per_ray={wins} "
                        f"bvh_box_tests_per_ray={bvh_boxes} "
                        f"bvh_tri_tests_per_ray={bvh_tris} ")
        isect_ops += (scene.n_quads * OPS_QUAD + scene.n_planes * OPS_PLANE
                      + OPS_RESOLVE + OPS_EMIT)
        samples = w * h * 4
        rays = tm["rays"]
        # every ray intersects; each path's last ray is not shaded
        ops = (samples * OPS_PRIMARY[var.split("_")[1]] + rays * isect_ops
               + (rays - samples) * OPS_SHADE
               + (fetches * OPS_STACK if cb.meshed(scene)
                  else fetches * OPS_TEX_TOP + albedo * OPS_TEX_ALBEDO))
        nbytes = w * h * BYTES_PER_PIXEL + (
            scene.tex_tile.numel() * 4 if cb.textured(scene) else 0)
        if cb.meshed(scene):
            nbytes += 4 * scene.planar_tile.numel()
        bound_ms, bound_by, ops, nbytes, bound_old = row_bound(
            ops, nbytes, rays, k7, sph)
        # the bound with the per-test quads' operations (the earlier count)
        bound_quads = bound(ops + rays * scene.n_quads
                            * (OPS_QUAD_PER_TEST - OPS_QUAD), nbytes)[0]
        if var in TEXTURED_LOCKSTEP:
            k3_replay(var, scene, cam)
        print(f"phase6 count_s={time.perf_counter() - t_row} "
              f"variant={var} slab_tests_per_ray={slabs} "
              f"sphere_tests_per_ray={spheres} {sph_txt}{mesh_txt}"
              f"tex_fetches={fetches} tex_albedo_blends={albedo} "
              f"ops={ops:.6e} bytes={nbytes} bound_ms={bound_ms} "
              f"bound_share={bound_ms / tm['ms']} "
              f"bound_ms_table_order={bound_old} "
              f"bound_ms_per_test_quads={bound_quads}")
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
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this
            **bvh_note(var), **old_bound(bound_old),
        })
    for row, (tag, lens, kname, replaces) in feature_rows.items():
        t_row = time.perf_counter()
        tm = ftimed[row]
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0, **tm["cfg_kw"])
        var = cb.variant(scene, cam)
        tally = render_counts(scene, cam, cfg4, 4, dev, warp_tiles(var))
        fc = {k_: tally[k_] for k_ in FEATURE_KEYS}
        issue = {k_: tally[k_] for k_ in REPLAY_KEYS}
        rays = tm["rays"]
        check(abs(fc["rays"] - rays) <= 0.005 * rays,
              f"{row}: counted {fc['rays']} rays, the kernel cast {rays}")
        k4t = (brute_terms(scene, tally["brute_boxes"] / rays,
                           tally["brute_tris"] / rays)
               if scene.tri_brute else None)
        isect_ops = (scene.n_spheres * OPS_SPHERE + scene.n_quads * OPS_QUAD
                     + scene.n_planes * OPS_PLANE + OPS_RESOLVE + OPS_EMIT
                     + (OPS_FOG_FLIGHT if scene.fog_sigma_t > 0.0 else 0))
        samples = w * h * 4
        ops = (samples * OPS_PRIMARY["lens" if lens else "pinhole"]
               + rays * isect_ops + fc["opaque"] * OPS_SHADE
               + fc["refract"] * OPS_REFRACT
               + fc["scatter"] * OPS_FOG_SCATTER
               + planar_ops(fc)
               + fc["bump"] * OPS_BUMP + fc["uv_fetch"] * OPS_STACK)
        nbytes = w * h * BYTES_PER_PIXEL + 4 * sum(
            t.numel() for t in texture_tables(scene))
        bound_ms, bound_by, ops, nbytes, bound_old = row_bound(
            ops, nbytes, rays, k4t)
        counts = " ".join(f"{k_}={v}" for k_, v in fc.items())
        walk_txt = (f"n_tris={scene.n_tris} "
                    f"k4t_box_tests_per_ray={tally['brute_boxes'] / rays} "
                    f"k4t_tri_tests_per_ray={tally['brute_tris'] / rays} "
                    f"k4t_far_rays={tally.get('brute_far', 0)} "
                    f"bound_ms_table_order={bound_old} " if k4t else "")
        print(f"phase6 count_s={time.perf_counter() - t_row} "
              f"row={row!r} case={tag!r} variant={var} {counts} "
              f"{walk_txt}ops={ops:.6e} bytes={nbytes} bound_ms={bound_ms} "
              f"bound_share={bound_ms / tm['ms']} {issue_text(issue)} "
              f"| card: {smi}")
        if kname is None:
            continue
        table.append({
            "name": kname, "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            "replaces": replaces,
            "launches": path_launches[tag],
            "max_abs_err": (max_err[var] if row.startswith("feature")
                            else feature_err[tag]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this
            **regroup_note(var, issue, regrouped),
            **k4t_note(k4t, tally["brute_boxes"] / rays,
                       tally["brute_tris"] / rays), **old_bound(bound_old),
        })
    for row, (tag, lens, sched, replaces) in tier_rows.items():
        t_row = time.perf_counter()
        var = row.split(" ")[0]
        tm = ttimed[row]
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0, schedule=sched)
        # the other schedule's yardstick casts the pinhole's rays
        if (tag, lens) not in mesh_tally:
            mesh_tally[(tag, lens)] = mesh_counts(scene, cam, cfg4, 4, dev)
        (mrays, boxes, tris, wins, fetches, bvh_boxes, bvh_tris,
         table_rays, static_far) = mesh_tally[(tag, lens)]
        rays = tm["rays"]
        check(abs(mrays - rays) <= 0.005 * rays,
              f"{row}: walked {mrays} rays, the kernel cast {rays}")
        walk = mesh_terms(scene, boxes, tris, bvh_boxes, bvh_tris, wins)
        # the streamed tier's winners' uv (the static tier's: static_terms)
        win_ops = OPS_MESH_UV if scene.tri_streamed and scene.has_mesh_uvs \
            else 0
        isect_ops = (wins * win_ops + scene.n_spheres * OPS_SPHERE
                     + scene.n_quads * OPS_QUAD + scene.n_planes * OPS_PLANE
                     + OPS_RESOLVE + OPS_EMIT)
        samples = w * h * 4
        ops = (samples * OPS_PRIMARY["lens" if lens else "pinhole"]
               + rays * isect_ops + (rays - samples) * OPS_SHADE
               + fetches * OPS_STACK)
        # the walk's tables are mesh_terms'
        tables = (scene.planar_tile,) if scene.has_mesh_uvs else ()
        nbytes = w * h * BYTES_PER_PIXEL + 4 * sum(t.numel() for t in tables)
        bound_ms, bound_by, ops, nbytes, bound_old = row_bound(
            ops, nbytes, rays, walk)
        print(f"phase6 count_s={time.perf_counter() - t_row} "
              f"variant={var} row={row!r} mesh={tag} "
              f"box_tests_per_ray={boxes} tri_tests_per_ray={tris} "
              f"tri_wins_per_ray={wins} bvh_box_tests_per_ray={bvh_boxes} "
              f"bvh_tri_tests_per_ray={bvh_tris} table_rays={table_rays} "
              f"far_rays={static_far} "
              f"uv_fetches={fetches} ops={ops:.6e} bytes={nbytes} "
              f"bound_ms={bound_ms} bound_share={bound_ms / tm['ms']} "
              f"bound_ms_table_order={bound_old} | card: {smi}")
        table.append({
            "name": row_name(row), "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            "replaces": "pathtracer_tpu/ops/" + replaces,
            "launches": case_launches.get((var, tag), launches[var]),
            "max_abs_err": max_err[var],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this
            **bvh_note(var), **old_bound(bound_old),
        })
    # the feature bounce on the other bases: the feature counts of each
    # case's rays, with its base's walk counted as the base's rows count it
    # (the yardsticks cast the main schedule's rays: the same counts)
    ncounts = {}
    for row, (tag, lens, sched, replaces) in new_rows.items():
        t_row = time.perf_counter()
        var = row.split(" ")[0]
        tm = ntimed[row]
        scene, cam = tm["scene"], tm["cam"]
        cfg4 = RenderConfig(w, h, pp=2, seed=0)
        if (tag, lens, warp_tiles(var)) not in ncounts:
            # the feature tallies and the base's walk in one pass
            tally = render_counts(scene, cam, cfg4, 4, dev, warp_tiles(var))
            fc = {k_: tally[k_] for k_ in FEATURE_KEYS}
            issue = {k_: tally[k_] for k_ in REPLAY_KEYS}
            per = {k_: v / fc["rays"] for k_, v in tally.items()}
            base_txt, k7, sph = "", None, None
            if scene.sph_clusters:
                slabs, spheres, bvh_slabs, bvh_spheres = (
                    per["slabs"], per["spheres"], per["bvh_slabs"],
                    per["bvh_spheres"])
                sph = sphere_terms(scene, slabs, spheres, bvh_slabs,
                                   bvh_spheres)
                base_ops = 0.0
                base_txt = (f"slab_tests_per_ray={slabs} "
                            f"sphere_tests_per_ray={spheres} "
                            f"bvh_slab_tests_per_ray={bvh_slabs} "
                            f"bvh_sphere_tests_per_ray={bvh_spheres}")
            elif cb.meshed(scene):
                boxes, tris, wins, bvh_boxes, bvh_tris = (
                    per["boxes"], per["tris"], per["wins"], per["bvh_boxes"],
                    per["bvh_tris"])
                table_rays = tally["table_rays"]
                k7 = mesh_terms(scene, boxes, tris, bvh_boxes, bvh_tris, wins)
                win_ops = (OPS_MESH_UV if scene.tri_streamed
                           and scene.has_mesh_uvs else 0)
                base_ops = wins * win_ops + scene.n_spheres * OPS_SPHERE
                base_txt = (f"box_tests_per_ray={boxes} "
                            f"tri_tests_per_ray={tris} tri_wins_per_ray={wins}"
                            f" bvh_box_tests_per_ray={bvh_boxes} "
                            f"bvh_tri_tests_per_ray={bvh_tris} "
                            f"table_rays={table_rays} "
                            f"far_rays={tally.get('static_far', 0)}")
            else:
                base_ops = scene.n_spheres * OPS_SPHERE
            k4t_tests = (per["brute_boxes"], per["brute_tris"])
            k4t = (brute_terms(scene, *k4t_tests) if scene.tri_brute
                   else None)
            if k4t:
                base_txt += (f" n_tris={scene.n_tris} k4t_box_tests_per_ray="
                             f"{k4t_tests[0]} k4t_tri_tests_per_ray="
                             f"{k4t_tests[1]}")
            ncounts[(tag, lens, warp_tiles(var))] = (
                fc, issue, base_ops, base_txt, k7, sph, k4t, k4t_tests)
        fc, issue, base_ops, base_txt, k7, sph, k4t, k4t_tests = ncounts[
            (tag, lens, warp_tiles(var))]
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
               + planar_ops(fc)
               + fc["bump"] * OPS_BUMP + fc["uv_fetch"] * OPS_STACK
               + tex_ops(fc))
        tables = ((scene.tex_tile,) if cb.textured(scene) else
                  texture_tables(scene))
        nbytes = w * h * BYTES_PER_PIXEL + 4 * sum(t.numel() for t in tables)
        bound_ms, bound_by, ops, nbytes, bound_old = row_bound(
            ops, nbytes, rays, k7, sph, k4t)
        counts = " ".join(f"{k_}={v}" for k_, v in fc.items())
        print(f"phase6 count_s={time.perf_counter() - t_row} "
              f"variant={var} row={row!r} case={tag!r} {base_txt} "
              f"{counts} ops={ops:.6e} bytes={nbytes} bound_ms={bound_ms} "
              f"bound_share={bound_ms / tm['ms']} "
              f"bound_ms_table_order={bound_old} {issue_text(issue)} "
              f"| card: {smi}")
        table.append({
            "name": row_name(row), "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            "replaces": "pathtracer_tpu/" + replaces,
            "launches": (case_launches.get((var, tag), launches[var])
                         if row != var else launches[var]),
            "max_abs_err": max_err[var],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this
            **bvh_note(var), **old_bound(bound_old),
            **regroup_note(var, issue, regrouped), **k4t_note(k4t, *k4t_tests),
        })
    # the mixed bases: one pass counts the feature tallies and both walks
    print(f"phase6 mixed_start_s={time.perf_counter() - t_start}")
    for row, tm in mtimed.items():
        t_row = time.perf_counter()
        scene, cam = tm["scene"], tm["cam"]
        var = cb.variant(scene, cam)
        fc = render_counts(scene, cam, RenderConfig(w, h, pp=2, seed=0), 4, dev,
                           warp_tiles(var))
        issue = {k_: fc.pop(k_) for k_ in REPLAY_KEYS}
        rays = tm["rays"]
        check(abs(fc["rays"] - rays) <= 0.005 * rays,
              f"{var}: counted {fc['rays']} rays, the kernel cast {rays}")
        k7 = sph = None
        k4t = (brute_terms(scene, fc["brute_boxes"] / rays,
                           fc["brute_tris"] / rays)
               if scene.tri_brute else None)
        if scene.sph_clusters:
            sph = sphere_terms(scene, fc["slabs"] / rays, fc["spheres"] / rays,
                               fc["bvh_slabs"] / rays,
                               fc["bvh_spheres"] / rays)
            walk_ops = 0.0
        else:
            walk_ops = rays * scene.n_spheres * OPS_SPHERE
        tables = (scene.tex_tile,) if cb.textured(scene) else ()
        if cb.meshed(scene):
            k7 = mesh_terms(scene, fc["boxes"] / rays, fc["tris"] / rays,
                            fc["bvh_boxes"] / rays, fc["bvh_tris"] / rays,
                            fc["wins"] / rays)
            # the streamed tier's winners' uv (the static tier's: in
            # static_terms); the walk's tables are mesh_terms'
            if scene.tri_streamed and scene.has_mesh_uvs:
                walk_ops += fc["wins"] * OPS_MESH_UV
            if scene.has_mesh_uvs:
                tables += (scene.planar_tile,)
        ops = (w * h * 4 * OPS_PRIMARY["pinhole"] + walk_ops
               + rays * (scene.n_quads * OPS_QUAD
                         + scene.n_planes * OPS_PLANE + OPS_RESOLVE
                         + OPS_EMIT)
               + fc["opaque"] * OPS_SHADE + fc["refract"] * OPS_REFRACT
               + fc["scatter"] * OPS_FOG_SCATTER + fc["uv_fetch"] * OPS_STACK
               + tex_ops(fc))
        nbytes = w * h * BYTES_PER_PIXEL + 4 * sum(t.numel() for t in tables)
        bound_ms, bound_by, ops, nbytes, bound_old = row_bound(
            ops, nbytes, rays, k7, sph, k4t)
        counts = " ".join(f"{k_}={v}" for k_, v in fc.items())
        print(f"phase6 count_s={time.perf_counter() - t_row} "
              f"variant={var} row={row!r} {counts} "
              f"slab_tests_per_ray={fc['slabs'] / rays} "
              f"sphere_tests_per_ray={fc['spheres'] / rays} "
              f"bvh_slab_tests_per_ray={fc['bvh_slabs'] / rays} "
              f"bvh_sphere_tests_per_ray={fc['bvh_spheres'] / rays} "
              f"bvh_box_tests_per_ray={fc['bvh_boxes'] / rays} "
              f"bvh_tri_tests_per_ray={fc['bvh_tris'] / rays} "
              f"table_rays={fc['table_rays']} ops={ops:.6e} "
              f"bytes={nbytes} bound_ms={bound_ms} "
              f"bound_share={bound_ms / tm['ms']} "
              f"bound_ms_table_order={bound_old} {issue_text(issue)} "
              f"| card: {smi}")
        mesh = MIXED_CASES[row][0]
        table.append({
            # the variant, then the case's second word (" dma")
            "name": row_name(" ".join([var, *row.split(" ")[1:]])),
            "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/wave_kernel.cu",
            # K3's lockstep loop with the combined set; else the mesh walk
            "replaces": "pathtracer_tpu/" + (
                "render/pallas_backend.py:306" if cb.textured(scene)
                else "ops/intersect.py:" + (
                    "1309" if mesh == "uv736" else "225" if mesh == "tri784"
                    else "262" if mesh in ("tri19600", "uv1472")
                    else "815")),
            "launches": case_launches[(var, row)],
            "max_abs_err": max_err[var],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes this
            **bvh_note(var), **old_bound(bound_old),
            **regroup_note(var, issue, regrouped),
            **k4t_note(k4t, fc["brute_boxes"] / rays, fc["brute_tris"] / rays),
        })
    check(all(k_["launches"] > 0 for k_ in table), "every variant launched")
    check(sorted({k_["name"] for k_ in table if k_["name"].endswith(">")
                  and " " not in k_["name"]})
          == sorted(f"wave_kernel<{v}>" for v in cb.VARIANTS),
          "every variant in the kernel table")
    print(f"phase6 total_s={time.perf_counter() - t_start}")
    post_phase(smi)
    xla_phase(smi)
    shard_phase(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
