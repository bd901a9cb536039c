"""The mixed bases against the JAX package on the CPU: sphere clusters
with the combined texture set, with every mesh tier, or with both, and
the combined set with a mesh without UVs. JAX's kernel runs every such
scene (``pallas_backend.supports``); the port renders each through one
instantiation per base tuple (``cuda_backend.MIXED_VARIANTS``), whose
plain version, the lockstep loop ``render/lockstep.py``, is held here.

- Scenes (``scene/mixed_scenes.py``): world 2's builder (its 11x11
  spheres in clusters) with world 1's combined ground material on its
  plane, or world 1's (the combined set), plus a mesh or not: the
  lat-long sphere stand-in for mario.glb (the brute tier at 40
  triangles, the static tier at 784, the streamed tier at 1936, the DMA
  tier forced on 1936 by ``force_dma``) or world 7's UV sphere (the static
  tier at 736 triangles, the streamed tier at 1472, the DMA tier forced on
  1472) beside sphere clusters (a UV mesh beside the combined set is
  XLA-only in JAX). Every mixed instantiation, and the combined set or
  clusters with the combined set beside a brute mesh; fog on one case,
  the thin lens on two, dispersive glass on the clusters and a mesh beside
  the combined set, and planar albedo and bump maps beside clusters and a
  mesh.
- Tables: each scene's tables bit-equal to JAX's finalize.
- Renders: the port's render_chunk against JAX's XLA driver at 32x18,
  pp=2, 4 samples, under the golden gates (tests/test_torch_render.py);
  test_torch_mixed_meshes.py runs eleven of the seventeen cases.
  JAX's XLA driver takes the forms it takes for world 4's large tables
  (the per-lane material gather and the chunked primitive sweep, the same
  values) by lowering ``_SELECT_LOOKUP_MAX`` and ``_UNROLL_MAX`` here:
  world 2's 124 materials and 122 spheres otherwise unroll into a compile
  that outruns these tests' budget.
- A twin of tests/test_fuzz.py:93 (the combined set with a clustered mesh
  through JAX's interpret-mode kernel against its XLA driver, under that
  test's gate) with the stand-in mesh in place of mario.glb; the port's
  plain version is held to the same XLA render.
- The variant each mixed scene routes to, the refusals that stay, and the
  kernel source's build parts.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import schema as jschema
from pathtracer_tpu.scene import textures as jtextures
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import clusters as tclusters
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import textures as ttextures
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.camera import define_camera
from pathtracer_tpu_torch.scene.mixed_scenes import mixed_builder
from test_torch_mesh_tiers import force_dma  # noqa: F401 (a fixture)
from test_torch_boxes import _primary_box_hits, jax_with_boxes
from test_torch_meshes import BOXES, mixed_mesh, tessellated_sphere, with_boxes
from test_torch_render import assert_golden_gates
from test_torch_scene import assert_tables_equal
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W, H = 32, 18
W1, W2 = tschema.WORLD_DEFAULT, tschema.WORLD_BRDF_TEST
FOG = dict(fog_sigma_t=0.0012, fog_albedo=(0.9, 0.9, 0.95), fog_g=0.5)


@pytest.fixture(scope="module", autouse=True)
def jax_large_table_forms():
    """JAX's XLA driver with its large-table material gather and chunked
    sweeps (see the module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jintegrator, "_SELECT_LOOKUP_MAX", 16)
        mp.setattr(jint, "_UNROLL_MAX", 16)
        yield


def mixed_scenes(pinhole=True, fog=False, world=W2, mesh=None, **kw):
    """(JAX scene, JAX camera, port scene, port camera) of
    ``mixed_builder``'s world at W x H with ``mixed_mesh(mesh)``."""
    out = []
    for worlds_mod, tex_mod, cam_fn in (
            (jworlds, jtextures, jdefine_camera),
            (tworlds, ttextures, define_camera)):
        b, cp = mixed_builder(
            world=world, mesh=None if mesh is None else mixed_mesh(mesh, world),
            worlds_mod=worlds_mod, textures_mod=tex_mod, **kw)
        if fog:
            b.set_fog(FOG["fog_sigma_t"], FOG["fog_albedo"], FOG["fog_g"])
        scene = b.finalize(world_kind=world, view_origin=cp.pos)
        out += [scene, cam_fn(cp.pos, cp.target, cp.fov, W, H,
                              use_pinhole=pinhole,
                              focal_distance=cp.focal_distance,
                              aperture_radius=cp.aperture_radius)]
    return out


# case -> (mixed_scenes' arguments, the variant); a case named "dma" forces
# the DMA tier
CASES = {
    "clu+tex": (dict(), "clustered+textured"),
    "clu+tex-fog-d": (dict(pinhole=False, fog=True), "clustered+textured"),
    "clu+tex+brute": (dict(mesh="brute"), "clustered+textured_k4t"),
    "clu+static": (dict(combined=False, mesh="static"),
                   "clustered+staticplain"),
    "clu+static-maps": (dict(combined=False, mesh="static", maps=True),
                        "clustered+staticplain"),
    "clu+streamed-d": (dict(combined=False, mesh="streamed", pinhole=False),
                       "clustered+meshplain"),
    "clu+dma": (dict(combined=False, mesh="dma"), "clustered+meshplain"),
    "clu+uv736": (dict(combined=False, mesh="uv736"), "clustered+static"),
    "clu+uv1472": (dict(combined=False, mesh="uv1472"), "clustered+mesh"),
    "clu+uv1472-dma": (dict(combined=False, mesh="uv1472"),
                       "clustered+mesh"),
    "clu+tex+static": (dict(mesh="static", mesh_material="ground"),
                       "clustered+textured+staticplain"),
    "clu+tex+static-glass": (dict(mesh="static", glass=True),
                             "clustered+textured+staticplain"),
    "clu+tex+streamed": (dict(mesh="streamed"),
                         "clustered+textured+meshplain"),
    "clu+tex+dma-d": (dict(mesh="dma", pinhole=False),
                      "clustered+textured+meshplain"),
    "tex+streamed": (dict(world=W1, mesh="streamed"), "textured+meshplain"),
    "tex+dma": (dict(world=W1, mesh="dma"), "textured+meshplain"),
    "tex+brute": (dict(world=W1, mesh="brute"),
                  "feattextured_pinhole_k4t"),
}


# the cases that test_torch_mixed_meshes.py runs (the meshes of the
# streamed tier, resident or DMA, the static tier's UV mesh, and the glass
# and planar-map cases): the same test in a file of its own, so that two
# workers share the renders
SPLIT_OFF = ("clu+static-maps", "clu+streamed-d", "clu+dma", "clu+uv736",
             "clu+uv1472", "clu+uv1472-dma", "clu+tex+static-glass",
             "clu+tex+streamed", "clu+tex+dma-d", "tex+streamed", "tex+dma")


@pytest.mark.parametrize("case", [c for c in CASES if c not in SPLIT_OFF])
def test_mixed_base_vs_xla(request, case):
    """Tables bit-equal to JAX's, the variant, and the plain version's
    render against JAX's XLA driver under the golden gates."""
    check_mixed_base_vs_xla(request, case)


def check_mixed_base_vs_xla(request, case):
    """test_mixed_base_vs_xla's checks of one case."""
    kw, want = CASES[case]
    if "dma" in case:
        request.getfixturevalue("force_dma")
    js, jcam, ts, tcam = mixed_scenes(**kw)
    assert_tables_equal(js, ts)
    assert bool(ts.sph_clusters) == (kw.get("world", W2) == W2)
    assert cuda_backend.variant(ts, tcam) == want and want in \
        cuda_backend.VARIANTS
    if "dma" in case:
        assert ts.tri_dma and ts.stream_gparents
    if kw.get("glass"):
        assert ts.featured and float(ts.mat_dispersion.max()) > 0.0
    if kw.get("maps"):
        assert ts.planar_maps and ts.any_bump
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(W, H, pp=2, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(W * H))
    tst = trenderer.render_chunk(ts, tcam, trenderer.RenderConfig(
        W, H, pp=2, seed=0), 0, 0, 4, trenderer.init_accum(W * H))
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count)


def _fuzz_scene(builder_cls, textures_mod):
    """tests/test_fuzz.py:93's scene with the stand-in in place of
    mario.glb (scaled and lifted as that test does): a sky, a light
    sphere, the combined set on a ground plane, the mesh in one grey
    material. At 100 triangles the mesh is in the static tier (two
    clusters), as mario.glb is; the interpret-mode kernel unrolls the
    static tier's triangles, so its cost grows with the mesh."""
    b = builder_cls()
    b.add_material(emit=(0.3, 0.35, 0.45))
    light = b.add_material(emit=(5.0, 4.5, 4.0))
    b.add_sphere((3, -3, 6), 1.0, light)
    for t in textures_mod.load_bespoke_textures():
        b.add_texture(t)
    ground = b.add_material(albedo_idx=1, metalness_idx=2, roughness_idx=3,
                            normal_idx=4)
    b.add_plane((0, 0, 1), 0.0, ground)
    m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
    tris = tessellated_sphere(100)
    b.set_mesh(tris.reshape(-1, 3) * 1.5 + np.float32([0, 0, 1.0]),
               np.full((3 * len(tris),), m, np.int32))
    return b.finalize()


def test_textured_mesh_scene_kernel_equivalence():
    """The twin of tests/test_fuzz.py:93: the combined set (lockstep
    driver, windowed fetch) with a clustered mesh (the static tier)
    through JAX's interpret-mode kernel against its XLA driver, under
    that test's gate; then the port's plain version (``textured+
    staticplain``) against the same XLA render under the golden gates."""
    js = _fuzz_scene(jschema.WorldBuilder, jtextures)
    ts = _fuzz_scene(tschema.WorldBuilder, ttextures)
    assert js.tex_combined and len(js.tri_clusters) > 0
    assert_tables_equal(js, ts)
    w, h, pp = 32, 18, 2
    jcam = jdefine_camera((0, -6, 2), (0, 0, 1), 35.0, w, h)
    base = jrenderer.RenderConfig(width=w, height=h, pp=pp, seed=1,
                                  backend="xla")
    kern = jrenderer.RenderConfig(width=w, height=h, pp=pp, seed=1,
                                  backend="pallas-interpret")
    img_x, _, jst = jrenderer.render_image(js, jcam, base)
    img_k, _, _ = jrenderer.render_image(js, jcam, kern)
    d = np.abs(np.asarray(img_x) - np.asarray(img_k)).max(axis=-1)
    assert np.median(d) < 1e-3, float(np.median(d))
    assert (d > 5e-2).mean() < 0.02, float((d > 5e-2).mean())
    tcam = define_camera((0, -6, 2), (0, 0, 1), 35.0, w, h)
    assert cuda_backend.variant(ts, tcam) == "textured+staticplain"
    _, _, tst = trenderer.render_image(
        ts, tcam, trenderer.RenderConfig(w, h, pp=pp, seed=1), device="cpu")
    assert_golden_gates(jst, tst)


def _port_scene(pinhole=True, world=W2, mesh=None, **kw):
    """A mixed scene of the port at 8x8 (see mixed_builder) with
    ``mixed_mesh(mesh)``."""
    b, cp = mixed_builder(
        world=world, mesh=None if mesh is None else mixed_mesh(mesh, world),
        **kw)
    scene = b.finalize(world_kind=world, view_origin=cp.pos)
    return scene, define_camera(cp.pos, cp.target, cp.fov, 8, 8,
                                use_pinhole=pinhole)


@pytest.mark.parametrize("case, want", [
    ("tex+static", "textured+staticplain"),
    ("tex+streamed", "textured+meshplain"),
    ("tex+dma", "textured+meshplain"),
    ("tex+brute", "feattextured_pinhole_k4t"),
    ("clu+brute", "featclustered_pinhole_k4t"),
    ("clu+tex+brute", "clustered+textured_k4t"),
    ("clu+streamed-uv", "clustered+mesh"),
    ("clu+dma-uv", "clustered+mesh"),
    ("clu+tex+streamed", "clustered+textured+meshplain"),
    ("clu+tex+dma", "clustered+textured+meshplain"),
    ("clu+tex-d", "clustered+textured"),
])
def test_mixed_variant_names(request, case, want):
    """The variant each mixed scene routes to, through either camera and
    with or without features (one instantiation per base tuple); the
    combined set with a brute mesh takes the combined set's feature form
    with K4t's walk, sphere clusters with a brute mesh the clustered one's,
    clusters with the combined set and a brute mesh the mixed base's.
    A mixed base has no other schedule."""
    if "dma" in case:
        request.getfixturevalue("force_dma")
    mesh = case.split("+")[-1].split("-")[0]
    mesh = None if mesh == "tex" else mesh
    if case.startswith("tex+"):
        ts, cam = _port_scene(world=W1, mesh=mesh)
        assert not ts.sph_clusters and ts.tex_combined
    elif case.endswith("-uv"):  # world 7's UV sphere at 1472 triangles
        ts, cam = _port_scene(combined=False, mesh="uv1472")
        assert ts.tri_streamed and ts.has_mesh_uvs
    else:
        ts, cam = _port_scene(pinhole=not case.endswith("-d"),
                              combined="tex" in case, mesh=mesh)
    assert ts.tri_brute == (mesh == "brute")
    assert cuda_backend.variant(ts, cam) == want and want in \
        cuda_backend.VARIANTS
    if "+" not in want:
        return
    fogged = dataclasses.replace(ts, **FOG)
    assert cuda_backend.variant(fogged, cam) == want
    lens = dataclasses.replace(cam, use_pinhole=False)
    assert cuda_backend.variant(ts, lens) == want
    with pytest.raises(NotImplementedError, match="mixed bases run lockstep"):
        cuda_backend.variant(ts, cam, "regen")


def test_every_mixed_variant_is_named():
    """Nine mixed instantiations: the combined set with clusters, with each
    mesh kind without UVs, and with both; clusters with each of the four
    mesh kinds (the streamed walk serves the resident and the DMA tier).
    Nine K4t forms: the feature variants without a mesh tier, the mixed
    base of clusters with the combined set among them. Eight box forms
    (K4): the brute and clustered spheres, the brute feature form and the
    static tier without UVs, through either camera."""
    assert len(cuda_backend.MIXED_VARIANTS) == 9
    assert len(cuda_backend.K4T_VARIANTS) == 9
    assert "clustered+textured_k4t" in cuda_backend.K4T_VARIANTS
    assert len(cuda_backend.BOX_VARIANTS) == 8
    assert len(set(cuda_backend.VARIANTS)) == len(cuda_backend.VARIANTS) == 60
    kinds = {v.split("+")[-1] for v in cuda_backend.MIXED_VARIANTS}
    assert kinds == set(cuda_backend.MESH_KINDS) | {"textured"}


# the ids are the cases' names from when the first three were refused
@pytest.mark.parametrize("case, match", [
    ("uv-mesh", "a UV mesh or a bump map beside a combined texture set on "
                "XLA only; renderer.render_chunk renders them as torch ops"),
    ("bump", "a UV mesh or a bump map beside a combined texture set on XLA "
             "only"),
    ("dma-max", "more than 1048576 triangles.*on XLA only"),
    ("boxes", "clustered\\+textured\\+staticplain_box: K4's box test has no "
              "form on this base"),
], ids=["uv-mesh-UV mesh together with a combined texture set.*XLA-only",
        "bump-bump map together with a combined texture set",
        "dma-max-more than 1048576 triangles", "boxes-boxes"])
def test_refusals_that_stay(request, case, match):
    """The kernel's wrapper refuses, on a mixed base too, what JAX renders
    on XLA only, naming the torch ops that render it (a UV mesh beside the
    combined set, a bump map on the combined set, meshes beyond the DMA
    tier: each off the kernel, none unported any more). Boxes on a base
    without a box form (K4's test sits in forms of its own,
    ``cuda_backend.BOX_VARIANTS``) are refused by the kernel's wrapper
    alone, naming the base; its plain version renders them against JAX's
    XLA driver under the golden gates."""
    if case == "boxes":
        js, jcam, ts, tcam = mixed_scenes(mesh="static")
        js = jax_with_boxes(js, BOXES["w2"])
        ts = with_boxes(ts, BOXES["w2"])
        cfg = trenderer.RenderConfig(W, H, pp=2, seed=0)
        cuda_backend.check_supported(ts, tcam, cfg)
        assert not ts.off_kernel and _primary_box_hits(ts, tcam, W, H) > 0
        with pytest.raises(NotImplementedError, match=match):
            cuda_backend.variant(ts, tcam)
        jst = jrenderer.render_chunk(
            js, jcam, jrenderer.RenderConfig(W, H, pp=2, seed=0),
            jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(W * H))
        tst = cuda_backend.render_chunk_plain(ts, tcam, cfg, 0, 0, 4,
                                              trenderer.init_accum(W * H))
        assert_golden_gates(jst, tst)
        assert int(tst.nan_count) == float(jst.nan_count)
        return
    ts, cam = _port_scene(mesh="static")
    cfg = trenderer.RenderConfig(8, 8, pp=1, seed=0)
    if case == "uv-mesh":
        ts = dataclasses.replace(ts, has_mesh_uvs=True)
    elif case == "bump":
        ts = dataclasses.replace(ts, any_bump=True)
    else:
        ts = dataclasses.replace(ts, n_tris=tclusters.DMA_MAX + 1)
    with pytest.raises(NotImplementedError, match=match):
        cuda_backend.check_supported(ts, cam, cfg)
    assert ts.off_kernel


def test_build_parts_hold_every_launcher():
    """The kernel source builds as parts 1-5 (``build_parts``: one nvcc
    each, all linked into one library), each part block defines one
    launcher (part 5 also K4t's intersect probe), and a build without a
    part stops at an #error."""
    src = cuda_backend.SOURCE.read_text()
    parts = cuda_backend.build_parts(src)
    assert parts == (1, 2, 3, 4, 5)
    blocks = dict(re.findall(
        r"^#if WAVE_HAS\((\d+)\)\n(.*?)^#endif  // WAVE_HAS\(\1\)", src,
        re.MULTILINE | re.DOTALL))
    assert sorted(map(int, blocks)) == list(parts)
    for name in ("wave_render", "launch_feature", "launch_mixed_pair",
                 "launch_mixed_triple", "launch_k4t", "wave_intersect"):
        defined = [k for k, body in blocks.items()
                   if re.search(rf"^(?:bool|int) {name}\([^;{{]*\{{", body,
                                 re.MULTILINE)]
        assert len(defined) == 1, (name, defined)
    head = src.split("#define WAVE_HAS")[0]
    assert "#ifndef WAVE_PART\n#error" in head
