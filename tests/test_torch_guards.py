"""Guards of the port: it runs without JAX and without the JAX package, a
CUDA request without a card raises, and the CUDA wrapper refuses what its
kernel does not cover instead of running the plain version."""

import ctypes
import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.io.bmp import read_bmp
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_scene import jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports_and_renders_without_jax(tmp_path):
    """jax, flax and pathtracer_tpu are unimportable in the child; every
    module of the port imports, the CLI renders worlds 3 and 7 at 8x8 on the
    CPU and writes their BMPs."""
    out = tmp_path / "w3.bmp"
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "pathtracer_tpu"):
            sys.modules[name] = None
        import pathtracer_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from pathtracer_tpu_torch.cli import main
        rc = main(["-w3", "-p1", "--size", "8x8", "--device", "cpu",
                   "--out", {str(out)!r}])
        assert rc == 0
        assert main(["-w7", "-p1", "--size", "8x8", "--device", "cpu",
                     "--out", {str(out) + ".w7"!r}]) == 0
        assert not any(k.startswith(("jax", "flax")) and v is not None
                       for k, v in sys.modules.items())
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert out.stat().st_size == 58 + 8 * 8 * 4
    assert (tmp_path / "w3.bmp.w7").stat().st_size == 58 + 8 * 8 * 4


def test_cli_world5_raises_naming_its_item(tmp_path, monkeypatch):
    """World 5 renders through the CLI: without mario.glb its ground, sky
    and sun, and with a mesh of the static tier loaded (a stand-in for the
    asset) also in fog, and with the denoiser (without fog, whose 8x8
    image is black): its pixels differ from the raw render's."""
    from pathtracer_tpu_torch.cli import main
    out = tmp_path / "w5.bmp"
    assert main(["-w5", "-p1", "--size", "8x8", "--device", "cpu", "--out",
                 str(out)]) == 0
    assert out.stat().st_size == 58 + 8 * 8 * 4
    from test_torch_meshes import tessellated_sphere
    tris = tessellated_sphere(800).reshape(-1, 3)
    monkeypatch.setattr(tworlds, "load_glb_triangles", lambda path, b: (
        tris, np.full((len(tris),), b.add_material(albedo=(0.5, 0.5, 0.5)),
                      np.int32)))
    assert main(["-w5", "-p1", "--size", "8x8", "--device", "cpu", "--fog",
                 "0.01", "--out", str(out)]) == 0
    assert out.stat().st_size == 58 + 8 * 8 * 4
    raw, den = tmp_path / "w5_raw.bmp", tmp_path / "w5_denoised.bmp"
    for path, extra in ((raw, []), (den, ["--denoise", "3"])):
        assert main(["-w5", "-p1", "--size", "8x8", "--device", "cpu",
                     "--out", str(path)] + extra) == 0
    assert den.stat().st_size == 58 + 8 * 8 * 4
    assert den.read_bytes() != raw.read_bytes()
    assert read_bmp(str(den)).max() > 0


def test_render_image_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    scene, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trenderer.render_image(scene, cam, trenderer.RenderConfig(8, 8, pp=1),
                               device="cuda")


def _textured_scene(w=8, h=8):
    """World 1 with one map dropped: three planar maps (albedo, metalness,
    roughness) instead of the combined 4-map set, through the feature
    kernel's planar fetch (K10's planar form). Returns the JAX scene too."""
    b, _ = jworlds.build_world(tschema.WORLD_DEFAULT)
    b.textures = b.textures[:3]
    for m in b.materials:
        if m.normal_idx:
            m.normal_idx = 0
    _, cam = jworlds.finalize_world(tschema.WORLD_DEFAULT, w, h)
    js = b.finalize(view_origin=cam.pos)
    scene = jax_scene_to_port(js)
    assert scene.n_textures == 3 and not scene.tex_combined
    return scene, cam, js


def _unported_textured_scene():
    """World 1 with one of its maps as the ground's bump map, which keeps
    the set combined: JAX renders it on XLA only, the port as torch ops."""
    from pathtracer_tpu_torch.scene.camera import define_camera
    from pathtracer_tpu_torch.scene.mixed_scenes import mixed_builder
    b, cp = mixed_builder(world=tschema.WORLD_DEFAULT, ground_bump=3)
    scene = b.finalize(view_origin=cp.pos)
    assert scene.tex_combined and scene.any_bump and scene.off_kernel
    return scene, define_camera(cp.pos, cp.target, cp.fov, 8, 8)


def test_cuda_wrapper_refuses_textured_scene(monkeypatch):
    """The kernel's wrapper refuses a bump map on a combined set without
    launching, naming the route that renders it."""
    scene, cam = _unported_textured_scene()
    assert scene.unsupported() == []

    def plain(*a, **k):
        raise AssertionError("the plain version must not run")

    monkeypatch.setattr(cuda_backend, "render_chunk_plain", plain)
    monkeypatch.setattr(cuda_backend, "render_chunk_wavefront", plain)
    launches = cuda_backend.LAUNCHES
    with pytest.raises(NotImplementedError,
                       match="bump map beside a combined texture set on XLA "
                             "only; renderer.render_chunk renders them as "
                             "torch ops"):
        cuda_backend.render_chunk_cuda(scene, cam,
                                       trenderer.RenderConfig(8, 8, pp=1),
                                       0, 0, 1, trenderer.init_accum(64))
    assert cuda_backend.LAUNCHES == launches


def test_cuda_wrapper_refuses_textured_clustered_scene():
    """A combined texture set with sphere clusters is the mixed variant
    ``clustered+textured``; with a bump map on the combined set (XLA-only
    in JAX) the wrapper refuses it, naming the route that renders it, and
    render_chunk does not send it to the kernel's route."""
    scene, cam = tworlds.finalize_world(tschema.WORLD_DEFAULT, 8, 8)
    w2, _ = tworlds.finalize_world(tschema.WORLD_BRDF_TEST, 8, 8)
    scene = dataclasses.replace(
        scene, sph_clusters=w2.sph_clusters,
        **{k: getattr(w2, k) for k in ("cl_offset", "cl_count", "cl_min",
                                       "cl_max", "cl_huge")})
    assert cuda_backend.variant(scene, cam) == "clustered+textured"
    bumped = dataclasses.replace(scene, any_bump=True)
    assert bumped.unsupported() == [] and bumped.off_kernel
    assert not trenderer.kernel_renders(bumped, trenderer.RenderConfig(8, 8))
    assert trenderer.kernel_renders(scene, trenderer.RenderConfig(8, 8))
    with pytest.raises(NotImplementedError,
                       match="bump map beside a combined texture set on XLA "
                             "only"):
        cuda_backend.render_chunk_cuda(bumped,
                                       cam, trenderer.RenderConfig(8, 8, pp=1),
                                       0, 0, 1, trenderer.init_accum(64))


@pytest.mark.parametrize("cfg", [
    trenderer.RenderConfig(8, 8, pp=1, debug_kind="bounce_count"),
    trenderer.RenderConfig(8, 8, pp=2, denoise=2),
], ids=["cfg0-ROADMAP", "cfg1-ROADMAP"])
def test_unported_configs_raise(cfg):
    """Both configs render (each once refused, naming its ROADMAP item):
    ``bounce_count`` through the unrolled driver, each pixel the count of
    bounces its path reached over MAX_BOUNCE_COUNT, equal to the port's
    ``integrator.trace`` on the same primary rays; ``denoise=2``'s packed
    pixels equal JAX's ``finalize`` (the a-trous filter, then the tonemap)
    on the same accumulator."""
    from pathtracer_tpu.render import renderer as jrenderer
    from pathtracer_tpu.utils.vec import Vec3 as JVec3
    from pathtracer_tpu_torch.render import integrator, wavefront
    from pathtracer_tpu_torch.utils import prng
    scene, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8)
    st = trenderer.render_chunk(scene, cam, cfg, 0, 0, cfg.spp,
                                trenderer.init_accum(64))
    assert st.samples_done == cfg.spp
    if cfg.debug_kind == "bounce_count":
        px = torch.arange(64)
        o, d = wavefront._primary_rays(cam, cfg, 0, px, torch.zeros_like(px))
        rad, stats = integrator.trace(scene, o, d, prng.path_keys(0, px, 0),
                                      debug_kind="bounce_count")
        assert torch.equal(st.sum.x, rad.x) and torch.equal(st.sum.z, rad.z)
        assert int(st.rays_cast) == int(stats.rays_cast)
        assert torch.equal(st.sum.x * tschema.MAX_BOUNCE_COUNT,
                           stats.lane_casts.float())
        return
    f = lambda t: __import__("jax").numpy.asarray(t.numpy())
    jst = jrenderer.AccumState(JVec3(*map(f, st.sum)),
                               JVec3(*map(f, st.sum_sq)), f(st.count),
                               f(st.nan_count.float()),
                               f(st.rays_cast.float()), st.samples_done)
    packed = trenderer.finalize(st, cfg).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jrenderer.finalize(
        jst, jrenderer.RenderConfig(8, 8, pp=2, denoise=2))))
    assert not np.array_equal(packed, trenderer.finalize(
        st, trenderer.RenderConfig(8, 8, pp=2)).numpy())


def test_plain_version_refuses_textured_scene(monkeypatch):
    """The kernel's plain version refuses a bump map on a combined set as
    its wrapper does; render_chunk renders it as torch ops (the plain
    path-regeneration loop), never reaching either."""
    scene, cam = _unported_textured_scene()
    cfg = trenderer.RenderConfig(8, 8, pp=1)
    with pytest.raises(NotImplementedError, match="on XLA only"):
        cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 1,
                                        trenderer.init_accum(64))

    def kernel_route(*a, **k):
        raise AssertionError("the kernel's route must not run")

    monkeypatch.setattr(cuda_backend, "render_chunk_cuda", kernel_route)
    monkeypatch.setattr(cuda_backend, "render_chunk_plain", kernel_route)
    st = trenderer.render_chunk(scene, cam, cfg, 0, 0, 1,
                                trenderer.init_accum(64))
    assert st.samples_done == 1 and float(st.count.sum()) == 64


def test_planar_textured_scene_renders_vs_xla():
    """World 1 with three planar 512x512 maps renders through the feature
    path against JAX's XLA driver at 16x9 under the golden gates."""
    import jax.numpy as jnp
    from pathtracer_tpu.render import renderer as jrenderer
    from pathtracer_tpu.utils import prng as jprng
    from test_torch_render import assert_golden_gates
    scene, cam, js = _textured_scene(16, 9)
    assert cuda_backend.variant(scene, cam) == "feature_pinhole"
    jst = jrenderer.render_chunk(
        js, cam, jrenderer.RenderConfig(16, 9, pp=2, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(16 * 9))
    tst = trenderer.render_chunk(scene, cam, trenderer.RenderConfig(
        16, 9, pp=2, seed=0), 0, 0, 4, trenderer.init_accum(16 * 9))
    assert_golden_gates(jst, tst)


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper computes exactly what the plain version
    computes, and launches nothing."""
    scene, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_QUAD, 16, 9)
    cfg = trenderer.RenderConfig(16, 9, pp=2, seed=5)
    launches = cuda_backend.LAUNCHES
    a = cuda_backend.render_chunk_cuda(scene, cam, cfg, 5, 0, 4,
                                       trenderer.init_accum(16 * 9))
    b = cuda_backend.render_chunk_plain(scene, cam, cfg, 5, 0, 4,
                                        trenderer.init_accum(16 * 9))
    assert cuda_backend.LAUNCHES == launches
    for x, y in zip(a.sum, b.sum):
        assert torch.equal(x, y)
    assert int(a.rays_cast) == int(b.rays_cast) and a.samples_done == 4


def _variant_scene(kind, pinhole):
    """A world, a world in fog ("w<n> fog") or a feature scene by name,
    with its camera at 8x8."""
    if isinstance(kind, str) and kind.endswith(" fog"):
        scene, cam = tworlds.finalize_world(int(kind[1]) - 1, 8, 8,
                                            use_pinhole=pinhole)
        return dataclasses.replace(scene, fog_sigma_t=0.0012), cam
    if isinstance(kind, str):
        from pathtracer_tpu_torch.scene.camera import define_camera
        from pathtracer_tpu_torch.scene.feature_scenes import FEATURE_CASES
        scene, (pos, target, fov), _ = FEATURE_CASES[kind]()
        return scene, define_camera(pos, target, fov, 8, 8,
                                    use_pinhole=pinhole)
    return tworlds.finalize_world(kind, 8, 8, use_pinhole=pinhole)


@pytest.mark.parametrize("kind, pinhole, want", [
    (tschema.WORLD_CORNELL_BOX, True, "brute_pinhole"),
    (tschema.WORLD_CORNELL_BOX, False, "brute_lens"),
    (tschema.WORLD_BRDF_TEST, True, "clustered_pinhole"),
    (tschema.WORLD_RAYTRACING_ONE_WEEKEND, True, "clustered_lens"),
    (tschema.WORLD_DEFAULT, True, "textured_pinhole"),
    (tschema.WORLD_DEFAULT, False, "textured_lens"),
    (tschema.WORLD_MESH_UV, True, "mesh_pinhole"),
    (tschema.WORLD_MESH_UV, False, "mesh_lens"),
    ("fog", True, "feature_pinhole"),
    ("everything", False, "feature_lens_k4t"),
    ("bump", True, "feature_pinhole"),
    ("w1 fog", True, "feattextured_pinhole"),
    ("w1 fog", False, "feattextured_lens"),
    ("w2 fog", True, "featclustered_pinhole"),
    ("w4 fog", True, "featclustered_lens"),
    ("w7 fog", True, "featmesh_pinhole"),
    ("w7 fog", False, "featmesh_lens"),
])
def test_kernel_variant_by_scene_and_camera(kind, pinhole, want):
    """The wrapper picks the feature kernel from fog, transmission, bump or
    planar maps or a brute-force mesh, on the base the scene has: the
    textured kernel's from a combined texture set, the mesh kernel's from
    a streamed triangle mesh, the clustered walk's from the scene's
    clusters; and the thin lens from the camera (world 4 forces it). The
    brute feature form runs path regeneration, with its pinhole also under
    lockstep; the clustered one has no other schedule."""
    scene, cam = _variant_scene(kind, pinhole)
    assert cuda_backend.variant(scene, cam) == want
    assert want in cuda_backend.VARIANTS
    if want == "feature_pinhole":
        assert cuda_backend.variant(scene, cam, "regen") == want
        assert cuda_backend.variant(scene, cam, "lockstep") == (
            "feature_pinhole_lockstep")
    elif want.startswith(("feature", "featclustered")):
        with pytest.raises(NotImplementedError, match="pinhole only"):
            cuda_backend.variant(scene, cam, "lockstep")


def test_kernel_params_layout():
    """The ctypes mirror declares the fields of struct WaveParams in
    wave_kernel.cu, in order, with matching pointer/int/float kinds."""
    src = cuda_backend.SOURCE.read_text()
    body = src[src.index("struct WaveParams {") + 19:]
    body = body[:body.index("};")]
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype = re.match(r"(const )?(float|int|uint32_t)", decl).group(2)
        for name in decl[len(re.match(r"(const )?\w+", decl).group(0)):].split(","):
            name = name.strip()
            kind = "ptr" if name.startswith("*") else ctype
            c_fields.append((name.lstrip("*").split("[")[0], kind))
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_uint32: "uint32_t", ctypes.c_float: "float",
             ctypes.c_float * 2: "float", ctypes.c_float * 3: "float",
             ctypes.c_float * 8: "float",
             ctypes.c_float * 6: "float", ctypes.c_int * 4: "int",
             ctypes.c_uint32 * 2: "uint32_t"}
    py_fields = [(n, kinds[t]) for n, t in cuda_backend.WaveParams._fields_]
    assert py_fields == c_fields
    # the feature variants' fields come after the mesh variants', then the
    # static tier's, the mixed variants' camera, the streamed walk's BVH,
    # the sphere clusters' BVH and the uv rows' layout, the planar table
    # and the thin lens's pp reciprocal and folded plane term, the walks'
    # far-ray bounds, the mesh walk's set-apart triangles, the quads'
    # records, K9's level-0 wrap constants and, last, the launch's pixels
    # and their warp tiles (a shard of a render across devices)
    names = [n for n, _ in c_fields]
    assert names.index("stack_wmax") < names.index("tri_ax")
    assert names.index("fog_albedo") < names.index("ctri_nx")
    assert names[-26:] == ["n_tclusters", "cam_lens", "bvh_nodes", "bvh_tris",
                           "bvh_tri_k", "bvh_root", "sbvh_nodes", "sbvh_sph",
                           "sbvh_idx", "sbvh_root", "n_sph_huge",
                           "stream_uv_cfm", "planar_tile", "planar_meta",
                           "pp_m", "lens_t0", "bvh_far", "bvh_wide",
                           "sbvh_far", "bvh_apart", "q_rec", "tex_m",
                           "lane_lo", "lane_hi", "tile_lo", "n_tiles"]
