"""The scenes JAX renders on XLA only, rendered by the port as torch ops.

JAX's kernel turns four kinds of scene away (``pallas_backend.supports``,
:140-167): a mesh with the uniform grid, a mesh beyond the DMA tier
(``clusters.DMA_MAX`` triangles), a UV mesh beside a combined texture set
and a bump map on a combined set. The port's ``render_chunk`` sends the
same four to the plain path-regeneration loop (``Scene.off_kernel``,
``renderer.kernel_renders``), where the mesh is walked through the grid or
swept as JAX's XLA drivers sweep it.

- Renders through the port's ``render_chunk`` against JAX's XLA wavefront
  driver at 32x18, 1 spp, under tests/test_golden.py's gates: a mesh with
  the grid; world 1 with a UV mesh in its combined ground material (the
  texture indices (1, 2, 3, 4)) and world 1 with one of its four maps as
  the ground's bump map, both built by a ``WorldBuilder``
  (``mixed_scenes.mixed_builder``); a mesh above ``DMA_MAX``. The last
  patches ``clusters.DMA_MAX`` in both packages to 1100, just above
  ``STREAM_MIN`` (1024), and renders a 1156-triangle mesh: a mesh of
  more than 1,048,576 triangles cannot be rendered on the CPU in a test's
  time, and both packages read the constant as a module attribute when
  they finalize and route. JAX's XLA driver runs with its large-table
  forms (``_SELECT_LOOKUP_MAX``, ``_UNROLL_MAX`` lowered, as
  tests/test_torch_mixed_bases.py does) to keep its compile short.
- The route: ``render_chunk`` on each of the four kinds never reaches the
  kernel's wrapper or its plain version; a scene of each kind the kernel
  took before still goes to the kernel's route; the wrapper still refuses
  the four, naming the route that renders them.
- Tables: each of the four scenes' tables equal to JAX's through the
  converter, the combined set's flat stack kept beside a UV mesh or a bump
  map.
"""

import jax.numpy as jnp
import pytest

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import accel as jaccel
from pathtracer_tpu.scene import clusters as jclusters
from pathtracer_tpu.scene import textures as jtextures
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import accel as taccel
from pathtracer_tpu_torch.scene import clusters as tclusters
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import textures as ttextures
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.camera import define_camera
from pathtracer_tpu_torch.scene.mixed_scenes import mixed_builder
from test_torch_meshes import mesh_builder, mixed_mesh, tessellated_sphere
from test_torch_render import assert_golden_gates
from test_torch_scene import assert_tables_equal
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W, H = 32, 18
W1, W5 = tschema.WORLD_DEFAULT, tschema.WORLD_MARIO
KINDS = ("grid", "uv+combined", "bump+combined", "beyond_dma")


@pytest.fixture(scope="module", autouse=True)
def jax_large_table_forms():
    """JAX's XLA driver with its large-table material gather and chunked
    sweeps (see the module docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jintegrator, "_SELECT_LOOKUP_MAX", 16)
        mp.setattr(jint, "_UNROLL_MAX", 16)
        yield


@pytest.fixture
def small_dma_max(monkeypatch):
    for mod in (jclusters, tclusters):
        monkeypatch.setattr(mod, "DMA_MAX", 1100)


def _scenes(kind):
    """(JAX scene, JAX camera, port scene, port camera) of ``kind``."""
    out = []
    for worlds_mod, tex_mod, accel_mod, cam_fn in (
            (jworlds, jtextures, jaccel, jdefine_camera),
            (tworlds, ttextures, taccel, define_camera)):
        grid, world = None, W1
        if kind in ("grid", "beyond_dma"):
            tris = tessellated_sphere(300 if kind == "grid" else 1200)
            b, cp = mesh_builder(worlds_mod, tris)
            world = W5
            if kind == "grid":
                grid = accel_mod.build_uniform_grid(tris)
        else:
            b, cp = mixed_builder(
                world=W1, worlds_mod=worlds_mod, textures_mod=tex_mod,
                **(dict(mesh=mixed_mesh("uv736", W1), mesh_material="ground")
                   if kind == "uv+combined" else dict(ground_bump=3)))
        scene = b.finalize(world_kind=world, grid=grid, view_origin=cp.pos)
        out += [scene, cam_fn(cp.pos, cp.target, cp.fov, W, H)]
    return out


@pytest.fixture(params=KINDS)
def kind(request):
    if request.param == "beyond_dma":
        request.getfixturevalue("small_dma_max")
    return request.param


def test_scene_is_off_kernel(kind):
    js, jcam, ts, tcam = _scenes(kind)
    assert ts.off_kernel
    assert ts.tex_combined == (kind in ("uv+combined", "bump+combined"))
    assert ts.n_tris > tclusters.DMA_MAX or kind != "beyond_dma"
    assert_tables_equal(js, ts)
    if ts.tex_combined:
        assert ts.tex_packed.numel() == 4 * ts.tex_hmax * ts.tex_wmax
    cfg = trenderer.RenderConfig(W, H, pp=1)
    assert not trenderer.kernel_renders(ts, cfg)
    with pytest.raises(NotImplementedError, match="on XLA only.*torch ops"):
        cuda_backend.check_supported(ts, tcam, cfg)


def test_render_vs_xla(kind, monkeypatch):
    """The port's render_chunk (never the kernel's route) against JAX's
    XLA wavefront driver, 32x18, 1 spp."""
    js, jcam, ts, tcam = _scenes(kind)

    def kernel_route(*a, **k):
        raise AssertionError("the kernel's route must not run")

    monkeypatch.setattr(cuda_backend, "render_chunk_cuda", kernel_route)
    monkeypatch.setattr(cuda_backend, "render_chunk_plain", kernel_route)
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(W, H, pp=1, seed=0),
        jprng.base_key(0), jnp.int32(0), 1, jrenderer.init_accum(W * H))
    tst = trenderer.render_chunk(ts, tcam, trenderer.RenderConfig(W, H, pp=1),
                                 0, 0, 1, trenderer.init_accum(W * H))
    assert tst.samples_done == 1
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count) == 0


KERNEL_SCENES = {
    "w3": lambda: tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8),
    "w1": lambda: tworlds.finalize_world(W1, 8, 8),
    "tex+mesh": lambda: _port_scene(mixed_builder(
        world=W1, mesh=mixed_mesh("brute", W1), mesh_material="ground")),
    "uv736": lambda: _port_scene(mesh_builder(tworlds, *mixed_mesh(
        "uv736", W1))),
    "w2+planar+bump": lambda: _port_scene(mixed_builder(
        world=tschema.WORLD_BRDF_TEST, maps=True, combined=False)),
}


def _port_scene(builder_and_params):
    b, cp = builder_and_params
    return (b.finalize(view_origin=cp.pos),
            define_camera(cp.pos, cp.target, cp.fov, 8, 8))


@pytest.mark.parametrize("name", list(KERNEL_SCENES))
def test_kernel_scenes_keep_the_kernel_route(name, monkeypatch):
    """Scenes the kernel took before go to its route (here its plain
    version, the tensors being on the CPU) and never to the torch-ops
    loop."""
    scene, cam = KERNEL_SCENES[name]()
    calls = []

    def route(name_):
        def run(*a, **k):
            calls.append(name_)
            return a[-1]
        return run

    monkeypatch.setattr(cuda_backend, "render_chunk_plain", route("plain"))
    monkeypatch.setattr(trenderer, "render_chunk_wavefront",
                        route("wavefront"))
    cfg = trenderer.RenderConfig(8, 8, pp=1)
    assert not scene.off_kernel and trenderer.kernel_renders(scene, cfg)
    cuda_backend.variant(scene, cam)  # an instantiation covers it
    trenderer.render_chunk(scene, cam, cfg, 0, 0, 1,
                           trenderer.init_accum(64))
    assert calls == ["plain"]


def test_off_kernel_scenes_take_the_torch_route(monkeypatch):
    """Each of the four kinds goes to the torch-ops loop, and a debug
    config of a kernel scene keeps its own route."""
    monkeypatch.setattr(jclusters, "DMA_MAX", 1100)
    monkeypatch.setattr(tclusters, "DMA_MAX", 1100)
    calls = []

    def wavefront(*a, **k):
        calls.append("wavefront")
        return a[-2]

    def kernel_route(*a, **k):
        raise AssertionError("the kernel's route must not run")

    monkeypatch.setattr(trenderer, "render_chunk_wavefront", wavefront)
    monkeypatch.setattr(cuda_backend, "render_chunk_cuda", kernel_route)
    monkeypatch.setattr(cuda_backend, "render_chunk_plain", kernel_route)
    for kind_ in KINDS:
        ts, tcam = _scenes(kind_)[2:]
        st = trenderer.render_chunk(ts, tcam, trenderer.RenderConfig(W, H,
                                                                     pp=1),
                                    0, 0, 1, trenderer.init_accum(W * H))
        assert st.samples_done == 1
    assert calls == ["wavefront"] * len(KINDS)
    # variance too is the kernel's config, and so off the kernel here
    assert not trenderer.kernel_renders(ts, trenderer.RenderConfig(
        W, H, debug_kind="variance"))
    assert not trenderer.kernel_renders(ts, trenderer.RenderConfig(
        W, H, mode="unrolled"))
