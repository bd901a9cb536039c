"""The mesh slice's modules against the JAX package on the CPU: the port's
world-7 and random-mesh tables (triangles, texel-space UVs, cluster order,
precomputed records, parents, record and bounds rows, cfm uv rows, the
flat texture stack) bit-equal to JAX's, the converter, the streamed walk
``intersect_scene_uv`` (K7's plain version) against JAX's streamed tier run
as its own test runs it (``_tracing_pallas_kernel``), and ``sample_texture``
(K10's plain version) bit-equal to JAX's.

The walk's gate: JAX's streamed tier is jitted, and XLA:CPU contracts
multiply-adds into FMAs where the port (and its CUDA kernel, built with
--fmad=false) rounds each operation, so t may differ in the last bits. The
winners (material and normal) must agree on at least 99.9% of rays (100%
measured), uv_ok everywhere, t within 2e-5 relative, and the uv of agreeing
winners within 1e-3 texels (1.3e-4 measured).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.ops import texture as jtexture
from pathtracer_tpu.scene import clusters as jclusters
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.scene.schema import WorldBuilder as JWorldBuilder
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops import texture as ttexture
from pathtracer_tpu_torch.scene import clusters as tclusters
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_scene import assert_tables_equal, jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W7 = tschema.WORLD_MESH_UV


def _uv_mesh_builder(builder_cls, n, seed=7, tex_size=16):
    """A random n-triangle mesh with per-vertex UVs and a pow2 texture
    (tests/test_mesh_uv.py::_uv_mesh_builder, for either builder)."""
    rng = np.random.RandomState(seed)
    b = builder_cls()
    b.add_material(emit=(0.3, 0.35, 0.45))
    light = b.add_material(emit=(6.0, 5.5, 5.0))
    b.add_sphere((6, -5, 9), 1.2, light)
    tex = (np.round(rng.rand(tex_size, tex_size, 3) * 255) / 255
           ).astype(np.float32)
    m = b.add_material(albedo=(0.9, 0.85, 0.8), roughness=0.8,
                       albedo_idx=b.add_texture(tex))
    base = (rng.rand(n, 1, 3) - 0.5) * 16.0
    tris = base + (rng.rand(n, 3, 3) - 0.5) * 1.0
    uvs = rng.rand(n * 3, 2).astype(np.float32) * 2.0
    b.set_mesh(tris.reshape(-1, 3).astype(np.float32),
               np.full((3 * n,), m, np.int32), uvs=uvs)
    return b


def _scenes(case):
    """(JAX scene, port scene) of world 7 or of a random 1500-triangle UV
    mesh, each built by its own package."""
    if case == "w7":
        js, _ = jworlds.finalize_world(W7, 32, 18)
        ts, _ = tworlds.finalize_world(W7, 32, 18)
        return js, ts
    return (_uv_mesh_builder(JWorldBuilder, 1500).finalize(),
            _uv_mesh_builder(tschema.WorldBuilder, 1500).finalize())


@pytest.mark.parametrize("case", ["w7", "random1500"])
def test_mesh_tables_bit_equal(case):
    js, ts = _scenes(case)
    assert_tables_equal(js, ts)
    assert ts.tri_streamed and not ts.tri_dma and ts.stream_uv_cfm
    assert ts.stream_row_cull and ts.tex_mesh_only
    assert ts.stream_parents == js.stream_parents
    assert (ts.stream_leaf, ts.n_stream_clusters) == (js.stream_leaf,
                                                     js.n_stream_clusters)
    rpc = tclusters.stream_rows_per_cluster(ts.stream_leaf)
    assert ts.mtri_pack.shape == (ts.n_stream_clusters * rpc, 128)
    assert ts.mtri_uvpack.shape == (ts.n_stream_clusters * 6, 128)
    if case == "w7":
        assert (ts.n_tris, ts.n_stream_clusters, len(ts.stream_parents),
                ts.stream_leaf) == (1472, 16, 1, 96)
        assert ts.mtri_pack.shape == (176, 128)
        assert (ts.tex_hmax, ts.tex_wmax, ts.tex_packed.numel()) == (64, 64,
                                                                     4096)


@pytest.mark.parametrize("case", ["w7", "random1500"])
def test_cluster_functions_bit_equal(case):
    """The clusterer, the precomputed records and the parent grouping, each
    on the same inputs, against JAX's functions."""
    seed = {"w7": None, "random1500": 7}[case]
    if seed is None:
        b, cam = tworlds.build_world(W7)
        tris, origin = b.triangles, cam.pos
    else:
        tris = _uv_mesh_builder(tschema.WorldBuilder, 1500).triangles
        origin = (0.0, -20.0, 3.0)
    bounds = tclusters.triangle_bounds(tris)
    for a, b_ in zip(bounds, jclusters.triangle_bounds(tris)):
        np.testing.assert_array_equal(a, b_)
    order, cl = tclusters.build_clusters(*bounds, sort_origin=origin)
    jorder, jcl = jclusters.build_clusters(*bounds, sort_origin=origin)
    np.testing.assert_array_equal(order, jorder)
    assert cl == jcl
    A, u, v = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    pre = tclusters.triangle_precompute(A[order], u[order], v[order])
    jpre = jclusters.triangle_precompute(A[order], u[order], v[order])
    assert pre.keys() == jpre.keys()
    for k in pre:
        assert pre[k].dtype == np.float32
        np.testing.assert_array_equal(pre[k], jpre[k], err_msg=k)
    perm, parents = tclusters.build_parents(cl, sort_origin=origin)
    jperm, jparents = jclusters.build_parents(cl, sort_origin=origin)
    np.testing.assert_array_equal(perm, jperm)
    assert parents == jparents


def test_converted_world7_equals_port_built():
    """convert.py carries the mesh tables and statics; the kernel's parent
    tables derive from stream_parents."""
    js, _ = jworlds.finalize_world(W7, 16, 9)
    ts, _ = tworlds.finalize_world(W7, 16, 9)
    conv = jax_scene_to_port(js)
    for k in tschema.DERIVED_TENSOR_FIELDS:
        assert torch.equal(getattr(conv, k), getattr(ts, k)), k
    assert conv.stream_prange.tolist() == [[0, 16, 0]]
    box = ts.stream_parents[0][2] + ts.stream_parents[0][3]
    assert torch.equal(conv.stream_pbox, torch.tensor([box]))
    for k in tschema.STATIC_FIELDS:
        assert getattr(conv, k) == getattr(ts, k), k


def test_world1_keeps_no_flat_stack():
    """A combined set is read through tex_tile: its flat stack is a dummy in
    the port-built and the converted scene alike."""
    js, _ = jworlds.finalize_world(tschema.WORLD_DEFAULT, 8, 8)
    ts, _ = tworlds.finalize_world(tschema.WORLD_DEFAULT, 8, 8)
    for s in (ts, jax_scene_to_port(js)):
        assert s.tex_packed.numel() == 1 and (s.tex_hmax, s.tex_wmax) == (1, 1)
    assert js.tex_packed.size == 4 * 512 * 512


def _kernel_rays(rng, n=1024):
    """tests/test_mesh_uv.py::_kernel_rays: origins in a 24-unit cube,
    unit directions, as (8, 128) JAX arrays."""
    o = [(rng.rand(n) - 0.5) * 24.0 for _ in range(3)]
    d = rng.randn(3, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (np.asarray(o, np.float32).reshape(3, 8, 128),
            d.reshape(3, 8, 128))


def _aimed_rays(rng, n=1024):
    """Rays from a shell of radius 4-7 around world 7's mesh toward random
    points of its box, so that most of them reach the mesh."""
    center = np.array([0.0, 0.0, 1.4])
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = center + dirs * rng.uniform(4.0, 7.0, (n, 1))
    target = center + (rng.rand(n, 3) - 0.5) * 2.8
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o.T.astype(np.float32).reshape(3, 8, 128),
            d.T.astype(np.float32).reshape(3, 8, 128))


@pytest.mark.parametrize("case, rays", [("w7", "kernel"), ("w7", "aimed"),
                                        ("random1500", "kernel")])
def test_intersect_scene_uv_vs_jax_streamed(case, rays):
    js, ts = _scenes(case)
    rng = np.random.RandomState(11)
    o, d = (_kernel_rays if rays == "kernel" else _aimed_rays)(rng)
    jint._tracing_pallas_kernel = True
    try:
        jh, jux, juy, jok = jint.intersect_scene_uv(
            js, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)))
    finally:
        jint._tracing_pallas_kernel = False
    flat = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    th, tux, tuy, tok = tint.intersect_scene_uv(
        ts, TVec3(*map(flat, o)), TVec3(*map(flat, d)))
    j = lambda a: np.asarray(a).reshape(-1)
    same = ((j(jh.mat) == th.mat.numpy())
            & np.all([j(a) == b.numpy() for a, b in zip(jh.normal, th.normal)],
                     axis=0))
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(j(jok), tok.numpy())
    np.testing.assert_allclose(j(jh.t)[same], th.t.numpy()[same], rtol=2e-5)
    sel = same & tok.numpy()
    # triangle winners: few random rays reach world 7's mesh
    assert sel.sum() >= {("w7", "kernel"): 4, ("w7", "aimed"): 400,
                         ("random1500", "kernel"): 50}[(case, rays)]
    for a, b in ((jux, tux), (juy, tuy)):
        assert np.abs(j(a)[sel] - b.numpy()[sel]).max() <= 1e-3
    assert (tux.numpy()[~tok.numpy()] == 0).all()


def _stack_scenes(sizes):
    """One material per texture of the given (h, w) sizes, random 8-bit
    texels, through both builders (no mesh: the stack alone)."""
    rng = np.random.RandomState(5)
    texs = [(np.round(rng.rand(h, w, 3) * 255) / 255).astype(np.float32)
            for h, w in sizes]
    out = []
    for cls in (JWorldBuilder, tschema.WorldBuilder):
        b = cls()
        b.add_material(emit=(0.1, 0.1, 0.1))
        for t in texs:
            b.add_material(albedo=(1.0, 1.0, 1.0), albedo_idx=b.add_texture(t))
        out.append(b.finalize())
    return out


@pytest.mark.parametrize("sizes", [[(64, 64)], [(16, 16), (8, 32), (12, 20)]],
                         ids=["world7_layer", "three_layers"])
def test_sample_texture_bit_equal(sizes):
    """K10's plain fetch against JAX's sample_texture on random, large and
    negative texel coordinates, NaN and infinities included; the 3-layer
    stack has unequal pow2 and non-pow2 sizes (hmax/wmax padding)."""
    js, ts = _stack_scenes(sizes)
    for k in ("tex_packed", "tex_w", "tex_h"):
        np.testing.assert_array_equal(np.asarray(getattr(js, k)),
                                      getattr(ts, k).numpy())
    assert (ts.tex_hmax, ts.tex_wmax) == (js.tex_hmax, js.tex_wmax)
    rng = np.random.RandomState(3)
    n = 4096
    u = np.concatenate([rng.uniform(-300, 300, n), rng.uniform(-1e9, 1e9, 64),
                        [3e9, -5e9, 1e20, np.nan, np.inf, -np.inf, 0.0, 63.99]]
                       ).astype(np.float32)
    v = np.concatenate([rng.uniform(-300, 300, n), rng.uniform(-1e9, 1e9, 64),
                        [1.5, np.nan, -2.5e9, 7.0, 0.25, 3e9, -0.0, 64.0]]
                       ).astype(np.float32)
    layer = rng.randint(0, len(sizes), len(u)).astype(np.int32)
    jc = jtexture.sample_texture(js, jnp.asarray(layer), jnp.asarray(u),
                                 jnp.asarray(v))
    tc = ttexture.sample_texture(ts, torch.from_numpy(layer),
                                 torch.from_numpy(u), torch.from_numpy(v))
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.isfinite(tc.x.numpy()[:n]).all()


def _plain_mesh_builder(n):
    """_uv_mesh_builder's mesh without its UVs and its texture."""
    b = _uv_mesh_builder(tschema.WorldBuilder, n)
    b.tri_uvs, b.textures = None, []
    for m in b.materials:
        m.albedo_idx = 0
    return b


@pytest.mark.parametrize("n, match", [
    (40, "K4t"),            # the brute sweep, now without UVs too
    (300, "K5's triangle"),  # the static tier
])
def test_unported_mesh_tiers_raise(n, match):
    """A mesh without UVs of either tier is ported (the brute sweep K4t in
    the feature kernel, the static tier's K5 triangle walk in its own), in
    fog too (the feature forms), and beside a combined texture set (the
    combined set's feature form, the mixed ``textured+staticplain``);
    either mesh with UVs beside a combined set (XLA-only in JAX) is no
    longer refused: it is routed off the kernel, to torch ops."""
    ts = _plain_mesh_builder(n).finalize()
    assert not ts.tri_streamed
    assert ts.tri_brute == (match == "K4t")
    assert ts.tri_static == (match == "K5's triangle")
    from pathtracer_tpu_torch.render import cuda_backend
    cam = tworlds.finalize_world(W7, 8, 8)[1]
    assert cuda_backend.variant(ts, cam) == {
        "K4t": "feature_pinhole_k4t",
        "K5's triangle": "staticplain_pinhole"}[match]
    fog = dataclasses.replace(ts, fog_sigma_t=0.01)
    assert cuda_backend.variant(fog, cam) == {
        "K4t": "feature_pinhole_k4t",
        "K5's triangle": "featstaticplain_pinhole"}[match]
    w1, _ = tworlds.finalize_world(tschema.WORLD_DEFAULT, 8, 8)
    comb = dataclasses.replace(
        fog, n_textures=4, tex_combined=True,
        **{k: getattr(w1, k) for k in ("tex_tile", "tex_comb_a",
                                       "tex_comb_b", "tex_mip")})
    assert cuda_backend.variant(comb, cam) == {
        "K4t": "feattextured_pinhole_k4t",
        "K5's triangle": "textured+staticplain"}[match]
    bad = dataclasses.replace(comb, has_mesh_uvs=True)
    from pathtracer_tpu_torch.render import renderer as trenderer
    assert bad.off_kernel and not comb.off_kernel
    assert not trenderer.kernel_renders(bad, trenderer.RenderConfig(8, 8))


def test_mesh_without_uvs_and_dma_tier_raise():
    """The streamed tier without UVs and the DMA tier are ported (the walk
    runs without the uv rows, world 7 with tri_dma set is a plain flag),
    in fog too (the feature form), and beside sphere clusters (the mixed
    ``clustered+meshplain``); a mesh above the DMA tier's limit, a UV mesh
    or a bump map beside a combined set go off the kernel: its wrapper
    refuses them, naming the torch ops that render them."""
    ts = _plain_mesh_builder(1100).finalize()
    assert ts.tri_streamed and not ts.has_mesh_uvs
    z = torch.zeros(4)
    h = tint.intersect_scene(ts, TVec3(z, z, z), TVec3(z, z, z + 1.0))
    assert h.t.shape == (4,)
    w7, cam = tworlds.finalize_world(W7, 8, 8)
    dma = dataclasses.replace(w7, tri_dma=True)
    a = tint.intersect_scene_uv(dma, TVec3(z, z, z + 1.4),
                                TVec3(z + 1.0, z, z))
    b_ = tint.intersect_scene_uv(w7, TVec3(z, z, z + 1.4),
                                 TVec3(z + 1.0, z, z))
    assert torch.equal(a[0].t, b_[0].t) and bool(a[3].all())
    fog = dataclasses.replace(ts, fog_sigma_t=0.01)
    from pathtracer_tpu_torch.render import cuda_backend
    assert cuda_backend.variant(fog, cam) == "featmeshplain_pinhole"
    assert cuda_backend.variant(dataclasses.replace(
        dma, fog_sigma_t=0.01), cam) == "featmesh_pinhole"
    from pathtracer_tpu_torch.render import renderer as trenderer
    w2, _ = tworlds.finalize_world(tschema.WORLD_BRDF_TEST, 8, 8)
    both = dataclasses.replace(
        ts, sph_clusters=w2.sph_clusters,
        **{k: getattr(w2, k) for k in ("cl_offset", "cl_count", "cl_min",
                                       "cl_max", "cl_huge")})
    cuda_backend.check_supported(both, cam, trenderer.RenderConfig(8, 8))
    assert cuda_backend.variant(both, cam) == "clustered+meshplain"
    huge = dataclasses.replace(both, n_tris=tclusters.DMA_MAX + 1)
    assert huge.off_kernel
    with pytest.raises(NotImplementedError,
                       match=f"more than {tclusters.DMA_MAX} triangles.*"
                             "on XLA only.*torch ops"):
        cuda_backend.check_supported(huge, cam, trenderer.RenderConfig(8, 8))
