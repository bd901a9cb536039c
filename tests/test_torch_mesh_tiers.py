"""The mesh tiers against the JAX package on the CPU: meshes without UVs
swept brute force (K4t's plain form), the static tier of 65-1024
triangles (K5's triangle form, with the winner's uv K8), the streamed
tier without UVs (K7) and the DMA tier with its grandparent level.

- Tables: each tier's tables and statics bit-equal to JAX's finalize
  through the converter, and the converted scene's kernel tables equal to
  the port-built ones. The DMA tier is forced on small meshes: the port by
  its own clusters.STREAM_MAX, PARENT_GROUP and GPARENT_MIN, JAX by
  PT_STREAM_DMA, PT_PARENT_GROUP and PT_GPARENT_MIN (as
  tests/test_clusters.py:339-420 forces it).
- Walks: the port's plain intersect_scene / intersect_scene_uv against
  JAX's kernel-mode functions (``_tracing_pallas_kernel``, op by op: jitted,
  XLA:CPU contracts multiply-adds into FMAs and moves winners at shared
  edges, 0.4% of these rays on the 144-triangle sphere) on rays aimed at
  the mesh. The gate is the winners (material and normal) on at least
  99.9% of rays (100% measured), t within 2e-5 relative and the uv of
  agreeing winners within 1e-3 texels.
- The DMA tier's render is bit-equal to the resident render of the same
  mesh, with the grandparent level on and off (pure pruning).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import clusters as tclusters
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_meshes import (
    lat_long_sphere, mesh_scene, tessellated_sphere, uv_sphere,
)
from test_torch_scene import assert_tables_equal, jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

@pytest.fixture
def force_dma(monkeypatch):
    """Forces the DMA tier with grandparents over parents of 4 clusters on
    a mesh of a few thousand triangles, in both packages."""
    for k, v in (("PT_STREAM_DMA", "1"), ("PT_PARENT_GROUP", "4"),
                 ("PT_GPARENT_MIN", "4")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tclusters, "STREAM_MAX", 1024)
    monkeypatch.setattr(tclusters, "PARENT_GROUP", 4)
    monkeypatch.setattr(tclusters, "GPARENT_MIN", 4)


CASES = {
    "brute40": lambda: (lat_long_sphere(4, 5), None),
    "static144": lambda: (tessellated_sphere(144), None),
    "static784": lambda: (tessellated_sphere(800), None),
    "static120uv": lambda: uv_sphere(12, 6),
    "static736uv": lambda: uv_sphere(16, 24),
    "streamed1936": lambda: (tessellated_sphere(2000), None),
    "dma1936": lambda: (tessellated_sphere(2000), None),
    "dma1984uv": lambda: uv_sphere(32, 32),
}


def _both(case, request):
    if case.startswith("dma"):
        request.getfixturevalue("force_dma")
    tris, uvs = CASES[case]()
    return (mesh_scene(jworlds, tris, uvs)[0],
            mesh_scene(tworlds, tris, uvs)[0])


@pytest.mark.parametrize("case", list(CASES))
def test_tier_tables_bit_equal(case, request):
    js, ts = _both(case, request)
    assert_tables_equal(js, ts)
    assert ts.unsupported() == []
    n = ts.n_tris
    assert ts.tri_brute == (n <= tclusters.CLUSTER_MIN)
    assert ts.tri_static == (tclusters.CLUSTER_MIN < n <= tclusters.STREAM_MIN)
    assert ts.tri_dma == case.startswith("dma") == js.tri_dma
    assert ts.tri_clusters == js.tri_clusters
    if ts.tri_static:
        assert ts.ctri_mat.shape[0] % 128 == 0 and len(ts.tri_clusters) > 1
        assert ts.tcl_range[:, 1].sum() == n
    if ts.tri_dma:
        assert len(ts.stream_gparents) == js.n_stream_gparents > 1
        assert len(ts.stream_parents) == js.n_stream_parents
    conv = jax_scene_to_port(js)
    for k in tschema.DERIVED_TENSOR_FIELDS:
        assert torch.equal(getattr(conv, k), getattr(ts, k)), k
    kind = cuda_backend.mesh_kind(ts) if cuda_backend.meshed(ts) else None
    assert kind == {"brute40": None, "static144": "staticplain",
                    "static784": "staticplain", "static120uv": "static",
                    "static736uv": "static", "streamed1936": "meshplain",
                    "dma1936": "meshplain", "dma1984uv": "mesh"}[case]


def _aimed_rays(rng, n=1024, center=(0.0, 0.0, 1.2)):
    """Rays from a shell of radius 1.5-5 around the mesh toward random
    points of its box, as (8, 128) arrays."""
    c = np.asarray(center)
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = c + dirs * rng.uniform(1.5, 5.0, (n, 1))
    d = c + (rng.rand(n, 3) - 0.5) * 2.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o.T.astype(np.float32).reshape(3, 8, 128),
            d.T.astype(np.float32).reshape(3, 8, 128))


def _jax_kernel_mode(js, o, d, uv):
    """JAX's kernel-mode intersect (the code Mosaic compiles), run op by op:
    jitted, XLA:CPU would contract multiply-adds into FMAs."""
    jint._tracing_pallas_kernel = True
    try:
        fn = jint.intersect_scene_uv if uv else jint.intersect_scene
        return fn(js, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)))
    finally:
        jint._tracing_pallas_kernel = False


@pytest.mark.parametrize("case", ["brute40", "static144", "static120uv",
                                  "streamed1936", "dma1936"])
def test_plain_walks_vs_jax_kernel_mode(case, request):
    """K4t plain, K5 triangles, K8, K7 without UVs and its DMA tier."""
    js, ts = _both(case, request)
    uv = ts.has_mesh_uvs
    o, d = _aimed_rays(np.random.RandomState(11))
    jout = _jax_kernel_mode(js, o, d, uv)
    flat = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    fn = tint.intersect_scene_uv if uv else tint.intersect_scene
    tout = fn(ts, TVec3(*map(flat, o)), TVec3(*map(flat, d)))
    jh, th = (jout[0], tout[0]) if uv else (jout, tout)
    j = lambda a: np.asarray(a).reshape(-1)
    same = ((j(jh.mat) == th.mat.numpy())
            & np.all([j(a) == b.numpy() for a, b in zip(jh.normal, th.normal)],
                     axis=0))
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(j(jh.t)[same], th.t.numpy()[same], rtol=2e-5)
    mesh_mat = ts.n_materials - 1
    assert (th.mat.numpy() == mesh_mat).sum() >= 300  # triangle winners
    if uv:
        ok = tout[3].numpy()
        np.testing.assert_array_equal(j(jout[3]), ok)
        sel = same & ok
        for a, b in ((jout[1], tout[1]), (jout[2], tout[2])):
            assert np.abs(j(a)[sel] - b.numpy()[sel]).max() <= 1e-3


def _render(scene, cam, w=32, h=18):
    cfg = trenderer.RenderConfig(w, h, pp=2, seed=0)
    return cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 4,
                                           trenderer.init_accum(w * h))


@pytest.mark.parametrize("uv", [False, True], ids=["plain", "uv"])
def test_dma_tier_bit_equal_to_resident(uv, monkeypatch):
    """The same mesh resident, in the DMA tier with grandparents and in the
    DMA tier without them renders bit-equal, through the plain version."""
    tris, uvs = (uv_sphere(32, 32) if uv
                 else (tessellated_sphere(2000), None))
    monkeypatch.setattr(tclusters, "PARENT_GROUP", 4)
    resident, cam = mesh_scene(tworlds, tris, uvs)
    monkeypatch.setattr(tclusters, "STREAM_MAX", 1024)
    monkeypatch.setattr(tclusters, "GPARENT_MIN", 4)
    gp, _ = mesh_scene(tworlds, tris, uvs)
    monkeypatch.setattr(tclusters, "GPARENT_MIN", 1 << 30)
    flat, _ = mesh_scene(tworlds, tris, uvs)
    assert not resident.tri_dma and gp.tri_dma and flat.tri_dma
    assert len(gp.stream_gparents) > 1 and not flat.stream_gparents
    # the grandparents permute the parent list; the clusters stay
    assert sorted(gp.stream_parents) == list(resident.stream_parents)
    assert flat.stream_parents == resident.stream_parents
    assert torch.equal(gp.mtri_pack, resident.mtri_pack)
    states = [_render(s, cam) for s in (resident, gp, flat)]
    for st in states[1:]:
        for a, b in zip(states[0].sum, st.sum):
            assert torch.equal(a, b)
        assert torch.equal(states[0].count, st.count)
        assert int(states[0].rays_cast) == int(st.rays_cast)
    # one walk for both tiers: the same variant renders all three
    want = {False: ("meshplain",) * 3, True: ("mesh",) * 3}[uv]
    assert tuple(cuda_backend.mesh_kind(s) for s in (resident, gp, flat)) \
        == want


def test_tie_goes_to_the_lower_record():
    """Two coincident triangles hit at the same t: the streamed walk keeps
    the lower record, the resident walk's strict-< order (and the kernel's
    tie-break under the grandparent level, which visits parents out of
    table order)."""
    tri = lat_long_sphere(30, 40)
    k = 2 * 40 * 15 + 10  # a triangle of the middle row
    ts, _ = mesh_scene(tworlds, np.concatenate([tri, tri[k:k + 1]]))
    assert ts.tri_streamed
    a, b, c = tri[k].astype(np.float64)
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n)
    col = lambda v: TVec3(*(torch.tensor([x], dtype=torch.float32)
                            for x in v))
    o, d = col((a + b + c) / 3.0 + 0.5 * n), col(-n)
    t_win, rec = tint._stream_winners(ts, o, d,
                                      torch.full((1,), tschema.F32_MAX))
    recs = ts.mtri_pack[:, :117].reshape(-1, 13)
    _, _, t, hit, _, _ = tint._record_tests(recs, o, d)
    ties = torch.nonzero(hit & (t == t_win)).reshape(-1).tolist()
    assert len(ties) == 2 and int(rec) == min(ties)


def test_mesh_refusals():
    """A clustered mesh in fog is ported (the static tier's feature form),
    and so are a mesh with sphere clusters and a mesh without UVs with a
    combined texture set (the mixed variants); a UV mesh or a bump map
    with a combined texture set goes off the kernel (XLA-only in JAX): its
    wrapper refuses it, naming the torch ops that render it."""
    ts, cam = mesh_scene(tworlds, tessellated_sphere(800))
    fog = dataclasses.replace(ts, fog_sigma_t=0.01)
    assert fog.unsupported() == []
    assert cuda_backend.variant(fog, cam) == "featstaticplain_pinhole"
    w2, _ = tworlds.finalize_world(tschema.WORLD_BRDF_TEST, 8, 8)
    both = dataclasses.replace(
        ts, sph_clusters=w2.sph_clusters,
        **{k: getattr(w2, k) for k in ("cl_offset", "cl_count", "cl_min",
                                       "cl_max", "cl_huge")})
    cuda_backend.check_supported(both, cam, trenderer.RenderConfig(8, 8))
    assert cuda_backend.variant(both, cam) == "clustered+staticplain"
    w1, _ = tworlds.finalize_world(tschema.WORLD_DEFAULT, 8, 8)
    comb = dataclasses.replace(
        ts, n_textures=4, tex_combined=True,
        **{k: getattr(w1, k) for k in ("tex_tile", "tex_comb_a",
                                       "tex_comb_b", "tex_mip")})
    assert comb.unsupported() == []
    assert cuda_backend.variant(comb, cam) == "textured+staticplain"
    for bad, what in ((dataclasses.replace(comb, has_mesh_uvs=True),
                       "a UV mesh or a bump map beside a combined texture "
                       "set on XLA only"),
                      (dataclasses.replace(comb, any_bump=True),
                       "a UV mesh or a bump map beside a combined texture "
                       "set on XLA only")):
        assert bad.unsupported() == [] and bad.off_kernel
        assert not trenderer.kernel_renders(bad, trenderer.RenderConfig(8, 8))
        with pytest.raises(NotImplementedError, match=what):
            cuda_backend.check_supported(bad, cam,
                                         trenderer.RenderConfig(8, 8))
