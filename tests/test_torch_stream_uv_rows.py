"""K7's row-parallel uv rows against the JAX package on the CPU.

JAX's finalize keeps a streamed UV mesh's uv rows parallel to its record
rows (``clusters.pack_stream_uv``) when its largest cluster holds more than
128 triangles, and its kernel resolves the winner's uv from them
(``_intersect_triangles_streamed``'s ``fetch_uv`` branch). The mesh here is
1000 small random triangles with UVs and 200 slivers across them
(``mixed_scenes.with_slivers``): the slivers are huge triangles, so the
huge cluster holds 200, and its rows number past 128.

- Tables: ``pack_stream_uv`` and every table and static bit-equal to JAX's
  through the converter, resident and forced into the DMA tier (the port by
  its own clusters.STREAM_MAX, PARENT_GROUP and GPARENT_MIN, JAX by
  PT_STREAM_DMA, PT_PARENT_GROUP and PT_GPARENT_MIN); ``stream_uv_cfm``
  False and ``stream_leaf`` 200 on both sides, and no refusal.
- The BVH's winners are numbered by record (row * 9 + slot), which keys
  the parallel uv rows, past the 128 that the cluster-field-major number
  allows.
- Walks: the port's plain ``intersect_scene_uv`` against JAX's kernel-mode
  streamed tier (op by op) under tests/test_torch_mesh.py's gate (winners
  on at least 99.9% of rays, uv_ok equal, t within 2e-5 relative, the uv
  of agreeing winners within 1e-3 texels), and the card's walk replayed
  (``_intersect_triangles_bvh``) equal to the table-order walk: winners,
  t and uv bit for bit.
- One 16x8 render (pp=1, 4 samples) through the port's plain version
  against JAX's XLA wavefront renderer under the golden gates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import clusters as jclusters
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import clusters as tclusters
from pathtracer_tpu_torch.scene import mixed_scenes
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_bvh import box_records
from test_torch_mesh_tiers import force_dma  # noqa: F401 (a fixture)
from test_torch_meshes import mesh_scene
from test_torch_render import assert_golden_gates
from test_torch_scene import assert_tables_equal
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

CENTER = np.array([0.0, 0.0, 1.2])


def sliver_mesh(n=1000, seed=7):
    """n small random triangles in a 2.4-unit box about CENTER (world 5's
    mesh place), their uvs the vertices' x and y over the box (a planar
    projection, smooth as a modelled mesh's), and 200 slivers across
    them."""
    rng = np.random.RandomState(seed)
    base = CENTER + (rng.rand(n, 1, 3) - 0.5) * 2.4
    tris = (base + (rng.rand(n, 3, 3) - 0.5) * 0.15).astype(np.float32)
    uvs = (tris.reshape(-1, 3)[:, :2] - CENTER[:2] + 1.2) / 2.4
    return mixed_scenes.with_slivers(tris, uvs)


def _both(dma, request, w=32, h=18):
    if dma:
        request.getfixturevalue("force_dma")
    tris, uvs = sliver_mesh()
    return (mesh_scene(jworlds, tris, uvs, w, h),
            mesh_scene(tworlds, tris, uvs, w, h))


@pytest.mark.parametrize("dma", [False, True], ids=["resident", "dma"])
def test_row_parallel_tables_bit_equal(dma, request):
    (js, _), (ts, _) = _both(dma, request)
    assert_tables_equal(js, ts)
    for s in (js, ts):
        assert s.tri_streamed and s.tri_dma == dma
        assert not s.stream_uv_cfm and s.stream_leaf == 200
    assert ts.unsupported() == []
    assert cuda_backend.mesh_kind(ts) == "mesh"
    rpc = tclusters.stream_rows_per_cluster(ts.stream_leaf)
    assert ts.mtri_uvpack.shape == ts.mtri_pack.shape == (
        ts.n_stream_clusters * rpc, 128)
    # pack_stream_uv alone, on the scene's cluster-ordered uv table
    clusters = ((0, 200, None, None), (200, 96, (0.0,) * 3, (1.0,) * 3),
                (296, 7, (0.0,) * 3, (1.0,) * 3))
    uvt = np.random.RandomState(1).rand(303, 6).astype(np.float32)
    got = tclusters.pack_stream_uv(uvt, clusters, 200)
    np.testing.assert_array_equal(got, jclusters.pack_stream_uv(uvt, clusters,
                                                                200))
    assert got.dtype == np.float32 and got.shape == (3 * rpc, 128)


def test_bvh_numbers_records_past_128(request):
    (_, _), (ts, _) = _both(False, request)
    k = ts.bvh_tri_k.long()
    assert torch.equal(tint._bvh_record_number(ts, k), k)
    # the huge cluster's rows hold slots past 128 of their cluster
    rpc = tclusters.stream_rows_per_cluster(ts.stream_leaf)
    assert int((k % (rpc * 9)).max()) >= 128
    recs = ts.mtri_pack[:, :117].reshape(-1, 13)
    tri = ~torch.from_numpy(box_records(ts))
    assert torch.equal(ts.bvh_tris[tri], recs[k[tri], :12])


def _aimed_rays(rng, n=1024):
    """Rays from a shell of radius 2-5 around the mesh toward random points
    of its box, as (8, 128) arrays."""
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    o = CENTER + dirs * rng.uniform(2.0, 5.0, (n, 1))
    d = CENTER + (rng.rand(n, 3) - 0.5) * 2.4 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o.T.astype(np.float32).reshape(3, 8, 128),
            d.T.astype(np.float32).reshape(3, 8, 128))


@pytest.mark.parametrize("dma", [False, True], ids=["resident", "dma"])
def test_intersect_scene_uv_vs_jax_streamed(dma, request):
    (js, _), (ts, _) = _both(dma, request)
    o, d = _aimed_rays(np.random.RandomState(11))
    jint._tracing_pallas_kernel = True
    try:
        jh, jux, juy, jok = jint.intersect_scene_uv(
            js, JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)))
    finally:
        jint._tracing_pallas_kernel = False
    flat = lambda a: torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    O, D = TVec3(*map(flat, o)), TVec3(*map(flat, d))
    th, tux, tuy, tok = tint.intersect_scene_uv(ts, O, D)
    j = lambda a: np.asarray(a).reshape(-1)
    same = ((j(jh.mat) == th.mat.numpy())
            & np.all([j(a) == b.numpy() for a, b in zip(jh.normal, th.normal)],
                     axis=0))
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(j(jok), tok.numpy())
    np.testing.assert_allclose(j(jh.t)[same], th.t.numpy()[same], rtol=2e-5)
    sel = same & tok.numpy()
    assert sel.sum() >= 150  # triangle winners
    for a, b in ((jux, tux), (juy, tuy)):
        assert np.abs(j(a)[sel] - b.numpy()[sel]).max() <= 1e-3
    # the card's walk, replayed, resolves the same winners bit for bit
    best = tint._non_triangles(ts, O, D)
    table = tint.intersect_triangles(ts, O, D, best, want_uv=True)
    bvh = tint._intersect_triangles_bvh(ts, O, D, best, want_uv=True)
    assert torch.equal(table[0].t, bvh[0].t)
    assert torch.equal(table[0].mat, bvh[0].mat)
    for a, b in zip((*table[0].normal, *table[1:]), (*bvh[0].normal, *bvh[1:])):
        assert torch.equal(a, b)


def test_render_vs_xla(request):
    (js, jcam), (ts, tcam) = _both(False, request, 16, 8)
    assert cuda_backend.variant(ts, tcam) == "mesh_pinhole"
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(16, 8, pp=1, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(16 * 8))
    tst = cuda_backend.render_chunk_plain(
        ts, tcam, trenderer.RenderConfig(16, 8, pp=1, seed=0), 0, 0, 4,
        trenderer.init_accum(16 * 8))
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count) == 0
