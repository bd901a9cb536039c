"""The static tier's BVH (``clusters.build_static_bvh``) and the plain
version of the card's static-tier walk (``ops/intersect.py::
_static_bvh_winners``: the huge cluster in order, then near-first over the
BVH of the other triangles) on the CPU.

- The BVH on the static tiers of tests/test_torch_mesh_tiers.py (144 and
  784 triangles without UVs, 120 and 736 with) and on meshes with a huge
  cluster (the 784-triangle sphere and the 120-triangle UV sphere on two
  triangles spanning the scene):
  the huge cluster's records first, every other triangle that can hit in
  exactly one leaf of at most ``STATIC_LEAF`` records, each record its
  ``ctri_*`` row with its cluster-order index, leaf boxes that hold their
  triangles with the padding, node boxes the exact unions of their
  children's, the depth within the kernel's stack; the converter derives
  the same tables from JAX's scene.
- The walk against the table-order walk ``_intersect_triangles_clustered``
  (the render's plain path): winners equal, t, alpha and beta bit-equal,
  the resolved hit and uv equal, with the BVH's children as built and
  swapped, on rays aimed at the mesh, rays that graze its triangles along
  and across their edges, and rays at its vertices.
- Exact ties: a grid whose rays meet shared edges at one t (the lower
  cluster-order index wins in any visit order; a plane at the same t keeps
  its hit), and a huge square under the grid at the same height, whose
  triangles keep every tie.
- Against JAX: the walk's hits on the UV mesh with a huge cluster
  against JAX's kernel-mode static tier (run op by op, as
  tests/test_torch_mesh_tiers.py runs it) under that file's gate, and a 16x8 render whose static tier takes the card's walk against
  JAX's XLA driver under the golden gates and bit-equal to the port's
  table-order render.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import clusters as tclu
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_mesh_tiers import _aimed_rays, _jax_kernel_mode
from test_torch_meshes import (
    mesh_builder, mesh_scene, tessellated_sphere, uv_sphere,
)
from test_torch_render import assert_golden_gates
from test_torch_scene import jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W5 = tschema.WORLD_MARIO


def _with_huge(tris, uvs=None):
    """``tris`` (and their ``uvs``) on two triangles of a 12 x 12 square at
    z = 0.25 under them (with uvs over [0, 1]^2): each spans more than
    clusters.HUGE_FRAC of the scene."""
    a, b, c, d = ([-6, -6, 0.25], [6, -6, 0.25], [6, 6, 0.25], [-6, 6, 0.25])
    tris = np.concatenate([tris, np.asarray([[a, b, c], [a, c, d]],
                                            np.float32)])
    if uvs is None:
        return tris, None
    return tris, np.concatenate([uvs, np.asarray(
        [[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)])


CASES = {
    "static144": lambda: (tessellated_sphere(144), None),
    "static784": lambda: (tessellated_sphere(800), None),
    "static120uv": lambda: uv_sphere(12, 6),
    "static736uv": lambda: uv_sphere(16, 24),
    "huge786": lambda: _with_huge(tessellated_sphere(800)),
    "huge122uv": lambda: _with_huge(*uv_sphere(12, 6)),
}


def _case(case, module=tworlds):
    """(scene, camera params, triangles, uvs, ray centre) of a case."""
    tris, uvs = CASES[case]()
    b, cp = mesh_builder(module, tris, uvs)
    scene = b.finalize(world_kind=W5, view_origin=cp.pos)
    center = (0.0, 0.0, 1.4) if uvs is not None else (0.0, 0.0, 1.2)
    return scene, cp, tris, uvs, center


def _kids(nodes: torch.Tensor) -> np.ndarray:
    return nodes[:, 12:14].contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_static_bvh_well_formed(case):
    ts, cp, tris, _, _ = _case(case)
    assert ts.tri_static
    n = ts.n_tris
    # the cluster order, as finalize makes it
    order, tri_clusters = tclu.build_clusters(*tclu.triangle_bounds(tris),
                                              sort_origin=cp.pos)
    assert tri_clusters == ts.tri_clusters
    huge = [c for c in ts.tri_clusters if c[2] is None]
    n_huge = huge[0][1] if huge else 0
    assert tint._bvh_huge(ts) == n_huge == (2 if "huge" in case else 0)
    ctri = np.concatenate([np.stack([c.numpy() for c in ts.ctri_n], 1),
                           ts.ctri_d.numpy()[:, None],
                           np.stack([c.numpy() for c in ts.ctri_e1], 1),
                           ts.ctri_a0.numpy()[:, None],
                           np.stack([c.numpy() for c in ts.ctri_e2], 1),
                           ts.ctri_b0.numpy()[:, None]], 1)[:n]
    key = ts.bvh_tri_k.numpy().astype(np.int64)
    shift = tclu.STATIC_KEY_SHIFT
    k = (key >> 1) & ((1 << (shift - 1)) - 1)
    recs = ts.bvh_tris.numpy()
    # every record is its ctri_* row; the huge cluster's come first, in
    # order; every other triangle that can hit (a record not all zero) once
    a0 = ts.bvh_apart[0]
    box_rec = np.zeros((len(k),), bool)
    for sec in range(2):  # each section's union and its groups' boxes
        first, n_sec = ts.bvh_apart[2 * sec:2 * sec + 2]
        box_rec[first:first + min(n_sec, 1)] = True
        box_rec[[g0 - 1 for _, _, g0, _ in tint._apart_groups(ts, sec)]] = True
    np.testing.assert_array_equal(recs[~box_rec], ctri[k[~box_rec]])
    assert k[:n_huge].tolist() == list(range(n_huge))
    can_hit = [i for i in range(n_huge, n) if ctri[i].any()]
    assert sorted(k[n_huge:a0].tolist() + k[a0:][~box_rec[a0:]].tolist()) \
        == can_hit
    # the triangles as the precomputed test sees them: A, A + u, A + v
    t = tris.astype(np.float32)[order].astype(np.float64)
    a = t[:, 0]
    corners = np.stack([a, a + (t[:, 1] - t[:, 0]).astype(np.float32),
                        a + (t[:, 2] - t[:, 0]).astype(np.float32)])
    lo, hi = corners.min(0), corners.max(0)
    big = max(np.abs(lo[n_huge:]).max(), np.abs(hi[n_huge:]).max())
    m = tclu.STATIC_PAD_ULPS * float(np.spacing(np.float32(big)))
    pads = np.full((n,), m)
    apart, far_apart = np.zeros((n,), bool), np.zeros((n,), bool)
    pads[n_huge:], apart[n_huge:], far_apart[n_huge:], far = tclu.mesh_pads(
        (t[n_huge:, 1] - t[n_huge:, 0]).astype(np.float32),
        (t[n_huge:, 2] - t[n_huge:, 0]).astype(np.float32), m, big)
    assert (ts.bvh_far, ts.bvh_wide) == (far["bvh_far"], far["bvh_wide"])
    # the degenerate pole slivers of the lat-long spheres are set apart
    assert apart.any() == ("static" in case and "uv" not in case
                           or case == "huge786")
    pad = lambda sel: pads[sel]
    # each key: its cluster, its index, and the check bit unless its bound,
    # padded, lies inside its cluster's box (the huge cluster: never); the
    # keys order as the indices
    tri = ~box_rec
    assert (np.argsort(key[:a0]) == np.argsort(k[:a0])).all()
    for j in np.nonzero(tri)[0]:
        off, cnt, cmn, cmx = ts.tri_clusters[key[j] >> shift]
        assert off <= k[j] < off + cnt
        i, p = k[j], pad(k[j])
        inside = cmn is None or ((lo[i] - p > cmn).all()
                                 and (hi[i] + p < cmx).all())
        assert key[j] & 1 == (not inside)
    assert 0 < (key[n_huge:a0] & 1).mean() < 0.8
    # the triangles set apart that can hit, in groups by cluster under the
    # cluster's box: the degenerate slivers (every ray's), then the other
    # slivers (a far ray's)
    a0, n_apart, f0, n_far = ts.bvh_apart
    for sec, (n_sec, sel) in enumerate(((n_apart, apart), (n_far, far_apart))):
        got = []
        groups = tint._apart_groups(ts, sec)
        for mn, mx, g0, cnt in groups:
            off, c_n, cmn, cmx = ts.tri_clusters[key[g0] >> shift]
            assert (mn, mx) == (cmn, cmx)
            sel_k = k[g0:g0 + cnt]
            assert (off <= sel_k).all() and (sel_k < off + c_n).all()
            got += sel_k.tolist()
        assert got == [i for i in range(n_huge, n) if sel[i] and ctri[i].any()]
        assert sum(1 + c for _, _, _, c in groups) + min(n_sec, 1) == n_sec
    assert a0 + n_apart == f0 and f0 + n_far == len(k)
    nodes = ts.bvh_nodes.numpy()
    kids = _kids(ts.bvh_nodes)
    spans, depth = [], [0]

    def box(ref, level):
        if ref & tclu.BVH_LEAF:
            first, cnt = (ref & (tclu.BVH_LEAF - 1)) >> 4, ref & 15
            assert 1 <= cnt <= tclu.STATIC_LEAF and first >= n_huge
            spans.append((first, cnt))
            return None
        depth[0] = max(depth[0], level)
        got = []
        for j in range(2):
            b = nodes[ref, 6 * j:6 * j + 6]
            sub = box(int(kids[ref, j]), level + 1)
            if sub is None:  # a leaf: it holds its triangles, padded
                first, cnt = spans[-1]
                sel = k[first:first + cnt]
                p = pad(sel)[:, None]
                mn, mx = (lo[sel] - p).min(0), (hi[sel] + p).max(0)
                assert (b[:3] <= mn).all() and (b[3:] >= mx).all()
                assert (b[:3] >= mn - m).all()
            else:  # an inner node: the exact union of its children's
                np.testing.assert_array_equal(b, sub)
            got.append(b)
        return np.concatenate([np.minimum(got[0][:3], got[1][:3]),
                               np.maximum(got[0][3:], got[1][3:])])

    root = box(0, 1)
    np.testing.assert_array_equal(np.float32(ts.bvh_root), root)
    assert depth[0] == ts.bvh_depth <= tclu.BVH_MAX_DEPTH
    spans.sort()
    assert [f for f, _ in spans] == np.cumsum(
        [n_huge] + [c for _, c in spans[:-1]]).tolist()
    assert sum(c for _, c in spans) == a0 - n_huge
    # the converter derives the same tables from JAX's scene
    conv = jax_scene_to_port(_case(case, jworlds)[0])
    for f in ("bvh_nodes", "bvh_tris", "bvh_tri_k"):
        assert torch.equal(getattr(conv, f), getattr(ts, f)), f
    assert (conv.bvh_root, conv.bvh_depth) == (ts.bvh_root, ts.bvh_depth)


def _grazing_rays(rng, tris, n):
    """Rays at points of random (not degenerate) triangles' edges, a few
    ulps inside or
    outside them, in the triangle's plane along and across the edge with a
    normal component of 0 to 1e-3, and rays from random points aimed at
    random vertices: (o, d) as (3, n) arrays."""
    t = tris.astype(np.float64)
    area = np.linalg.norm(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1)
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
    along = rng.rand(n) < 0.5
    d = np.where(along[:, None], edge, across)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    d += nrm * rng.choice([0.0, 1e-5, 1e-3], (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = q - 2.0 * d
    # a quarter: from random points at random vertices
    m = n // 4
    vo = t[pick[:m], e[:m]]
    o[:m] = vo + rng.randn(m, 3) * 2.0
    d[:m] = vo - o[:m]
    d[:m] /= np.linalg.norm(d[:m], axis=1, keepdims=True)
    return o.T.astype(np.float32), d.T.astype(np.float32)


def _flat(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(c).reshape(-1))
                   for c in a))


def _swapped(ts):
    """``ts`` with every node's two children swapped (boxes and
    references), the huge count kept in the root."""
    nodes = ts.bvh_nodes.clone()
    nodes[:, 0:6], nodes[:, 6:12] = ts.bvh_nodes[:, 6:12], ts.bvh_nodes[:, 0:6]
    nodes[:, 12], nodes[:, 13] = ts.bvh_nodes[:, 13], ts.bvh_nodes[:, 12]
    return dataclasses.replace(ts, bvh_nodes=nodes)


def _both_walks(ts, o, d, uv):
    best = tint._non_triangles(ts, o, d)
    ref = tint._intersect_triangles_clustered(ts, o, d, best, uv)
    tally = {}
    t, win, a, b = tint._static_bvh_winners(ts, o, d, best.t, tally)
    out = tint._intersect_triangles_static_bvh(ts, o, d, best, uv)
    return best, ref, (t, win, a, b), out, tally


@pytest.mark.parametrize("order", ["built", "swapped"])
@pytest.mark.parametrize("case", list(CASES))
def test_bvh_walk_equals_table_walk(case, order):
    ts, _, tris, uvs, center = _case(case)
    if order == "swapped":
        ts = _swapped(ts)
    rng = np.random.RandomState(5)
    ao, ad = _aimed_rays(rng, 1024, center)
    go, gd = _grazing_rays(rng, tris, 2048)
    o = _flat(np.concatenate([ao.reshape(3, -1), go], 1))
    d = _flat(np.concatenate([ad.reshape(3, -1), gd], 1))
    uv = uvs is not None
    best, ref, (t, idx, a, b), out, tally = _both_walks(ts, o, d, uv)
    # the winners, their t, alpha and beta: the table walk's, bit for bit
    found = ref[3]
    assert torch.equal(idx >= 0, found) and int(found.sum()) >= 1000
    t_ref, _, a_ref, b_ref = tint._ctri_tests(ts, o, d, idx.clamp_min(0))
    assert torch.equal(t, ref[0].t)
    assert torch.equal(t[found], t_ref[found])
    assert torch.equal(a[found], a_ref[found])
    assert torch.equal(b[found], b_ref[found])
    # the resolved hit and uv
    assert torch.equal(out[0].mat, ref[0].mat)
    for x, y in [*zip(out[0].normal, ref[0].normal), *zip(out[1:], ref[1:])]:
        assert torch.equal(x, y)
    # the walk culls: a few triangle tests per ray
    assert tally["tris"] / o.x.numel() < 0.2 * ts.n_tris


def _grid(z, n=16, s=0.25):
    """An n x n grid of s-sized cells in the plane z, two triangles a cell
    (a, b, c) and (a, c, d) wound up: every value dyadic, so a ray down
    the z axis meets both triangles of a shared edge at exactly one t."""
    out = []
    for i in range(n):
        for k in range(n):
            x, y = -n * s / 2 + i * s, -n * s / 2 + k * s
            a, b = (x, y, z), (x + s, y, z)
            c, d = (x + s, y + s, z), (x, y + s, z)
            out += [[a, b, c], [a, c, d]]
    return np.asarray(out, np.float32)


def _huge_square(z):
    """Two triangles of a 16 x 16 square in the plane z, wound up."""
    a, b, c, d = (-8, -8, z), (8, -8, z), (8, 8, z), (-8, 8, z)
    return np.asarray([[a, b, c], [a, c, d]], np.float32)


@pytest.mark.parametrize("order", ["built", "swapped"])
@pytest.mark.parametrize("mesh, z", [("grid", 1.0), ("grid", 0.0),
                                     ("grid+huge", 1.0)],
                         ids=["above", "on_the_ground", "huge_under"])
def test_tie_on_shared_edges(mesh, z, order):
    """Rays that meet the grid at t = 4 on shared edges (each cell's
    diagonal, the edge between neighbouring cells, a corner), along a
    dyadic direction, hit two or more triangles at exactly that t, often
    in different leaves whose boxes the ray also enters at exactly t = 4:
    the walk takes the lowest cluster-order index, as the table-order walk
    does, whichever leaf it reaches first (the BVH as built, and with every
    node's children swapped). On the ground plane (z = 0) the plane's hit
    at the same t keeps its win; a huge square at the grid's height keeps
    every tie, its index being lower than any other."""
    tris = _grid(z)
    if mesh == "grid+huge":
        tris = np.concatenate([tris, _huge_square(z)])
    ts, _ = mesh_scene(tworlds, tris)
    assert ts.tri_static and ts.n_tris == len(tris)
    n_huge = tint._bvh_huge(ts)
    assert n_huge == (2 if mesh == "grid+huge" else 0)
    if order == "swapped":
        ts = _swapped(ts)
    s, pts = 0.25, []
    for x in np.arange(-1.75, 1.75, 0.5):
        for y in np.arange(-1.75, 1.75, 0.75):
            pts += [(x + s / 2, y + s / 2), (x + s, y + s / 2), (x + s, y + s)]
    pts = np.asarray(pts, np.float32)
    n = len(pts)
    step = np.float32([1 / 16, 1 / 32, -1.0])
    org = np.concatenate([pts, np.full((n, 1), z, np.float32)], 1) - 4 * step
    o = TVec3(*(torch.from_numpy(org[:, k].copy()) for k in range(3)))
    d = TVec3(*(torch.full((n,), float(v)) for v in step))
    best, ref, (t, idx, _, _), out, _ = _both_walks(ts, o, d, False)
    assert torch.equal(t, ref[0].t) and torch.equal(out[0].mat, ref[0].mat)
    # every triangle, tested brute force: two or more tie at t = 4
    col = lambda v: TVec3(*(c[:, None] for c in v))
    t_all, hit, _, _ = tint._ctri_tests(ts, col(o), col(d),
                                        slice(0, ts.n_tris))
    ties = hit & (t_all == 4.0)
    assert bool((ties.sum(1) >= 2).all())
    if z == 0.0:
        # the ground plane's hit at the same t keeps its win
        assert bool((best.t == 4.0).all()) and bool((idx == -1).all())
        return
    first = torch.where(ties, torch.arange(ts.n_tris), 1 << 30).amin(1)
    assert torch.equal(idx, first) and bool((t == 4.0).all())
    assert bool((first < n_huge).all()) == (mesh == "grid+huge")


def test_bvh_walk_vs_jax_kernel_mode():
    """The card's walk against JAX's static tier (kernel-mode, op by op:
    over a minute for a 736-triangle mesh, so a small UV mesh with a huge
    cluster) on the same numpy-seeded rays, under test_torch_mesh_tiers.py's
    gate: the winners (material and normal) on at least 99.9% of rays, t
    within 2e-5 relative, the uv of agreeing winners within 1e-3 texels."""
    case = "huge122uv"
    ts, _, _, uvs, center = _case(case)
    js = _case(case, jworlds)[0]
    o, d = _aimed_rays(np.random.RandomState(11), 1024, center)
    uv = uvs is not None
    jout = _jax_kernel_mode(js, o, d, uv)
    to, td = _flat(o), _flat(d)
    tout = tint._intersect_triangles_static_bvh(
        ts, to, td, tint._non_triangles(ts, to, td), uv)
    jh = jout[0] if uv else jout
    th = tout[0]
    j = lambda a: np.asarray(a).reshape(-1)
    same = ((j(jh.mat) == th.mat.numpy())
            & np.all([j(a) == b.numpy() for a, b in zip(jh.normal, th.normal)],
                     axis=0))
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(j(jh.t)[same], th.t.numpy()[same], rtol=2e-5)
    assert int(tout[3].sum()) >= 300  # triangle winners
    if uv:
        ok = tout[3].numpy()
        np.testing.assert_array_equal(j(jout[3]), ok)
        sel = same & ok
        for a, b in ((jout[1], tout[1]), (jout[2], tout[2])):
            assert np.abs(j(a)[sel] - b.numpy()[sel]).max() <= 1e-3


def test_render_vs_xla(monkeypatch):
    """A 16x8 render (pp=1, 4 samples) of the 736-triangle UV sphere whose
    static tier takes the card's walk: under the golden gates against
    JAX's XLA wavefront renderer, and bit-equal to the port's table-order
    render."""
    tris, uvs = CASES["static736uv"]()
    js, jcam = mesh_scene(jworlds, tris, uvs, 16, 8)
    ts, tcam = mesh_scene(tworlds, tris, uvs, 16, 8)
    assert cuda_backend.variant(ts, tcam) == "static_pinhole"
    cfg = trenderer.RenderConfig(16, 8, pp=1, seed=0)
    plain = lambda: cuda_backend.render_chunk_plain(
        ts, tcam, cfg, 0, 0, 4, trenderer.init_accum(16 * 8))
    table = plain()
    monkeypatch.setattr(tint, "_intersect_triangles_clustered",
                        tint._intersect_triangles_static_bvh)
    tst = plain()
    for a, b in [*zip(tst.sum, table.sum), (tst.count, table.count)]:
        assert torch.equal(a, b)
    assert int(tst.rays_cast) == int(table.rays_cast)
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(16, 8, pp=1, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(16 * 8))
    assert_golden_gates(jst, tst)
