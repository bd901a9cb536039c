"""The streamed tier's BVH and the card's walk over it (K7), on the CPU.

``scene/clusters.py::build_stream_bvh`` builds binary nodes over the
record rows that JAX's streamed tier packs; ``ops/intersect.py::
_bvh_winners`` is the plain version of the kernel's near-first walk
(``bvh_walk`` in csrc/wave_kernel.cu), step for step. It is held here to
the table-order plain walk ``_intersect_triangles_streamed``, which
tests/test_torch_mesh.py and tests/test_torch_mesh_tiers.py hold to JAX's
streamed tier: the same winners and bit-identical t, alpha and beta, on
world 7's UV sphere, a 19,600-triangle sphere and a mesh forced into the
DMA tier, with numpy-seeded rays; and directly against JAX's kernel-mode
walk on world 7 and the forced-DMA mesh. A planar grid whose rays hit
shared edges exactly checks the tie rule: the lower table-order number
wins, and a plane hit at the same t keeps its win.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.scene import clusters as tclusters
from pathtracer_tpu_torch.scene import convert as tconvert
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_mesh_tiers import (  # noqa: F401  (force_dma: a fixture)
    _aimed_rays, _jax_kernel_mode, force_dma,
)
from test_torch_meshes import mesh_scene, tessellated_sphere, uv_sphere
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W7 = tschema.WORLD_MESH_UV
PER = tclusters.STREAM_TRIS_PER_ROW


def _scene(case, request, module=tworlds):
    """(scene, ray centre) of a case: world 7, the 19,600-triangle sphere,
    or the forced-DMA tier on 1936 triangles without UVs or 1984 with."""
    if case == "w7":
        return module.finalize_world(W7, 16, 9)[0], (0.0, 0.0, 1.0)
    if case.startswith("dma"):
        request.getfixturevalue("force_dma")
    tris, uvs = {"sphere19600": lambda: (tessellated_sphere(19600), None),
                 "dma1936": lambda: (tessellated_sphere(2000), None),
                 "dma1984uv": lambda: uv_sphere(32, 32)}[case]()
    center = (0.0, 0.0, 1.4) if uvs is not None else (0.0, 0.0, 1.2)
    return mesh_scene(module, tris, uvs)[0], center


def _flat(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(c).reshape(-1))
                   for c in a))


CASES = ["w7", "sphere19600", "dma1936", "dma1984uv"]


def _stream_tris(ts):
    """The scene's triangles (A, u, v) by record row and slot, as finalize
    hands them to ``build_stream_bvh``."""
    kw = dict(n_tris=ts.n_tris, tri_a=ts.tri_a, tri_u=ts.tri_u,
              tri_v=ts.tri_v, tri_streamed=True, mtri_pack=ts.mtri_pack)
    return tconvert._stream_tris(kw)


def box_records(ts) -> np.ndarray:
    """Which of ``bvh_tris`` are box records: each leaf's first, the
    set-apart groups' union and each group's first."""
    nodes = ts.bvh_nodes.numpy()
    kids = nodes[:, 12:14].view(np.int32).reshape(-1)
    leaf = kids[(kids & tclusters.BVH_LEAF) != 0]
    mask = np.zeros((len(ts.bvh_tris),), bool)
    mask[(leaf & (tclusters.BVH_LEAF - 1)) >> 4] = True
    for sec in range(2):
        first, n = ts.bvh_apart[2 * sec:2 * sec + 2]
        mask[first:first + min(n, 1)] = True
        for _, _, g0, _ in tint._apart_groups(ts, sec):
            mask[g0 - 1] = True
    return mask


@pytest.mark.parametrize("case", CASES)
def test_bvh_well_formed(case, request):
    """Every row with a triangle in the tree is one leaf, reached once; its
    records are its row's box record (the row box the pack holds, and the
    count), then the row's triangles that can hit and are not set apart, in
    slot order, with their table-order numbers; its box holds each of
    them, bound by its vertices (a sliver's padded by
    ``clusters.mesh_pads``; every ray widens the boxes by its own bound); the
    triangles set apart follow in two sections, every ray's (the
    lat-long spheres' degenerate pole slivers) and a far ray's (the other
    slivers), in groups by row, each under its row's box record; every box a
    node holds is the exact union of its child's boxes; the depth is within
    the kernel's stack; the far bound is the padding's."""
    ts, _ = _scene(case, request)
    assert ts.tri_streamed and ts.tri_dma == case.startswith("dma")
    nodes = ts.bvh_nodes.numpy()
    kids = nodes[:, 12:14].view(np.int32)
    pack = ts.mtri_pack.numpy()
    lane = tclusters.ROW_BOUNDS_LANE
    recs = pack[:, :lane].reshape(len(pack), PER, tclusters.STREAM_FIELDS)
    rpc = tclusters.stream_rows_per_cluster(ts.stream_leaf)
    A, u, v = (x.astype(np.float64) for x in _stream_tris(ts))
    corners = np.stack([A, A + u, A + v])
    lo, hi = corners.min(0), corners.max(0)
    can_hit = recs[..., :12].any(axis=2) & (
        pack[:, lane] != np.float32(tclusters.ROW_EMPTY_FAR))[:, None]
    big = max(np.abs(lo[can_hit]).max(), np.abs(hi[can_hit]).max())
    m = tclusters.STATIC_PAD_ULPS * float(np.spacing(np.float32(big)))
    pads = np.zeros(can_hit.shape)
    apart, far_apart = (np.zeros(can_hit.shape, bool) for _ in range(2))
    pads[can_hit], apart[can_hit], far_apart[can_hit], far = \
        tclusters.mesh_pads(u[can_hit], v[can_hit], m, big)
    pads = np.where(far_apart, pads, 0.0)  # every ray widens the rest
    assert (ts.bvh_far, ts.bvh_wide) == (far["bvh_far"], far["bvh_wide"])
    assert 0 < ts.bvh_far < float("inf")
    tree = can_hit & ~apart
    tris = ts.bvh_tris.numpy()
    number = lambda row, j: (((row // rpc) * tclusters.UV_CFM_ROWS * 128
                              + (row % rpc) * PER) if ts.has_mesh_uvs
                             else row * PER) + j
    count = lambda r: int(np.asarray(r[3:4]).view(np.int32)[0])

    def box_record(i, row, cnt):
        np.testing.assert_array_equal(tris[i, 0:3], pack[row, lane:lane + 3])
        np.testing.assert_array_equal(tris[i, 4:7],
                                      pack[row, lane + 3:lane + 6])
        assert count(tris[i]) == cnt and not tris[i, 7:].any()

    seen, spans, depth = [], [], 0
    stack = [(0, 1)]
    while stack:
        node, level = stack.pop()
        depth = max(depth, level)
        for side in (0, 1):
            ref, box = int(kids[node, side]), nodes[node, 6 * side:6 * side + 6]
            if ref & tclusters.BVH_LEAF:
                first, cnt = (ref & (tclusters.BVH_LEAF - 1)) >> 4, ref & 15
                assert 1 <= cnt <= PER
                spans.append((first, 1 + cnt))
                # the leaf's row, from its first triangle's number
                k = ts.bvh_tri_k[first + 1:first + 2].long()
                row = int(tint._bvh_record_number(ts, k)) // PER
                j = np.nonzero(tree[row])[0]
                assert len(j) == cnt
                box_record(first, row, cnt)
                np.testing.assert_array_equal(tris[first + 1:first + 1 + cnt],
                                              recs[row, j, :12])
                np.testing.assert_array_equal(
                    ts.bvh_tri_k.numpy()[first + 1:first + 1 + cnt],
                    number(row, j))
                p = pads[row, j, None]
                assert (box[:3] <= lo[row, j] - p).all()
                assert (box[3:] >= hi[row, j] + p).all()
                seen.append(row)
            else:
                sub = nodes[ref]
                np.testing.assert_array_equal(
                    box, np.concatenate([np.minimum(sub[0:3], sub[6:9]),
                                         np.maximum(sub[3:6], sub[9:12])]))
                stack.append((ref, level + 1))
    full = np.nonzero(tree.any(axis=1))[0]
    assert sorted(seen) == full.tolist() and len(set(seen)) == len(seen)
    # the set-apart sections after the leaves: the degenerate slivers
    # (every ray's), then the other slivers (a far ray's), each its groups'
    # union, counting the records after it, then its groups by row
    a0, n_apart, f0, n_far = ts.bvh_apart
    assert (n_apart > 0) == (case in ("sphere19600", "dma1936")) \
        == bool(apart.any())
    for sec, (first, n, sel) in enumerate(((a0, n_apart, apart),
                                           (f0, n_far, far_apart))):
        groups = tint._apart_groups(ts, sec)
        rows = np.nonzero(sel.any(axis=1))[0]
        assert len(groups) == len(rows) and (n > 0) == bool(len(rows))
        for (mn, mx, g0, cnt), row in zip(groups, rows):
            j = np.nonzero(sel[row])[0]
            box_record(g0 - 1, row, len(j))
            np.testing.assert_array_equal(tris[g0:g0 + cnt],
                                          recs[row, j, :12])
            np.testing.assert_array_equal(ts.bvh_tri_k.numpy()[g0:g0 + cnt],
                                          number(row, j))
        if n:
            np.testing.assert_array_equal(
                tris[first, 0:3], np.min([g[0] for g in groups], axis=0))
            np.testing.assert_array_equal(
                tris[first, 4:7], np.max([g[1] for g in groups], axis=0))
            assert count(tris[first]) == n - 1
    # the leaves' records, then the groups', tile the record table
    spans.sort()
    assert [f for f, _ in spans] == np.cumsum([0] + [c for _, c in spans[:-1]]
                                              ).tolist()
    assert sum(c for _, c in spans) == a0
    assert a0 + n_apart == f0
    assert f0 + n_far == len(ts.bvh_tris) == len(ts.bvh_tri_k)
    assert depth == ts.bvh_depth <= tclusters.BVH_MAX_DEPTH
    root = np.asarray(ts.bvh_root, np.float32)
    np.testing.assert_array_equal(root, np.concatenate([
        np.minimum(nodes[0, 0:3], nodes[0, 6:9]),
        np.maximum(nodes[0, 3:6], nodes[0, 9:12])]))


@pytest.mark.parametrize("case", CASES)
def test_bvh_walk_equals_streamed_walk(case, request):
    """The near-first walk finds the table-order walk's winners, with
    bit-identical t, alpha and beta, and the same resolved hit and uv;
    it tests no more triangles than the table-order walk would at its
    final nearest hit, plus the boxes on the way."""
    ts, center = _scene(case, request)
    o, d = map(_flat, _aimed_rays(np.random.RandomState(5), 1024, center))
    best = tint._non_triangles(ts, o, d)
    t_ref, rec_ref = tint._stream_winners(ts, o, d, best.t)
    tally = {}
    t_bvh, win, a_bvh, b_bvh = tint._bvh_winners(ts, o, d, best.t, tally)
    number = ts.bvh_tri_k.long()[win.clamp_min(0)]
    rec = torch.where(win >= 0, tint._bvh_record_number(ts, number), -1)
    assert torch.equal(rec, rec_ref) and torch.equal(t_bvh, t_ref)
    found = rec_ref >= 0
    assert int(found.sum()) >= 300  # rays that hit the mesh
    w = rec_ref.clamp_min(0)
    pack = ts.mtri_pack[:, :tclusters.ROW_BOUNDS_LANE].reshape(
        -1, PER, tclusters.STREAM_FIELDS)
    _, _, t_rec, _, a_ref, b_ref = tint._record_tests(
        pack[w // PER, w % PER], o, d)
    assert torch.equal(t_rec[found], t_bvh[found])
    assert torch.equal(a_ref[found], a_bvh[found])
    assert torch.equal(b_ref[found], b_bvh[found])
    uv = ts.has_mesh_uvs
    ref_out = tint._intersect_triangles_streamed(ts, o, d, best, uv)
    out = tint._intersect_triangles_bvh(ts, o, d, best, uv)
    assert torch.equal(out[0].t, ref_out[0].t)
    assert torch.equal(out[0].mat, ref_out[0].mat)
    for a, b in [*zip(out[0].normal, ref_out[0].normal), *zip(out[1:],
                                                                ref_out[1:])]:
        assert torch.equal(a, b)
    # the walk's tests, counted per ray: one root box, two per node
    assert tally["boxes"] >= o.x.numel() and tally["tris"] > 0


@pytest.mark.parametrize("case", ["w7", "dma1936", "dma1984uv"])
def test_bvh_walk_vs_jax_kernel_mode(case, request):
    """The near-first walk against JAX's streamed tier (kernel-mode, op by
    op) on the same numpy-seeded rays, under test_torch_mesh_tiers.py's
    gate: the winners (material and normal) on at least 99.9% of rays, t
    within 2e-5 relative, the uv of agreeing winners within 1e-3 texels."""
    ts, center = _scene(case, request)
    js, _ = _scene(case, request, jworlds)
    o, d = _aimed_rays(np.random.RandomState(11), 1024, center)
    uv = ts.has_mesh_uvs
    jout = _jax_kernel_mode(js, o, d, uv)
    to, td = _flat(o), _flat(d)
    tout = tint._intersect_triangles_bvh(ts, to, td,
                                         tint._non_triangles(ts, to, td), uv)
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


def _grid(z, n=24, s=0.25):
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


def _swapped(ts):
    """``ts`` with every node's two children swapped (boxes and
    references): where both children are entered at the same t, the walk
    now reaches the other one first."""
    nodes = ts.bvh_nodes.clone()
    nodes[:, 0:6], nodes[:, 6:12] = ts.bvh_nodes[:, 6:12], ts.bvh_nodes[:, 0:6]
    nodes[:, 12], nodes[:, 13] = ts.bvh_nodes[:, 13], ts.bvh_nodes[:, 12]
    return dataclasses.replace(ts, bvh_nodes=nodes)


@pytest.mark.parametrize("order", ["built", "swapped"])
@pytest.mark.parametrize("z", [1.0, 0.0], ids=["above", "on_the_ground"])
def test_tie_on_shared_edges(z, order):
    """Rays that meet the grid at t = 4 on shared edges (each cell's
    diagonal, the edge between neighbouring cells, a corner), along a
    dyadic direction, hit two or more triangles at exactly that t, often
    in different leaves whose boxes the ray also enters at exactly t = 4:
    the walk takes the lowest table-order number, as the table-order walk
    does, whichever leaf it reaches first (the BVH as built, and with
    every node's children swapped, so that the other leaf comes first). On
    the ground plane (z = 0) the plane's hit at the same t keeps its
    win."""
    ts, _ = mesh_scene(tworlds, _grid(z))
    assert ts.tri_streamed and ts.n_tris == 1152
    if order == "swapped":
        ts = _swapped(ts)
    s, pts = 0.25, []
    for x in np.arange(-2.75, 2.75, 0.5):
        for y in np.arange(-2.75, 2.75, 0.75):
            pts += [(x + s / 2, y + s / 2), (x + s, y + s / 2), (x + s, y + s)]
    pts = np.asarray(pts, np.float32)
    n = len(pts)
    step = np.float32([1 / 16, 1 / 32, -1.0])
    org = np.concatenate([pts, np.full((n, 1), z, np.float32)], 1) - 4 * step
    o = TVec3(*(torch.from_numpy(org[:, k].copy()) for k in range(3)))
    d = TVec3(*(torch.full((n,), float(v)) for v in step))
    best = tint._non_triangles(ts, o, d)
    t_ref, rec_ref = tint._stream_winners(ts, o, d, best.t)
    t_bvh, win, _, _ = tint._bvh_winners(ts, o, d, best.t)
    number = ts.bvh_tri_k.long()[win.clamp_min(0)]
    rec = torch.where(win >= 0, tint._bvh_record_number(ts, number), -1)
    assert torch.equal(rec, rec_ref) and torch.equal(t_bvh, t_ref)
    # every record, tested brute force: two or more tie at t = 5 - z
    recs = ts.mtri_pack[:, :tclusters.ROW_BOUNDS_LANE].reshape(
        -1, tclusters.STREAM_FIELDS)
    col = lambda v: TVec3(*(c[:, None] for c in v))
    _, _, t, hit, _, _ = tint._record_tests(recs, col(o), col(d))
    ties = hit & (t == 4.0)
    assert bool((ties.sum(1) >= 2).all())
    if z == 0.0:
        # the ground plane's hit at the same t keeps its win
        assert bool((best.t == 4.0).all()) and bool((rec == -1).all())
        return
    first = torch.where(ties, torch.arange(recs.shape[0]), 1 << 30).amin(1)
    assert torch.equal(rec, first)
    assert bool((t_bvh == 4.0).all())
