"""K4t's BVH (``clusters.build_brute_bvh``) and the plain version of the
card's K4t walk (``ops/intersect.py::_brute_bvh_winners``: near-first over
a BVH of a brute mesh's precomputed 64-byte records) on the CPU.

- The records: each value (n_unit, d, w, A, u, v) bit-equal to the value
  the sweep's test ``ray_planar_triangle_uv`` forms per test, the port's
  and JAX's (run op by op), on the 40-triangle sphere, the everything
  scene's three UV triangles and a random 64-triangle mesh with slivers.
- The tree: every triangle that can hit in exactly one leaf of at most
  ``BRUTE_LEAF``, each record its table index's, leaf boxes that hold
  their triangles with the padding, node boxes the exact unions of their
  children's, the depth within the kernel's stack; a mesh of at most
  ``BRUTE_SWEEP_MAX`` (one and two triangles) gets no tree, its records
  in table order to be swept; the converter derives the same tables from
  JAX's scene as ``WorldBuilder.finalize`` makes.
- The walk against the sweep ``_brute_sweep_winners`` (the render's plain
  path) and against the same sweep over the records: winners, t, alpha and
  beta bit-equal, with the tree as built and with every node's children
  swapped, on one, two, 40 and 64 triangles and a mesh of duplicated
  triangles, on rays aimed at the mesh, rays that graze its triangles along
  and across their edges (from 2 and from 20 to 1000 units away: the
  padding's reach), rays at its vertices, and exact ties on the shared
  edges of a grid and its copy (the lower table index wins in any visit
  order; a plane at the same t keeps its hit). PyTorch's sqrt on the CPU
  is not correctly rounded (numpy's, JAX's and the card's sqrtf are): where
  it gives a triangle's |cross(u, v)| one ulp off, the port's CPU sweep
  differs from the records, and only on the rays that triangle decides.
- Without the padding the walk misses winners on those grazing rays.
- A 32x18 render (pp=1) of the 40-triangle sphere through the walk:
  bit-equal to the sweep's render and under the golden gates against JAX's
  XLA driver.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu.utils import vec as jvec
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import clusters as tclu
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.feature_scenes import FEATURE_CASES
from pathtracer_tpu_torch.utils import vec as tvec
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_mesh_tiers import _aimed_rays
from test_torch_meshes import lat_long_sphere, mesh_scene
from test_torch_render import assert_golden_gates
from test_torch_scene import jax_scene_to_port
from test_torch_static_bvh import _flat, _grazing_rays, _grid, _swapped
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)


def _random64(seed=3):
    """48 random triangles in a 2-unit box about (0, 0, 1) and 16 slivers
    (a third vertex 1e-3 to 1e-5 off the middle of the first two)."""
    rng = np.random.RandomState(seed)
    c = np.float32([0.0, 0.0, 1.0])
    a = c + rng.uniform(-1, 1, (48, 1, 3))
    tris = a + rng.uniform(-0.4, 0.4, (48, 3, 3))
    p, q = c + rng.uniform(-1, 1, (16, 3)), c + rng.uniform(-1, 1, (16, 3))
    off = rng.randn(16, 3) * rng.choice([1e-3, 1e-4, 1e-5], (16, 1))
    slivers = np.stack([p, q, (p + q) / 2 + off], 1)
    return np.concatenate([tris, slivers]).astype(np.float32)


def _everything_tris():
    """The everything scene's three UV triangles, as (3, 3, 3) vertices."""
    sc = FEATURE_CASES["everything"]()[0]
    n = sc.n_tris
    col = lambda v: np.stack([x.numpy()[:n] for x in v], 1)
    a, u, v = col(sc.tri_a), col(sc.tri_u), col(sc.tri_v)
    return np.stack([a, a + u, a + v], 1)


MESHES = {
    "one": lambda: lat_long_sphere(4, 5)[12:13],
    "two": lambda: lat_long_sphere(4, 5)[12:14],
    "tri40": lambda: lat_long_sphere(4, 5),
    "random64": _random64,
    # 32 triangles and a copy of each: every hit ties two at one t
    "dup64": lambda: np.concatenate([lat_long_sphere(4, 4)] * 2),
}


def _scene(case, module=tworlds):
    tris = MESHES[case]()
    ts, _ = mesh_scene(module, tris)
    return ts, tris


def _avu(tris):
    """The tables' A, u, v (float32, as finalize forms them)."""
    t = np.asarray(tris, np.float32)
    return t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]


@pytest.mark.parametrize("case", ["tri40", "everything", "random64"])
def test_records_bit_equal_to_the_sweep(case):
    tris = _everything_tris() if case == "everything" else MESHES[case]()
    A, u, v = _avu(tris)
    rec = tclu.brute_records(A, u, v)
    assert rec.shape == (len(A), tclu.BRUTE_REC_FLOATS)
    np.testing.assert_array_equal(rec[:, 8:11], A)
    np.testing.assert_array_equal(rec[:, 11:14], u)
    np.testing.assert_array_equal(rec[:, [14, 15, 7]], v)
    # the per-test values of ray_planar_triangle_uv / _planar_coords,
    # JAX's (op by op) and the port's; the port's n_unit and d only where
    # PyTorch's CPU sqrt gives |cross(u, v)| correctly rounded
    off = _cpu_sqrt_off(tris)
    assert len(off) == 0 or case == "random64"
    kept = np.setdiff1d(np.arange(len(A)), off)
    for mod, arr, back, rows in (
            (jvec, jnp.asarray, np.asarray, slice(None)),
            (tvec, torch.from_numpy, lambda x: x.numpy(), kept)):
        V = lambda x: mod.Vec3(*(arr(np.ascontiguousarray(x[:, k]))
                                 for k in range(3)))
        n = mod.cross(V(u), V(v))
        n_unit = mod.normalize(n, eps=1e-30)
        d_coef = mod.dot(V(A), n_unit)
        w = n * (1.0 / mod.dot(n, n))
        np.testing.assert_array_equal(rec[rows, 0:3], np.stack(
            [back(c) for c in n_unit], 1)[rows])
        np.testing.assert_array_equal(rec[rows, 3], back(d_coef)[rows])
        np.testing.assert_array_equal(rec[:, 4:7], np.stack(
            [back(c) for c in w], 1))


@pytest.mark.parametrize("case", list(MESHES))
def test_brute_bvh_well_formed(case):
    ts, tris = _scene(case)
    assert ts.tri_brute and ts.n_tris == len(tris)
    n = ts.n_tris
    A, u, v = _avu(tris)
    k = ts.bvh_tri_k.numpy()
    # each triangle's record once, with its table index, but a triangle
    # whose w is not finite (a degenerate one: the sweep never takes it)
    rec = tclu.brute_records(A, u, v)
    can_hit = np.isfinite(rec[:, 4:7]).all(1)
    assert sorted(k.tolist()) == np.nonzero(can_hit)[0].tolist()
    assert can_hit.all() == (case not in ("tri40", "dup64"))
    np.testing.assert_array_equal(ts.bvh_tris.numpy(), rec[k])
    n_swept = tint._bvh_huge(ts)
    if can_hit.sum() <= tclu.BRUTE_SWEEP_MAX:
        # no tree: the records in table order, swept in order
        assert n_swept == can_hit.sum() and ts.bvh_root == ()
        assert (np.diff(k) > 0).all() and ts.bvh_depth == 0
        return
    assert n_swept == 0
    a = A.astype(np.float64)
    corners = np.stack([a, a + u.astype(np.float64), a + v.astype(np.float64)])
    lo, hi = corners.min(0), corners.max(0)
    m = tclu.BRUTE_PAD_ULPS * np.spacing(np.float32(max(
        np.abs(lo[can_hit]).max(), np.abs(hi[can_hit]).max())))
    nodes = ts.bvh_nodes.numpy()
    kids = nodes[:, 12:14].copy().view(np.int32)
    spans, depth = [], [0]

    def box(ref, level):
        if ref & tclu.BVH_LEAF:
            first, cnt = (ref & (tclu.BVH_LEAF - 1)) >> 4, ref & 15
            assert cnt <= tclu.BRUTE_LEAF
            if cnt:
                spans.append((first, cnt))
            return None
        depth[0] = max(depth[0], level)
        got = []
        for j in range(2):
            b = nodes[ref, 6 * j:6 * j + 6]
            sub = box(int(kids[ref, j]), level + 1)
            if sub is None and int(kids[ref, j]) & 15:
                # a leaf: it holds its triangles, padded
                first, cnt = spans[-1]
                sel = k[first:first + cnt]
                mn, mx = lo[sel].min(0), hi[sel].max(0)
                assert (b[:3] <= mn - m).all() and (b[3:] >= mx + m).all()
                assert (b[:3] >= mn - 2 * m).all() and (b[3:] <= mx + 2 * m).all()
            elif sub is None:  # a one-leaf tree's empty second child
                assert np.isnan(b).all()
            else:  # an inner node: the exact union of its children's
                np.testing.assert_array_equal(b, sub)
            got.append(b)
        return np.concatenate([np.fmin(got[0][:3], got[1][:3]),
                               np.fmax(got[0][3:], got[1][3:])])

    root = box(0, 1)
    np.testing.assert_array_equal(np.float32(ts.bvh_root), root)
    assert depth[0] == ts.bvh_depth <= tclu.BRUTE_MAX_DEPTH
    spans.sort()
    assert [f for f, _ in spans] == np.cumsum(
        [0] + [c for _, c in spans[:-1]]).tolist()
    assert sum(c for _, c in spans) == len(k)
    # the converter derives the same tables from JAX's scene
    conv = jax_scene_to_port(_scene(case, jworlds)[0])
    for f in ("bvh_nodes", "bvh_tris", "bvh_tri_k"):  # bits: NaN boxes
        assert torch.equal(_bits(getattr(conv, f)), _bits(getattr(ts, f))), f
    assert np.array_equal(conv.bvh_root, ts.bvh_root, equal_nan=True)
    assert conv.bvh_depth == ts.bvh_depth


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _record_sweep(ts, o, d, t0):
    """The sweep over the BVH's records in table order (_brute_tests, the
    strict-< carry): (t, index, alpha, beta)."""
    order = torch.argsort(ts.bvh_tri_k.long())
    t_run, win, a_win, b_win = tint._winner_state(t0)
    for r in order.tolist():
        i = int(ts.bvh_tri_k[r])
        t, hit, alpha, beta = tint._brute_tests(ts.bvh_tris[r], o, d)
        take = hit & (t < t_run)
        t_run = torch.where(take, t, t_run)
        win = torch.where(take, i, win)
        a_win = torch.where(take, alpha, a_win)
        b_win = torch.where(take, beta, b_win)
    return t_run, win, a_win, b_win


def _both(ts, o, d):
    """The port's sweep's, the record sweep's and the walk's winners (t,
    index, alpha, beta) after the scene's spheres, quads and planes, and
    the walk's tally."""
    t0 = tint._non_triangles(ts, o, d).t
    tally = {}
    return (tint._brute_sweep_winners(ts, o, d, t0),
            _record_sweep(ts, o, d, t0),
            tint._brute_bvh_winners(ts, o, d, t0, tally), tally)


def _cpu_sqrt_off(tris) -> np.ndarray:
    """The triangles whose |cross(u, v)| PyTorch's CPU sqrt gives other
    than the correctly rounded value (numpy's, as the records hold)."""
    A, u, v = _avu(tris)
    n2 = tclu._dot32(*[tclu._cross32(u, v)] * 2)
    return np.nonzero(torch.sqrt(torch.from_numpy(n2)).numpy()
                      != np.sqrt(n2))[0]


@pytest.mark.parametrize("order", ["built", "swapped"])
@pytest.mark.parametrize("case", list(MESHES))
def test_walk_equals_sweep(case, order):
    ts, tris = _scene(case)
    if order == "swapped":
        ts = _swapped(ts)
    rng = np.random.RandomState(7)
    ao, ad = _aimed_rays(rng, 1024, (0.0, 0.0, 1.0))
    go, gd = _grazing_rays(rng, tris, 2048)
    # the same grazing rays from 20 to 1000 units further back
    fo = go - gd * np.float32(rng.choice([20.0, 200.0, 1000.0], go.shape[1]))
    o = _flat(np.concatenate([ao.reshape(3, -1), go, fo], 1))
    d = _flat(np.concatenate([ad.reshape(3, -1), gd, gd], 1))
    sweep, records, walk, tally = _both(ts, o, d)
    for a, b in zip(records, walk):
        assert torch.equal(a, b)
    off = torch.from_numpy(_cpu_sqrt_off(tris))
    same = torch.ones_like(sweep[1], dtype=torch.bool)
    for a, b in zip(sweep, walk):
        same &= a == b
    # the port's CPU sweep: the same where no triangle PyTorch's sqrt gives
    # one ulp off won either
    decided = torch.isin(sweep[1], off) | torch.isin(walk[1], off)
    assert bool((same | decided).all())
    assert bool(same.all()) or case == "random64"
    found = walk[1] >= 0
    assert int(found.sum()) >= (200 if len(tris) > 2 else 20)
    if len(tris) >= 40:
        # the walk culls: a few triangle tests per ray
        assert tally["tris"] / o.x.numel() < 0.4 * ts.n_tris
    if case == "dup64":
        # every winner is the first of its pair
        assert bool((walk[1][found] < 32).all())


@pytest.mark.parametrize("order", ["built", "swapped"])
@pytest.mark.parametrize("z", [1.0, 0.0], ids=["above", "on_the_ground"])
def test_tie_on_shared_edges(z, order):
    """Rays that meet a 4 x 4 grid and its copy (64 triangles) at t = 4 on
    shared edges (each cell's diagonal, the edge between neighbouring
    cells, a corner), along a dyadic direction, hit four or more triangles
    at exactly that t, often in different leaves: the walk takes the lowest
    table index, as the sweep does, whichever leaf it reaches first; on the
    ground plane (z = 0) the plane's hit at the same t keeps its win."""
    tris = np.concatenate([_grid(z, n=4)] * 2)
    ts, _ = mesh_scene(tworlds, tris)
    assert ts.tri_brute and ts.n_tris == 64
    if order == "swapped":
        ts = _swapped(ts)
    s, pts = 0.25, []
    for x in (-0.5, -0.25, 0.0, 0.25):
        for y in (-0.5, -0.25, 0.0, 0.25):
            pts += [(x + s / 2, y + s / 2), (x + s, y + s / 2), (x + s, y + s)]
    pts = np.asarray(pts, np.float32)
    n = len(pts)
    step = np.float32([1 / 16, 1 / 32, -1.0])
    org = np.concatenate([pts, np.full((n, 1), z, np.float32)], 1) - 4 * step
    o = TVec3(*(torch.from_numpy(org[:, k].copy()) for k in range(3)))
    d = TVec3(*(torch.full((n,), float(v)) for v in step))
    sweep, records, walk, _ = _both(ts, o, d)
    for a, b, c in zip(sweep, records, walk):
        assert torch.equal(a, c) and torch.equal(b, c)
    recs = ts.bvh_tris[torch.argsort(ts.bvh_tri_k.long())]
    col = lambda v: TVec3(*(c[:, None] for c in v))
    t_all, hit, _, _ = tint._brute_tests(recs, col(o), col(d))
    ties = hit & (t_all == 4.0)
    assert bool((ties.sum(1) >= 2).all()) and (ties.sum(1) >= 4).sum() > n / 2
    if z == 0.0:
        assert bool((walk[0] == 4.0).all()) and bool((walk[1] == -1).all())
        return
    first = torch.where(ties, torch.arange(64), 1 << 30).amin(1)
    assert torch.equal(walk[1], first) and bool((walk[0] == 4.0).all())


def test_render_vs_xla(monkeypatch):
    """A 32x18 render (pp=1, 4 samples) of the 40-triangle sphere on world
    5's ground whose K4t takes the card's walk: bit-equal to the port's
    sweep render, and under the golden gates against JAX's XLA wavefront
    renderer."""
    tris = MESHES["tri40"]()
    js, jcam = mesh_scene(jworlds, tris, None, 32, 18)
    ts, tcam = mesh_scene(tworlds, tris, None, 32, 18)
    assert cuda_backend.variant(ts, tcam) == "feature_pinhole_k4t"
    cfg = trenderer.RenderConfig(32, 18, pp=1, seed=0)
    plain = lambda: cuda_backend.render_chunk_plain(
        ts, tcam, cfg, 0, 0, 4, trenderer.init_accum(32 * 18))
    sweep = plain()
    monkeypatch.setattr(tint, "_intersect_triangles_brute",
                        tint._intersect_triangles_brute_bvh)
    walk = plain()
    for a, b in [*zip(walk.sum, sweep.sum), (walk.count, sweep.count)]:
        assert torch.equal(a, b)
    assert int(walk.rays_cast) == int(sweep.rays_cast)
    # JAX's XLA driver with its chunked sweep (``_UNROLL_MAX`` lowered, as
    # tests/test_torch_mixed_bases.py does): the same tests in a loop,
    # which XLA compiles 5x faster than the 40 triangles unrolled
    monkeypatch.setattr(jint, "_UNROLL_MAX", 16)
    monkeypatch.setattr(jintegrator, "_SELECT_LOOKUP_MAX", 16)
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(32, 18, pp=1, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(32 * 18))
    assert_golden_gates(jst, walk)


def test_uv_walk_resolves_as_the_sweep():
    """The everything scene (three UV triangles among spheres and quads):
    the walk's resolved hit and uv equal the sweep's on aimed rays."""
    ts = FEATURE_CASES["everything"]()[0]
    assert ts.tri_brute and ts.has_mesh_uvs
    rng = np.random.RandomState(9)
    tris = _everything_tris()
    c = tris.reshape(-1, 3).mean(0)
    o, d = _aimed_rays(rng, 1024, tuple(float(x) for x in c))
    go, gd = _grazing_rays(rng, tris, 1024)
    o = _flat(np.concatenate([o.reshape(3, -1), go], 1))
    d = _flat(np.concatenate([d.reshape(3, -1), gd], 1))
    best = tint._non_triangles(ts, o, d)
    ref = tint._intersect_triangles_brute(ts, o, d, best, True)
    out = tint._intersect_triangles_brute_bvh(ts, o, d, best, True)
    assert int(ref[3].sum()) >= 100
    assert torch.equal(out[0].t, ref[0].t)
    assert torch.equal(out[0].mat, ref[0].mat)
    for x, y in [*zip(out[0].normal, ref[0].normal), *zip(out[1:], ref[1:])]:
        assert torch.equal(x, y)


def test_probe_on_the_cpu_is_the_plain_sweep():
    """``cuda_backend.intersect_probe_cuda`` on CPU rays runs its plain
    version (the sweep), which the card's walk equals: t, material and
    normal of the 40-triangle sphere's hits on grazing and vertex rays."""
    ts, tris = _scene("tri40")
    o, d = _grazing_rays(np.random.RandomState(4), tris, 1024)
    rays = torch.from_numpy(np.concatenate([o, d]).T.copy())
    t, mat, n, uvx, uvy, ok = cuda_backend.intersect_probe_cuda(ts, rays)
    fo, fd = _flat(o), _flat(d)
    best = tint._non_triangles(ts, fo, fd)
    walk = tint._intersect_triangles_brute_bvh(ts, fo, fd, best, False)[0]
    assert int((t < best.t).sum()) >= 500
    assert torch.equal(t, walk.t) and torch.equal(mat, walk.mat)
    assert torch.equal(n, torch.stack(list(walk.normal), 1))
    assert not bool(ok.any()) and not bool(uvx.any() or uvy.any())


def test_unpadded_boxes_cull_winners(monkeypatch):
    """The grazing rays reach the leaves' faces: built without the padding
    (``BRUTE_PAD_ULPS`` 0) and every ray walked through the boxes as they
    are (without a padding, the far bound widens every ray's boxes), the
    walk misses winners the sweep takes on them, which the padded boxes
    keep (test_walk_equals_sweep)."""
    monkeypatch.setattr(tclu, "BRUTE_PAD_ULPS", 0)
    ts, tris = _scene("tri40")
    assert ts.bvh_far < 0
    ts = dataclasses.replace(ts, bvh_far=float("inf"))
    rng = np.random.RandomState(7)
    go, gd = _grazing_rays(rng, tris, 4096)
    o, d = _flat(go), _flat(gd)
    _, records, walk, _ = _both(ts, o, d)
    assert int((records[1] != walk[1]).sum()) > 0
