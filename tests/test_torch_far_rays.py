"""The card's BVH walks on rays from far away, on the CPU.

A walk's box tests keep every hit the plain version takes only while the
rounding of that hit stays inside the boxes' padding, and that rounding
grows with the ray's distance (``scene/clusters.py``, "A ray from far
away"). Each walk therefore sends a ray from beyond its scene's bound
(``Scene.bvh_far``, ``Scene.sbvh_far``) down an exact path: it walks
with every box widened by the ray's own error bound, and the static tier
tests its winner's cluster box whatever its key. Held here, with the plain replays of the
card's walks (``ops/intersect.py``), on grazing and aimed rays moved back
10^2 to 10^5 times the scene's scale:

- K4t (``_brute_bvh_winners``) on the 40-triangle lat-long sphere at scale
  1 and 0.01: winners, t, alpha and beta bit-equal to the sweep over the
  same records and to the sweep the render uses
  (``_brute_sweep_winners``); the bound derived from the padding in the
  table; the rays beyond it counted; and against JAX's
  ``intersect_triangles_brute`` run op by op.
- The static tier (``_static_bvh_winners``,
  ``_intersect_triangles_static_bvh``) on the 784- and 736-triangle
  spheres: winners, t, alpha and beta and the resolved hit and uv
  bit-equal to the table-order walk ``_intersect_triangles_clustered``;
  and on the 144-triangle sphere, whose degenerate pole slivers the walk
  tests after its tree (``clusters.mesh_pads``), from 10 to 10^4 times its
  largest coordinate.
- The sphere clusters (``_sphere_bvh_winners``) on worlds 2 and 4, rays
  aimed at their spheres from 10^2 to 10^4 units, and on 2-cm spheres
  spread over 60 units (a negative reach: every ray far), rays grazing
  them from near their centre: t and material bit-equal to the
  table-order walk ``_intersect_spheres_clustered``, and on world 4 to
  JAX's kernel-mode ``intersect_spheres`` run op by op.
- K7 (``_bvh_winners``) on world 7 and the 19,600-triangle sphere, rays
  aimed at the mesh from 10^2 to 10^4 units, and on the sphere rays
  grazing its triangles and rays at its degenerate pole triangles, from 2
  units and moved back 10^2 to 10^4 units: winners and t (and alpha and
  beta) bit-equal to the table-order streamed walk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.scene import clusters as tclu
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_brute_bvh import _record_sweep
from test_torch_mesh_tiers import _aimed_rays, _jax_kernel_mode
from test_torch_meshes import (
    lat_long_sphere, mesh_scene, tessellated_sphere, uv_sphere,
)
from test_torch_static_bvh import _flat, _grazing_rays

@pytest.fixture(autouse=True)
def _one_thread():
    """Each test on one thread of PyTorch's CPU pool: the replays are many
    small ops, which the pool's threads slow down when the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W2, W4 = tschema.WORLD_BRDF_TEST, tschema.WORLD_RAYTRACING_ONE_WEEKEND
W7 = tschema.WORLD_MESH_UV


def _back(o, d, dist):
    """The rays (o, d) ((3, n) float32) moved back along d by ``dist``."""
    return (o - d * np.float32(dist)).astype(np.float32), d


def _inf_norm(o) -> np.ndarray:
    return np.abs(o).max(axis=0)


# --- K4t --------------------------------------------------------------------

def _k4t(scale):
    tris = (lat_long_sphere(4, 5) * np.float32(scale)).astype(np.float32)
    ts, _ = mesh_scene(tworlds, tris)
    assert ts.tri_brute and ts.bvh_root
    return ts, tris, float(np.abs(tris).max())


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_k4t_bound_from_the_padding(scale):
    """The bound is far_bound of the leaves' padding: the padding over 16u
    less the largest coordinate's share, 16u (1 + 2k) B (k the triangles'
    largest shape, B the largest coordinate with the padding), rounded
    down to float32; for these well-shaped triangles, 120 to 256 times the
    mesh's largest coordinate (the padding is 2^11 ulps of it: 2^-13 to
    2^-12 of it, by where it falls in its binade)."""
    ts, tris, big = _k4t(scale)
    pad = tclu.BRUTE_PAD_ULPS * float(np.spacing(np.float32(big)))
    t = tris.astype(np.float64)
    e = np.sort(np.linalg.norm(np.stack([t[:, 1] - t[:, 0], t[:, 2] - t[:, 0],
                                         t[:, 2] - t[:, 1]], 1), axis=2), 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = e[:, 1] * e[:, 2] / np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1)
    k = k[np.isfinite(k) & (k <= tclu.SLIVER)].max()
    want = pad * 2.0 ** 20 - (1 + 2 * k) * (big + pad)
    assert np.float32(ts.bvh_far) == ts.bvh_far
    assert 0 <= want - ts.bvh_far < 1e-6 * want
    assert 120 * big < ts.bvh_far <= 256 * big


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_k4t_walk_equals_sweep(scale):
    ts, tris, big = _k4t(scale)
    rng = np.random.RandomState(11)
    go, gd = _grazing_rays(rng, tris, 2048)
    far = []
    for k in (1e2, 1e3, 1e4, 1e5):
        fo, fd = _back(go, gd, k * big)
        o, d = _flat(fo), _flat(fd)
        t0 = tint._non_triangles(ts, o, d).t
        tally = {}
        walk = tint._brute_bvh_winners(ts, o, d, t0, tally)
        for a, b in zip(_record_sweep(ts, o, d, t0), walk):
            assert torch.equal(a, b), k
        for a, b in zip(tint._brute_sweep_winners(ts, o, d, t0), walk):
            assert torch.equal(a, b), k
        assert int((walk[1] >= 0).sum()) >= 200
        far.append((tally.get("far_rays", 0), _inf_norm(fo)))
    # the rays the walk widened: those beyond the bound
    for n, o_inf in far:
        assert n == int((o_inf > ts.bvh_far).sum())


def test_k4t_vs_jax_op_by_op():
    """200 units from the 2-cm sphere (10^4 times its largest coordinate),
    256 grazing rays: JAX's sweep, op by op, and the walk take the same
    triangle at the same t."""
    ts, tris, big = _k4t(0.01)
    js, _ = mesh_scene(jworlds, tris)
    go, gd = _grazing_rays(np.random.RandomState(13), tris, 256)
    fo, fd = _back(go, gd, 1e4 * big)
    o, d = _flat(fo), _flat(fd)
    best = tint._non_triangles(ts, o, d)
    t, idx, _, _ = tint._brute_bvh_winners(ts, o, d, best.t)
    n = fo.shape[1]
    jbest = jint.Hit(jnp.asarray(best.t.numpy()),
                     jnp.asarray(best.mat.numpy()),
                     JVec3(*(jnp.zeros((n,)),) * 3))
    with jax.disable_jit():
        jh = jint.intersect_triangles_brute(js, JVec3(*map(jnp.asarray, fo)),
                                            JVec3(*map(jnp.asarray, fd)),
                                            jbest)
    found = (idx >= 0).numpy()
    mat = np.where(found, ts.tri_mat[idx.clamp_min(0)].numpy(),
                   best.mat.numpy())
    np.testing.assert_array_equal(np.asarray(jh.t), t.numpy())
    np.testing.assert_array_equal(np.asarray(jh.mat), mat)
    assert found.sum() >= 30


# --- the static tier -----------------------------------------------------------

@pytest.mark.parametrize("case", ["static784", "static736uv"])
def test_static_walk_equals_table_walk(case):
    tris, uvs = {"static784": lambda: (tessellated_sphere(800), None),
                 "static736uv": lambda: uv_sphere(16, 24)}[case]()
    ts, _ = mesh_scene(tworlds, tris, uvs)
    assert ts.tri_static
    big = float(np.abs(tris).max())
    uv = uvs is not None
    go, gd = _grazing_rays(np.random.RandomState(5), tris, 2048)
    far = []
    for k in (1e2, 1e3, 1e4):
        o, d = map(_flat, _back(go, gd, k * big))
        best = tint._non_triangles(ts, o, d)
        ref = tint._intersect_triangles_clustered(ts, o, d, best, uv)
        tally = {}
        t, idx, a, b = tint._static_bvh_winners(ts, o, d, best.t, tally)
        out = tint._intersect_triangles_static_bvh(ts, o, d, best, uv)
        found = ref[3]
        assert torch.equal(idx >= 0, found) and int(found.sum()) >= 200
        t_ref, _, a_ref, b_ref = tint._ctri_tests(ts, o, d, idx.clamp_min(0))
        assert torch.equal(t, ref[0].t)
        assert torch.equal(a[found], a_ref[found])
        assert torch.equal(b[found], b_ref[found])
        assert torch.equal(out[0].mat, ref[0].mat)
        for x, y in [*zip(out[0].normal, ref[0].normal),
                     *zip(out[1:], ref[1:])]:
            assert torch.equal(x, y)
        far.append(tally.get("far_rays", 0))
    # from 10^3 times on, every ray beyond the bound: its boxes widened
    assert far[1:] == [o.x.numel()] * 2
    assert 90 * big < ts.bvh_far < 200 * big


@pytest.mark.parametrize("times", [10, 100, 1000, 10000])
def test_static_walk_with_slivers(times):
    """The 144-triangle tessellated sphere, whose pole triangles are
    slivers (shape above clusters.SLIVER; the degenerate ones set apart,
    clusters.mesh_pads), grazing rays from 10 to 10^4 times its largest
    coordinate: the walk and the table-order walk take the same winner at
    the same t. Before the set-apart triangles were tested after the walk,
    1, 1, 4 and 2 of the 2048 rays differed: the table-order walk took a
    pole sliver whose hit lay outside its padded leaf box, which the walk
    culled."""
    tris = tessellated_sphere(144)
    ts, _ = mesh_scene(tworlds, tris)
    assert ts.tri_static and ts.bvh_apart[1] > 0
    big = float(np.abs(tris).max())
    go, gd = _grazing_rays(np.random.RandomState(5), tris, 2048)
    o, d = map(_flat, _back(go, gd, times * big))
    best = tint._non_triangles(ts, o, d)
    ref = tint._intersect_triangles_clustered(ts, o, d, best, False)
    tally = {}
    t, idx, _, _ = tint._static_bvh_winners(ts, o, d, best.t, tally)
    assert int(ref[3].sum()) >= 200
    assert torch.equal(idx >= 0, ref[3])
    assert torch.equal(t, ref[0].t)
    assert torch.equal(idx, tint._static_table_winners(ts, o, d, best.t)[1])


# --- the sphere clusters -------------------------------------------------------

SPHERES = {"w2": (W2, (2.5, 2.5, 1.0), (6.0, 6.0, 1.0)),
           "w4": (W4, (0.0, 0.0, 1.5), (22.0, 22.0, 2.0))}


def _sphere_rays(case, n, dist, seed=5):
    """Rays from ``dist`` units away aimed at random points of the case's
    box of spheres: (o, d) as (3, n) float32."""
    _, center, aimed = SPHERES[case]
    rng = np.random.RandomState(seed)
    tgt = (rng.rand(n, 3) - 0.5) * np.asarray(aimed) + np.asarray(center)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (tgt - d * dist).T.astype(np.float32), d.T.astype(np.float32)


@pytest.mark.parametrize("case", list(SPHERES))
def test_sphere_walk_equals_table_walk(case):
    ts, _ = tworlds.finalize_world(SPHERES[case][0], 16, 9)
    far = []
    for dist in (1e2, 1e3, 1e4):
        o, d = map(_flat, _sphere_rays(case, 2048, dist))
        table = tint._intersect_spheres_clustered(ts, o, d, tint._miss(o))
        tally = {}
        t, win = tint._sphere_bvh_winners(
            ts, o, d, torch.full((2048,), tschema.F32_MAX), tally)
        assert torch.equal(t, table.t)
        assert torch.equal(torch.where(win >= 0, ts.csph_mat[win.clamp_min(0)],
                                       0), table.mat)
        assert int((win >= ts.sph_clusters[0][1]).sum()) >= 20
        far.append(tally.get("far_rays", 0))
    assert far == [2048] * 3  # every ray beyond the reach
    # the reach: the least of each sphere's (clusters.sphere_far_reach)
    # less its distance from z
    zx, zy, zz, reach = ts.sbvh_far[:4]
    r = ts.sbvh_sph[:, 3].numpy().astype(np.float64)
    dz = np.linalg.norm(ts.sbvh_sph[:, :3].numpy() - np.float32([zx, zy, zz]),
                        axis=1)
    assert 0 < reach <= (tclu.sphere_far_reach(r) - dz).min()
    assert 50.0 < reach < 100.0


def _small_spheres(n=300, r=0.01, width=60.0, seed=3):
    """``n`` spheres of radius ``r`` spread over a ``width`` x ``width`` x 2
    slab about the origin, under a sky: their centres (n, 3) float64 and
    the scene. Most lie further from the spheres' centre z than their own
    reach (clusters.sphere_far_reach, about 362 r), so the BVH's reach R is
    negative."""
    rng = np.random.RandomState(seed)
    b = tschema.WorldBuilder()
    b.add_material(emit=(0.2, 0.3, 0.4))
    m = b.add_material(albedo=(0.7,) * 3)
    c = (rng.rand(n, 3) - 0.5) * np.asarray([width, width, 2.0])
    for x in c:
        b.add_sphere(tuple(float(v) for v in x), r, m)
    return c, b.finalize(view_origin=(0.0, 0.0, 0.0))


def test_small_spheres_spread_wide():
    """2-cm spheres spread over 60 units, rays from within 9 units of their
    centre z grazing spheres over 24 units from it (1 to 1.15 radii off
    their centres): R is negative, so every ray walks with its boxes
    widened, and the walk equals the table-order walk bit for bit. With R
    squared, a ray within |R| of z walked the padded boxes as they are and
    lost hits that the sphere test takes outside them."""
    c, ts = _small_spheres()
    zx, zy, zz, reach = ts.sbvh_far[:4]
    z = np.asarray([zx, zy, zz])
    assert reach < -30.0
    rng = np.random.RandomState(5)
    n = 4096
    aim = np.nonzero(np.linalg.norm(c - z, axis=1) > 24.0)[0]
    c = c[aim[rng.randint(0, len(aim), n)]]
    o = z + (rng.rand(n, 3) - 0.5) * np.asarray([18.0, 18.0, 2.0])
    to_c = (c - o) / np.linalg.norm(c - o, axis=1, keepdims=True)
    side = rng.randn(n, 3)
    side -= (side * to_c).sum(1, keepdims=True) * to_c
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    d = c + side * (0.01 * (1.0 + 0.15 * rng.rand(n, 1))) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = _flat(o.T.astype(np.float32)), _flat(d.T.astype(np.float32))
    table = tint._intersect_spheres_clustered(ts, o, d, tint._miss(o))
    tally = {}
    t, win = tint._sphere_bvh_winners(
        ts, o, d, torch.full((n,), tschema.F32_MAX), tally)
    assert tally["far_rays"] == n
    assert torch.equal(t, table.t)
    assert torch.equal(torch.where(win >= 0, ts.csph_mat[win.clamp_min(0)],
                                   0), table.mat)
    assert int((t < tschema.F32_MAX).sum()) >= 1000


def test_sphere_walk_vs_jax_op_by_op():
    """World 4 from 1000 units, 256 rays: JAX's kernel-mode clustered walk,
    op by op, and the walk take the same sphere, at t within 2e-6 relative
    (a few ulps: the square root of a grazing ray's small discriminant
    magnifies XLA's last-bit differences, tests/test_torch_sphere_bvh.py)."""
    kind = SPHERES["w4"][0]
    js, _ = jworlds.finalize_world(kind, 16, 9)
    ts, _ = tworlds.finalize_world(kind, 16, 9)
    o, d = _sphere_rays("w4", 256, 1e3, seed=9)
    n = o.shape[1]
    jbest = jint.Hit(jnp.full((n,), jint.F32_MAX), jnp.zeros((n,), jnp.int32),
                     JVec3(*(jnp.zeros((n,)),) * 3))
    jint._tracing_pallas_kernel = True
    try:
        with jax.disable_jit():
            jh = jint.intersect_spheres(js, JVec3(*map(jnp.asarray, o)),
                                        JVec3(*map(jnp.asarray, d)), jbest)
    finally:
        jint._tracing_pallas_kernel = False
    t, win = tint._sphere_bvh_winners(ts, _flat(o), _flat(d),
                                      torch.full((n,), tschema.F32_MAX))
    mat = torch.where(win >= 0, ts.csph_mat[win.clamp_min(0)], 0).numpy()
    np.testing.assert_array_equal(np.asarray(jh.mat), mat)
    np.testing.assert_allclose(np.asarray(jh.t), t.numpy(), rtol=2e-6)
    assert (mat != 0).mean() > 0.2


# --- K7 ----------------------------------------------------------------------

def _k7(case, module=tworlds):
    if case == "w7":
        return module.finalize_world(W7, 16, 9)[0], (0.0, 0.0, 1.0)
    return mesh_scene(module, tessellated_sphere(19600))[0], (0.0, 0.0, 1.2)


def _pole_rays(rng, tris, n):
    """Rays at the lat-long sphere's degenerate pole triangles (two
    vertices 1e-16 apart or equal), from random points 2 units off at
    their vertices: (o, d) as (3, n) arrays."""
    t = tris.astype(np.float64)
    area = np.linalg.norm(np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1)
    sel = rng.choice(np.nonzero(area <= 1e-9)[0], n)
    q = t[sel, rng.randint(0, 3, n)] + rng.randn(n, 3) * 1e-3
    o = q + rng.randn(n, 3) * 2.0
    d = q - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.T, d.T


@pytest.mark.parametrize("seed", [5, 7])
def test_k7_grazing_rays(seed):
    """K7's walk (``_bvh_winners``) on the 19,600-triangle sphere, rays
    grazing its triangles (test_torch_static_bvh.py's) and rays at its
    degenerate pole triangles (set apart, clusters.mesh_pads), from 2
    units and moved back 10^2 to 10^4 units: the winning record and t
    bit-equal to the streamed table-order walk (``_stream_winners``), and
    alpha and beta to the winner's record test. With the leaves JAX's row
    boxes unpadded and no row cull, 1 to 8 of these rays differed: hits a
    few ulps outside their row box, which the streamed walk tests where
    the ray enters the row's cluster, and hits in a row whose box the ray
    enters exactly at its nearest hit before the mesh, which the streamed
    walk culls."""
    tris = tessellated_sphere(19600)
    ts, _ = mesh_scene(tworlds, tris)
    assert ts.tri_streamed and ts.bvh_apart[1] > 0
    rng = np.random.RandomState(seed)
    go, gd = _grazing_rays(rng, tris, 2048)
    po, pd = _pole_rays(rng, tris, 256)
    go, gd = np.concatenate([go, po], 1), np.concatenate([gd, pd], 1)
    per, nf = tclu.STREAM_TRIS_PER_ROW, tclu.STREAM_FIELDS
    recs = ts.mtri_pack[:, :per * nf].reshape(-1, nf)
    for dist in (0.0, 1e2, 1e3, 1e4):
        o, d = map(_flat, _back(go.astype(np.float32), gd.astype(np.float32),
                                dist))
        best = tint._non_triangles(ts, o, d)
        t_ref, rec_ref = tint._stream_winners(ts, o, d, best.t)
        tally = {}
        t, win, a, b = tint._bvh_winners(ts, o, d, best.t, tally)
        number = ts.bvh_tri_k.long()[win.clamp_min(0)]
        rec = torch.where(win >= 0, tint._bvh_record_number(ts, number), -1)
        assert torch.equal(rec, rec_ref) and torch.equal(t, t_ref), dist
        found = rec_ref >= 0
        assert int(found.sum()) >= 700
        _, _, _, _, a_ref, b_ref = tint._record_tests(
            recs[rec_ref.clamp_min(0)], o, d)
        assert torch.equal(a[found], a_ref[found])
        assert torch.equal(b[found], b_ref[found])
        assert (tally.get("far_rays", 0) > 0) == (dist > ts.bvh_far)


@pytest.mark.parametrize("case", ["w7", "sphere19600"])
def test_k7_walk_equals_streamed_walk(case):
    ts, center = _k7(case)
    o, d = (a.reshape(3, -1) for a in _aimed_rays(np.random.RandomState(5),
                                                  1024, center))
    for dist in (1e2, 1e3, 1e4):
        fo, fd = map(_flat, _back(o, d, dist))
        best = tint._non_triangles(ts, fo, fd)
        t_ref, rec_ref = tint._stream_winners(ts, fo, fd, best.t)
        t, win, _, _ = tint._bvh_winners(ts, fo, fd, best.t)
        number = ts.bvh_tri_k.long()[win.clamp_min(0)]
        rec = torch.where(win >= 0, tint._bvh_record_number(ts, number), -1)
        assert torch.equal(rec, rec_ref) and torch.equal(t, t_ref)
        assert int((rec >= 0).sum()) >= 200
