"""The sphere clusters' BVH (``clusters.build_sphere_bvh``) and the plain
version of the card's clustered sphere walk
(``ops/intersect.py::_sphere_bvh_winners``: the huge cluster in order, then
near-first over the BVH) on the CPU.

- The BVH on worlds 2 and 4: every sphere outside the huge cluster in
  exactly one leaf of at most ``SPHERE_LEAF`` records, each record the
  sphere's ``csph_*`` row, leaf boxes the exact float32 union of their
  spheres' boxes, each widened by ``SPHERE_PAD`` r and rounded outward, node boxes the exact unions of their
  children's, the depth within the kernel's stack; the converter derives
  the same tables from JAX's scene.
- The walk against the table-order walk ``_intersect_spheres_clustered``
  (the render's plain path): winners equal and t bit-equal; and against
  JAX's kernel-mode ``intersect_spheres`` at 2048 rays (run op by op):
  winners equal on every ray, t within rtol 2e-4. XLA:CPU compiles each
  cluster's tests as one ``lax.cond`` body whose fused multiply-adds round
  t differently in the last bits (tests/test_torch_clusters.py), and on
  rays that graze a sphere the square root of the small discriminant
  magnifies that: 1.6e-4 relative at most on these rays, the table-order
  walk's difference too, whose t the BVH walk equals bit for bit.
- Exact ties: copies of spheres at other cluster-order indices, and a
  small sphere whose top touches the huge ground sphere's at the same t.
  The least (t, index) must win with the BVH as built and with every
  node's children swapped, which reverses the visit order of the children
  a ray enters at the same entry: a strict-< walk keeps whichever copy it
  reaches first and fails.
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
from pathtracer_tpu_torch.scene import clusters as tclu
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_scene import jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W2, W4 = tschema.WORLD_BRDF_TEST, tschema.WORLD_RAYTRACING_ONE_WEEKEND


def _kids(nodes: torch.Tensor) -> np.ndarray:
    return nodes[:, 12:14].contiguous().view(torch.int32).numpy()


def _leaves(scene):
    """(first, count, box) of every leaf reached from the root, and the
    inner levels of the deepest path, checking every node's boxes on the
    way."""
    nodes = scene.sbvh_nodes.numpy()
    kids = _kids(scene.sbvh_nodes)
    sph = scene.sbvh_sph.numpy().astype(np.float64)
    pad = tclu.SPHERE_PAD * sph[:, 3:]
    lo = np.nextafter((sph[:, :3] - sph[:, 3:] - pad).astype(np.float32),
                      np.float32(-np.inf))
    hi = np.nextafter((sph[:, :3] + sph[:, 3:] + pad).astype(np.float32),
                      np.float32(np.inf))
    out, depth = [], [0]

    def box(ref, level):
        """The exact union box of the subtree ``ref``."""
        if ref & tclu.BVH_LEAF:
            first, cnt = (ref & (tclu.BVH_LEAF - 1)) >> 4, ref & 15
            assert 1 <= cnt <= tclu.SPHERE_LEAF
            b = np.concatenate([lo[first:first + cnt].min(0),
                                hi[first:first + cnt].max(0)])
            out.append((first, cnt, b))
            return b
        depth[0] = max(depth[0], level)
        got = [box(int(k), level + 1) for k in kids[ref]]
        for j in range(2):
            np.testing.assert_array_equal(nodes[ref, 6 * j:6 * j + 6], got[j])
        return np.concatenate([np.minimum(got[0][:3], got[1][:3]),
                               np.maximum(got[0][3:], got[1][3:])])

    root = box(0, 1)
    np.testing.assert_array_equal(np.float32(scene.sbvh_root), root)
    return out, depth[0]


@pytest.mark.parametrize("kind", [W2, W4], ids=["w2", "w4"])
def test_sphere_bvh_well_formed(kind):
    ts, _ = tworlds.finalize_world(kind, 16, 9)
    leaves, depth = _leaves(ts)
    assert depth == ts.sbvh_depth <= tclu.BVH_MAX_DEPTH
    # the leaves cover the records once, in order
    firsts = sorted((f, c) for f, c, _ in leaves)
    assert [f for f, _ in firsts] == list(np.cumsum([0] + [c for _, c in
                                                           firsts])[:-1])
    n = sum(c for _, c in firsts)
    assert n == len(ts.sbvh_idx) == len(ts.sbvh_sph)
    # every sphere outside the huge cluster, once, as its csph_* row
    rest = [i for off, cnt, mn, _ in ts.sph_clusters if mn is not None
            for i in range(off, off + cnt)]
    assert sorted(ts.sbvh_idx.tolist()) == rest
    huge = [c for c in ts.sph_clusters if c[2] is None]
    assert len(huge) == 1 and huge[0][0] == 0
    idx = ts.sbvh_idx.long()
    assert torch.equal(ts.sbvh_sph, torch.stack(
        [*(c[idx] for c in ts.csph_center), ts.csph_radius[idx]], 1))
    # the converter derives the same tables from JAX's scene
    js, _ = jworlds.finalize_world(kind, 16, 9)
    conv = jax_scene_to_port(js)
    for k in ("sbvh_nodes", "sbvh_sph", "sbvh_idx"):
        assert torch.equal(getattr(conv, k), getattr(ts, k)), k
    assert (conv.sbvh_root, conv.sbvh_depth) == (ts.sbvh_root, ts.sbvh_depth)


def _rays(rng, n, center, scale, aimed):
    """Origins in a cube about ``center``; half the rays aimed at random
    points of a box about it, the other half in random directions."""
    o = (rng.rand(n, 3) - 0.5) * scale + center
    d = rng.randn(n, 3)
    tgt = (rng.rand(n, 3) - 0.5) * aimed + center
    d[::2] = (tgt - o)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.T.astype(np.float32), d.T.astype(np.float32)


CASES = {"w2": (W2, (2.5, 2.5, 1.0), 12.0, (6.0, 6.0, 1.0)),
         "w4": (W4, (0.0, 0.0, 1.5), 24.0, (22.0, 22.0, 2.0))}


def _walks(ts, o, d):
    n = o.shape[1]
    O, D = TVec3(*map(torch.from_numpy, o)), TVec3(*map(torch.from_numpy, d))
    table = tint._intersect_spheres_clustered(ts, O, D, tint._miss(O))
    tally = {}
    t, win = tint._sphere_bvh_winners(ts, O, D,
                                      torch.full((n,), tschema.F32_MAX), tally)
    return table, t, win, tally


@pytest.mark.parametrize("case", list(CASES))
def test_bvh_walk_equals_table_walk(case):
    kind, center, scale, aimed = CASES[case]
    ts, _ = tworlds.finalize_world(kind, 16, 9)
    o, d = _rays(np.random.RandomState(3), 4096, np.asarray(center), scale,
                 np.asarray(aimed))
    table, t, win, tally = _walks(ts, o, d)
    found = win >= 0
    assert torch.equal(t, table.t)
    assert torch.equal(torch.where(found, ts.csph_mat[win.clamp_min(0)], 0),
                       table.mat)
    assert found.float().mean() > 0.2
    # the walk culls: far fewer sphere tests than the table's spheres
    assert tally["spheres"] / len(t) < 0.2 * len(ts.sbvh_idx)


@pytest.mark.parametrize("case", list(CASES))
def test_bvh_walk_vs_jax_kernel_mode(case):
    kind, center, scale, aimed = CASES[case]
    js, _ = jworlds.finalize_world(kind, 16, 9)
    ts, _ = tworlds.finalize_world(kind, 16, 9)
    o, d = _rays(np.random.RandomState(9), 2048, np.asarray(center), scale,
                 np.asarray(aimed))
    n = o.shape[1]
    jbest = jint.Hit(jnp.full((n,), jint.F32_MAX), jnp.zeros((n,), jnp.int32),
                     JVec3(*(jnp.zeros((n,)),) * 3))
    jint._tracing_pallas_kernel = True
    try:
        jh = jint.intersect_spheres(js, JVec3(*map(jnp.asarray, o)),
                                    JVec3(*map(jnp.asarray, d)), jbest)
    finally:
        jint._tracing_pallas_kernel = False
    _, t, win, _ = _walks(ts, o, d)
    mat = torch.where(win >= 0, ts.csph_mat[win.clamp_min(0)], 0)
    np.testing.assert_array_equal(np.asarray(jh.mat), mat.numpy())
    np.testing.assert_allclose(np.asarray(jh.t), t.numpy(), rtol=2e-4)
    assert (mat.numpy() != 0).mean() > 0.2


def _tie_scene():
    """A huge ground sphere (r = 1000, top at z = 0), a small sphere inside
    it whose top touches the ground's at the origin, 90 small spheres on a
    grid (clusters), and copies of 12 of them in other materials (other
    cluster-order indices). Returns the scene, the copied spheres' centres
    and radii, and the touching sphere's material."""
    b = tschema.WorldBuilder()
    b.add_material(emit=(0.2, 0.3, 0.4))
    b.add_sphere((0.0, 0.0, -1000.0), 1000.0, b.add_material(albedo=(0.5,) * 3))
    touch = b.add_material(albedo=(0.1, 0.9, 0.1))
    b.add_sphere((0.0, 0.0, -0.5), 0.5, touch)
    grid = [((x - 4.5) * 2.0, (y - 4.0) * 2.0, 0.75)
            for x in range(10) for y in range(9)]
    for i, c in enumerate(grid):
        b.add_sphere(c, 0.25 + 0.02 * (i % 5), b.add_material(albedo=(0.7,) * 3))
    copied = list(range(0, 90, 8))
    for i in copied:
        c, r, _ = b.spheres[2 + i]
        b.add_sphere(c, r, b.add_material(albedo=(0.9, 0.1, 0.1)))
    scene = b.finalize(view_origin=(0.0, -12.0, 6.0))
    return scene, [b.spheres[2 + i][:2] for i in copied], touch


def _swapped(scene):
    """The same BVH with every node's children swapped."""
    nodes = scene.sbvh_nodes.clone()
    nodes[:, 0:6], nodes[:, 6:12] = scene.sbvh_nodes[:, 6:12], \
        scene.sbvh_nodes[:, 0:6]
    nodes[:, 12], nodes[:, 13] = scene.sbvh_nodes[:, 13], \
        scene.sbvh_nodes[:, 12]
    return dataclasses.replace(scene, sbvh_nodes=nodes)


@pytest.mark.parametrize("order", ["built", "swapped"])
def test_exact_ties_take_the_lower_index(order):
    scene, copied, touch = _tie_scene()
    assert len(scene.sph_clusters) > 2 and scene.sph_clusters[0][2] is None
    if order == "swapped":
        scene = _swapped(scene)
    # straight down onto each copied sphere's top, from a few heights and
    # offsets within its disc, and onto the touching sphere's top at z = 0
    # (both t = 2 exactly: 1002^2 and 2.5^2 round exactly)
    o, d = [], []
    for (cx, cy, cz), r in copied:
        for dx, dy, h in ((0.0, 0.0, 2.0), (0.25, 0.0, 3.0),
                          (0.0, -0.125, 5.0), (-0.125, 0.25, 1.5)):
            o.append((cx + dx * r, cy + dy * r, cz + r + h))
            d.append((0.0, 0.0, -1.0))
    o.append((0.0, 0.0, 2.0))
    d.append((0.0, 0.0, -1.0))
    o, d = np.asarray(o, np.float32).T, np.asarray(d, np.float32).T
    table, t, win, _ = _walks(scene, o, d)
    assert torch.equal(t, table.t)
    # every copied ray ties two spheres: the lower index (the first of the
    # copies in cluster order) wins, as in the table-order walk
    O, D = TVec3(*map(torch.from_numpy, o)), TVec3(*map(torch.from_numpy, d))
    t_all, hit, _ = tint._sphere_t(
        TVec3(*(c[:, None] for c in O)), TVec3(*(c[:, None] for c in D)),
        TVec3(*(c[None] for c in scene.csph_center)), scene.csph_radius[None])
    ties = hit & (t_all == t[:, None])
    assert (ties.sum(1) == 2).all()
    first = torch.where(ties, torch.arange(ties.shape[1]),
                        ties.shape[1]).amin(1)
    assert torch.equal(win, first)
    assert torch.equal(scene.csph_mat[win], table.mat)
    # the touching sphere ties the huge ground, whose index is lower
    assert float(t[-1]) == 2.0 and int(win[-1]) == 0
    assert int(table.mat[-1]) != touch
