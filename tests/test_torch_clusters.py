"""Sphere clusters of the port (scene/clusters.py, the cluster walk in
ops/intersect.py) against the JAX package's.

The builder must give the JAX permutation and float32 bounds bit for bit.
The clustered walk is held against JAX's ``intersect_spheres`` in kernel
mode (``_tracing_pallas_kernel``), which takes ``_intersect_clustered_idx``
and, on 1-D ray batches, ``_windowed_lut``'s plain gather
(intersect.py:973-975). Winners (material) must be equal and t within
rtol 2e-5 / atol 1e-4, the tolerance of tests/test_clusters.py: XLA on the
CPU compiles each cluster's tests as one ``lax.cond`` body whose fused
multiply-adds round t differently in the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.scene import clusters as jclu
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.scene.schema import WorldBuilder as JWorldBuilder
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.scene import clusters as tclu
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)


def _random_spheres(huge, n=150, seed=2):
    """tests/test_clusters.py's 150-sphere set, with or without the huge
    r=1000 outlier: (centers, radii) as float32, as the builders keep them."""
    rng = np.random.RandomState(seed)
    c, r = [], []
    for _ in range(n):
        rng.rand(3)  # the albedo draw of the JAX test's builder
        c.append((rng.rand(3) - 0.5) * 20.0)
        r.append(0.1 + rng.rand() * 0.5)
    if huge:
        c.append((0.0, 0.0, -1000.0))
        r.append(1000.0)
    return np.asarray(c, np.float32), np.asarray(r, np.float32)


def _world_spheres(kind):
    b, cam = tworlds.build_world(kind)
    c = np.asarray([s[0] for s in b.spheres], np.float32)
    r = np.asarray([s[1] for s in b.spheres], np.float32)
    return c, r, cam.pos


CASES = {
    "w2": lambda: _world_spheres(tschema.WORLD_BRDF_TEST),
    "w4": lambda: _world_spheres(tschema.WORLD_RAYTRACING_ONE_WEEKEND),
    "random_huge": lambda: (*_random_spheres(True), None),
    "random_no_huge": lambda: (*_random_spheres(False), None),
    "random_huge_sorted": lambda: (*_random_spheres(True), (0.0, -30.0, 5.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_clusters_bit_equal(case):
    centers, radii, origin = CASES[case]()
    jb = jclu.sphere_bounds(centers, radii)
    tb = tclu.sphere_bounds(centers, radii)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)
    jorder, jcl = jclu.build_clusters(*jb, sort_origin=origin)
    torder, tcl = tclu.build_clusters(*tb, sort_origin=origin)
    np.testing.assert_array_equal(jorder, torder)
    assert jcl == tcl
    assert len(tcl) > 1
    assert (tcl[0][2] is None) == (case not in ("random_no_huge",))


@pytest.mark.parametrize("kind, n_clusters", [
    (tschema.WORLD_BRDF_TEST, 3), (tschema.WORLD_RAYTRACING_ONE_WEEKEND, 9)])
def test_world_cluster_tables(kind, n_clusters):
    """finalize's cluster descriptors and the kernel tables derived from
    them, and the cluster-ordered sphere rows, for worlds 2 and 4."""
    js, _ = jworlds.finalize_world(kind, 16, 9)
    ts, _ = tworlds.finalize_world(kind, 16, 9)
    assert ts.sph_clusters == js.sph_clusters
    assert len(ts.sph_clusters) == n_clusters
    for name in ("csph_radius", "csph_mat"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy())
    assert ts.csph_radius.shape[0] % 128 == 0
    off, cnt, huge = (t.tolist() for t in (ts.cl_offset, ts.cl_count,
                                           ts.cl_huge))
    assert off == [c[0] for c in ts.sph_clusters]
    assert cnt == [c[1] for c in ts.sph_clusters]
    assert huge == [int(c[2] is None) for c in ts.sph_clusters]
    assert sum(cnt) == ts.n_spheres
    for k, c in enumerate(ts.sph_clusters):
        if c[2] is not None:
            assert tuple(float(v[k]) for v in ts.cl_min) == c[2]
            assert tuple(float(v[k]) for v in ts.cl_max) == c[3]


def _rays(rng, n=512, scale=30.0, center=(0.0, 0.0, 0.0)):
    o = np.stack([(rng.rand(n) - 0.5) * scale + c for c in center])
    d = rng.randn(3, n)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_ray_slab_entry_bit_equal():
    rng = np.random.RandomState(7)
    o, d = _rays(rng, scale=8.0)
    d[0, :16] = 0.0  # axis-parallel rays take the 1e-30 reciprocal
    mn, mx = (-2.5, -1.0, 0.25), (3.0, 4.5, 1.75)
    jt, jh = jint.ray_slab_entry(JVec3(*map(jnp.asarray, o)),
                                 JVec3(*map(jnp.asarray, d)), mn, mx)
    tt, th = tint.ray_slab_entry(TVec3(*map(torch.from_numpy, o)),
                                 TVec3(*map(torch.from_numpy, d)), mn, mx)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(jh), th.numpy())
    assert 0.05 < th.numpy().mean() < 0.95


def _random_scenes(huge):
    """The same 150-sphere scene through both packages' builders."""
    rng = np.random.RandomState(2)
    jb, tb = JWorldBuilder(), tschema.WorldBuilder()
    for b in (jb, tb):
        b.add_material(emit=(0.1, 0.2, 0.3))
    for _ in range(150):
        alb, c, r = tuple(rng.rand(3)), tuple((rng.rand(3) - 0.5) * 20.0), \
            0.1 + rng.rand() * 0.5
        for b in (jb, tb):
            b.add_sphere(c, r, b.add_material(albedo=alb))
    if huge:
        for b in (jb, tb):
            b.add_sphere((0.0, 0.0, -1000.0), 1000.0,
                         b.add_material(albedo=(0.5, 0.5, 0.5)))
    return jb.finalize(), tb.finalize(), rng


def _scenes(case):
    if case == "w4":
        kind = tschema.WORLD_RAYTRACING_ONE_WEEKEND
        js, _ = jworlds.finalize_world(kind, 16, 9)
        ts, _ = tworlds.finalize_world(kind, 16, 9)
        rng = np.random.RandomState(4)
        return js, ts, _rays(rng, scale=24.0, center=(0.0, 0.0, 1.5))
    js, ts, rng = _random_scenes(case == "huge")
    return js, ts, _rays(rng)


@pytest.mark.parametrize("case", ["huge", "no_huge", "w4"])
def test_clustered_intersect_matches_jax_kernel(case):
    js, ts, (o, d) = _scenes(case)
    assert len(ts.sph_clusters) > 1 and ts.sph_clusters == js.sph_clusters
    n = o.shape[1]
    jbest = jint.Hit(jnp.full((n,), jint.F32_MAX), jnp.zeros((n,), jnp.int32),
                     JVec3(*(jnp.zeros((n,)),) * 3))
    jint._tracing_pallas_kernel = True
    try:
        jh = jint.intersect_spheres(js, JVec3(*map(jnp.asarray, o)),
                                    JVec3(*map(jnp.asarray, d)), jbest)
    finally:
        jint._tracing_pallas_kernel = False
    z = torch.zeros(n)
    tbest = tint.Hit(torch.full((n,), tschema.F32_MAX),
                     torch.zeros(n, dtype=torch.int32), TVec3(z, z, z))
    th = tint.intersect_spheres(ts, TVec3(*map(torch.from_numpy, o)),
                                TVec3(*map(torch.from_numpy, d)), tbest)
    np.testing.assert_array_equal(np.asarray(jh.mat), th.mat.numpy())
    np.testing.assert_allclose(np.asarray(jh.t), th.t.numpy(),
                               rtol=2e-5, atol=1e-4)
    # normal = normalize(d*t + (o - c)): on the r=1000 ground sphere the
    # last-bit t differences above move it by up to ~1e-3
    for a, b in zip(jh.normal, th.normal):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=2e-3)
    assert (th.mat.numpy() != 0).mean() > 0.03  # the rays do hit spheres


def test_clustered_equals_brute_walk():
    """Within the port: the cluster walk finds the brute sweep's winners
    (material and t) on world 4."""
    kind = tschema.WORLD_RAYTRACING_ONE_WEEKEND
    ts, _ = tworlds.finalize_world(kind, 16, 9)
    brute = ts.without_clusters()
    o, d = _rays(np.random.RandomState(5), scale=24.0, center=(0, 0, 1.5))
    o, d = TVec3(*map(torch.from_numpy, o)), TVec3(*map(torch.from_numpy, d))
    a = tint.intersect_scene(ts, o, d)
    b = tint.intersect_scene(brute, o, d)
    assert torch.equal(a.mat, b.mat)
    assert torch.equal(a.t, b.t)
    for x, y in zip(a.normal, b.normal):
        assert torch.equal(x, y)
