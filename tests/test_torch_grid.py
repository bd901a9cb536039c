"""The uniform grid and its walk against the JAX package, on the CPU.

- Binning (``scene/accel.py``): twins of ``tests/test_accel.py``'s
  ``TestBinning`` cases, and ``build_uniform_grid``'s CSR arrays equal,
  element for element, to JAX's on a 784-triangle sphere and on 300
  random triangles of every size (JAX bins through its native library or
  its loop over the triangles; the port's binning is vectorised).
- The walk (``ops/traverse.py::intersect_triangles_grid``) on 512 rays at
  a builder mesh inside the grid, rays from inside and outside the grid
  (test_accel.py's distribution, whose mesh needs the absent
  ``mario.glb``): hit or miss and material equal to JAX's walk on every
  ray, t within rtol 1e-6 (JAX's jitted CPU code contracts multiply-adds
  into FMAs), and bit-equal to the port's sweep (K4t's, chunked).
- ``finalize_world(use_grid=True)``: a world without a mesh keeps no grid,
  and a mesh outside the world volume raises in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jintersect
from pathtracer_tpu.ops import traverse as jtraverse
from pathtracer_tpu.scene import accel as jaccel
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tintersect
from pathtracer_tpu_torch.ops import traverse as ttraverse
from pathtracer_tpu_torch.scene import accel as taccel
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3
from test_torch_meshes import W5, mesh_builder, tessellated_sphere
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

F32_MAX = tschema.F32_MAX


def test_voxel_coords_reference_convention():
    """floor(p / sep) + half (win32_main.cpp:1266-1268): -2.5 maps to 0."""
    half = taccel.GRID_RES >> 1
    pts = np.array([[0.0, 0.0, 0.0], [-2.5, -2.5, -2.5],
                    [2.4999, 2.4999, 2.4999]], np.float32)
    c = taccel.voxel_coords(pts)
    assert (c[0] == half).all() and (c[1] == 0).all()
    assert (c[2] == taccel.GRID_RES - 1).all()
    np.testing.assert_array_equal(c, jaccel.voxel_coords(pts))


def test_single_triangle_span():
    """A triangle spanning two cells in x is binned into both."""
    tri = np.array([[[0.01, 0.01, 0.01], [taccel.CELL_SIZE * 1.5, 0.01, 0.01],
                     [0.01, 0.02, 0.01]]], np.float32)
    start, count, refs, res = taccel.build_uniform_grid(tri)
    assert res == taccel.GRID_RES and int(count.sum()) == 2
    assert (refs[:2] == 0).all() and refs.dtype == torch.int32


def test_out_of_bounds_raises():
    tri = np.array([[[0, 0, 0], [3.0, 0, 0], [0, 1, 0]]], np.float32)
    with pytest.raises(ValueError, match="out of the world bounds"):
        taccel.build_uniform_grid(tri)


def _random_triangles(n, seed=3):
    """``n`` triangles inside [-2.4, 2.4]^3, from specks to ones spanning
    half the world, some sharing a cell list with many others."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-2.4, 2.4, (n, 1, 3))
    size = 10.0 ** rng.uniform(-3, 0.3, (n, 1, 1))
    bc = a + size * rng.uniform(-1, 1, (n, 2, 3))
    return np.clip(np.concatenate([a, bc], axis=1), -2.4, 2.4).astype(
        np.float32)


@pytest.mark.parametrize("case", ["sphere784", "random300"])
def test_grid_equals_jax(case):
    tris = (tessellated_sphere(800) if case == "sphere784"
            else _random_triangles(300))
    jg = jaccel.build_uniform_grid(tris)
    tg = taccel.build_uniform_grid(tris)
    assert tg[3] == jg[3] == taccel.GRID_RES
    for a, b in zip(jg[:3], tg[:3]):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _grid_scenes():
    tris = tessellated_sphere(800)
    jb, cp = mesh_builder(jworlds, tris)
    tb, _ = mesh_builder(tworlds, tris)
    js = jb.finalize(world_kind=W5, grid=jaccel.build_uniform_grid(tris),
                     view_origin=cp.pos)
    ts = tb.finalize(world_kind=W5, grid=taccel.build_uniform_grid(tris),
                     view_origin=cp.pos)
    return js, ts


def _rays(n=512, seed=0):
    """test_accel.py's rays at a mesh inside [-1, 1]^2 x [0, 2]: origins
    in [-6, 6]^2 x [-1, 4] (most outside the grid), aimed at its box with
    jitter, so that many hit and many miss."""
    rng = np.random.RandomState(seed)
    o = np.stack([rng.uniform(-6, 6, n), rng.uniform(-6, 6, n),
                  rng.uniform(-1, 4, n)]).astype(np.float32)
    target = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-1.0, 1.0, n),
                       rng.uniform(0.0, 2.0, n)]).astype(np.float32)
    d = target - o + 0.5 * rng.randn(3, n).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)
    return o, d


def test_dda_vs_jax_and_sweep():
    js, ts = _grid_scenes()
    assert ts.grid_res == js.grid_res == taccel.GRID_RES and ts.off_kernel
    o, d = _rays()
    n = o.shape[1]
    jo, jd = JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d))
    init = jintersect.Hit(jnp.full((n,), F32_MAX), jnp.zeros((n,), jnp.int32),
                          JVec3(*(jnp.zeros((n,)),) * 3))
    jh = jax.jit(lambda o, d, b: jtraverse.intersect_triangles_grid(
        js, o, d, b))(jo, jd, init)
    to, td = (Vec3(*map(torch.from_numpy, x)) for x in (o, d))
    ttraverse.STEPS = ttraverse.WALKS = 0
    th = ttraverse.intersect_triangles_grid(ts, to, td, tintersect._miss(to))
    assert ttraverse.WALKS == 1 and ttraverse.STEPS > 64
    jt, tt = np.asarray(jh.t), th.t.numpy()
    hit = jt < F32_MAX
    np.testing.assert_array_equal(hit, tt < F32_MAX)
    assert 50 < hit.sum() < n - 50
    np.testing.assert_array_equal(np.asarray(jh.mat), th.mat.numpy())
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-6)
    jn = np.stack([np.asarray(c) for c in jh.normal])
    tn = np.stack([c.numpy() for c in th.normal])
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-6)
    # the port's sweep, and the same cut into chunks of 100 triangles
    sw = tintersect._intersect_triangles_brute(
        ts, to, td, tintersect._miss(to), want_uv=False)[0]
    sw_small = tintersect._resolve_brute(ts, tintersect._miss(to), *(
        tintersect._brute_sweep_winners(ts, to, td, tintersect._miss(to).t,
                                        pairs=100 * n)), False)[0]
    for s in (sw, sw_small):
        np.testing.assert_array_equal(s.t.numpy(), tt)
        np.testing.assert_array_equal(s.mat.numpy(), th.mat.numpy())
        for a, b in zip(s.normal, th.normal):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # intersect_scene walks the grid after the plane
    full = tintersect.intersect_scene(ts, to, td)
    first = tintersect._non_triangles(ts, to, td)
    assert (first.mat != 0).any()
    walked = ttraverse.intersect_triangles_grid(ts, to, td, first)
    for a, b in ((full.t, walked.t), (full.mat, walked.mat)):
        assert torch.equal(a, b)


def test_finalize_world_use_grid():
    """World 3 has no mesh, so no grid; world 7's UV sphere reaches z =
    2.8, beyond the grid, and both packages raise the reference's error."""
    ts, _ = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8,
                                   use_grid=True)
    assert ts.grid_res == 0 and ts.grid_tris.shape == (1,)
    for mod in (jworlds, tworlds):
        with pytest.raises(ValueError, match="out of the world bounds"):
            mod.finalize_world(tschema.WORLD_MESH_UV, 8, 8, use_grid=True)
