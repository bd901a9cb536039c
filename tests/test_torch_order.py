"""The K1 remainder's orders against the JAX package on the CPU: the lane
and sample orders ``render_chunk_pallas`` gives its ``pallas_call``
(pathtracer_tpu/render/pallas_backend.py:483-523), as the port's
yardsticks compute them (render/orders.py).

- The texel sort: ``orders.texel_sort_pixels`` equals JAX's
  ``_texel_sort`` permutation on world 1 (JAX on XLA, as
  tests/test_clusters.py:607-621 calls it), over the whole image and a
  shard's pixels, through both cameras.
- The 64-sample sub-chunks: ``orders.sub_chunks`` gives the launches
  JAX makes, observed by running ``render_chunk_pallas`` eagerly with its
  ``pallas_call`` replaced by a stand-in that records each launch's first
  sample and returns zeros, on worlds 1-4, 6 and 7 and a stack scene.
- The stack tiles: which scenes take them (JAX's ``use_stack`` on the brute
  feature variants) and ``orders.tile_pixels``, the 8x4 tiles' lane
  table, against the kernel's own tile map (``regroup.kernel_lanes``).
- Every order renders what the kernel's own order renders: the plain
  version's image does not depend on the lanes, and the wrapper on CPU
  tensors runs it whatever order its ``_order`` hook gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.render import pallas_backend as jpallas
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import feature_scenes as jfeatures
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.render import cuda_backend, orders
from pathtracer_tpu_torch.render import regroup
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import feature_scenes as tfeatures
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.camera import define_camera
from test_torch_scene import jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W1 = tschema.WORLD_DEFAULT
WORLDS = {"w1": W1, "w2": tschema.WORLD_BRDF_TEST,
          "w3": tschema.WORLD_CORNELL_BOX,
          "w4": tschema.WORLD_RAYTRACING_ONE_WEEKEND,
          "w6": tschema.WORLD_CORNELL_QUAD, "w7": tschema.WORLD_MESH_UV}


@pytest.mark.parametrize("pinhole", [True, False], ids=["pinhole", "lens"])
@pytest.mark.parametrize("lo, hi", [(0, 32 * 18), (100, 437)],
                         ids=["image", "shard"])
def test_texel_sort_equals_jax(pinhole, lo, hi):
    """The port's texel-sort order of world 1's pixels at 32x18 (a shard's
    pixels too: JAX sorts the shard's ``pixel_idx``) equals JAX's."""
    w, h = 32, 18
    js, jcam = jworlds.finalize_world(W1, w, h, use_pinhole=pinhole)
    ts, tcam = tworlds.finalize_world(W1, w, h, use_pinhole=pinhole)
    assert orders.sort_texels(ts)
    want = np.asarray(jax.jit(jpallas._texel_sort, static_argnums=(1, 2))(
        js, jcam, jrenderer.RenderConfig(w, h, pp=4, seed=0),
        jnp.arange(lo, hi, dtype=jnp.int32)))
    got = orders.texel_sort_pixels(
        ts, tcam, trenderer.RenderConfig(w, h, pp=4, seed=0),
        torch.arange(lo, hi, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want + lo)
    # the order moves the pixels: sorted by texel tile, not scanlines
    assert not np.array_equal(want, np.arange(hi - lo))
    # the replay's warp map is the same order
    lanes, _ = regroup.texel_sort_lanes(
        ts, tcam, trenderer.RenderConfig(w, h, pp=4, seed=0))
    if lo == 0:
        np.testing.assert_array_equal(lanes[got.long()].numpy(),
                                      np.arange(w * h))


def _jax_launches(js, jcam, n_samples, w=16, h=8):
    """The (first sample, samples) of each launch ``render_chunk_pallas``
    makes for ``n_samples``: run eagerly, each ``pallas_call`` replaced by
    a stand-in that records its first sample and returns zeros."""
    firsts = []

    def pallas_call(kernel, *, out_shape, **kw):
        def run(sk, ss0, *args):
            firsts.append(int(np.asarray(ss0).reshape(-1)[0]))
            return [jnp.zeros(o.shape, o.dtype) for o in out_shape]
        return run

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jpallas.pl, "pallas_call", pallas_call)
        jpallas.render_chunk_pallas(
            js, jcam, jrenderer.RenderConfig(w, h, pp=2, seed=0),
            jprng.base_key(0), jnp.int32(0), n_samples,
            jrenderer.init_accum(w * h), jnp.arange(w * h, dtype=jnp.int32))
    ends = firsts[1:] + [n_samples]
    return [(a, b - a) for a, b in zip(firsts, ends)]


@pytest.mark.parametrize("name", [*WORLDS, "bump"])
def test_sub_chunks_equal_jax(name):
    """``sub_chunks`` makes JAX's launches: 64 samples at most on sphere
    clusters (worlds 2 and 4), none split on the combined set (world 1),
    brute spheres and quads (worlds 3 and 6), a stack (world 7's mesh
    wears its checker through JAX's tiled stack; the bump scene)."""
    if name == "bump":
        js, (pos, target, fov), _ = jfeatures.FEATURE_CASES[name]()
        jcam = jdefine_camera(pos, target, fov, 16, 8)
        ts = tfeatures.FEATURE_CASES[name]()[0]
    else:
        js, jcam = jworlds.finalize_world(WORLDS[name], 16, 8)
        ts, _ = tworlds.finalize_world(WORLDS[name], 16, 8)
    assert jax_scene_to_port(js).tex_stack_tiled == ts.tex_stack_tiled
    for n in (150, 3):
        want = _jax_launches(js, jcam, n)
        assert orders.sub_chunks(ts, n) == want, (name, n, want)
    split = len(orders.sub_chunks(ts, 150)) > 1
    assert split == (name in ("w2", "w4")), name


@pytest.mark.parametrize("name, want", [
    ("bump", True), ("tbn", True), ("everything", True), ("fog", False),
    ("w1", False), ("w7", False), ("w3", False)])
def test_stack_tiles_scenes(name, want):
    """The brute feature variants of a scene with JAX's tiled stack take
    the square tiles; a scene without a stack keeps its scanlines (fog),
    as do the other bases (world 1's combined set is sorted instead, world
    7's mesh variants already walk on tiles)."""
    if name in tfeatures.FEATURE_CASES:
        ts = tfeatures.FEATURE_CASES[name]()[0]
    else:
        ts, _ = tworlds.finalize_world(WORLDS[name], 8, 8)
    assert orders.stack_tiles(ts) == want
    if want:
        assert orders.stacked(ts) and ts.featured


@pytest.mark.parametrize("w, h, lo, hi", [
    (64, 36, 0, 64 * 36), (60, 34, 0, 60 * 34), (60, 34, 130, 1001),
    (60, 34, 70, 110)])
def test_tile_pixels_are_the_kernel_tiles(w, h, lo, hi):
    """``tile_pixels`` puts each pixel of ``lo .. hi-1`` at the lane the
    kernel's 8x4 tile map gives it over the launch's tiles
    (``regroup.kernel_lanes``), once each, and -1 at the lanes of a tile
    outside the image or the range."""
    table = orders.tile_pixels(w, h, lo, hi, "cpu")
    tile_lo, n_tiles = cuda_backend.shard_tiles(w, h, lo, hi)
    assert table.dtype == torch.int32 and table.numel() == 32 * n_tiles
    held = table[table >= 0].long()
    assert sorted(held.tolist()) == list(range(lo, hi))
    lanes, _ = regroup.kernel_lanes(w, h, tiles=True)
    lane = torch.nonzero(table >= 0).flatten() + 32 * tile_lo
    assert torch.equal(lanes[held], lane)


@pytest.mark.parametrize("name, order", [
    ("w1", "texel_sort"), ("bump", "stack_tiles"), ("w2", "sub_chunks")])
def test_orders_render_the_same_image(name, order):
    """On CPU tensors the wrapper renders the plain version whatever order
    its ``_order`` hook gives (``orders.hook``): the same sums as with
    none (the card's launches are held bit-equal to each other by
    chip_smoke.py phase 3)."""
    if name == "bump":
        ts, (pos, target, fov), kw = tfeatures.FEATURE_CASES[name]()
        cam = define_camera(pos, target, fov, 8, 6)
    else:
        ts, cam = tworlds.finalize_world(WORLDS[name], 8, 6)
        kw = {}
    cfg = trenderer.RenderConfig(8, 6, pp=1, seed=0, **kw)
    assert orders.applies(order, ts)
    hooked = orders.hook(order, ts, cam, cfg, 2)
    assert (hooked[0] is None) == (order == "sub_chunks")
    runs = [cuda_backend.render_chunk_cuda(
        ts, cam, cfg, 0, 0, 2, trenderer.init_accum(8 * 6), _order=o)
        for o in (None, hooked)]
    a, b = runs
    assert all(torch.equal(x, y) for x, y in zip(
        (*a.sum, *a.sum_sq, a.count), (*b.sum, *b.sum_sq, b.count)))
    assert int(a.rays_cast) == int(b.rays_cast)
