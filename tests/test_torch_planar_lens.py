"""K10's planar table and fetch and K1's thin-lens aperture point, as the
CUDA kernel forms them, against the JAX package on the CPU.

- The planar table (``schema.planar_tables``): through the kernel's
  addressing (``ops/texture.py::planar_word``) every texel of every layer
  is its word of the flat stack, each layer at its own size (16x16, 8x8,
  24x40, 3x7, 1x1 and a 512x512 map cut to 500x300); the converter's
  table of JAX's scene equals the builder's.
- The wraps: ``schema.udivmod32`` and ``ops/texture.py::wrap_recip`` (the
  kernel's ``udivmod`` and ``wrap_mod``) equal ``//`` and ``%`` for every
  divisor 1..4096 at 0, 1, n - 1, n, n + 1, 2^31 - 1, 2^32 - 1 and random
  values.
- The fetch: ``planar_sample`` and ``planar_maps`` (one address for the
  maps of one size) bit-equal to the port's and JAX's ``bespoke_sample``
  at random world xy, negative, above 1e9 and NaN.
- The lens: the kernel's ray indices from pp's reciprocal, its disk index
  and its points (the immediates of ``disk_point``, read from the kernel
  source) equal JAX's select sweep (``raygen.py:141-146``) for samples
  0..12*pp at pp 1, 2, 4 and 12; the host-folded ``lens_t0`` equals the
  plain version's per-lane lens_d - n . pos.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import texture as jtexture
from pathtracer_tpu.render import raygen as jraygen
from pathtracer_tpu.scene.schema import WorldBuilder as JWorldBuilder
from pathtracer_tpu_torch.ops import texture as ttexture
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render.raygen import focal_plane
from pathtracer_tpu_torch.render.renderer import RenderConfig, init_accum
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import splat
from test_torch_scene import jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

# (h, w): the sizes held, then two more 16x16 layers for the ground
SIZES = ((16, 16), (8, 8), (40, 24), (7, 3), (1, 1), (300, 500), (16, 16),
         (16, 16))


def _planar_builder(cls):
    """A ground plane whose material has planar metalness, roughness and
    albedo maps of one size (16x16) and a wall plane whose three are of
    three sizes, under a sphere light."""
    b = cls()
    rng = np.random.RandomState(5)
    idx = [b.add_texture((np.round(rng.rand(h, w, 3) * 255.0) / 255.0)
                         .astype(np.float32)) for h, w in SIZES]
    light = b.add_material(emit=(4.0, 4.0, 4.0))
    b.add_sphere((0.0, 0.0, 5.0), 1.0, light)
    ground = b.add_material(albedo=(0.5, 0.5, 0.5), albedo_idx=idx[0],
                            metalness_idx=idx[6], roughness_idx=idx[7])
    wall = b.add_material(albedo=(0.5, 0.5, 0.5), albedo_idx=idx[5],
                          metalness_idx=idx[3], roughness_idx=idx[4])
    b.add_plane((0.0, 0.0, 1.0), 0.0, ground)
    b.add_plane((0.0, -1.0, 0.0), -10.0, wall)
    return b


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene) of :func:`_planar_builder`."""
    return (_planar_builder(JWorldBuilder).finalize(),
            _planar_builder(tschema.WorldBuilder).finalize())


@pytest.mark.parametrize("layer", range(len(SIZES)))
def test_planar_table_words(scenes, layer):
    _, ts = scenes
    assert ts.planar_maps
    h, w = SIZES[layer]
    meta = ts.planar_meta[layer].tolist()
    assert meta[1:4] == [-(-w // 8), w, h]
    recips = np.asarray(meta[4:6], np.int32).view(np.uint32).tolist()
    assert recips == [tschema.planar_recip(w), tschema.planar_recip(h)]
    assert np.asarray(meta[6:8], np.int32).view(np.float32).tolist() == [w, h]
    y, x = (torch.from_numpy(a.reshape(-1).astype(np.int64))
            for a in np.mgrid[0:h, 0:w])
    word = meta[0] * 64 + ttexture.planar_word(meta[1], y, x)
    flat = (layer * ts.tex_hmax + y) * ts.tex_wmax + x
    assert torch.equal(ts.planar_tile[word], ts.tex_packed[flat])
    # each layer's tiles follow the last one's: no layer is padded
    assert meta[0] == sum(-(-hh // 8) * -(-ww // 8) for hh, ww in SIZES[:layer])


def test_planar_table_from_jax(scenes):
    js, ts = scenes
    conv = jax_scene_to_port(js)
    for k in ("planar_tile", "planar_meta", "tex_packed", "tex_w", "tex_h"):
        assert torch.equal(getattr(conv, k), getattr(ts, k)), k


def _dividends(n: np.ndarray) -> np.ndarray:
    """(len(n), 15) uint64 dividends: 0, 1, n - 1, n, n + 1, 2^31 - 1,
    2^32 - 1 and eight random uint32 values per divisor."""
    rng = np.random.RandomState(11)
    fixed = np.stack([np.zeros_like(n), np.ones_like(n), n - 1, n, n + 1,
                      np.full_like(n, 2 ** 31 - 1), np.full_like(n, 2 ** 32 - 1)], 1)
    return np.concatenate([fixed, rng.randint(0, 2 ** 32, (len(n), 8),
                                              dtype=np.uint64)], 1)


@pytest.mark.parametrize("form", ["udivmod", "wrap"])
def test_reciprocal_division_exact(form):
    n = np.arange(1, 4097, dtype=np.uint64)
    x = _dividends(n)
    if form == "udivmod":
        m = np.asarray([tschema.recip32(int(k)) for k in n], np.uint64)
        q, r = tschema.udivmod32(x, n[:, None], m[:, None])
        np.testing.assert_array_equal(q, x // n[:, None])
        np.testing.assert_array_equal(r, x % n[:, None])
    else:
        m = np.asarray([tschema.planar_recip(int(k)) for k in n], np.int64)
        got = ttexture.wrap_recip(torch.from_numpy(x.astype(np.int64)),
                                  torch.from_numpy(n.astype(np.int64))[:, None],
                                  torch.from_numpy(m)[:, None])
        np.testing.assert_array_equal(got.numpy(), x % n[:, None])
        assert ((m == 0) == ((n & (n - 1)) == 0)).all()


def _world_xy(n, seed):
    rng = np.random.RandomState(seed)
    x = ((rng.rand(n) - 0.5) * 60.0).astype(np.float32)
    x[: n // 8] *= 1e7                                   # some above 1e9
    x[n // 8: n // 4] = -np.abs(x[n // 8: n // 4])       # negative
    x[-6:] = [np.nan, 2e9, -2e9, 3e38, -3e38, 0.0]
    return x


def test_planar_fetch_bit_equal(scenes):
    js, ts = scenes
    n = 2048
    layer = np.random.RandomState(3).randint(0, len(SIZES), n).astype(np.int32)
    x, y = _world_xy(n, 1), _world_xy(n, 2)[::-1].copy()
    tl, tx, ty = (torch.from_numpy(a) for a in (layer, x, y))
    want = jtexture.bespoke_sample(js, jnp.asarray(layer), jnp.asarray(x),
                                   jnp.asarray(y))
    for got in (ttexture.planar_sample(ts, tl, tx, ty),
                ttexture.bespoke_sample(ts, tl, tx, ty)):
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_planar_maps_share_address(scenes):
    """The kernel's planar_maps (metalness, roughness, albedo): the
    ground's three maps of one size take one address, the wall's three of
    three sizes three, a lane without maps none; every texel bit-equal to
    JAX's bespoke_sample."""
    js, ts = scenes
    n = 1024
    x, y = _world_xy(n, 4), _world_xy(n, 5)
    wall = np.arange(n) % 3 == 1
    none = np.arange(n) % 3 == 2
    maps = []
    for g, w_ in ((6, 3), (7, 4), (0, 5)):
        layer = np.where(wall, w_, g).astype(np.int32)
        layer[none] = -1
        maps.append(layer)
    got, computed = ttexture.planar_maps(
        ts, [torch.from_numpy(m) for m in maps], torch.from_numpy(x),
        torch.from_numpy(y))
    np.testing.assert_array_equal(computed.numpy(),
                                  np.where(none, 0, np.where(wall, 3, 1)))
    for layer, tex in zip(maps, got):
        want = jtexture.bespoke_sample(js, jnp.asarray(np.maximum(layer, 0)),
                                       jnp.asarray(x), jnp.asarray(y))
        for a, b in zip(want, tex):
            np.testing.assert_array_equal(
                np.where(layer >= 0, np.asarray(a), 0.0), b.numpy())


def _kernel_disk() -> np.ndarray:
    """The (12, 2) float32 points of the kernel's disk_point, read from
    its source."""
    src = cuda_backend.SOURCE.read_text()
    body = src[src.index("float2 disk_point("):]
    body = body[:body.index("return make_float2")]
    pts = re.findall(r"take\((\d+), F\(([-0-9.]+)\), F\(([-0-9.]+)\)\);", body)
    assert [int(k) for k, _, _ in pts] == list(range(12))
    return np.asarray([(float(a), float(b)) for _, a, b in pts], np.float32)


@pytest.mark.parametrize("pp", [1, 2, 4, 12])
def test_lens_disk_point(pp):
    s = np.arange(12 * pp + 1, dtype=np.uint64)
    q, r = tschema.udivmod32(s, pp, tschema.recip32(pp))
    np.testing.assert_array_equal(q, s // pp)
    np.testing.assert_array_equal(r, s % pp)
    di = ((r * q) % 12).astype(np.int64)
    got = _kernel_disk()[di]
    # JAX's select sweep over its table
    ri, ri2 = jnp.asarray(s // pp, jnp.int32), jnp.asarray(s % pp, jnp.int32)
    idx = (ri2 * ri) % jraygen.NUM_POISSON
    dx = jnp.zeros(idx.shape, jnp.float32)
    dy = jnp.zeros_like(dx)
    for k, (px, py) in enumerate(jraygen.POISSON_DISK):
        dx = jnp.where(idx == k, px, dx)
        dy = jnp.where(idx == k, py, dy)
    np.testing.assert_array_equal(got[:, 0], np.asarray(dx))
    np.testing.assert_array_equal(got[:, 1], np.asarray(dy))
    np.testing.assert_array_equal(di, np.asarray(idx))


@pytest.mark.parametrize("kind", [tschema.WORLD_CORNELL_BOX,
                                  tschema.WORLD_RAYTRACING_ONE_WEEKEND])
def test_lens_t0_folded(kind):
    scene, cam = tworlds.finalize_world(kind, 8, 6, use_pinhole=False)
    cfg = RenderConfig(8, 6, pp=2)
    state = init_accum(48)
    px = torch.zeros(48, dtype=torch.int32)
    p = cuda_backend._params(scene, cam, cfg, 0, 0, 1, state, px, px.clone())
    n, d_coef = focal_plane(cam)
    pos = splat(cam.pos, torch.zeros(1))
    want = d_coef - (n[0] * pos.x + n[1] * pos.y + n[2] * pos.z)
    assert np.float32(p.lens_t0) == want.numpy()[0]
    assert p.pp_m == tschema.recip32(2)
