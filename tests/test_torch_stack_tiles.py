"""K10's texel form and K11 on the planar table, as the CUDA kernel reads
them, against the flat stack and JAX on the CPU.

- The table: every scene with a texture set outside a combined set gets
  one (world 7's mesh-UV albedo map, the bump scene, the everything scene,
  planar maps), each layer's words the flat stack's through the kernel's
  addressing; a combined set keeps the dummies.
- K10's texel form (``ops/texture.py::planar_texel_sample``, the kernel's
  ``fetch_texel``) bit-equal to ``sample_texture`` (the plain version's
  fetch from the flat stack) on layers of 1x1, 7x3, 40x24, 500x300 and
  powers of two, at texel-space coordinates past the layer's size,
  negative, above 2^31 (saturation), infinite and NaN.
- K11 (``planar_height3``, the kernel's ``fetch_height3``: two column and
  two row wraps for the 12 corners) bit-equal to ``bespoke_height3`` and
  to JAX's ``bespoke_sample`` at the three points, on those layers and on
  the everything scene's and a UV mesh's stacks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import texture as jtexture
from pathtracer_tpu.scene.schema import WorldBuilder as JWorldBuilder
from pathtracer_tpu_torch.ops import texture as ttexture
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.feature_scenes import FEATURE_CASES
from test_torch_features import _coords, _stack_scenes
from test_torch_planar_lens import SIZES, _planar_builder


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test on one thread of PyTorch's CPU pool: the replays are many
    small ops, which the pool's threads slow down when the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table_scenes():
    return {
        "w7": tworlds.finalize_world(tschema.WORLD_MESH_UV, 16, 9)[0],
        "bump": FEATURE_CASES["bump"]()[0],
        "everything": FEATURE_CASES["everything"]()[0],
        "planar": _planar_builder(tschema.WorldBuilder).finalize(),
    }


@pytest.mark.parametrize("name", ["w7", "bump", "everything", "planar", "w1"])
def test_texel_table_for_every_stack(name):
    if name == "w1":
        ts = tworlds.finalize_world(tschema.WORLD_DEFAULT, 16, 9)[0]
        assert ts.tex_combined
        assert ts.planar_tile.numel() == 64 and not ts.planar_meta.any()
        return
    ts = _table_scenes()[name]
    assert ts.n_textures and not ts.tex_combined
    if name == "bump":
        assert ts.any_bump
    if name == "w7":
        assert ts.tex_mesh_only and ts.has_mesh_uvs
    assert len(ts.planar_meta) == ts.tex_w.numel()
    for layer, (w, h) in enumerate(zip(ts.tex_w.tolist(), ts.tex_h.tolist())):
        meta = ts.planar_meta[layer].tolist()
        assert meta[1:4] == [-(-w // 8), w, h]
        y, x = (torch.from_numpy(a.reshape(-1).astype(np.int64))
                for a in np.mgrid[0:h, 0:w])
        word = meta[0] * 64 + ttexture.planar_word(meta[1], y, x)
        flat = (layer * ts.tex_hmax + y) * ts.tex_wmax + x
        assert torch.equal(ts.planar_tile[word], ts.tex_packed[flat])


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits (NaN equal to NaN)."""
    return t.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def planar_pair():
    return (_planar_builder(JWorldBuilder).finalize(),
            _planar_builder(tschema.WorldBuilder).finalize())


def _texel_coords(n, seed, size):
    """Texel-space coordinates on a layer of ``size``: up to four times it,
    negative, above 2^31, infinite and NaN."""
    rng = np.random.RandomState(seed)
    c = ((rng.rand(n) - 0.25) * 4.0 * size).astype(np.float32)
    c[: n // 16] = rng.rand(n // 16).astype(np.float32) * 1e10   # saturate
    c[-8:] = [np.nan, np.inf, -np.inf, 3e38, -3e38, 0.0, size, size - 0.5]
    return c


@pytest.mark.parametrize("layer", range(len(SIZES)))
def test_texel_form_bit_equal(planar_pair, layer):
    _, ts = planar_pair
    h, w = SIZES[layer]
    n = 1024
    u, v = (torch.from_numpy(_texel_coords(n, s, z))
            for s, z in ((1, w), (2, h)))
    lay = torch.full((n,), layer, dtype=torch.int32)
    want = ttexture.sample_texture(ts, lay, u, v)
    got = ttexture.planar_texel_sample(ts, lay, u, v)
    for a, b in zip(want, got):
        assert torch.equal(_bits(a), _bits(b))


def test_height3_bit_equal_on_the_layer_sizes(planar_pair):
    js, ts = planar_pair
    n = 2048
    layer = np.random.RandomState(3).randint(0, len(SIZES), n).astype(np.int32)
    x, y = _coords(n, 5), _coords(n, 6)[::-1].copy()
    tl, tx, ty = (torch.from_numpy(a) for a in (layer, x, y))
    got = ttexture.planar_height3(ts, tl, tx, ty)
    for a, b in zip(ttexture.bespoke_height3(ts, tl, tx, ty), got):
        assert torch.equal(_bits(a), _bits(b))
    jl, jx, jy = jnp.asarray(layer), jnp.asarray(x), jnp.asarray(y)
    eps = jnp.float32(0.01)
    want = (jtexture.bespoke_sample(js, jl, jx, jy).x,
            jtexture.bespoke_sample(js, jl, jx + eps, jy).x,
            jtexture.bespoke_sample(js, jl, jx, jy + eps).x)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_height3_bit_equal_on_feature_stacks():
    """The everything scene's two 8x8 layers and a UV mesh's 16x16, as
    tests/test_torch_features.py holds ``bespoke_height3`` to JAX."""
    for js, ts in _stack_scenes():
        n = 512
        nl = int(ts.tex_w.numel())
        layer = np.random.RandomState(3).randint(0, nl, n).astype(np.int32)
        x, y = _coords(n, 1), _coords(n, 2)[::-1].copy()
        tl, tx, ty = (torch.from_numpy(a) for a in (layer, x, y))
        got = ttexture.planar_height3(ts, tl, tx, ty)
        jl, jx, jy = jnp.asarray(layer), jnp.asarray(x), jnp.asarray(y)
        eps = jnp.float32(0.01)
        want = (jtexture.bespoke_sample(js, jl, jx, jy).x,
                jtexture.bespoke_sample(js, jl, jx + eps, jy).x,
                jtexture.bespoke_sample(js, jl, jx, jy + eps).x)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
