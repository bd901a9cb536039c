"""finalize (ACES -> sRGB -> BGRA pack) and the BMP writer against the JAX
package. The packed bytes must agree exactly, except that ``pow`` differs
by an ulp between XLA and PyTorch, which may move a channel by one step on
fewer than 0.1% of channels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.io import bmp as jbmp
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.utils import color as jcolor
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.io import bmp as tbmp
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene.convert import accum_from_numpy
from pathtracer_tpu_torch.utils import color as tcolor
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W, H = 64, 48


def _channels(packed):
    p = np.asarray(packed).astype(np.uint32)
    return np.stack([(p >> s) & 0xFF for s in (24, 16, 8, 0)], -1).astype(np.int64)


@pytest.fixture(scope="module")
def accum():
    rs = np.random.RandomState(3)
    n = W * H
    # radiance spanning black, the sRGB knee, mid-tones and overexposure
    count = rs.randint(1, 9, size=n).astype(np.float32)
    mean = np.exp(rs.uniform(-9.0, 2.5, size=(3, n))).astype(np.float32)
    mean[:, : n // 16] = 0.0
    s = (mean * count).astype(np.float32)
    sq = (s * mean * 1.5).astype(np.float32)
    return dict(sum=s, sum_sq=sq, count=count, nan_count=np.float32(2.0),
                rays_cast=np.float32(12345.0), samples_done=np.int32(8))


def _jax_state(a):
    return jrenderer.AccumState(
        sum=JVec3(*map(jnp.asarray, a["sum"])),
        sum_sq=JVec3(*map(jnp.asarray, a["sum_sq"])),
        count=jnp.asarray(a["count"]), nan_count=jnp.asarray(a["nan_count"]),
        rays_cast=jnp.asarray(a["rays_cast"]),
        samples_done=jnp.asarray(a["samples_done"]))


@pytest.mark.parametrize("debug_kind", ["regular", "variance"])
def test_finalize_bytes(accum, debug_kind):
    jcfg = jrenderer.RenderConfig(W, H, debug_kind=debug_kind)
    tcfg = trenderer.RenderConfig(W, H, debug_kind=debug_kind)
    a = _channels(jrenderer.finalize(_jax_state(accum), jcfg))
    b = _channels(trenderer.finalize(accum_from_numpy(accum), tcfg))
    diff = np.abs(a - b)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


def test_resolve_equal(accum):
    cfg = trenderer.RenderConfig(W, H)
    np.testing.assert_array_equal(
        np.asarray(jrenderer.resolve(_jax_state(accum),
                                     jrenderer.RenderConfig(W, H))),
        trenderer.resolve(accum_from_numpy(accum), cfg).numpy())


def test_linear_to_srgb_and_tonemap():
    x = np.linspace(-0.5, 3.0, 20001, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(jcolor.linear_to_srgb(jnp.asarray(x))),
        tcolor.linear_to_srgb(torch.from_numpy(x)).numpy(), rtol=0, atol=3e-7)
    jt = jcolor.tonemap_aces(JVec3(*(jnp.asarray(x),) * 3))
    tt = tcolor.tonemap_aces(TVec3(*(torch.from_numpy(x),) * 3))
    np.testing.assert_array_equal(np.asarray(jt.x), tt.x.numpy())


def test_accum_from_numpy_counters(accum):
    st = accum_from_numpy(accum)
    assert st.rays_cast.dtype == torch.int64 and int(st.rays_cast) == 12345
    assert int(st.nan_count) == 2 and st.samples_done == 8


def test_write_bmp_byte_identical(tmp_path):
    rs = np.random.RandomState(11)
    packed = rs.randint(0, 2**32, size=(7, 13), dtype=np.uint64).astype(np.uint32)
    jbmp.write_bmp(str(tmp_path / "j.bmp"), packed)
    tbmp.write_bmp(str(tmp_path / "t.bmp"), torch.from_numpy(
        packed.astype(np.int64)))
    assert (tmp_path / "j.bmp").read_bytes() == (tmp_path / "t.bmp").read_bytes()
    np.testing.assert_array_equal(tbmp.read_bmp(str(tmp_path / "t.bmp")), packed)
