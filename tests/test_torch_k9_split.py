"""K9 as the CUDA kernel reads it, split where the shade reads it
(``pathtracer_tpu_torch/ops/texture.py``: ``combined_at``, ``combined_words``,
``combined_channel``, ``combined_albedo``): the address step and the
per-channel blends bit-equal to the port's and JAX's XLA fetches and to
the words of JAX's windowed fetch run in interpret mode, on world 1's
512x512 set (level 0 and every pyramid level) and on its four maps cut to
48x40 (no power of two: no pyramid, the wraps by the sizes' reciprocals),
whose --mips renders level 0. Tolerance: none (bit-equal)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import texture as jtex
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.ops import texture as ttex
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render.renderer import RenderConfig, init_accum
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import textures as ttextures
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_textures import _jax_windowed_words
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W1 = tschema.WORLD_DEFAULT
RES = ttextures.REFERENCE_RES_DIR
CUT = (48, 40)


def _scenes(cut):
    """(JAX scene, port scene) of world 1, its maps cut to ``cut`` (w, h)
    where given."""
    if cut is None:
        return (jworlds.finalize_world(W1, 16, 9, res_dir=RES)[0],
                tworlds.finalize_world(W1, 16, 9, res_dir=RES)[0])
    out = []
    for worlds in (jworlds, tworlds):
        b, _ = worlds.build_world(W1, res_dir=RES)
        b.textures = [t[:cut[1], :cut[0]].copy() for t in b.textures]
        out.append(b.finalize(world_kind=W1))
    return tuple(out)


@pytest.fixture(scope="module", params=[None, CUT], ids=["512x512", "48x40"])
def scenes(request):
    return (request.param, *_scenes(request.param))


def _uv(n=8 * 128, lim=130.0, seed=11):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-lim, lim, n).astype(np.float32),
            rs.uniform(-lim, lim, n).astype(np.float32), rs)


def _channels(out):
    alb, met, rgh, nrm = out
    return [np.asarray(c) for c in (*alb, met, rgh, *nrm)]


def test_tables_and_wraps(scenes):
    """The cut set is combined without a pyramid and its tile table equals
    JAX's; the kernel's level-0 wrap constants are the sizes' reciprocals
    there and masks on the 512x512 set."""
    cut, js, ts = scenes
    np.testing.assert_array_equal(np.asarray(js.tex_tile), ts.tex_tile.numpy())
    assert ts.tex_combined and ts.tex_mip_meta == js.tex_mip_meta
    w, h = cut or (512, 512)
    assert (ts.tex_comb_w, ts.tex_comb_h) == (w, h)
    assert (ts.tex_mip_meta == ()) == (cut is not None)
    m = (tschema.planar_recip(w), tschema.planar_recip(h))
    assert (m == (0, 0)) == (cut is None)
    for n, mn in zip((w, h), m):
        if mn:
            x = np.arange(0, 1 << 16, 7)
            np.testing.assert_array_equal(tschema.udivmod32(x, n, mn)[1], x % n)


def test_split_fetch_bit_equal_to_xla(scenes):
    """Every channel from one address and its words (combined_split), and
    the albedo from the A words alone (combined_albedo), against the
    port's and JAX's XLA fetch at level 0, for u, v ~ U(+-130)."""
    _, js, ts = scenes
    u, v, _ = _uv()
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    got = _channels(ttex.combined_split(ts, tu, tv))
    port = _channels(ttex.bespoke_sample_combined(ts, tu, tv))
    want = _channels(jtex.bespoke_sample_combined(js, jnp.asarray(u), jnp.asarray(v)))
    for g, p, j in zip(got, port, want):
        assert g.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, j)
    alb = ttex.combined_albedo(ts, ttex.combined_at(ts, tu, tv))
    for g, j in zip(alb, want[:3]):
        np.testing.assert_array_equal(g.numpy(), j)


@pytest.mark.parametrize("level", list(range(10)) + ["mixed"])
def test_split_mip_fetch_bit_equal_to_xla(level):
    """The 512x512 set's pyramid: combined_split at every level and with a
    per-lane level against the port's and JAX's XLA mip fetch."""
    js, ts = _scenes(None)
    u, v, rs = _uv(lim=34.0)
    lod = (rs.randint(0, 10, u.shape) if level == "mixed"
           else np.full(u.shape, level)).astype(np.int32)
    tu, tv, tl = torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(lod)
    got = _channels(ttex.combined_split(ts, tu, tv, tl))
    want = _channels(jtex.bespoke_sample_combined_mip(
        js, jnp.asarray(u), jnp.asarray(v), jnp.asarray(lod)))
    port = _channels(ttex.bespoke_sample_combined_mip(ts, tu, tv, tl))
    for g, p, j in zip(got, port, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, j)


def test_cut_words_match_jax_windowed():
    """The cut set's address step (its wraps by the reciprocals): the word
    pairs against the words JAX's windowed fetch
    (bespoke_sample_combined_windowed, an interpret-mode pallas_call)
    returns for every lane it fetches, every pair inside the table (world
    1's own set: test_torch_textures.py)."""
    js, ts = _scenes(CUT)
    u, v, rs = _uv(seed=5)
    needs = rs.rand(u.size) < 0.8
    at = ttex.combined_at(ts, torch.from_numpy(u), torch.from_numpy(v))
    for c in at[0]:
        assert int(c.min()) >= 0 and int(c.max()) < ts.tex_tile.numel() // 2
    wa, wb = ttex.combined_words(ts, at)
    for g, j in zip(wa + wb, _jax_windowed_words(js, u, v, needs)):
        np.testing.assert_array_equal(g.numpy()[needs], j[needs])


def test_cut_set_params_and_mips():
    """The kernel's parameters for the cut set: level-0 wraps by the
    sizes' reciprocals and no pyramid, so --mips renders level 0: a plain
    lockstep render with the CLI's mip constant equals one without, bit for
    bit; world 1's own set keeps masks and its pyramid."""
    _, ts = _scenes(CUT)
    full = tworlds.finalize_world(W1, 16, 9, res_dir=RES)[0]
    _, cam = tworlds.finalize_world(W1, 16, 9, res_dir=RES)
    mips = 2.0 * cam.half_film_height / (9 * cam.focal_length)
    for scene, m, levels in ((ts, (tschema.planar_recip(48), tschema.planar_recip(40)), 0),
                             (full, (0, 0), 10)):
        cfg = RenderConfig(16, 9, pp=1, seed=0, mip_scale=mips)
        st = init_accum(16 * 9)
        px = torch.zeros(16 * 9, dtype=torch.int32)
        p = cuda_backend._params(scene, cam, cfg, 0, 0, 1, st, px, px.clone())
        assert tuple(p.tex_m) == m and p.tex_levels == levels
    renders = [cuda_backend.render_chunk_plain(
        ts, cam, RenderConfig(16, 9, pp=1, seed=0, mip_scale=ms), 0, 0, 2,
        init_accum(16 * 9)) for ms in (0.0, mips)]
    a, b = renders
    for x, y in zip((*a.sum, *a.sum_sq, a.count), (*b.sum, *b.sum_sq, b.count)):
        assert torch.equal(x, y)
    assert int(a.rays_cast) == int(b.rays_cast) > 0
    assert float(sum(c.sum() for c in a.sum)) > 0
