"""The feature slice against the JAX package on the CPU: the five feature
scenes (scene/feature_scenes.py), the planar texture fetch (K10's planar
form), the bump map's height fetch (K11), the brute UV triangle sweep (K4t),
the Henyey-Greenstein phase function and Snell refraction.

- Tables: the port's builders against JAX's ``finalize`` through the
  converter, bit-equal (quad normals within 1 ulp, as for the worlds).
- Renders: the port's render_chunk (the plain version of the feature
  kernel) against JAX's XLA wavefront driver at 32x18, pp=2, under the
  golden gates (tests/test_torch_render.py::assert_golden_gates); the fog
  scene is in tests/test_torch_fog.py.
- Fetches: ``bespoke_sample`` and ``bespoke_height3`` bit-equal to JAX's
  ``bespoke_sample`` on random, huge, negative, NaN and infinite world
  coordinates.
- The brute sweep, HG and refraction against JAX run op by op (eager, so
  XLA:CPU fuses nothing): bit-equal, except where the two libraries round
  differently (cos, sin, PyTorch's CPU sqrt, XLA's rsqrt rewrite), within
  the ulps or the bound stated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.ops import sampling as jsampling
from pathtracer_tpu.ops import shade as jshade
from pathtracer_tpu.ops import texture as jtexture
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import feature_scenes as jfeatures
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu.scene.schema import WorldBuilder as JWorldBuilder
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.ops import sampling as tsampling
from pathtracer_tpu_torch.ops import shade as tshade
from pathtracer_tpu_torch.ops import texture as ttexture
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import feature_scenes as tfeatures
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene.camera import define_camera
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_mesh import _uv_mesh_builder
from test_torch_render import assert_golden_gates
from test_torch_scene import assert_tables_equal
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W, H = 32, 18


@pytest.mark.parametrize("name", list(tfeatures.FEATURE_CASES))
def test_feature_tables_equal(name):
    js, jview, jkw = jfeatures.FEATURE_CASES[name]()
    ts, tview, tkw = tfeatures.FEATURE_CASES[name]()
    assert_tables_equal(js, ts)
    assert tuple(map(tuple, np.atleast_1d(jview[:2]))) == tuple(
        map(tuple, np.atleast_1d(tview[:2]))) and jview[2] == tview[2]
    assert jkw == tkw
    assert ts.featured


def _render_pair(name, pinhole=True):
    js, (pos, target, fov), kw = jfeatures.FEATURE_CASES[name]()
    ts, _, _ = tfeatures.FEATURE_CASES[name]()
    jst = jrenderer.render_chunk(
        js, jdefine_camera(pos, target, fov, W, H, use_pinhole=pinhole),
        jrenderer.RenderConfig(W, H, pp=2, seed=0, **kw), jprng.base_key(0),
        jnp.int32(0), 4, jrenderer.init_accum(W * H))
    cam = define_camera(pos, target, fov, W, H, use_pinhole=pinhole)
    tst = trenderer.render_chunk(ts, cam, trenderer.RenderConfig(
        W, H, pp=2, seed=0, **kw), 0, 0, 4, trenderer.init_accum(W * H))
    return jst, tst, cuda_backend.variant(ts, cam)


@pytest.mark.parametrize("name, pinhole", [
    ("bump", True), ("tbn", True), ("dispersion", True),
    ("everything", True), ("everything", False)])
def test_feature_render_vs_xla_wavefront(name, pinhole):
    """Each scene (everything with RR, as its builder asks) against the
    XLA driver; the variant is the feature kernel's."""
    jst, tst, var = _render_pair(name, pinhole)
    assert var == (("feature_pinhole" if pinhole else "feature_lens")
                   + ("_k4t" if name == "everything" else ""))
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count)


def _stack_scenes():
    """(JAX scene, port scene) pairs with flat texture stacks: the
    everything scene (two 8x8 layers) and a random mesh scene's 16x16."""
    js, _, _ = jfeatures.FEATURE_CASES["everything"]()
    ts, _, _ = tfeatures.FEATURE_CASES["everything"]()
    jm = _uv_mesh_builder(JWorldBuilder, 20).finalize()
    tm = _uv_mesh_builder(tschema.WorldBuilder, 20).finalize()
    return ((js, ts), (jm, tm))


def _coords(n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n) - 0.5).astype(np.float32) * 40.0
    x[: n // 8] *= 1e7                                  # huge
    x[n // 8: n // 4] = -np.abs(x[n // 8: n // 4])      # negative
    x[-6:] = [np.nan, np.inf, -np.inf, 3e38, -3e38, 0.0]
    return x


def test_bespoke_sample_and_height3_bit_equal():
    for js, ts in _stack_scenes():
        n = 512
        nl = int(ts.tex_w.numel())
        layer = np.random.RandomState(3).randint(0, nl, n).astype(np.int32)
        x, y = _coords(n, 1), _coords(n, 2)[::-1].copy()
        jl, jx, jy = jnp.asarray(layer), jnp.asarray(x), jnp.asarray(y)
        tl, tx, ty = (torch.from_numpy(a) for a in (layer, x, y))
        jc = jtexture.bespoke_sample(js, jl, jx, jy)
        tc = ttexture.bespoke_sample(ts, tl, tx, ty)
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        eps = jnp.float32(0.01)
        want = (jc.x, jtexture.bespoke_sample(js, jl, jx + eps, jy).x,
                jtexture.bespoke_sample(js, jl, jx, jy + eps).x)
        for a, b in zip(want, ttexture.bespoke_height3(ts, tl, tx, ty)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _rays(n, seed, origin=(0.0, -8.0, 1.0)):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.5  # toward the mesh
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.asarray(origin, np.float32), (n, 1))
    o += (rng.rand(n, 3).astype(np.float32) - 0.5) * 4.0
    return o, d


@pytest.mark.parametrize("case", ["everything", "random40"])
def test_brute_uv_sweep_vs_jax(case):
    """K4t's plain version: winners (material and normal), t and uv of
    intersect_scene_uv against JAX's (the brute UV sweep), bit-equal."""
    if case == "everything":
        js, _, _ = jfeatures.FEATURE_CASES["everything"]()
        ts, _, _ = tfeatures.FEATURE_CASES["everything"]()
    else:
        js = _uv_mesh_builder(JWorldBuilder, 40).finalize()
        ts = _uv_mesh_builder(tschema.WorldBuilder, 40).finalize()
    assert ts.tri_brute and not ts.tri_streamed
    o, d = _rays(4096, 5, (0.0, -8.0, 1.0) if case == "everything"
                 else (0.0, -20.0, 0.0))
    jh, jux, juy, jok = jint.intersect_scene_uv(
        js, JVec3(*(jnp.asarray(o[:, k]) for k in range(3))),
        JVec3(*(jnp.asarray(d[:, k]) for k in range(3))))
    th, tux, tuy, tok = tint.intersect_scene_uv(
        ts, TVec3(*(torch.from_numpy(o[:, k].copy()) for k in range(3))),
        TVec3(*(torch.from_numpy(d[:, k].copy()) for k in range(3))))
    assert 0 < int(tok.sum()) < 4096
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_array_equal(np.asarray(jh.mat), th.mat.numpy())
    for a, b in ((jh.t, th.t), (jux, tux), (juy, tuy), *zip(jh.normal,
                                                             th.normal)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("g", [0.0, 0.5, -0.3])
def test_henyey_greenstein_vs_jax(g):
    """HG sample and pdf: cos_theta bit-equal; the sample's x and y within
    2 ulps (cos and sin of the two libraries); the pdf within 8 ulps (6
    measured): XLA:CPU rewrites JAX's 1 / sqrt(denom) into rsqrt, where the
    port and its kernel divide (IEEE, the same on the card)."""
    rng = np.random.RandomState(11)
    u1, u2 = (rng.rand(4096).astype(np.float32) for _ in range(2))
    js = jsampling.henyey_greenstein_sample(jnp.asarray(u1), jnp.asarray(u2),
                                            g)
    tsmp = tsampling.henyey_greenstein_sample(torch.from_numpy(u1),
                                              torch.from_numpy(u2), g)
    np.testing.assert_array_equal(np.asarray(js.z), tsmp.z.numpy())
    assert _ulps(js.x, tsmp.x).max() <= 2 and _ulps(js.y, tsmp.y).max() <= 2
    c = (rng.rand(4096).astype(np.float32) * 2.0 - 1.0)
    assert _ulps(jsampling.pdf_henyey_greenstein(jnp.asarray(c), g),
                 tsampling.pdf_henyey_greenstein(torch.from_numpy(c), g)
                 .numpy()).max() <= 8


def test_refraction_vs_jax():
    """find_refraction_direction with rays entering and leaving glass of
    index 1.3-1.6, total internal reflection included: the TIR flags
    equal, the directions bit-equal on 99% of rays and within 1e-6 on all
    (2.4e-7 measured): PyTorch's CPU sqrt is not correctly rounded on 0.7%
    of inputs, where XLA's and the card's are."""
    rng = np.random.RandomState(13)
    n = 4096
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nn = rng.randn(n, 3).astype(np.float32)
    nn /= np.linalg.norm(nn, axis=1, keepdims=True)
    ior = (1.3 + 0.3 * rng.rand(n)).astype(np.float32)
    jd, jok = jshade.find_refraction_direction(
        JVec3(*(jnp.asarray(d[:, k]) for k in range(3))),
        JVec3(*(jnp.asarray(nn[:, k]) for k in range(3))), jnp.asarray(ior))
    td, tok = tshade.find_refraction_direction(
        TVec3(*(torch.from_numpy(d[:, k].copy()) for k in range(3))),
        TVec3(*(torch.from_numpy(nn[:, k].copy()) for k in range(3))),
        torch.from_numpy(ior))
    ok = tok.numpy()
    assert 0 < (~ok).sum() < n  # some rays are totally reflected
    np.testing.assert_array_equal(np.asarray(jok), ok)
    for a, b in zip(jd, td):
        assert (np.asarray(a) == b.numpy()).mean() > 0.99
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-6)
