"""The unrolled driver on the CPU against the JAX package: the port's
``integrator.trace`` through ``renderer.render_chunk`` (the debug kinds,
``mode="unrolled"``) and ``just_importance`` through the plain wavefront,
against JAX's XLA drivers on the Cornell box (world 3) at 32x18, one
sample, under the golden gates (tests/test_torch_render.py); the routes
``render_chunk`` takes; and the two samplers on no render path.

JAX's renders run its ``renderer._one_sample`` (the body of
``render_chunk``'s sample loop) op by op on XLA:CPU under
``jax.disable_jit``: tracing and compiling the unrolled driver once per
kind costs about 3 s each, op by op the four renders take about 8 s,
most of it compiling each primitive once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import sampling as jsampling
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.ops import sampling as tsampling
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils import prng as tprng
from test_torch_render import assert_golden_gates
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W, H = 32, 18
KINDS = ("bounce_count", "termination_condition", "primary_ray_normals")


@pytest.fixture(scope="module")
def jax_renders():
    """JAX's renders of sample 0 of world 3: the three debug kinds and
    ``just_importance`` (JAX's unrolled and wavefront drivers agree bit
    for bit, tests/test_wavefront.py)."""
    js, jcam = jworlds.finalize_world(tschema.WORLD_CORNELL_BOX, W, H)
    cfgs = {k: dict(debug_kind=k) for k in KINDS}
    cfgs["just_importance"] = dict(just_importance=True)
    with jax.disable_jit():
        return {k: jrenderer._one_sample(
            js, jcam, jrenderer.RenderConfig(W, H, pp=1, seed=0, **kw),
            jprng.base_key(0), jnp.int32(0), jrenderer.init_accum(W * H))
            for k, kw in cfgs.items()}


def _port(cfg, kind=tschema.WORLD_CORNELL_BOX):
    ts, tcam = tworlds.finalize_world(kind, W, H)
    return trenderer.render_chunk(ts, tcam, cfg, 0, 0, cfg.spp,
                                  trenderer.init_accum(W * H))


@pytest.mark.parametrize("kind", KINDS)
def test_debug_kind_vs_xla(jax_renders, kind):
    """Each debug kind through the port's unrolled driver (the route
    ``mode="auto"`` picks) against JAX's, under the golden gates; the
    values are the kind's own: multiples of 1/MAX_BOUNCE_COUNT, the four
    termination colours (or black), normals mapped into [0, 1]."""
    tst = _port(trenderer.RenderConfig(W, H, pp=1, seed=0, debug_kind=kind))
    assert_golden_gates(jax_renders[kind], tst)
    assert tst.samples_done == 1 and int(tst.nan_count) == 0
    v = torch.stack(list(tst.sum))
    if kind == "bounce_count":
        q = v * tschema.MAX_BOUNCE_COUNT
        assert torch.equal(q, q.round()) and float(v.min()) >= 0.25
    elif kind == "termination_condition":
        # black where the path ended otherwise (an estimator draw refused)
        colours = {tuple(c) for c in v.T.tolist()}
        assert colours <= {(0, 0, 1), (0, 1, 0), (1, 0, 0), (1, 1, 0),
                           (0, 0, 0)}
        assert (0, 0, 1) in colours and (0, 1, 0) in colours
    else:
        assert float(v.min()) >= 0.0 and float(v.max()) <= 1.0


def test_just_importance_vs_xla(jax_renders):
    """``just_importance`` (the diffuse estimator samples the light only)
    through the port's plain wavefront against JAX's driver under the
    golden gates; the port's unrolled driver renders the same sums bit for
    bit."""
    cfg = trenderer.RenderConfig(W, H, pp=1, seed=0, just_importance=True)
    tst = _port(cfg)
    assert_golden_gates(jax_renders["just_importance"], tst)
    unrolled = _port(trenderer.RenderConfig(W, H, pp=1, seed=0,
                                            just_importance=True,
                                            mode="unrolled"))
    for a, b in zip((*tst.sum, *tst.sum_sq, tst.count),
                    (*unrolled.sum, *unrolled.sum_sq, unrolled.count)):
        assert torch.equal(a, b)
    assert int(tst.rays_cast) == int(unrolled.rays_cast)
    # the light-only estimator differs from the mixture
    mixed = _port(trenderer.RenderConfig(W, H, pp=1, seed=0))
    assert not torch.equal(mixed.sum.x, tst.sum.x)


@pytest.mark.parametrize("kind, pinhole", [
    (tschema.WORLD_CORNELL_BOX, True), (tschema.WORLD_CORNELL_QUAD, True),
    (tschema.WORLD_CORNELL_BOX, False)], ids=["w3", "w6", "w3-d"])
def test_mode_unrolled_equals_regeneration(kind, pinhole):
    """``mode="unrolled"`` renders the regular and variance targets through
    the unrolled driver; JAX's drivers agree bit for bit and so do the
    port's: the unrolled sums, counts and rays equal the plain version of
    the kernel's (path regeneration), with Russian roulette too."""
    ts, tcam = tworlds.finalize_world(kind, 16, 9, use_pinhole=pinhole)
    for rr in (False, True):
        runs = [trenderer.render_chunk(
            ts, tcam, trenderer.RenderConfig(16, 9, pp=2, seed=3, mode=mode,
                                             use_russian_roulette=rr),
            3, 0, 4, trenderer.init_accum(16 * 9))
            for mode in ("unrolled", "auto")]
        a, b = runs
        for x, y in zip((*a.sum, *a.sum_sq, a.count),
                        (*b.sum, *b.sum_sq, b.count)):
            assert torch.equal(x, y)
        assert int(a.rays_cast) == int(b.rays_cast)
        assert a.samples_done == b.samples_done == 4


def test_render_chunk_routes(monkeypatch):
    """The regular and variance targets under auto or wavefront go to the
    kernel's wrapper; a debug kind, ``mode="unrolled"`` and
    ``just_importance`` never reach it; the wrapper itself refuses them
    without launching, and an unknown kind or mode raises."""
    ts, tcam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 4, 4)
    calls = []
    plain = cuda_backend.render_chunk_plain
    monkeypatch.setattr(cuda_backend, "render_chunk_plain",
                        lambda *a: calls.append(a[2]) or plain(*a))

    def run(**kw):
        calls.clear()
        trenderer.render_chunk(ts, tcam, trenderer.RenderConfig(
            4, 4, pp=1, **kw), 0, 0, 1, trenderer.init_accum(16))
        return bool(calls)

    assert run() and run(debug_kind="variance") and run(mode="wavefront")
    for kw in (dict(debug_kind="bounce_count"), dict(mode="unrolled"),
               dict(just_importance=True), dict(debug_kind="bounce_count",
                                                mode="wavefront")):
        assert not run(**kw), kw
    launches = cuda_backend.LAUNCHES
    for kw in (dict(debug_kind="termination_condition"),
               dict(just_importance=True), dict(mode="unrolled")):
        with pytest.raises(ValueError, match="as torch ops"):
            cuda_backend.render_chunk_cuda(ts, tcam, trenderer.RenderConfig(
                4, 4, pp=1, **kw), 0, 0, 1, trenderer.init_accum(16))
    assert cuda_backend.LAUNCHES == launches
    for kw in (dict(debug_kind="nope"), dict(mode="nope")):
        with pytest.raises(ValueError, match="nope"):
            run(**kw)


def test_trace_refuses_both_estimator_flags():
    """World 4's materials set ``just_cosine``; ``just_importance`` on top
    of it raises as JAX's assert does."""
    ts, tcam = tworlds.finalize_world(tschema.WORLD_RAYTRACING_ONE_WEEKEND,
                                      4, 4)
    assert ts.just_cosine
    with pytest.raises(AssertionError, match="can't both be true"):
        trenderer.render_chunk(ts, tcam, trenderer.RenderConfig(
            4, 4, pp=1, just_importance=True, mode="unrolled"), 0, 0, 1,
            trenderer.init_accum(16))


def test_samplers_off_the_render_path():
    """``normal_from_uniforms`` and ``uniform_hemisphere`` against JAX's on
    100,000 seeded uniforms (the first ten u1 at 0, the clamp's case).
    Tolerance: XLA:CPU's log, sin and cos are its own approximations, not
    correctly rounded (about 14% of its float32 logs and 1.3% of its cosines
    differ from float64's rounding, PyTorch's 0.1% and 5%), so the two
    agree within a few ulps, not bit for bit: rtol 1e-6 with atol 2e-6 on
    the Gaussian (|x| up to about 14), 1e-7 on the unit directions."""
    rng = np.random.RandomState(7)
    u1 = rng.rand(100_000).astype(np.float32)
    u2 = rng.rand(100_000).astype(np.float32)
    u1[:10] = 0.0
    a = np.asarray(jprng.normal_from_uniforms(jnp.asarray(u1),
                                              jnp.asarray(u2), stddev=2.5))
    b = tprng.normal_from_uniforms(torch.from_numpy(u1), torch.from_numpy(u2),
                                   stddev=2.5).numpy()
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=2e-6)
    assert abs(b.std() - 2.5) < 0.03
    ja = jsampling.uniform_hemisphere(jnp.asarray(u1), jnp.asarray(u2))
    tb = tsampling.uniform_hemisphere(torch.from_numpy(u1),
                                      torch.from_numpy(u2))
    for x, y in zip(ja, tb):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(tb.z.numpy(), u1)
