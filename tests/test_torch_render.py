"""The slice end to end on the CPU: the port's render_chunk (the plain
version of the CUDA kernel) against the JAX package's XLA wavefront driver
and its Pallas kernel in interpret mode, cross-framework resume, and exact
resume within the port.

Gates are the repo's golden-test ones (tests/test_golden.py:46-47): the
per-pixel resolved radiance has median |diff| < 1e-4 and fewer than 5% of
pixels off by more than 1e-2. Ulp-level differences between XLA and
PyTorch (fused multiply-adds, sin/cos) can flip a discrete choice on a few
paths, which moves whole samples; the valid-sample counts must match and
the ray counts agree within 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.render.pallas_backend import render_chunk_pallas
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.convert import accum_from_numpy
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)


def _jax_leaves(st):
    return dict(sum=np.asarray(st.sum), sum_sq=np.asarray(st.sum_sq),
                count=np.asarray(st.count), nan_count=np.asarray(st.nan_count),
                rays_cast=np.asarray(st.rays_cast),
                samples_done=np.asarray(st.samples_done))


def _jax_chunk(kind, w, h, pp, s0, n, state=None, pallas=False,
               use_pinhole=True):
    js, cam = jworlds.finalize_world(kind, w, h, use_pinhole=use_pinhole)
    cfg = jrenderer.RenderConfig(w, h, pp=pp, seed=0)
    key = jprng.base_key(0)
    state = jrenderer.init_accum(w * h) if state is None else state
    if pallas:
        return render_chunk_pallas(js, cam, cfg, key, jnp.int32(s0), n, state,
                                   jnp.arange(w * h, dtype=jnp.int32),
                                   interpret=True)
    return jrenderer.render_chunk(js, cam, cfg, key, jnp.int32(s0), n, state)


def _port_chunk(kind, w, h, pp, s0, n, state=None, use_pinhole=True):
    ts, cam = tworlds.finalize_world(kind, w, h, use_pinhole=use_pinhole)
    cfg = trenderer.RenderConfig(w, h, pp=pp, seed=0)
    state = trenderer.init_accum(w * h) if state is None else state
    return trenderer.render_chunk(ts, cam, cfg, 0, s0, n, state)


def _resolved(sum3, count):
    return np.asarray(sum3) / np.maximum(np.asarray(count), 1.0)


def assert_golden_gates(jst, tst):
    a = _resolved(np.asarray(jst.sum), jst.count)
    b = _resolved(torch.stack(list(tst.sum)).numpy(), tst.count.numpy())
    d = np.abs(a - b).max(axis=0)
    assert np.median(d) < 1e-4, f"median |diff| {np.median(d)}"
    assert (d > 1e-2).mean() < 0.05, f"flips {(d > 1e-2).mean()}"
    np.testing.assert_array_equal(np.asarray(jst.count), tst.count.numpy())
    jr, tr = float(jst.rays_cast), int(tst.rays_cast)
    assert abs(jr - tr) <= 0.01 * jr, (jr, tr)
    assert b.max() > 0


@pytest.mark.parametrize("kind", [tschema.WORLD_CORNELL_BOX,
                                  tschema.WORLD_CORNELL_QUAD])
def test_render_chunk_vs_xla_wavefront(kind):
    jst = _jax_chunk(kind, 32, 18, 2, 0, 4)
    tst = _port_chunk(kind, 32, 18, 2, 0, 4)
    assert_golden_gates(jst, tst)
    assert tst.samples_done == 4 and int(tst.nan_count) == float(jst.nan_count)


@pytest.mark.parametrize("kind, w, h, pinhole", [
    (tschema.WORLD_RAYTRACING_ONE_WEEKEND, 16, 12, True),   # forced thin lens
    (tschema.WORLD_CORNELL_BOX, 32, 18, False),             # -w3 -d
])
def test_thin_lens_slice_vs_xla_wavefront(kind, w, h, pinhole):
    """World 4 (clustered spheres in the port, the brute sweep in the XLA
    driver; thin lens; just_cosine over 512 material rows) and the Cornell
    box through the thin lens."""
    jst = _jax_chunk(kind, w, h, 2, 0, 4, use_pinhole=pinhole)
    tst = _port_chunk(kind, w, h, 2, 0, 4, use_pinhole=pinhole)
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count)


def test_cli_world4_thin_lens_scene_seed(tmp_path, capsys):
    """-w4 with --scene-seed and -d on -w3 through the CLI, on the CPU."""
    from pathtracer_tpu_torch.cli import main
    for argv in (["-w4", "-p1", "--scene-seed", "99"], ["-w3", "-d", "-p1"]):
        out = tmp_path / "img.bmp"
        assert main(argv + ["--size", "8x6", "--device", "cpu",
                            "--out", str(out)]) == 0
        assert out.stat().st_size == 54 + 4 + 8 * 6 * 4
    assert main(["-w4", "-p1", "--scene-seed", "os", "--size", "4x4",
                 "--device", "cpu", "--out", str(out)]) == 0
    assert "--scene-seed os: layout seed" in capsys.readouterr().out


def test_render_chunk_vs_pallas_interpret():
    jst = _jax_chunk(tschema.WORLD_CORNELL_BOX, 128, 32, 1, 0, 1, pallas=True)
    tst = _port_chunk(tschema.WORLD_CORNELL_BOX, 128, 32, 1, 0, 1)
    assert_golden_gates(jst, tst)


def test_cross_framework_resume():
    """A JAX checkpoint after 2 samples, finished in the port, against 4
    JAX samples."""
    kind, w, h, pp = tschema.WORLD_CORNELL_BOX, 32, 18, 2
    half = _jax_chunk(kind, w, h, pp, 0, 2)
    full = _jax_chunk(kind, w, h, pp, 0, 4)
    st = accum_from_numpy(_jax_leaves(half))
    assert st.samples_done == 2
    ts, cam = tworlds.finalize_world(kind, w, h)
    _, _, st = trenderer.render_image(ts, cam, trenderer.RenderConfig(
        w, h, pp=pp, seed=0), state=st, device="cpu")
    assert st.samples_done == 4
    assert_golden_gates(full, st)


@pytest.mark.parametrize("kind", [tschema.WORLD_CORNELL_BOX,
                                  tschema.WORLD_CORNELL_QUAD])
def test_resume_within_port_exact(kind):
    ts, cam = tworlds.finalize_world(kind, 16, 12)
    cfg = trenderer.RenderConfig(16, 12, pp=2, seed=3,
                                 use_russian_roulette=True)
    img1, pk1, st1 = trenderer.render_image(ts, cam, cfg, device="cpu")
    img2, pk2, st2 = trenderer.render_image(ts, cam, cfg, chunk_samples=1,
                                            device="cpu")
    part = trenderer.render_chunk(ts, cam, cfg, cfg.seed, 0, 1,
                                  trenderer.init_accum(16 * 12))
    _, _, st3 = trenderer.render_image(ts, cam, cfg, state=part, device="cpu")
    for st in (st2, st3):
        for a, b in zip(st1.sum, st.sum):
            assert torch.equal(a, b)
        assert torch.equal(st1.count, st.count)
        assert int(st1.rays_cast) == int(st.rays_cast)
    assert torch.equal(pk1, pk2)
    assert torch.equal(img1, img2)
