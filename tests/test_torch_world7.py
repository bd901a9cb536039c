"""World 7 (the mesh-UV world) end to end on the CPU: the port's
render_chunk (the plain version of the mesh kernel: the streamed walk and
the mesh-UV fetch) against the JAX package at 32x18.

- Against the XLA wavefront renderer, pp=2, both schedules and the thin
  lens (-d). That renderer sweeps the triangles with the brute
  ``ray_planar_triangle`` form, whose normals and barycentrics differ from
  the streamed tier's precomputed records in the last bits, so the gates
  are tests/test_golden.py's: median |diff| < 1e-4, fewer than 5% of pixels
  off by more than 1e-2, equal valid counts, rays within 1%.
- Against the Pallas kernel in interpret mode, 1 sample: the same streamed
  form (the XLA renderer cannot trace it: its rays are 1-D). XLA:CPU
  contracts multiply-adds into FMAs and the port does not, so this is held
  to the same gates, not to bit-equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.render.pallas_backend import render_chunk_pallas
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.io.bmp import packed_to_rgb, read_bmp
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_render import assert_golden_gates
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W7 = tschema.WORLD_MESH_UV
W, H = 32, 18


@pytest.mark.parametrize("schedule, pinhole", [
    ("regen", True), ("lockstep", True), (None, False)],
    ids=["regen", "lockstep", "lens"])
def test_world7_vs_xla_wavefront(schedule, pinhole):
    js, jcam = jworlds.finalize_world(W7, W, H, use_pinhole=pinhole)
    ts, tcam = tworlds.finalize_world(W7, W, H, use_pinhole=pinhole)
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(W, H, pp=2, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(W * H))
    cfg = trenderer.RenderConfig(W, H, pp=2, seed=0, schedule=schedule)
    tst = cuda_backend.render_chunk_plain(ts, tcam, cfg, 0, 0, 4,
                                          trenderer.init_accum(W * H))
    assert_golden_gates(jst, tst)
    assert tst.samples_done == 4 and int(tst.nan_count) == float(jst.nan_count)


def test_world7_vs_pallas_interpret():
    js, cam = jworlds.finalize_world(W7, W, H)
    ts, _ = tworlds.finalize_world(W7, W, H)
    cfg = jrenderer.RenderConfig(W, H, pp=2, seed=0)
    jst = render_chunk_pallas(js, cam, cfg, jprng.base_key(0), jnp.int32(0), 1,
                              jrenderer.init_accum(W * H),
                              jnp.arange(W * H, dtype=jnp.int32),
                              interpret=True)
    tst = trenderer.render_chunk(ts, cam, trenderer.RenderConfig(
        W, H, pp=2, seed=0), 0, 0, 1, trenderer.init_accum(W * H))
    assert_golden_gates(jst, tst)


def test_world7_schedules_agree():
    """Both schedules compute the same per-pixel values, bit for bit."""
    ts, cam = tworlds.finalize_world(W7, 16, 9)
    out = [cuda_backend.render_chunk_plain(
        ts, cam, trenderer.RenderConfig(16, 9, pp=2, seed=1, schedule=s),
        1, 0, 4, trenderer.init_accum(16 * 9)) for s in ("regen", "lockstep")]
    for a, b in zip(out[0].sum + out[0].sum_sq, out[1].sum + out[1].sum_sq):
        assert np.array_equal(a.numpy(), b.numpy())
    assert int(out[0].rays_cast) == int(out[1].rays_cast)


@pytest.mark.parametrize("flags", [[], ["-d"]])
def test_cli_world7_writes_an_image(tmp_path, capsys, flags):
    from pathtracer_tpu_torch.cli import main
    out = tmp_path / "w7.bmp"
    assert main(["-w7", "--size", "32x18", "-p1", "--device", "cpu",
                 "--out", str(out)] + flags) == 0
    img = packed_to_rgb(read_bmp(str(out)))
    assert img.shape == (18, 32, 3) and img.max() > 0
    text = capsys.readouterr().out
    assert "camera located at c->pos = (0.000000,-7.000000,2.200000)" in text
    assert "0 NaN samples" in text


def test_world7_kernel_variants():
    ts, cam = tworlds.finalize_world(W7, 8, 8)
    _, lens = tworlds.finalize_world(W7, 8, 8, use_pinhole=False)
    assert cuda_backend.variant(ts, cam) == "mesh_pinhole"
    assert cuda_backend.variant(ts, lens) == "mesh_lens"
    other = cuda_backend.MESH_OTHER_SCHEDULE
    assert cuda_backend.variant(ts, cam, other) == f"mesh_pinhole_{other}"
    with pytest.raises(NotImplementedError, match="pinhole only"):
        cuda_backend.variant(ts, lens, other)
    clustered, _ = tworlds.finalize_world(tschema.WORLD_BRDF_TEST, 8, 8)
    both = dataclasses.replace(
        ts, sph_clusters=clustered.sph_clusters,
        **{k: getattr(clustered, k) for k in ("cl_offset", "cl_count",
                                              "cl_min", "cl_max", "cl_huge")})
    cuda_backend.check_supported(both, cam, trenderer.RenderConfig(8, 8))
    assert cuda_backend.variant(both, cam) == "clustered+mesh"
    assert cuda_backend.variant(both, lens) == "clustered+mesh"
    w1, _ = tworlds.finalize_world(tschema.WORLD_DEFAULT, 8, 8)
    comb = dataclasses.replace(
        both, n_textures=4, tex_combined=True,
        **{k: getattr(w1, k) for k in ("tex_tile", "tex_comb_a",
                                       "tex_comb_b", "tex_mip")})
    # a UV mesh beside a combined set: JAX renders it on XLA only, so the
    # kernel's wrapper refuses it and render_chunk routes it to torch ops
    assert comb.off_kernel
    assert not trenderer.kernel_renders(comb, trenderer.RenderConfig(8, 8))
    with pytest.raises(NotImplementedError,
                       match="a UV mesh or a bump map beside a combined "
                             "texture set on XLA only"):
        cuda_backend.check_supported(comb, cam, trenderer.RenderConfig(8, 8))
