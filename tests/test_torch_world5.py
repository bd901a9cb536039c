"""World 5 and the mesh tiers end to end on the CPU, and the CLI repairs.

- Renders: world 5's builder without its asset plus a 40-triangle (K4t
  plain), a 784-triangle (the static tier without UVs, Mario's tier and
  size) and a 736-triangle UV mesh (the static tier with UVs, K8), and a
  1936-triangle mesh forced into the DMA tier with grandparents, each
  through the port's render_chunk (the plain version of its kernel)
  against the JAX package's XLA wavefront renderer at 32x18, pp=2, under
  the golden gates of tests/test_torch_render.py (median |diff| < 1e-4,
  fewer than 5% of pixels off by more than 1e-2, equal valid counts, rays
  within 1%). The XLA renderer sweeps every triangle brute force with
  ray_planar_triangle, whose t differs from the precomputed form's in the
  last bits, so the gates are the golden ones.
- World 5 with a GLB these tests write (the asset itself is not in the
  repository): tables equal to JAX's, the render under the same gates.
- The CLI: ``-w5`` without the asset against JAX's ``-w5`` (8x8), ``--out
  x.png`` (PNG bytes whose pixels equal JAX's; BMP bytes for an extension
  PIL does not know; a refusal naming PIL without PIL), the
  progress lines of the default ``--chunk`` (min(spp, 64)) at 144 spp
  and the camera explanation, against JAX's CLI.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu import cli as jcli
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch import cli as tcli
from pathtracer_tpu_torch.io.bmp import packed_to_rgb, read_bmp
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_gltf import write_glb
from test_torch_mesh_tiers import force_dma  # noqa: F401 (a fixture)
from test_torch_meshes import (
    lat_long_sphere, mesh_scene, tessellated_sphere, uv_sphere,
)
from test_torch_render import assert_golden_gates
from test_torch_scene import assert_tables_equal

W5 = tschema.WORLD_MARIO
W, H = 32, 18


def _render_both(js, jcam, ts, tcam, w=W, h=H):
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(w, h, pp=2, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(w * h))
    tst = cuda_backend.render_chunk_plain(
        ts, tcam, trenderer.RenderConfig(w, h, pp=2, seed=0), 0, 0, 4,
        trenderer.init_accum(w * h))
    return jst, tst


@pytest.mark.parametrize("case, variant", [
    ("tri40", "feature_pinhole_k4t"), ("tri784", "staticplain_pinhole"),
    ("uv736", "static_pinhole"), ("dma1936", "meshplain_pinhole")])
def test_mesh_render_vs_xla(case, variant, request):
    if case == "dma1936":
        request.getfixturevalue("force_dma")
    tris, uvs = {"tri40": lambda: (lat_long_sphere(4, 5), None),
                 "tri784": lambda: (tessellated_sphere(800), None),
                 "uv736": lambda: uv_sphere(16, 24),
                 "dma1936": lambda: (tessellated_sphere(2000), None)}[case]()
    js, jcam = mesh_scene(jworlds, tris, uvs)
    ts, tcam = mesh_scene(tworlds, tris, uvs)
    assert cuda_backend.variant(ts, tcam) == variant
    jst, tst = _render_both(js, jcam, ts, tcam)
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count) == 0


def test_world5_with_a_written_glb(tmp_path):
    """World 5 loads res_dir/mario.glb: a GLB of 360 triangles in three
    primitives (the static tier), two base-colour materials appended and
    one primitive on the reference's default material 1 (the sun's)."""
    write_glb(str(tmp_path / "mario.glb"))
    js, jcam = jworlds.finalize_world(W5, W, H, res_dir=str(tmp_path))
    ts, tcam = tworlds.finalize_world(W5, W, H, res_dir=str(tmp_path))
    assert ts.n_tris == 360 and ts.tri_static and ts.n_materials == 5
    assert_tables_equal(js, ts)
    assert cuda_backend.variant(ts, tcam) == "staticplain_pinhole"
    jst, tst = _render_both(js, jcam, ts, tcam)
    assert_golden_gates(jst, tst)


def _cli_pair(tmp_path, argv, name):
    """Runs JAX's CLI and the port's (on the CPU) with ``argv``, writing
    ``name`` into separate directories; returns the two paths and the
    port's stdout lines."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    tout.mkdir()
    assert jcli.main(argv + ["--out", str(jout / name)]) == 0
    assert tcli.main(argv + ["--device", "cpu", "--out",
                             str(tout / name)]) == 0
    return jout / name, tout / name


def test_world5_cli_without_asset_vs_jax(tmp_path, capsys):
    """``-w5`` renders ground, sky and sun when mario.glb is absent, in both
    packages; the 8-bit images agree but for a few coin-flip pixels."""
    jpath, tpath = _cli_pair(tmp_path, ["-w5", "-p2", "--size", "8x8"],
                             "w5.bmp")
    a = packed_to_rgb(read_bmp(str(jpath))).astype(int)
    b = packed_to_rgb(read_bmp(str(tpath))).astype(int)
    assert a.shape == b.shape == (8, 8, 3) and b.max() > 0
    off = np.abs(a - b).max(axis=-1)
    assert np.median(off) == 0 and (off > 2).mean() <= 0.05
    text = capsys.readouterr().out
    assert "camera located at c->pos = (-5.000000,-5.000000,1.000000)" in text


def test_out_png_matches_jax(tmp_path):
    """--out x.png writes PNG bytes whose pixels equal JAX's."""
    from PIL import Image
    jpath, tpath = _cli_pair(tmp_path, ["-w3", "-p1", "--size", "8x8"],
                             "w3.png")
    for p in (jpath, tpath):
        assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(np.asarray(Image.open(jpath)),
                                  np.asarray(Image.open(tpath)))


def test_out_unknown_extension_and_no_pil(tmp_path, monkeypatch, capsys):
    """An extension PIL does not know falls back to BMP bytes, as JAX's
    CLI does; without PIL a non-BMP --out raises naming PIL and writes
    nothing."""
    argv = ["-w3", "-p1", "--size", "4x4", "--device", "cpu", "--out"]
    odd = tmp_path / "img.notaformat"
    assert tcli.main(argv + [str(odd)]) == 0
    assert odd.read_bytes()[:2] == b"BM"
    assert "unknown extension" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "PIL", None)
    png = tmp_path / "img.png"
    with pytest.raises(NotImplementedError, match="needs PIL"):
        tcli.main(argv + [str(png)])
    assert not png.exists()
    assert tcli.main(argv + [str(tmp_path / "img")]) == 0  # no extension
    assert (tmp_path / "img").read_bytes()[:2] == b"BM"


def test_default_chunk_progress_and_camera_text_vs_jax(tmp_path, capsys):
    """Above 64 spp the default --chunk (min(spp, 64)) renders in chunks
    and prints JAX's progress lines; the camera explanation is JAX's."""
    argv = ["-w3", "-p12", "--size", "2x2"]
    jcli.main(argv + ["--out", str(tmp_path / "j.bmp")])
    jtext = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "t.bmp")])
    ttext = capsys.readouterr().out
    progress = lambda text: [ln.split("(")[0] for ln in text.splitlines()
                             if ln.startswith("  ") and "samples" in ln]
    assert progress(ttext) == progress(jtext) == [
        "  64/144 samples ", "  128/144 samples ", "  144/144 samples "]
    explain = lambda text: text[text.index("DefineCamera"):
                                text.index("direction.") + 10]
    assert explain(ttext) == explain(jtext)
