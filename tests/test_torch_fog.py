"""Fog on the CPU against the JAX package: the fog feature scene (world 6
in fog: the quad form of the volume NEE) and world 3 through the thin lens
with the CLI's fog (the sphere form), the port's render_chunk (the plain
version of the feature kernel) against JAX's XLA wavefront driver at 32x18,
pp=2, under the golden gates (tests/test_torch_render.py); the fog flags of
the CLI, world 1 in fog through the CLI, with the denoiser too.
"""

import dataclasses

import jax.numpy as jnp
import pytest

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import feature_scenes as jfeatures
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.io.bmp import packed_to_rgb, read_bmp
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import feature_scenes as tfeatures
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.camera import define_camera
from test_torch_render import assert_golden_gates

W, H = 32, 18
FOG = dict(fog_sigma_t=0.0012, fog_albedo=(0.9, 0.9, 0.95), fog_g=0.5)


def _chunks(js, jcam, ts, tcam, **cfg_kw):
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(W, H, pp=2, seed=0, **cfg_kw),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(W * H))
    tst = trenderer.render_chunk(ts, tcam, trenderer.RenderConfig(
        W, H, pp=2, seed=0, **cfg_kw), 0, 0, 4, trenderer.init_accum(W * H))
    return jst, tst


@pytest.mark.parametrize("pinhole", [True, False], ids=["pinhole", "lens"])
def test_fog_scene_vs_xla_wavefront(pinhole):
    js, (pos, target, fov), kw = jfeatures.FEATURE_CASES["fog"]()
    ts, _, _ = tfeatures.FEATURE_CASES["fog"]()
    assert ts.quad_light >= 0 and ts.fog_g == 0.5
    tcam = define_camera(pos, target, fov, W, H, use_pinhole=pinhole)
    jst, tst = _chunks(
        js, jdefine_camera(pos, target, fov, W, H, use_pinhole=pinhole),
        ts, tcam, **kw)
    assert cuda_backend.variant(ts, tcam).startswith("feature")
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count)


@pytest.mark.parametrize("kind, pinhole, g", [
    (tschema.WORLD_CORNELL_BOX, False, 0.5),
    (tschema.WORLD_CORNELL_BOX, True, 0.0)], ids=["w3-d", "w3-isotropic"])
def test_fog_world_vs_xla_wavefront(kind, pinhole, g):
    """World 3 with the CLI's fog (dataclasses.replace of the statics, as
    both CLIs apply it): the sphere form of the volume NEE, the thin lens,
    and the isotropic phase function."""
    fog = dict(FOG, fog_g=g)
    js, jcam = jworlds.finalize_world(kind, W, H, use_pinhole=pinhole)
    ts, tcam = tworlds.finalize_world(kind, W, H, use_pinhole=pinhole)
    jst, tst = _chunks(js.replace(**fog), jcam,
                       dataclasses.replace(ts, **fog), tcam)
    assert_golden_gates(jst, tst)


@pytest.mark.parametrize("flags", [["-w6"], ["-w3", "-d"]],
                         ids=["w6", "w3-d"])
def test_cli_fog_writes_an_image(tmp_path, capsys, flags):
    from pathtracer_tpu_torch.cli import main
    out = tmp_path / "fog.bmp"
    assert main(flags + ["--fog", "0.0012", "--fog-albedo", "0.9,0.9,0.95",
                         "--fog-g", "0.5", "--size", "16x9", "-p1",
                         "--device", "cpu", "--out", str(out)]) == 0
    img = packed_to_rgb(read_bmp(str(out)))
    assert img.shape == (9, 16, 3) and img.max() > 0
    assert "0 NaN samples" in capsys.readouterr().out


def test_cli_fog_on_world1_raises(tmp_path):
    """World 1 in fog renders (its combined texture set under the textured
    lockstep kernel's feature form), and with the denoiser on the same
    command too: the same linear image, filtered before the tonemap, so
    its pixels differ from the raw ones; a bad --fog-albedo raises."""
    from pathtracer_tpu_torch.cli import main
    out = tmp_path / "w1.bmp"
    assert main(["-w1", "--fog", "0.0012", "--size", "8x8", "-p2",
                 "--device", "cpu", "--out", str(out)]) == 0
    assert packed_to_rgb(read_bmp(str(out))).max() > 0
    den = tmp_path / "den.bmp"
    assert main(["-w1", "--fog", "0.0012", "--size", "8x8", "-p2",
                 "--device", "cpu", "--denoise", "2", "--out", str(den)]) == 0
    img = packed_to_rgb(read_bmp(str(den)))
    assert img.shape == (8, 8, 3) and img.max() > 0
    assert out.read_bytes() != den.read_bytes()
    with pytest.raises(SystemExit, match="R,G,B"):
        main(["-w3", "--fog", "0.01", "--fog-albedo", "1,1", "--size", "8x8",
              "--device", "cpu", "--out", str(tmp_path / "w3.bmp")])
