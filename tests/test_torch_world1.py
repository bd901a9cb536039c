"""World 1 end to end on the CPU: the port's render_chunk (the plain
version of the textured kernel, the bounce-lockstep loop) against the JAX
package's XLA wavefront renderer at 32x18, pp=2, under the golden gates of
tests/test_torch_render.py (median |diff| < 1e-4, fewer than 5% of pixels
off by more than 1e-2, valid counts equal, rays within 1%), with the
default maps, -nmr, --tbn, --mips and the thin lens (-d)."""

import dataclasses

import jax.numpy as jnp
import pytest

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import textures as ttextures
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_render import assert_golden_gates
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W1 = tschema.WORLD_DEFAULT
W, H, PP = 32, 18, 2
NO_MAPS = dict(use_normal_maps=False, use_metalness_maps=False,
               use_roughness_maps=False)


def _mip_scale(cam):
    """The CLI's --mips constant."""
    return 2.0 * cam.half_film_height / (H * cam.focal_length)


@pytest.mark.parametrize("case", ["default", "nmr", "tbn", "mips", "lens"])
def test_world1_render_chunk_vs_xla_wavefront(case):
    pinhole = case != "lens"
    js, jcam = jworlds.finalize_world(W1, W, H, use_pinhole=pinhole,
                                      res_dir=ttextures.REFERENCE_RES_DIR)
    ts, tcam = tworlds.finalize_world(W1, W, H, use_pinhole=pinhole)
    statics = {"nmr": NO_MAPS, "tbn": dict(tbn_normal_maps=True)}.get(case, {})
    js, ts = js.replace(**statics), dataclasses.replace(ts, **statics)
    mip = _mip_scale(tcam) if case == "mips" else 0.0
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(W, H, pp=PP, seed=0, mip_scale=mip),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(W * H))
    tst = trenderer.render_chunk(
        ts, tcam, trenderer.RenderConfig(W, H, pp=PP, seed=0, mip_scale=mip),
        0, 0, 4, trenderer.init_accum(W * H))
    assert_golden_gates(jst, tst)
    assert tst.samples_done == 4 and int(tst.nan_count) == float(jst.nan_count)
