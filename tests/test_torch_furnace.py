"""White-furnace energy gates on the port: the twins of tests/test_furnace.py.

The port's plain version renders the same scenes (its own ``WorldBuilder``
and camera, at the same size, spp and seeds) under the same analytic gates:
a lossless glass sphere under a constant environment returns exactly 0 or
the sky on every sample; its dispersive form stays quantized on the sky's
channels with an unbiased mean; a Lambertian albedo-1 surface integrates
the sky back to just under 1. The twin of ``:114`` holds the port's plain
version against JAX's XLA render of the furnace under the golden gates
(tests/test_torch_render.py::assert_golden_gates).
"""

import numpy as np

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu.scene.schema import WorldBuilder as JWorldBuilder
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene.camera import define_camera
from pathtracer_tpu_torch.scene.schema import WorldBuilder
from test_furnace import SKY, W, H
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)
from test_torch_render import assert_golden_gates


def furnace_world(builder_cls, camera_fn, dispersion=0.0):
    """test_furnace.furnace_world with the given builder and camera."""
    b = builder_cls()
    b.add_material(emit=SKY)  # material 0 = the constant environment
    glass = b.add_material(albedo=(1.0, 1.0, 1.0), ior=1.5,
                           transmission=1.0, roughness=0.0,
                           dispersion=dispersion)
    b.add_sphere((0.0, 0.0, 0.0), 1.2, glass)
    return b, camera_fn((0, -4, 0.2), (0, 0, 0), 45.0, W, H)


def _render(b, cam, pp, seed):
    cfg = trenderer.RenderConfig(W, H, pp=pp, seed=seed)
    img, _, st = trenderer.render_image(b.finalize(), cam, cfg, device="cpu")
    return img.numpy(), st


def test_per_sample_radiance_is_exactly_zero_or_sky():
    """Every 1-spp pixel is bit-exactly the sky (escaped) or 0 (killed at
    the depth limit inside the glass), most of them the sky."""
    b, cam = furnace_world(WorldBuilder, define_camera)
    assert cuda_backend.variant(b.finalize(), cam) == "feature_pinhole"
    img, _ = _render(b, cam, 1, 7)
    sky = np.array(SKY, np.float32)
    is_sky = np.all(img == sky, axis=-1)
    is_dead = np.all(img == 0.0, axis=-1)
    assert np.all(is_sky | is_dead), (
        f"off-furnace pixels: {img[~(is_sky | is_dead)][:4]}")
    assert is_sky.mean() > 0.8, f"escape fraction {is_sky.mean():.3f}"


def test_dispersive_furnace_exact_support_and_mean():
    """Each sample adds 0, the sky or 3x one channel of it: every channel
    times spp is a whole multiple of the sky's, and the mean is the sky's
    within 5%, the channels within 10% of each other."""
    b, cam = furnace_world(WorldBuilder, define_camera, dispersion=0.02)
    img, _ = _render(b, cam, 4, 7)
    sky = np.array(SKY, np.float32)
    mult = img * 16 / sky
    assert np.all(np.abs(mult - np.round(mult)) < 1e-3), (
        "per-channel values are not sky_c-quantized: energy leak")
    assert np.all(np.round(mult) >= 0) and np.all(np.round(mult) <= 3 * 16)
    ratio = img.mean(axis=(0, 1)) / sky
    assert np.all(np.abs(ratio - 1.0) < 0.05), f"mean/sky {ratio}"
    assert ratio.max() - ratio.min() < 0.1, f"channel skew {ratio}"


def test_diffuse_surface_furnace_statistical():
    """The surface estimator's energy (brdf * 2/px over the mixture pdf):
    an albedo-1 Lambertian sphere under the sky integrates to 0.94-1.02 of
    it (JAX observed 0.9855 at this seed)."""
    b = WorldBuilder()
    b.add_material(emit=SKY)
    anchor = b.add_material(albedo=(0, 0, 0))
    b.add_sphere((0.0, 0.0, -500.0), 0.5, anchor)  # far NEE anchor
    d = b.add_material(albedo=(1.0, 1.0, 1.0), roughness=1.0)
    b.add_sphere((0.0, 6.0, 0.0), 3.0, d)
    cam = define_camera((0, -2, 0), (0, 6, 0), 30.0, W, H)
    img, _ = _render(b, cam, 8, 3)
    ratio = img.mean(axis=(0, 1)) / np.array(SKY, np.float32)
    assert np.all(ratio > 0.94) and np.all(ratio < 1.02), (
        f"surface estimator energy off: mean/sky {ratio}")


def test_plain_version_matches_xla_on_the_furnace():
    """The twin of test_furnace.py:114 (JAX's kernel against its XLA
    driver, bit-equal): the port's plain version of the kernel against
    JAX's XLA render of the furnace, under the golden gates, its pixels
    still exactly 0 or the sky."""
    jb, jcam = furnace_world(JWorldBuilder, jdefine_camera)
    _, _, jst = jrenderer.render_image(
        jb.finalize(), jcam, jrenderer.RenderConfig(width=W, height=H, pp=2,
                                                    seed=7))
    b, cam = furnace_world(WorldBuilder, define_camera)
    img, tst = _render(b, cam, 2, 7)
    assert_golden_gates(jst, tst)
    # each pixel's sum is k whole skies, k = 0 .. 4, the same k on every
    # channel
    k = np.stack([t.numpy() for t in tst.sum], -1) / np.float32(SKY)
    assert np.allclose(k, np.round(k[..., :1]), rtol=0, atol=1e-5)
    assert np.all((k >= 0) & (k <= 4.00001)) and np.isfinite(img).all()
