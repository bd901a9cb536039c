"""Random scenes on the port: the twins of tests/test_fuzz.py.

JAX's fuzz tests hold its renderer to the scalar oracle (not ported) on
random mixes of emissive, metal, smooth and rough materials, overlapping
spheres, planes and quads and lights of random size, with glass, Russian
roulette, dispersion, fog, a bump-mapped floor and a UV-textured triangle;
and its kernel to its XLA driver on the god-rays and the everything-at-once
scenes. Here the port's plain version renders the same scenes at the same
16x12 (16x10) and pp 2 with the same seeds and is held to JAX's XLA driver
under the golden gates (tests/test_torch_render.py::assert_golden_gates).
``_random_world`` is test_fuzz.py's, taking the builder class (one scene
for each package from the same numpy draws). The scenes with fog
(test_fuzz.py:149, :202, :223) are in tests/test_torch_fuzz_features.py; the twin of test_fuzz.py:93 is
tests/test_torch_mixed_bases.py::test_textured_mesh_scene_kernel_
equivalence.
"""

import numpy as np
import pytest

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu.scene.schema import WorldBuilder as JWorldBuilder
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene.camera import define_camera
from pathtracer_tpu_torch.scene.schema import WorldBuilder
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)
from test_torch_render import assert_golden_gates

PACKAGES = {"jax": (JWorldBuilder, jdefine_camera),
            "port": (WorldBuilder, define_camera)}


def _random_world(seed: int, builder_cls):
    """test_fuzz.py:18-45 with the builder class as an argument."""
    rng = np.random.RandomState(seed)
    b = builder_cls()
    b.add_material(emit=tuple(rng.rand(3) * (rng.rand() < 0.7)))
    light = b.add_material(albedo=(0, 0, 0), emit=tuple(2 + 20 * rng.rand(3)))
    b.add_sphere(rng.uniform(-3, 3, 3) + (0, 0, 4), 0.5 + rng.rand(), light)
    for _ in range(rng.randint(2, 7)):
        kind = rng.randint(3)
        smooth = rng.rand() < 0.4
        m = b.add_material(
            albedo=tuple(rng.rand(3)),
            metalness=float(rng.rand() * (rng.rand() < 0.5)),
            metal_color=tuple(rng.rand(3)),
            roughness=0.0 if smooth else float(rng.rand()),
            ior=float(1.0 + 0.5 * rng.rand()),
        )
        if kind == 0:
            b.add_sphere(rng.uniform(-3, 3, 3), 0.3 + rng.rand(), m)
        elif kind == 1:
            n = rng.randn(3)
            n /= np.linalg.norm(n)
            b.add_plane(tuple(n), float(rng.uniform(-4, -2)), m)
        else:
            b.add_quad(rng.uniform(-3, 3, 3), rng.uniform(-2, 2, 3),
                       rng.uniform(-2, 2, 3), m)
    return b


def _glass(seed, builder_cls):
    """test_fuzz.py:68's scene: a random world with a glass sphere."""
    rng = np.random.RandomState(seed)
    b = _random_world(seed, builder_cls)
    glass = b.add_material(albedo=tuple(0.9 + 0.1 * rng.rand(3)),
                           ior=float(1.3 + 0.4 * rng.rand()),
                           transmission=1.0)
    b.add_sphere(rng.uniform(-2, 2, 3), 0.6 + rng.rand() * 0.8, glass)
    return b


SCENES = {  # name -> (builder(seed, builder_cls), seed, RR)
    "random7": (_random_world, 7, False),        # test_fuzz.py:50
    "random21": (_random_world, 21, False),
    "random1001": (_random_world, 1001, False),
    "glass17": (_glass, 17, True),               # test_fuzz.py:68
    "glass99": (_glass, 99, True),
    "rr42": (_random_world, 42, True),           # test_fuzz.py:130
}


def _render(pkg, b, cam, w, h, pp, seed, rr):
    if pkg == "jax":
        cfg = jrenderer.RenderConfig(width=w, height=h, pp=pp, seed=seed,
                                     use_russian_roulette=rr)
        return jrenderer.render_image(b.finalize(), cam, cfg)[2]
    cfg = trenderer.RenderConfig(w, h, pp=pp, seed=seed,
                                 use_russian_roulette=rr)
    return trenderer.render_image(b.finalize(), cam, cfg, device="cpu")[2]


@pytest.mark.parametrize("name", list(SCENES))
def test_random_scene_vs_xla(name):
    """Each fuzz scene at 16x12, pp 2 (the seed's own), the port's plain
    version against JAX's XLA driver under the golden gates, finite."""
    check_scene(*SCENES[name])


def check_scene(make, seed, rr):
    """``make(seed, builder_cls)``'s scene through both packages at 16x12,
    pp 2, under the golden gates; the port's sums finite."""
    st = {}
    for pkg, (builder_cls, camera_fn) in PACKAGES.items():
        cam = camera_fn((0, -8, 1), (0, 0, 0), 35.0, 16, 12)
        st[pkg] = _render(pkg, make(seed, builder_cls), cam, 16, 12, 2, seed,
                          rr)
    assert_golden_gates(st["jax"], st["port"])
    assert all(np.isfinite(t.numpy()).all() for t in st["port"].sum)

