"""The fuzz scenes in fog on the port: the twins of tests/test_fuzz.py:149,
:202 and :223 (see tests/test_torch_fuzz.py).

Fog with the Henyey-Greenstein phase and volume NEE, dispersive and plain
glass, Russian roulette, a bump-mapped floor and a UV-textured triangle on
test_fuzz.py's random worlds (the feature bounce with K4t's walk), and
world 6 in the god-rays fog with its quad light, the port's plain version
against JAX's XLA driver at 16x12 (16x10), pp 2, under the golden gates.
"""

import numpy as np
import pytest

from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_fuzz import PACKAGES, _random_world, _render, check_scene
from test_torch_render import assert_golden_gates
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)


def _bump_and_uv(b, rng, base):
    """A bump-mapped floor and a UV-textured triangle at ``base``."""
    bump_tex = np.repeat(rng.rand(8, 8, 1), 3, 2).astype(np.float32)
    bump_tex = (np.round(bump_tex * 255.0) / 255.0).astype(np.float32)
    bm = b.add_material(albedo=(0.5, 0.45, 0.4), roughness=0.9,
                        bump_idx=b.add_texture(bump_tex), bump_scale=0.3)
    b.add_plane((0, 0, 1), 4.0, bm)
    check = (np.indices((8, 8)).sum(0) % 2)[..., None].repeat(3, 2)
    uv_tex = (np.round((check * 0.7 + 0.2) * 255.0) / 255.0
              ).astype(np.float32)
    um = b.add_material(albedo=(1.0, 0.9, 0.8),
                        albedo_idx=b.add_texture(uv_tex), roughness=0.7)
    pts = np.asarray([base + [-1, 0, -1], base + [1, 0, -1],
                      base + [0, 0, 1.2]], np.float32)
    b.set_mesh(pts, np.full(3, um, np.int32),
               uvs=np.asarray([[0, 0], [2, 0], [1, 2]], np.float32))


def _everything(seed, builder_cls):
    """test_fuzz.py:149's scene: fog x dispersive glass x plain glass x a
    bump-mapped floor x a UV-textured triangle on a random world."""
    rng = np.random.RandomState(seed + 7)
    b = _random_world(seed, builder_cls)
    glass = b.add_material(albedo=tuple(0.9 + 0.1 * rng.rand(3)),
                           ior=float(1.3 + 0.4 * rng.rand()),
                           transmission=1.0,
                           dispersion=float(0.05 + 0.1 * rng.rand()))
    b.add_sphere(rng.uniform(-2, 2, 3), 0.6 + rng.rand() * 0.8, glass)
    plain = b.add_material(albedo=(0.95, 0.95, 0.98), ior=1.5,
                           transmission=1.0)
    b.add_sphere(rng.uniform(-2, 2, 3), 0.4 + rng.rand() * 0.5, plain)
    b.set_fog(float(0.02 + 0.04 * rng.rand()),
              albedo=tuple(0.6 + 0.4 * rng.rand(3)),
              g=float(rng.uniform(-0.5, 0.7)))
    _bump_and_uv(b, rng, rng.uniform(-2, 2, 3))
    return b


def _everything_kernel(seed, builder_cls):
    """test_fuzz.py:223's scene: fog x dispersive glass x a bump-mapped
    floor x a UV-textured triangle at the origin."""
    rng = np.random.RandomState(seed + 7)
    b = _random_world(seed, builder_cls)
    glass = b.add_material(albedo=tuple(0.9 + 0.1 * rng.rand(3)),
                           ior=float(1.3 + 0.4 * rng.rand()),
                           transmission=1.0,
                           dispersion=float(0.05 + 0.1 * rng.rand()))
    b.add_sphere(rng.uniform(-2, 2, 3), 0.6 + rng.rand() * 0.8, glass)
    b.set_fog(0.02, albedo=(0.8, 0.85, 0.9), g=0.4)
    _bump_and_uv(b, rng, np.zeros(3))
    return b


@pytest.mark.parametrize("make, seed", [
    (_everything, 5), (_everything, 31),     # test_fuzz.py:149
    (_everything_kernel, 5),                 # test_fuzz.py:223
], ids=["everything5", "everything31", "everything_kernel5"])
def test_everything_vs_xla(make, seed):
    """The scene at its seed, RR on, through both packages under the
    golden gates."""
    check_scene(make, seed, True)


def test_fog_quad_light_vs_xla():
    """The twin of test_fuzz.py:202: world 6 in the god-rays fog (fog and
    the quad light's NEE) at 16x10, pp 2, seed 2."""
    st = {}
    for pkg, worlds in (("jax", jworlds), ("port", tworlds)):
        b, cp = worlds.build_world(worlds.WORLD_CORNELL_QUAD)
        b.set_fog(0.0012, albedo=(0.9, 0.9, 0.95), g=0.5)
        cam = PACKAGES[pkg][1](cp.pos, cp.target, cp.fov, 16, 10)
        st[pkg] = _render(pkg, b, cam, 16, 10, 2, 2, False)
    assert_golden_gates(st["jax"], st["port"])
