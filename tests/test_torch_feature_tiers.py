"""The feature bounce (fog, transmission with dispersion, planar and bump
maps) on every base JAX's kernel runs it on, on the CPU against the JAX
package: the port's render_chunk (the plain version of each feature
instantiation) against JAX's XLA wavefront driver at 32x18, pp=2, 4
samples, under the golden gates (tests/test_torch_render.py):

- world 1 in the CLI's fog, pinhole and thin lens: the combined set under
  the lockstep schedule (``feattextured_*``, plain ``render/lockstep.py``);
- world 1 with its textured material made dispersive glass: the combined
  set's albedo weighting the dielectric lobe;
- world 4's 484 spheres with dispersive glass, through a pinhole
  (``featclustered_pinhole``), and world 4 in fog through its thin lens
  (``featclustered_lens``): the sky is world 4's only light and fog
  occludes the sky, so both packages render that black, sample for sample.
  (World 2 in fog goes on the card, against its plain version: JAX's XLA
  compile of world 2 alone takes over a minute on the CPU.)
- world 7 in fog: the streamed walk with UVs (``featmesh_pinhole``);
- world 5's builder with a 784-triangle sphere (the static tier without
  UVs) and world 7's UV sphere at 736 triangles (the static tier with
  UVs, K8), each in fog.

It also checks that ``cuda_backend.variant`` names every feature
instantiation (the DMA tier's by a forced small build, and world 7 with
``tri_dma`` set) and that both schedules of world 1 in fog accumulate the
same sums. The JAX renders are made once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.camera import define_camera
from test_torch_mesh_tiers import force_dma  # noqa: F401 (a fixture)
from test_torch_meshes import mesh_scene, tessellated_sphere, uv_sphere
from test_torch_render import assert_golden_gates
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W, H = 32, 18
FOG = dict(fog_sigma_t=0.0012, fog_albedo=(0.9, 0.9, 0.95), fog_g=0.5)
W1, W2, W4, W7 = (tschema.WORLD_DEFAULT, tschema.WORLD_BRDF_TEST,
                  tschema.WORLD_RAYTRACING_ONE_WEEKEND, tschema.WORLD_MESH_UV)


def _fogged(js, ts):
    return js.replace(**FOG), dataclasses.replace(ts, **FOG)


def _glass(worlds_mod, camera_fn, kind):
    """World ``kind`` built by the same builder calls in either package,
    with dispersive glass: world 4's every seventh sphere (seen through a
    pinhole), or world 1's textured (combined-set) material."""
    b, cp = worlds_mod.build_world(kind)
    if kind == W4:
        m = b.add_material(albedo=(1.0, 1.0, 1.0), roughness=0.0, ior=1.5,
                           transmission=1.0, dispersion=0.05)
        b.spheres = [(c, r, m if i % 7 == 3 and i else mat)
                     for i, (c, r, mat) in enumerate(b.spheres)]
    else:
        for mat in b.materials:
            if mat.albedo_idx:
                mat.transmission, mat.ior, mat.dispersion = 1.0, 1.5, 0.05
    scene = b.finalize(world_kind=kind, view_origin=cp.pos)
    return scene, camera_fn(cp.pos, cp.target, cp.fov, W, H,
                            use_pinhole=True,
                            focal_distance=cp.focal_distance,
                            aperture_radius=cp.aperture_radius)


def _fog_world(kind, pinhole=True):
    """World ``kind`` in the CLI's fog, both packages."""
    js, jcam = jworlds.finalize_world(kind, W, H, use_pinhole=pinhole)
    ts, tcam = tworlds.finalize_world(kind, W, H, use_pinhole=pinhole)
    js, ts = _fogged(js, ts)
    return js, jcam, ts, tcam


def _fog_mesh(tris, uvs=None):
    """World 5's builder with ``tris`` (and ``uvs``) in fog, both
    packages."""
    js, jcam = mesh_scene(jworlds, tris, uvs)
    ts, tcam = mesh_scene(tworlds, tris, uvs)
    js, ts = _fogged(js, ts)
    return js, jcam, ts, tcam


CASES = {  # case -> (the scenes and cameras of both packages, variant)
    "w1-fog": (lambda: _fog_world(W1), "feattextured_pinhole"),
    "w1-fog-d": (lambda: _fog_world(W1, False), "feattextured_lens"),
    "w1-glass": (lambda: (*_glass(jworlds, jdefine_camera, W1),
                          *_glass(tworlds, define_camera, W1)),
                 "feattextured_pinhole"),
    "w4-glass": (lambda: (*_glass(jworlds, jdefine_camera, W4),
                          *_glass(tworlds, define_camera, W4)),
                 "featclustered_pinhole"),
    "w4-fog-d": (lambda: _fog_world(W4, False), "featclustered_lens"),
    "w7-fog": (lambda: _fog_world(W7), "featmesh_pinhole"),
    "tri784-fog": (lambda: _fog_mesh(tessellated_sphere(800)),
                   "featstaticplain_pinhole"),
    "uv736-fog": (lambda: _fog_mesh(*uv_sphere(16, 24)),
                  "featstatic_pinhole"),
}


@pytest.fixture(scope="module")
def renders():
    """case -> (JAX accumulator, port scene, port camera), made once."""
    cache = {}

    def get(case):
        if case not in cache:
            js, jcam, ts, tcam = CASES[case][0]()
            jst = jrenderer.render_chunk(
                js, jcam, jrenderer.RenderConfig(W, H, pp=2, seed=0),
                jprng.base_key(0), jnp.int32(0), 4,
                jrenderer.init_accum(W * H))
            cache[case] = (jst, ts, tcam)
        return cache[case]
    return get


@pytest.mark.parametrize("case", [c for c in CASES if c != "w4-fog-d"])
def test_feature_base_vs_xla(renders, case):
    jst, ts, tcam = renders(case)
    assert cuda_backend.variant(ts, tcam) == CASES[case][1]
    tst = trenderer.render_chunk(ts, tcam, trenderer.RenderConfig(
        W, H, pp=2, seed=0), 0, 0, 4, trenderer.init_accum(W * H))
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count)


def test_world4_in_fog_is_black_as_in_jax(renders):
    """World 4's only light is the sky and fog occludes the sky (every sky
    ray scatters), so both packages accumulate zeros, with equal valid
    counts and rays within 1%."""
    jst, ts, tcam = renders("w4-fog-d")
    assert ts.sph_clusters and not tcam.use_pinhole
    assert cuda_backend.variant(ts, tcam) == "featclustered_lens"
    tst = trenderer.render_chunk(ts, tcam, trenderer.RenderConfig(
        W, H, pp=2, seed=0), 0, 0, 4, trenderer.init_accum(W * H))
    assert float(np.abs(np.asarray(jst.sum)).max()) == 0.0
    assert all(float(c.abs().max()) == 0.0 for c in tst.sum)
    np.testing.assert_array_equal(np.asarray(jst.count), tst.count.numpy())
    jr, tr = float(jst.rays_cast), int(tst.rays_cast)
    assert abs(jr - tr) <= 0.01 * jr and tr > W * H * 4


def test_world1_fog_schedules_agree(renders):
    """World 1 in fog under the lockstep loop and the regeneration loop:
    the same sums, counts and rays."""
    _, ts, tcam = renders("w1-fog")
    cfg = trenderer.RenderConfig(W, H, pp=2, seed=0)
    out = [cuda_backend.render_chunk_plain(
        ts, tcam, dataclasses.replace(cfg, schedule=s), 0, 0, 4,
        trenderer.init_accum(W * H)) for s in ("lockstep", "regen")]
    for a, b in zip(out[0].sum + out[0].sum_sq, out[1].sum + out[1].sum_sq):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert torch.equal(out[0].count, out[1].count)
    assert int(out[0].rays_cast) == int(out[1].rays_cast)


def _tier(case, pinhole=True):
    """(scene, camera) of a mesh-tier case in fog, 8x8."""
    tris, uvs = {"tri784": (tessellated_sphere(800), None),
                 "uv736": uv_sphere(16, 24),
                 "tri1936": (tessellated_sphere(2000), None),
                 "dma1936": (tessellated_sphere(2000), None),
                 "dma1984uv": uv_sphere(32, 32)}[case]
    ts, cam = mesh_scene(tworlds, tris, uvs, 8, 8, pinhole=pinhole)
    return dataclasses.replace(ts, **FOG), cam


@pytest.mark.parametrize("case, pinhole, schedule, want", [
    ("tri784", True, None, "featstaticplain_pinhole"),
    ("tri784", False, None, "featstaticplain_lens"),
    ("uv736", True, None, "featstatic_pinhole"),
    ("uv736", False, None, "featstatic_lens"),
    ("tri1936", True, None, "featmeshplain_pinhole"),
    ("tri1936", False, None, "featmeshplain_lens"),
    ("dma1936", True, None, "featmeshplain_pinhole"),
    ("dma1936", False, None, "featmeshplain_lens"),
    ("dma1984uv", True, None, "featmesh_pinhole"),
    ("dma1984uv", False, None, "featmesh_lens"),
    ("w7", True, None, "featmesh_pinhole"),
    ("w7", False, None, "featmesh_lens"),
    ("w7", True, "regen", "featmesh_pinhole_regen"),
    ("w7-dma", True, None, "featmesh_pinhole"),
    ("w2", True, None, "featclustered_pinhole"),
    ("w1", True, "regen", "feattextured_pinhole_regen"),
    ("w3", True, "lockstep", "feature_pinhole_lockstep"),
    ("w3", True, "regen", "feature_pinhole"),
])
def test_feature_variant_names(request, case, pinhole, schedule, want):
    """Each feature instantiation by the scene, camera and schedule that
    pick it; the DMA tier's forced on a small mesh, world 7 with tri_dma
    set (a plain flag) keeps the resident walk."""
    if case.startswith("dma"):
        request.getfixturevalue("force_dma")
    if case.startswith("w"):
        kind = {"w1": W1, "w2": W2, "w3": tschema.WORLD_CORNELL_BOX,
                "w7": W7}[case[:2]]
        ts, cam = tworlds.finalize_world(kind, 8, 8, use_pinhole=pinhole)
        ts = dataclasses.replace(ts, tri_dma=case.endswith("dma"), **FOG)
    else:
        ts, cam = _tier(case, pinhole)
    assert ts.unsupported() == []
    assert cuda_backend.variant(ts, cam, schedule) == want
    assert want in cuda_backend.VARIANTS


@pytest.mark.parametrize("case, schedule", [
    ("tri784", "regen"), ("w2", "lockstep"), ("w1-d", "regen")])
def test_feature_schedules_without_an_instantiation_raise(case, schedule):
    """A schedule a feature base does not instantiate raises before any
    launch, naming the variant."""
    if case == "tri784":
        ts, cam = _tier(case)
    else:
        ts, cam = tworlds.finalize_world(
            {"w2": W2, "w1-d": W1}[case], 8, 8,
            use_pinhole=not case.endswith("-d"))
        ts = dataclasses.replace(ts, **FOG)
    with pytest.raises(NotImplementedError, match="feat.*pinhole only"):
        cuda_backend.render_chunk_cuda(
            ts, cam, trenderer.RenderConfig(8, 8, pp=1, schedule=schedule),
            0, 0, 1, trenderer.init_accum(64))
