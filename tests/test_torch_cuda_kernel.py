"""The hand-written CUDA kernel against its plain PyTorch version, on the
card. Skipped where there is no CUDA device (the kernel has no CPU mode).

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py

Gates (bench.py --verify's): fewer than 1% of pixels with resolved
|diff| > 1e-3 and 0.1% with |diff| > 0.1, equal valid-sample counts, ray
counts within 0.5%. Both sides evaluate the same float32 expressions
without contraction; only sin/cos ulps could flip a discrete choice.
"""

import dataclasses

import pytest
import torch

from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds

W4 = tschema.WORLD_RAYTRACING_ONE_WEEKEND
W1 = tschema.WORLD_DEFAULT
NO_MAPS = dict(use_normal_maps=False, use_metalness_maps=False,
               use_roughness_maps=False)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda:0")


def _pair(dev, kind, w, h, pp, n, use_pinhole=True, brute=False,
          variant=None, schedule=None, statics=None, **cfg_kw):
    scene, cam = tworlds.finalize_world(kind, w, h, use_pinhole=use_pinhole)
    scene = dataclasses.replace(scene, **(statics or {}))
    scene = (scene.without_clusters() if brute else scene).to(dev)
    cfg = trenderer.RenderConfig(w, h, pp=pp, seed=0, schedule=schedule,
                                 **cfg_kw)
    if variant is not None:
        assert cuda_backend.variant(scene, cam, schedule) == variant
    before = cuda_backend.LAUNCHES
    k = cuda_backend.render_chunk_cuda(scene, cam, cfg, 0, 0, n,
                                       trenderer.init_accum(w * h, dev))
    assert cuda_backend.LAUNCHES == before + 1
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, n,
                                        trenderer.init_accum(w * h, dev))
    torch.cuda.synchronize()
    return cfg, k, p


def _assert_verify_gates(cfg, k, p):
    d = (trenderer.resolve(k, cfg) - trenderer.resolve(p, cfg)).abs().amax(-1)
    assert float((d > 1e-3).float().mean()) < 0.01
    assert float((d > 0.1).float().mean()) < 0.001
    assert torch.equal(k.count, p.count)
    assert abs(int(k.rays_cast) - int(p.rays_cast)) <= 0.005 * int(p.rays_cast)
    assert k.samples_done == p.samples_done


@pytest.mark.parametrize("kind, pp, n", [
    (tschema.WORLD_CORNELL_BOX, 4, 16),
    (tschema.WORLD_CORNELL_QUAD, 4, 16),
    (tschema.WORLD_BRDF_TEST, 2, 4),
])
def test_kernel_matches_plain(cuda, kind, pp, n):
    _assert_verify_gates(*_pair(cuda, kind, 256, 144, pp, n))


@pytest.mark.parametrize("kind, pinhole, brute, variant", [
    (W4, True, False, "clustered_lens"),            # w4 forces the lens
    (tschema.WORLD_BRDF_TEST, True, False, "clustered_pinhole"),
    (tschema.WORLD_BRDF_TEST, True, True, "brute_pinhole"),
    (tschema.WORLD_CORNELL_BOX, False, False, "brute_lens"),
    (W4, True, True, "brute_lens"),
])
def test_kernel_variants_match_plain(cuda, kind, pinhole, brute, variant):
    _assert_verify_gates(*_pair(cuda, kind, 256, 144, 2, 4,
                                use_pinhole=pinhole, brute=brute,
                                variant=variant))


def _mip_scale(w, h):
    _, cam = tworlds.finalize_world(W1, w, h)
    return 2.0 * cam.half_film_height / (h * cam.focal_length)


@pytest.mark.parametrize("schedule, pinhole, statics, mips, rr", [
    ("lockstep", True, None, False, False),
    ("regen", True, None, False, False),
    (None, False, None, False, False),                      # textured lens
    ("lockstep", True, None, True, False),                  # --mips
    ("regen", True, None, True, False),
    ("lockstep", True, dict(tbn_normal_maps=True), False, False),  # --tbn
    ("regen", True, dict(tbn_normal_maps=True), False, True),
    ("lockstep", True, NO_MAPS, False, True),               # -nmr, --rr
])
def test_textured_kernel_matches_plain(cuda, schedule, pinhole, statics,
                                       mips, rr):
    """World 1 at 64x36 through the textured variants, each schedule
    against its plain version (lockstep: render/lockstep.py; regen:
    render/wavefront.py)."""
    scene, cam = tworlds.finalize_world(W1, 64, 36, use_pinhole=pinhole)
    want = cuda_backend.variant(scene, cam, schedule)
    assert want.startswith("textured")
    _assert_verify_gates(*_pair(
        cuda, W1, 64, 36, 2, 4, use_pinhole=pinhole, variant=want,
        schedule=schedule, statics=statics,
        mip_scale=_mip_scale(64, 36) if mips else 0.0,
        use_russian_roulette=rr))


def test_textured_schedules_agree(cuda):
    """Both textured schedules accumulate the same image."""
    scene, cam = tworlds.finalize_world(W1, 64, 36)
    scene = scene.to(cuda)
    out = []
    for schedule in ("lockstep", "regen"):
        cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0, schedule=schedule)
        out.append(cuda_backend.render_chunk_cuda(
            scene, cam, cfg, 0, 0, 4, trenderer.init_accum(64 * 36, cuda)))
    assert torch.equal(trenderer.resolve(out[0], cfg),
                       trenderer.resolve(out[1], cfg))
    assert int(out[0].rays_cast) == int(out[1].rays_cast)


@pytest.mark.parametrize("schedule, pinhole, variant", [
    (None, True, "mesh_pinhole"),
    (None, False, "mesh_lens"),
    (cuda_backend.MESH_OTHER_SCHEDULE, True,
     f"mesh_pinhole_{cuda_backend.MESH_OTHER_SCHEDULE}"),
])
def test_mesh_kernel_matches_plain(cuda, schedule, pinhole, variant):
    """World 7 at 64x36 through the mesh variants (the streamed walk K7 and
    the mesh-UV fetch K10), each against its plain version."""
    _assert_verify_gates(*_pair(
        cuda, tschema.WORLD_MESH_UV, 64, 36, 2, 4, use_pinhole=pinhole,
        variant=variant, schedule=schedule))


def test_mesh_schedules_agree(cuda):
    """Both mesh schedules accumulate the same image."""
    scene, cam = tworlds.finalize_world(tschema.WORLD_MESH_UV, 64, 36)
    scene = scene.to(cuda)
    out = []
    for schedule in ("lockstep", "regen"):
        cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0, schedule=schedule)
        out.append(cuda_backend.render_chunk_cuda(
            scene, cam, cfg, 0, 0, 4, trenderer.init_accum(64 * 36, cuda)))
    assert torch.equal(trenderer.resolve(out[0], cfg),
                       trenderer.resolve(out[1], cfg))
    assert int(out[0].rays_cast) == int(out[1].rays_cast)


def test_clustered_kernel_equals_brute_kernel(cuda):
    """World 4: the K5 walk finds the brute sweep's hits, so the two
    kernel variants accumulate the same image."""
    scene, cam = tworlds.finalize_world(W4, 128, 72)
    cfg = trenderer.RenderConfig(128, 72, pp=2, seed=0)
    out = []
    for sc in (scene, scene.without_clusters()):
        st = cuda_backend.render_chunk_cuda(sc.to(cuda), cam, cfg, 0, 0, 4,
                                            trenderer.init_accum(128 * 72,
                                                                 cuda))
        out.append(trenderer.resolve(st, cfg))
    assert torch.equal(out[0], out[1])


def test_kernel_matches_plain_with_rr_and_offset(cuda):
    scene, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 96, 54)
    scene = scene.to(cuda)
    cfg = trenderer.RenderConfig(96, 54, pp=3, seed=7,
                                 use_russian_roulette=True)
    k = cuda_backend.render_chunk_cuda(scene, cam, cfg, 7, 3, 6,
                                       trenderer.init_accum(96 * 54, cuda))
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 7, 3, 6,
                                        trenderer.init_accum(96 * 54, cuda))
    _assert_verify_gates(cfg, k, p)


def test_render_image_chunked_resume_on_card(cuda):
    scene, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_QUAD, 64, 36)
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=1)
    _, pk1, st1 = trenderer.render_image(scene, cam, cfg, device=cuda)
    _, pk2, st2 = trenderer.render_image(scene, cam, cfg, chunk_samples=3,
                                         device=cuda)
    assert torch.equal(st1.count, st2.count)
    assert torch.equal(pk1, pk2)


def test_kernel_rejects_bad_accumulator(cuda):
    scene, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8)
    scene = scene.to(cuda)
    st = trenderer.init_accum(8 * 8, cuda)
    st.count = st.count.double()
    with pytest.raises(ValueError, match="count"):
        cuda_backend.render_chunk_cuda(scene, cam,
                                       trenderer.RenderConfig(8, 8, pp=1),
                                       0, 0, 1, st)


@pytest.mark.parametrize("name, pinhole", [
    ("bump", True), ("tbn", True), ("fog", True), ("dispersion", True),
    ("everything", True), ("everything", False), ("fog", False)])
def test_feature_kernel_matches_plain(cuda, name, pinhole):
    """The five feature scenes at 64x36 through the feature variants (fog,
    transmission with dispersion, planar and bump maps, the brute UV
    triangle sweep) against the plain regeneration loop."""
    from pathtracer_tpu_torch.scene.camera import define_camera
    from pathtracer_tpu_torch.scene.feature_scenes import FEATURE_CASES
    scene, (pos, target, fov), cfg_kw = FEATURE_CASES[name]()
    cam = define_camera(pos, target, fov, 64, 36, use_pinhole=pinhole)
    scene = scene.to(cuda)
    assert cuda_backend.variant(scene, cam) == (
        ("feature_pinhole" if pinhole else "feature_lens")
        + ("_k4t" if name == "everything" else ""))
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0, **cfg_kw)
    before = cuda_backend.LAUNCHES
    k = cuda_backend.render_chunk_cuda(scene, cam, cfg, 0, 0, 4,
                                       trenderer.init_accum(64 * 36, cuda))
    assert cuda_backend.LAUNCHES == before + 1
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 4,
                                        trenderer.init_accum(64 * 36, cuda))
    torch.cuda.synchronize()
    _assert_verify_gates(cfg, k, p)


@pytest.mark.parametrize("kind, pinhole", [
    (tschema.WORLD_CORNELL_QUAD, True), (tschema.WORLD_CORNELL_BOX, False)])
def test_fog_world_kernel_matches_plain(cuda, kind, pinhole):
    """-w6 and -w3 -d with --fog 0.0012 --fog-albedo 0.9,0.9,0.95
    --fog-g 0.5: the quad and the sphere form of the volume NEE."""
    fog = dict(fog_sigma_t=0.0012, fog_albedo=(0.9, 0.9, 0.95), fog_g=0.5)
    _assert_verify_gates(*_pair(
        cuda, kind, 64, 36, 2, 4, use_pinhole=pinhole, statics=fog,
        variant="feature_pinhole" if pinhole else "feature_lens"))


def test_planar_maps_kernel_matches_plain(cuda):
    """World 1 with three planar 512x512 maps (albedo, metalness,
    roughness: no combined set) through the feature variant."""
    b, cam_p = tworlds.build_world(W1)
    b.textures = b.textures[:3]
    for m in b.materials:
        m.normal_idx = 0
    scene = b.finalize(view_origin=cam_p.pos)
    _, cam = tworlds.finalize_world(W1, 64, 36)
    assert scene.planar_maps
    scene = scene.to(cuda)
    assert cuda_backend.variant(scene, cam) == "feature_pinhole"
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0)
    k = cuda_backend.render_chunk_cuda(scene, cam, cfg, 0, 0, 4,
                                       trenderer.init_accum(64 * 36, cuda))
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 4,
                                        trenderer.init_accum(64 * 36, cuda))
    torch.cuda.synchronize()
    _assert_verify_gates(cfg, k, p)


def _tier_scene(case, monkeypatch):
    """A mesh-tier case of tests/test_torch_meshes.py on world 5's ground,
    the DMA cases forced on a small mesh (parents of 4 clusters,
    grandparents from 4 parents)."""
    from pathtracer_tpu_torch.scene import clusters as tclusters
    from test_torch_meshes import (
        lat_long_sphere, tessellated_sphere, uv_sphere,
    )
    if case.startswith("dma"):
        monkeypatch.setattr(tclusters, "STREAM_MAX", 1024)
        monkeypatch.setattr(tclusters, "PARENT_GROUP", 4)
        monkeypatch.setattr(tclusters, "GPARENT_MIN", 4)
    return {"tri40": lambda: (lat_long_sphere(4, 5), None),
            "tri784": lambda: (tessellated_sphere(800), None),
            "uv736": lambda: uv_sphere(16, 24),
            "tri1936": lambda: (tessellated_sphere(2000), None),
            "dma1936": lambda: (tessellated_sphere(2000), None),
            "dma1984uv": lambda: uv_sphere(32, 32)}[case]()


@pytest.mark.parametrize("case, pinhole, schedule, variant", [
    ("tri40", True, None, "feature_pinhole_k4t"),   # K4t without UVs
    ("tri40", False, None, "feature_lens_k4t"),
    ("tri784", True, None, "staticplain_pinhole"),  # K5's triangle form
    ("tri784", False, None, "staticplain_lens"),
    ("tri784", True, cuda_backend.MESH_OTHER_SCHEDULE,
     f"staticplain_pinhole_{cuda_backend.MESH_OTHER_SCHEDULE}"),
    ("uv736", True, None, "static_pinhole"),        # K8
    ("uv736", False, None, "static_lens"),
    ("tri1936", True, None, "meshplain_pinhole"),   # K7 without UVs
    ("tri1936", False, None, "meshplain_lens"),
    ("dma1936", True, None, "meshplain_pinhole"),  # K7's DMA tier
    ("dma1936", False, None, "meshplain_lens"),
    ("dma1984uv", True, None, "mesh_pinhole"),
    ("dma1984uv", False, None, "mesh_lens"),
])
def test_mesh_tier_kernels_match_plain(cuda, monkeypatch, case, pinhole,
                                       schedule, variant):
    """Each mesh-tier instantiation at 64x36 against its plain version."""
    from test_torch_meshes import mesh_scene
    tris, uvs = _tier_scene(case, monkeypatch)
    scene, cam = mesh_scene(tworlds, tris, uvs, 64, 36, pinhole=pinhole)
    scene = scene.to(cuda)
    assert cuda_backend.variant(scene, cam, schedule) == variant
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0, schedule=schedule)
    before = cuda_backend.VARIANT_LAUNCHES[variant]
    k = cuda_backend.render_chunk_cuda(scene, cam, cfg, 0, 0, 4,
                                       trenderer.init_accum(64 * 36, cuda))
    assert cuda_backend.VARIANT_LAUNCHES[variant] == before + 1
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 4,
                                        trenderer.init_accum(64 * 36, cuda))
    torch.cuda.synchronize()
    _assert_verify_gates(cfg, k, p)


@pytest.mark.parametrize("case", ["dma1936", "dma1984uv"])
def test_dma_tier_kernel_bit_equal_to_resident(cuda, monkeypatch, case):
    """The same mesh through the resident walk, the DMA tier's walk with
    grandparents and without them: bit-equal kernel renders."""
    from pathtracer_tpu_torch.scene import clusters as tclusters
    from test_torch_meshes import mesh_scene
    tris, uvs = _tier_scene(case, monkeypatch)
    monkeypatch.setattr(tclusters, "STREAM_MAX", 1 << 20)
    resident, cam = mesh_scene(tworlds, tris, uvs, 64, 36)
    monkeypatch.setattr(tclusters, "STREAM_MAX", 1024)
    gp, _ = mesh_scene(tworlds, tris, uvs, 64, 36)
    monkeypatch.setattr(tclusters, "GPARENT_MIN", 1 << 30)
    flat, _ = mesh_scene(tworlds, tris, uvs, 64, 36)
    assert gp.stream_gparents and not flat.stream_gparents
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0)
    out = [cuda_backend.render_chunk_cuda(s.to(cuda), cam, cfg, 0, 0, 4,
                                          trenderer.init_accum(64 * 36, cuda))
           for s in (resident, gp, flat)]
    for st in out[1:]:
        for a, b in zip(out[0].sum, st.sum):
            assert torch.equal(a, b)
        assert int(st.rays_cast) == int(out[0].rays_cast)


FOG = dict(fog_sigma_t=0.0012, fog_albedo=(0.9, 0.9, 0.95), fog_g=0.5)


@pytest.mark.parametrize("kind, pinhole, schedule, variant", [
    (W1, True, None, "feattextured_pinhole"),
    (W1, False, None, "feattextured_lens"),
    (W1, True, "regen", "feattextured_pinhole_regen"),
    (tschema.WORLD_BRDF_TEST, True, None, "featclustered_pinhole"),
    (tschema.WORLD_BRDF_TEST, False, None, "featclustered_lens"),
    (W4, True, None, "featclustered_lens"),
    (tschema.WORLD_MESH_UV, True, None, "featmesh_pinhole"),
    (tschema.WORLD_MESH_UV, False, None, "featmesh_lens"),
    (tschema.WORLD_MESH_UV, True, "regen", "featmesh_pinhole_regen"),
    (tschema.WORLD_CORNELL_QUAD, True, "lockstep",
     "feature_pinhole_lockstep"),
])
def test_fog_base_kernels_match_plain(cuda, kind, pinhole, schedule,
                                      variant):
    """Worlds 1, 2, 4, 7 and 6 in the CLI's fog at 64x36 through the
    feature forms of their bases (the combined set under lockstep, sphere
    clusters, the streamed walk with UVs) and the yardstick schedules."""
    _assert_verify_gates(*_pair(cuda, kind, 64, 36, 2, 4,
                                use_pinhole=pinhole, statics=FOG,
                                variant=variant, schedule=schedule))


@pytest.mark.parametrize("case, pinhole, variant", [
    ("tri784", True, "featstaticplain_pinhole"),
    ("tri784", False, "featstaticplain_lens"),
    ("uv736", True, "featstatic_pinhole"),
    ("uv736", False, "featstatic_lens"),
    ("tri1936", True, "featmeshplain_pinhole"),
    ("tri1936", False, "featmeshplain_lens"),
    ("dma1936", True, "featmeshplain_pinhole"),
    ("dma1936", False, "featmeshplain_lens"),
    ("dma1984uv", True, "featmesh_pinhole"),
    ("dma1984uv", False, "featmesh_lens"),
])
def test_fog_mesh_tier_kernels_match_plain(cuda, monkeypatch, case, pinhole,
                                           variant):
    """Each mesh tier in fog at 64x36 through its feature form."""
    from test_torch_meshes import mesh_scene
    tris, uvs = _tier_scene(case, monkeypatch)
    scene, cam = mesh_scene(tworlds, tris, uvs, 64, 36, pinhole=pinhole)
    scene = dataclasses.replace(scene, **FOG).to(cuda)
    assert cuda_backend.variant(scene, cam) == variant
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0)
    k = cuda_backend.render_chunk_cuda(scene, cam, cfg, 0, 0, 4,
                                       trenderer.init_accum(64 * 36, cuda))
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 4,
                                        trenderer.init_accum(64 * 36, cuda))
    torch.cuda.synchronize()
    _assert_verify_gates(cfg, k, p)


def _maps_or_glass(case):
    """(scene, camera params, world kind): world 2 or the 784-triangle
    mesh with planar albedo and bump maps on the ground plane, or world 1
    with its combined-set material as dispersive glass."""
    import numpy as np
    from test_torch_meshes import mesh_builder, tessellated_sphere
    if case == "tri784 maps":
        b, cp = mesh_builder(tworlds, tessellated_sphere(800))
        kind = tschema.WORLD_MARIO
    else:
        kind = tschema.WORLD_BRDF_TEST if case == "w2 maps" else W1
        b, cp = tworlds.build_world(kind)
    if case.endswith("maps"):
        m = b.materials[b.planes[0][2]]
        m.albedo_idx = b.add_texture(tworlds._mesh_uv_demo_texture())
        hf = np.repeat(np.random.RandomState(7).rand(8, 8, 1), 3, 2)
        m.bump_idx = b.add_texture((np.round(hf * 255.0) / 255.0)
                                   .astype(np.float32))
        m.bump_scale = 0.5
    else:
        for m in b.materials:
            if m.albedo_idx:
                m.transmission, m.ior, m.dispersion = 1.0, 1.5, 0.05
    return b.finalize(world_kind=kind, view_origin=cp.pos), cp


@pytest.mark.parametrize("case, variant", [
    ("w2 maps", "featclustered_pinhole"),
    ("tri784 maps", "featstaticplain_pinhole"),
    ("w1 glass", "feattextured_pinhole"),
])
def test_maps_and_glass_on_bases_match_plain(cuda, case, variant):
    """Planar and bump maps on a clustered and a static-tier scene, and
    dispersive glass on world 1's combined set (its K9 albedo weights the
    dielectric lobe), at 64x36."""
    from pathtracer_tpu_torch.scene.camera import define_camera
    scene, cp = _maps_or_glass(case)
    scene = scene.to(cuda)
    cam = define_camera(cp.pos, cp.target, cp.fov, 64, 36)
    assert cuda_backend.variant(scene, cam) == variant
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0)
    k = cuda_backend.render_chunk_cuda(scene, cam, cfg, 0, 0, 4,
                                       trenderer.init_accum(64 * 36, cuda))
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 4,
                                        trenderer.init_accum(64 * 36, cuda))
    torch.cuda.synchronize()
    _assert_verify_gates(cfg, k, p)


@pytest.mark.parametrize("case", ["dma1936", "dma1984uv"])
def test_fog_dma_tier_kernel_bit_equal_to_resident(cuda, monkeypatch, case):
    """In fog too, the DMA tier's walk with and without its grandparents
    renders bit-equal to the resident walk."""
    from pathtracer_tpu_torch.scene import clusters as tclusters
    from test_torch_meshes import mesh_scene
    tris, uvs = _tier_scene(case, monkeypatch)
    monkeypatch.setattr(tclusters, "STREAM_MAX", 1 << 20)
    resident, cam = mesh_scene(tworlds, tris, uvs, 64, 36)
    monkeypatch.setattr(tclusters, "STREAM_MAX", 1024)
    gp, _ = mesh_scene(tworlds, tris, uvs, 64, 36)
    assert gp.stream_gparents
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0)
    out = [cuda_backend.render_chunk_cuda(
        dataclasses.replace(s, **FOG).to(cuda), cam, cfg, 0, 0, 4,
        trenderer.init_accum(64 * 36, cuda)) for s in (resident, gp)]
    for a, b in zip(out[0].sum, out[1].sum):
        assert torch.equal(a, b)
    assert int(out[1].rays_cast) == int(out[0].rays_cast)


@pytest.mark.parametrize("variant, world, mesh, opts, pinhole, fog", [
    ("clustered+textured", "w2", None, {}, True, False),
    ("clustered+textured", "w2", None, {}, False, True),
    ("clustered+textured_k4t", "w2", "brute", {}, True, True),
    ("textured+staticplain", "w1", "static", {}, False, True),
    ("textured+meshplain", "w1", "streamed", {}, True, False),
    ("textured+meshplain", "w1", "dma", {}, True, True),
    ("clustered+mesh", "w2", "uv1472", {}, True, False),
    ("clustered+meshplain", "w2", "streamed", {}, False, False),
    ("clustered+mesh", "w2", "uv1472 dma", {}, True, True),
    ("clustered+meshplain", "w2", "dma", {}, True, False),
    ("clustered+static", "w2", "uv736", {}, False, True),
    ("clustered+staticplain", "w2", "static", {}, True, False),
    ("clustered+staticplain", "w2", "static", {"maps": True}, False, True),
    ("clustered+textured+meshplain", "w2", "streamed", {}, True, True),
    ("clustered+textured+meshplain", "w2", "dma", {}, False, False),
    ("clustered+textured+staticplain", "w2", "static",
     {"mesh_material": "ground"}, True, False),
    ("clustered+textured+staticplain", "w2", "static", {"glass": True},
     False, True),
])
def test_mixed_kernels_match_plain(cuda, monkeypatch, variant, world, mesh,
                                   opts, pinhole, fog):
    """Each mixed instantiation (sphere clusters with the combined set or
    a mesh tier, the combined set with a tier without UVs, all three) at
    64x36 against the lockstep plain version, through the camera and with
    or without the CLI's fog (one instantiation covers both); the DMA tier
    forced on a small mesh. Clusters with the combined set also beside a
    brute mesh (its K4t walk), and the feature bounce's dispersive glass
    and planar maps on mixed bases."""
    from pathtracer_tpu_torch.scene import clusters as tclusters
    from pathtracer_tpu_torch.scene.camera import define_camera
    from pathtracer_tpu_torch.scene.mixed_scenes import mixed_builder
    from test_torch_meshes import mixed_mesh
    if mesh is not None and mesh.endswith("dma"):
        monkeypatch.setattr(tclusters, "STREAM_MAX", 1024)
        monkeypatch.setattr(tclusters, "PARENT_GROUP", 4)
        monkeypatch.setattr(tclusters, "GPARENT_MIN", 4)
    kind = W1 if world == "w1" else tschema.WORLD_BRDF_TEST
    b, cp = mixed_builder(
        world=kind, combined="textured" in variant,
        mesh=None if mesh is None else mixed_mesh(mesh.split()[0], kind),
        **opts)
    scene = b.finalize(world_kind=kind, view_origin=cp.pos)
    scene = dataclasses.replace(scene, **(FOG if fog else {})).to(cuda)
    cam = define_camera(cp.pos, cp.target, cp.fov, 64, 36,
                        use_pinhole=pinhole, focal_distance=cp.focal_distance,
                        aperture_radius=cp.aperture_radius)
    assert cuda_backend.variant(scene, cam) == variant
    cfg = trenderer.RenderConfig(64, 36, pp=2, seed=0)
    before = cuda_backend.VARIANT_LAUNCHES[variant]
    k = cuda_backend.render_chunk_cuda(scene, cam, cfg, 0, 0, 4,
                                       trenderer.init_accum(64 * 36, cuda))
    assert cuda_backend.VARIANT_LAUNCHES[variant] == before + 1
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 4,
                                        trenderer.init_accum(64 * 36, cuda))
    torch.cuda.synchronize()
    _assert_verify_gates(cfg, k, p)


@pytest.fixture(scope="module")
def no_regroup_lib():
    """The kernel built with -DWAVE_NO_REGROUP: every feature variant
    shades each path in its own thread (chip_smoke.py's yardstick)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return cuda_backend.compile_library(("WAVE_NO_REGROUP",))[0]


@pytest.mark.parametrize("name, pinhole, schedule", [
    ("bump", True, None), ("tbn", True, None), ("fog", True, None),
    ("dispersion", True, None), ("everything", True, None),
    ("everything", False, None), ("w6 fog", True, None),
    ("w3 fog", False, None), ("w6 fog", True, "lockstep"),
    ("w1 fog", True, None), ("w2 fog", True, None),
    ("w7 fog", True, "regen")])
def test_regrouped_kernel_bit_equal(cuda, no_regroup_lib, name, pinhole,
                                    schedule):
    """Each feature scene, and worlds 6, 3, 1, 2 and 7 in the CLI's fog, at
    64x36 (ragged 8x4 tiles and blocks): the kernel, whose feature variants
    regroup their shading lanes by event, bit-equal to the
    -DWAVE_NO_REGROUP build and to the plain version (sums, squares,
    counts, rays)."""
    from pathtracer_tpu_torch.scene.camera import define_camera
    from pathtracer_tpu_torch.scene.feature_scenes import FEATURE_CASES
    w, h = 64, 36
    if name in FEATURE_CASES:
        scene, (pos, target, fov), cfg_kw = FEATURE_CASES[name]()
        cam = define_camera(pos, target, fov, w, h, use_pinhole=pinhole)
    else:
        kind = {"w6": tschema.WORLD_CORNELL_QUAD, "w3": tschema.WORLD_CORNELL_BOX,
                "w1": W1, "w2": tschema.WORLD_BRDF_TEST,
                "w7": tschema.WORLD_MESH_UV}[name.split(" ")[0]]
        scene, cam = tworlds.finalize_world(kind, w, h, use_pinhole=pinhole)
        scene, cfg_kw = dataclasses.replace(scene, **FOG), {}
    scene = scene.to(cuda)
    cfg = trenderer.RenderConfig(w, h, pp=2, seed=0, schedule=schedule,
                                 **cfg_kw)
    var = cuda_backend.variant(scene, cam, schedule)
    assert var.startswith("feat")

    def kernel(lib):
        kept = cuda_backend._lib
        cuda_backend._lib = lib
        try:
            return cuda_backend.render_chunk_cuda(
                scene, cam, cfg, 0, 0, 4, trenderer.init_accum(w * h, cuda))
        finally:
            cuda_backend._lib = kept

    k = kernel(cuda_backend.build())
    y = kernel(no_regroup_lib)
    p = cuda_backend.render_chunk_plain(scene, cam, cfg, 0, 0, 4,
                                        trenderer.init_accum(w * h, cuda))
    torch.cuda.synchronize()
    for other in (y, p):
        for a, b in zip((*k.sum, *k.sum_sq, k.count),
                        (*other.sum, *other.sum_sq, other.count)):
            assert torch.equal(a, b), var
        assert int(k.rays_cast) == int(other.rays_cast)
        assert int(k.nan_count) == int(other.nan_count)


@pytest.mark.parametrize("kind, lens", [
    (tschema.WORLD_CORNELL_BOX, False),     # brute_pinhole: scanlines
    (W1, False),                            # textured lockstep: 8x4 tiles
    (tschema.WORLD_MESH_UV, True),          # mesh_lens: 8x4 tiles
    (W4, True),                             # clustered_lens: 8x4 tiles
])
def test_kernel_shards_equal_one_launch(cuda, kind, lens):
    """render_image_sharded over [cuda:0] * 7 at 60x34 (2040 pixels: four
    padding lanes, each a launch of pixel 0; shards that cut through warp
    tiles and scanline warps) equals one launch bit for bit; rays_cast is
    above it by at most the padding lanes' rays."""
    from pathtracer_tpu_torch.parallel.shard import render_image_sharded
    scene, cam = tworlds.finalize_world(kind, 60, 34, use_pinhole=not lens)
    cfg = trenderer.RenderConfig(60, 34, pp=2, seed=0)
    _, pk1, st1 = trenderer.render_image(scene, cam, cfg, device=cuda)
    before = cuda_backend.LAUNCHES
    _, pk7, st7 = render_image_sharded(scene, cam, cfg, devices=[cuda] * 7)
    assert cuda_backend.LAUNCHES == before + 7 + 4
    assert torch.equal(pk1, pk7)
    for a, b in zip([*st1.sum, *st1.sum_sq, st1.count],
                    [*st7.sum, *st7.sum_sq, st7.count]):
        assert torch.equal(a, b)
    assert 0 <= int(st7.rays_cast) - int(st1.rays_cast) <= 7 * 4 * 4
