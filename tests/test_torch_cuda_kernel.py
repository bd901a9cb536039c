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
