"""Rendering across devices (``parallel/shard.py``), the twin of
tests/test_parallel.py, on the CPU with ``devices=[cpu] * 8`` (and 4 of
them for the subset) beside JAX's 8-device CPU mesh (tests/conftest.py).

The port's sharded image, packed image and trimmed accumulators are
bit-equal (``torch.equal``) to its own ``render_image``, and within the
golden gates (tests/test_torch_render.py::assert_golden_gates) of JAX's
``render_image_sharded`` on a mesh of the same width; ``rays_cast``
exceeds the one-device count by at most the padding lanes' rays
(test_parallel.py:35-43). Every route takes a shard: the kernel's plain
version (worlds 3, 1, 6, 7 and fog: JAX's ``TestShardedKernel``), the
wavefront route off the kernel and the unrolled driver. Checkpoints cross
between the two renderers both ways. The kernel's pixel map of a shard
(its warp tiles, ``cuda_backend.shard_tiles``, and its launches,
``shard_launches``) is replayed here thread by thread.
"""

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.parallel.shard import make_mesh as jmake_mesh
from pathtracer_tpu.parallel.shard import (
    render_image_sharded as jrender_sharded,
)
from pathtracer_tpu.render.renderer import RenderConfig as JConfig
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.parallel import shard
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import progressive as tprogressive
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.camera import define_camera
from pathtracer_tpu_torch.scene.feature_scenes import FEATURE_CASES
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)
from test_torch_render import assert_golden_gates

CPU = torch.device("cpu")
W3 = tschema.WORLD_CORNELL_BOX
# (width, height, pp, devices): JAX's TestSharded cases
CASES = {"24x16": (24, 16, 2, 8), "25x17": (25, 17, 1, 8),
         "subset": (24, 16, 1, 4)}


def _port(w, h, pp, n_dev, kind=W3, **kw):
    """(one-device render, sharded render) of the port on the CPU."""
    scene, cam = tworlds.finalize_world(kind, w, h)
    cfg = trenderer.RenderConfig(w, h, pp=pp, seed=0, **kw)
    return (trenderer.render_image(scene, cam, cfg, device="cpu"),
            shard.render_image_sharded(scene, cam, cfg,
                                       devices=[CPU] * n_dev))


@pytest.fixture(scope="module")
def renders():
    """Each case's port renders and JAX's sharded render on a mesh of the
    same width."""
    out = {}
    for name, (w, h, pp, n_dev) in CASES.items():
        js, jcam = jworlds.finalize_world(W3, w, h)
        jout = jrender_sharded(js, jcam, JConfig(width=w, height=h, pp=pp,
                                                 seed=0),
                               mesh=jmake_mesh(jax.devices()[:n_dev]))
        out[name] = (*_port(w, h, pp, n_dev), jout)
    return out


def _assert_same(one, sharded):
    """Image, packed image and every accumulator tensor bit-equal; the
    counters of a padded render may differ only in rays_cast."""
    (img1, pk1, st1), (img8, pk8, st8) = one, sharded
    assert torch.equal(img1, img8) and torch.equal(pk1, pk8)
    for a, b in zip([*st1.sum, *st1.sum_sq, st1.count],
                    [*st8.sum, *st8.sum_sq, st8.count]):
        assert torch.equal(a, b)
    assert int(st1.nan_count) == int(st8.nan_count)
    assert st1.samples_done == st8.samples_done


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_single_and_jax(renders, case):
    """Bit-equal to the port's one-device render; within the golden gates
    of JAX's sharded render; the trimmed state holds the image's lanes."""
    w, h, _, _ = CASES[case]
    one, sharded, (_, _, jst) = renders[case]
    _assert_same(one, sharded)
    assert sharded[2].count.shape == (w * h,)
    assert_golden_gates(jst, sharded[2])


@pytest.mark.parametrize("case", list(CASES))
def test_summed_diagnostics(renders, case):
    """rays_cast summed over the shards: the padding lanes add at most
    n_dev * MAX_BOUNCE_COUNT * spp rays (test_parallel.py:35-43); none
    without padding."""
    w, h, pp, n_dev = CASES[case]
    (_, _, st1), (_, _, st8), _ = renders[case]
    extra = int(st8.rays_cast) - int(st1.rays_cast)
    assert 0 <= extra <= n_dev * 4 * pp * pp
    assert (extra == 0) == ((w * h) % n_dev == 0)


def test_counters_across_chunks():
    """Over chunks of one sample the summed counters equal one device's:
    each chunk's shards add their own counts to the total once (JAX's
    render_image_sharded adds every shard's count to the replicated total
    before its psum, so from the second chunk on it counts the incoming
    total once per device)."""
    w, h = 24, 16
    scene, cam = tworlds.finalize_world(W3, w, h)
    cfg = trenderer.RenderConfig(w, h, pp=2, seed=0)
    one = trenderer.render_image(scene, cam, cfg, device="cpu",
                                 chunk_samples=1)
    sharded = shard.render_image_sharded(scene, cam, cfg, devices=[CPU] * 8,
                                         chunk_samples=1)
    _assert_same(one, sharded)
    assert int(one[2].rays_cast) == int(sharded[2].rays_cast) == 2200


def _feature(name, w, h):
    scene, (pos, target, fov), kw = FEATURE_CASES[name]()
    return scene, define_camera(pos, target, fov, w, h), kw


@pytest.mark.parametrize("kind, pp, kw", [
    (W3, 2, {}),                                          # brute_pinhole
    (tschema.WORLD_DEFAULT, 1, {}),                       # textured lockstep
    (tschema.WORLD_CORNELL_QUAD, 2, {}),                  # the quad light
    ("fog", 2, {}),                                       # feature_pinhole
    (tschema.WORLD_MESH_UV, 1, {}),                       # mesh lockstep
    (W3, 1, {"mode": "unrolled"}),                        # unrolled driver
    (W3, 1, {"debug_kind": "bounce_count"}),              # unrolled driver
    (W3, 1, {"just_importance": True}),                   # wavefront route
], ids=["w3", "w1", "w6", "fog", "w7", "unrolled", "bounce_count",
        "just_importance"])
def test_every_route_shards(kind, pp, kw):
    """Every route of render_chunk renders a shard: the kernel's plain
    version (JAX's TestShardedKernel with the plain version in place of
    pallas-interpret), the unrolled driver and the wavefront route, each
    sharded 8 ways at 25x17 (uneven) bit-equal to one device."""
    w, h = 25, 17
    if kind == "fog":
        scene, cam, fkw = _feature("fog", w, h)
    else:
        scene, cam = tworlds.finalize_world(kind, w, h)
        fkw = {}
    cfg = trenderer.RenderConfig(w, h, pp=pp, seed=0, **fkw, **kw)
    assert trenderer.kernel_renders(scene, cfg) == (not kw)
    one = trenderer.render_image(scene, cam, cfg, device="cpu")
    sharded = shard.render_image_sharded(scene, cam, cfg,
                                         devices=[CPU] * 8)
    _assert_same(one, sharded)
    assert one[0].max() > 0


def _copy(st):
    c = lambda t: t.clone()
    return trenderer.AccumState(
        trenderer.Vec3(*map(c, st.sum)), trenderer.Vec3(*map(c, st.sum_sq)),
        c(st.count), c(st.nan_count), c(st.rays_cast), st.samples_done)


def test_progress_sees_padded_state_and_resumes():
    """progress_cb receives the padded state gathered on the first device
    (JAX's); a padded state handed back resumes to the uninterrupted image,
    and a single-device state resumes sharded (zero-padded)."""
    w, h = 25, 17
    scene, cam = tworlds.finalize_world(W3, w, h)
    cfg = trenderer.RenderConfig(w, h, pp=3, seed=0)
    full = trenderer.render_image(scene, cam, cfg, device="cpu")
    seen = {}

    def keep(s, total, st):
        assert st.count.shape == (shard._padded_pixels(w * h, 8),)
        seen.setdefault(s, st)

    sharded = shard.render_image_sharded(scene, cam, cfg, devices=[CPU] * 8,
                                         chunk_samples=4, progress_cb=keep)
    assert sorted(seen) == [4, 8, 9]
    _assert_same(full, sharded)
    resumed = shard.render_image_sharded(scene, cam, cfg, devices=[CPU] * 8,
                                         state=seen[4])
    _assert_same(full, resumed)
    half = {}
    # render_image folds into its state in place: keep a copy
    trenderer.render_image(scene, cam, cfg, chunk_samples=4, device="cpu",
                           progress_cb=lambda s, t, st: half.setdefault(
                               s, _copy(st)))
    resumed = shard.render_image_sharded(scene, cam, cfg, devices=[CPU] * 5,
                                         state=half[4])
    _assert_same(full, resumed)


@pytest.mark.parametrize("sharded_writer", [False, True],
                         ids=["one_to_sharded", "sharded_to_both"])
def test_checkpoint_resume_across_renderers(tmp_path, sharded_writer):
    """A checkpoint written by the one-device renderer resumes sharded, and
    one written mid-render by the sharded renderer resumes on both, each to
    the bit-identical image (test_parallel.py:163-210)."""
    w, h = 24, 16
    scene, cam = tworlds.finalize_world(W3, w, h)
    cfg = trenderer.RenderConfig(w, h, pp=3, seed=0)
    full = trenderer.render_image(scene, cam, cfg, device="cpu")
    path = str(tmp_path / "ck.npz")
    save = lambda s, t, st: (tprogressive.save_checkpoint(path, st)
                             if s == 4 else None)
    if sharded_writer:
        shard.render_image_sharded(scene, cam, cfg, devices=[CPU] * 8,
                                   chunk_samples=4, progress_cb=save)
    else:
        trenderer.render_image(scene, cam, cfg, chunk_samples=4,
                               progress_cb=save, device="cpu")
    loaded, found = tprogressive.load_checkpoint(path, w * h, device="cpu")
    assert found and loaded.samples_done == 4
    _assert_same(full, shard.render_image_sharded(scene, cam, cfg,
                                                  devices=[CPU] * 8,
                                                  state=loaded))
    if sharded_writer:
        loaded, _ = tprogressive.load_checkpoint(path, w * h, device="cpu")
        _assert_same(full, trenderer.render_image(scene, cam, cfg,
                                                  state=loaded,
                                                  device="cpu"))


def test_make_devices_defaults_to_every_card():
    """Without a list the sharded renderer takes every CUDA device, and
    without a card it raises (no fallback to the CPU)."""
    assert shard.make_devices(["cpu", CPU]) == [CPU, CPU]
    with pytest.raises(ValueError, match="empty"):
        shard.make_devices([])
    if torch.cuda.is_available():
        assert len(shard.make_devices()) == torch.cuda.device_count()
        return
    scene, cam = tworlds.finalize_world(W3, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard.render_image_sharded(scene, cam,
                                   trenderer.RenderConfig(8, 8, pp=1))


def _kernel_pixels(w, h, pixels, tiles):
    """The pixels one launch over ``pixels`` (lo, hi) renders, thread by
    thread, as wave_body and wave_kernel_grouped map them: the 8x4 warp
    tiles (``tiles``) or scanlines, with wave_render's and launch's block
    counts."""
    lo, hi = pixels
    tiles_x = (w + 7) >> 3
    tile_lo, n_tiles = cuda_backend.shard_tiles(w, h, lo, hi)
    blocks = (n_tiles + 3) >> 2 if tiles else (hi - lo + 127) // 128
    b, t = np.arange(blocks)[:, None], np.arange(128)[None, :]
    if tiles:
        tile = tile_lo + b * 4 + (t >> 5)
        x = (tile % tiles_x) * 8 + (t & 7)
        y = (tile // tiles_x) * 4 + ((t >> 3) & 3)
        pix = y * w + x
        has = (x < w) & (pix >= lo) & (pix < hi)
    else:
        pix = lo + b * 128 + t
        has = pix < hi
    return pix[has]


@pytest.mark.parametrize("w, h", [(24, 16), (25, 17), (60, 34), (7, 3),
                                  (1280, 720)])
@pytest.mark.parametrize("n_dev", [1, 2, 7, 8])
def test_kernel_shard_map(w, h, n_dev):
    """Each device's launches (shard_launches) cover its lanes once: the
    image's pixels of its shard by one launch, each padding lane by a launch
    of pixel 0 at that lane; under both warp maps each launch's threads
    render exactly its pixels, each once, and a whole image's launch takes
    the blocks it took before shards (the image's whole and ragged tiles)."""
    n_pix = w * h
    n = shard._padded_pixels(n_pix, n_dev) // n_dev
    for k in range(n_dev):
        lanes = []
        for (lo, hi), offset in cuda_backend.shard_launches(n_pix, (k * n, n)):
            for tiles in (False, True):
                got = np.sort(_kernel_pixels(w, h, (lo, hi), tiles))
                assert np.array_equal(got, np.arange(lo, hi)), (lo, tiles)
            lanes += [(p + offset, p) for p in range(lo, hi)]
        assert sorted(lanes) == [(j, k * n + j if k * n + j < n_pix else 0)
                                 for j in range(n)]
    tile_lo, n_tiles = cuda_backend.shard_tiles(w, h, 0, n_pix)
    assert tile_lo == 0 and n_tiles == ((w + 7) >> 3) * ((h + 3) >> 2)
