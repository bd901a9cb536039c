"""The plain model of the feature bounce's block-level regroup
(``pathtracer_tpu_torch/render/regroup.py``) on the CPU: each lane's event
against JAX's masks on the same inputs, the stable partition a block
writes (a bijection, contiguous by event, stable in thread order, on
ragged blocks under both warp maps), a render whose every bounce is shaded
through the partition and back bit-equal to the plain regeneration loop,
and the replay's warp-branch issue against a hand count and, on real
bounces, never above the issue in place. 64x36 at 2 spp or less.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.scene import feature_scenes as jfeatures
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import regroup, wavefront
from pathtracer_tpu_torch.render.integrator import BounceOut
from pathtracer_tpu_torch.render.renderer import RenderConfig, init_accum
from pathtracer_tpu_torch.scene import feature_scenes as tfeatures
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.camera import define_camera
from pathtracer_tpu_torch.utils import prng
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

FOG = dict(fog_sigma_t=0.0012, fog_albedo=(0.9, 0.9, 0.95), fog_g=0.5)
W, H = 64, 36


def _scenes(name):
    """(JAX scene, port scene, camera position) of "w6 fog" (the CLI's fog
    on world 6) or a feature scene by name."""
    if name == "w6 fog":
        kind = tschema.WORLD_CORNELL_QUAD
        js, jcam = jworlds.finalize_world(kind, W, H)
        ts, _ = tworlds.finalize_world(kind, W, H)
        return js.replace(**FOG), dataclasses.replace(ts, **FOG), np.asarray(
            jcam.pos, np.float32)
    js, (pos, _, _), _ = jfeatures.FEATURE_CASES[name]()
    ts, _, _ = tfeatures.FEATURE_CASES[name]()
    return js, ts, np.asarray(pos, np.float32)


@pytest.mark.parametrize("name", ["w6 fog", "dispersion", "everything"])
def test_events_match_jax_masks(name):
    """shade_events on the port's hit and draws against the same rule on
    JAX's: its fog flight test vol = s < hit.t (integrator.py:597-600) and
    its transmission test (:529) on its material lookup, bit-equal hits
    and draws from the same rays, pixels, samples and bounces."""
    js, ts, pos = _scenes(name)
    n = 4096
    rng = np.random.RandomState(17)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(pos, (n, 1))
    pixel = rng.randint(0, W * H, n)
    sample = rng.randint(0, 4, n)
    bounce = rng.randint(0, tschema.MAX_BOUNCE_COUNT, n)
    active = rng.rand(n) < 0.9

    jhit = jint.intersect_scene(js, JVec3(*(jnp.asarray(o[:, k]) for k in range(3))),
                                JVec3(*(jnp.asarray(d[:, k]) for k in range(3))))
    ju = jprng.bounce_uniforms(jprng.path_keys(0, jnp.asarray(pixel), jnp.asarray(sample)),
                               jnp.asarray(bounce))
    mat = jintegrator._material_lookup(js, jhit.mat)
    emit = mat["emit"]
    surface = (jhit.mat != 0) & ~((emit.x != 0.0) | (emit.y != 0.0) | (emit.z != 0.0))
    vol = jnp.zeros(n, bool)
    if js.fog_sigma_t > 0.0:
        s = -jnp.log(jnp.maximum(1.0 - ju[5], 1e-30)) / jnp.float32(js.fog_sigma_t)
        vol = s < jhit.t
    trans = (mat["transmission"] > 0.0 if js.any_transmissive  # as shade_bounce tests it
             else jnp.zeros(n, bool))
    below = jnp.asarray(active) & (jnp.asarray(bounce) < tschema.MAX_BOUNCE_COUNT - 1)
    want = np.full(n, regroup.EV_NONE)
    want = np.where(np.asarray(below & surface & ~trans), regroup.EV_OPAQUE, want)
    want = np.where(np.asarray(below & surface & trans), regroup.EV_GLASS, want)
    want = np.where(np.asarray(below & vol), regroup.EV_SCATTER, want)

    thit = tint.intersect_scene(ts, TVec3(*(torch.from_numpy(o[:, k].copy()) for k in range(3))),
                                TVec3(*(torch.from_numpy(d[:, k].copy()) for k in range(3))))
    np.testing.assert_array_equal(np.asarray(jhit.t), thit.t.numpy())
    tu = prng.bounce_uniforms(prng.path_keys(0, torch.from_numpy(pixel), torch.from_numpy(sample)),
                              torch.from_numpy(bounce))
    got = regroup.shade_events(ts, thit, tu, torch.from_numpy(bounce), torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), want)
    seen = set(np.unique(want).tolist())
    assert seen >= {"w6 fog": {regroup.EV_SCATTER, regroup.EV_OPAQUE, regroup.EV_NONE},
                    "dispersion": {regroup.EV_OPAQUE, regroup.EV_GLASS, regroup.EV_NONE},
                    "everything": {0, 1, 2, 3}}[name]


def _kernel_map(width, height, tiles):
    """Each thread's pixel (-1: none) by the kernel's own expressions
    (wave_kernel's and wave_kernel_grouped's pixel map)."""
    if tiles:
        tiles_x = (width + 7) >> 3
        n_blocks = (tiles_x * ((height + 3) >> 2) + 3) >> 2
    else:
        n_blocks = (width * height + 127) // 128
    out = np.full(n_blocks * 128, -1)
    for b in range(n_blocks):
        for t in range(128):
            if tiles:
                tile = b * 4 + (t >> 5)
                x = (tile % tiles_x) * 8 + (t & 7)
                y = (tile // tiles_x) * 4 + ((t >> 3) & 3)
                if x < width and y < height:
                    out[b * 128 + t] = y * width + x
            elif b * 128 + t < width * height:
                out[b * 128 + t] = b * 128 + t
    return out


def _naive_regroups(ev_blocks):
    """Per block, whether the kernel's ballots choose to regroup, counted
    the slow way: each warp's distinct events in place against each event's
    run of slots laid out by event."""
    out = []
    for blk in ev_blocks:
        before = sum(len({e for e in blk[w * 32:(w + 1) * 32] if e != regroup.EV_NONE})
                     for w in range(4))
        laid = sorted(blk)
        after = sum(len({e for e in laid[w * 32:(w + 1) * 32] if e != regroup.EV_NONE})
                    for w in range(4))
        out.append(after < before)
    return np.asarray(out)


@pytest.mark.parametrize("tiles", [False, True], ids=["scanlines", "tiles"])
@pytest.mark.parametrize("size", [(64, 36), (60, 34)], ids=["64x36", "60x34"])
@pytest.mark.parametrize("seed", [0, 1])
def test_order_is_a_stable_partition(tiles, size, seed):
    """kernel_lanes is the kernel's pixel map (ragged sizes leave threads
    without a pixel); regroup_order is a bijection of each block's
    threads; a block that regroups lays its shading events out contiguous
    by event and stable in thread order, and chooses exactly as the slow
    count does; one that does not keeps each path in its thread."""
    width, height = size
    lanes, n_threads = regroup.kernel_lanes(width, height, tiles)
    kmap = _kernel_map(width, height, tiles)
    assert n_threads == len(kmap)
    np.testing.assert_array_equal(kmap[lanes.numpy()], np.arange(width * height))
    assert (kmap >= 0).sum() == width * height

    rng = np.random.RandomState(seed)
    # mixed events, and in the top third of the rows opaque shades among
    # finished paths (blocks whose branches the regroup cannot cut)
    ev = rng.choice(4, width * height, p=[0.45, 0.3, 0.05, 0.2])
    top = np.arange(width * height) < width * (height // 3)
    ev[top] = np.where(rng.rand(int(top.sum())) < 0.8, regroup.EV_OPAQUE, regroup.EV_NONE)
    events = torch.from_numpy(ev)
    shader, regrouped = regroup.regroup_order(events, lanes, n_threads)
    shader, lanes_np = shader.numpy(), lanes.numpy()
    assert len(np.unique(shader)) == width * height
    np.testing.assert_array_equal(shader // 128, lanes_np // 128)

    by_thread = np.full(n_threads, regroup.EV_NONE)
    by_thread[lanes_np] = ev
    blocks = by_thread.reshape(-1, 128)
    np.testing.assert_array_equal(regrouped.numpy(), _naive_regroups(blocks))
    assert 0 < int(regrouped.sum()) < len(blocks)
    for b, blk in enumerate(blocks):
        in_block = np.flatnonzero(lanes_np // 128 == b)
        slots = shader[in_block] % 128
        if not regrouped[b]:
            np.testing.assert_array_equal(slots, lanes_np[in_block] % 128)
            continue
        threads = lanes_np[in_block] % 128
        order = np.argsort(slots)
        laid = ev[in_block][order]
        assert np.all(np.diff(laid) >= 0)
        for e in regroup.SHADING_EVENTS:
            mine = laid == e
            # contiguous from the counts of the events before it
            start = int((blk < e).sum())
            np.testing.assert_array_equal(np.sort(slots[ev[in_block] == e]),
                                          np.arange(start, start + mine.sum()))
            assert np.all(np.diff(threads[order][mine]) > 0)


def _permuted(real, lanes, n_threads, live, caught):
    """shade_bounce shading each bounce's lanes in the regrouped order and
    returning its outputs to their owners."""
    def shade(sc, o, d, hit, u, uv=None, **kw):
        ev = regroup.shade_events(sc, hit, u, live["bounce"], live["mask"])
        shader, regrouped = regroup.regroup_order(ev, lanes, n_threads)
        caught["regrouped"] += int(regrouped.sum())
        perm = torch.argsort(shader)
        inv = torch.argsort(perm)
        fwd = lambda v: TVec3(*(c[perm] for c in v)) if isinstance(v, TVec3) else v[perm]
        back = lambda v: TVec3(*(c[inv] for c in v)) if isinstance(v, TVec3) else v[inv]
        out = real(sc, fwd(o), fwd(d), type(hit)(*(fwd(f) for f in hit)),
                   tuple(fwd(x) for x in u),
                   uv=None if uv is None else tuple(fwd(x) for x in uv), **kw)
        return BounceOut(*(back(f) for f in out))
    return shade


@pytest.mark.parametrize("name, tiles", [("w6 fog", False), ("dispersion", False),
                                         ("everything", True), ("fog", True)])
def test_regrouped_shading_is_bit_equal(monkeypatch, name, tiles):
    """render_chunk_wavefront with every bounce's shade_bounce applied to
    its lanes in the regrouped order and back: bit-equal to it without
    (sums, squares, counts, rays)."""
    if name == "w6 fog":
        ts = dataclasses.replace(tworlds.finalize_world(tschema.WORLD_CORNELL_QUAD, W, H)[0],
                                 **FOG)
        cam, kw = tworlds.finalize_world(tschema.WORLD_CORNELL_QUAD, W, H)[1], {}
    else:
        ts, (pos, target, fov), kw = tfeatures.FEATURE_CASES[name]()
        cam = define_camera(pos, target, fov, W, H)
    cfg = RenderConfig(W, H, pp=1, seed=0, **kw)
    pix = torch.arange(W * H)
    want = wavefront.render_chunk_wavefront(ts, cam, cfg, 0, 0, 2, init_accum(W * H), pix)

    lanes, n_threads = regroup.kernel_lanes(W, H, tiles)
    live, caught = {}, {"regrouped": 0}
    primary, draw = wavefront._primary_rays, prng.bounce_uniforms

    def primary_caught(camera, config, key, pixel_idx, s):
        live["mask"] = s < 2
        return primary(camera, config, key, pixel_idx, s)

    def draw_caught(stream, bounce):
        live["bounce"] = bounce
        return draw(stream, bounce)

    monkeypatch.setattr(wavefront, "_primary_rays", primary_caught)
    monkeypatch.setattr(prng, "bounce_uniforms", draw_caught)
    monkeypatch.setattr(wavefront, "shade_bounce",
                        _permuted(wavefront.shade_bounce, lanes, n_threads, live, caught))
    got = wavefront.render_chunk_wavefront(ts, cam, cfg, 0, 0, 2, init_accum(W * H), pix)
    assert caught["regrouped"] > 0
    for a, b in zip((*want.sum, *want.sum_sq, want.count),
                    (*got.sum, *got.sum_sq, got.count)):
        assert torch.equal(a, b)
    assert int(want.rays_cast) == int(got.rays_cast)
    assert int(want.nan_count) == int(got.nan_count)


def test_warp_branch_issue_hand_count():
    """Two blocks of scanline warps. Block 0: warps 0 and 1 hold 16
    scatters and 16 opaque shades each, warps 2 and 3 nothing; in place
    four branches (2 x (156 + 226) = 764 operations), laid out two (a
    warp of scatters, a warp of opaque shades: 382): it regroups. Block 1:
    a warp of opaque shades, a warp of scatters, one glass lane: three
    branches either way (486), so it stays in place."""
    ev = np.full(256, regroup.EV_NONE)
    ev[0:64:2] = regroup.EV_SCATTER
    ev[1:64:2] = regroup.EV_OPAQUE
    ev[128:160] = regroup.EV_OPAQUE
    ev[160:192] = regroup.EV_SCATTER
    ev[192] = regroup.EV_GLASS
    ops = np.choose(np.minimum(ev, 3), [156, 226, 104, 0])
    lanes, n_threads = regroup.kernel_lanes(256, 1, False)
    assert n_threads == 256
    got = regroup.warp_branch_issue(torch.from_numpy(ev), torch.from_numpy(ops), lanes,
                                    n_threads)
    assert got == {"before": 764 + 486, "after": 382 + 486, "blocks": 2, "regrouped": 1}
    shader, regrouped = regroup.regroup_order(torch.from_numpy(ev), lanes, n_threads)
    assert regrouped.tolist() == [True, False]
    np.testing.assert_array_equal(shader[:64:2].numpy(), np.arange(32))
    np.testing.assert_array_equal(shader[1:64:2].numpy(), np.arange(32, 64))
    np.testing.assert_array_equal(shader[128:].numpy(), np.arange(128, 256))


@pytest.mark.parametrize("name", ["w6 fog", "dispersion"])
def test_replayed_issue_never_rises(monkeypatch, name):
    """The replay of the plain regeneration loop's bounces (each lane's
    shading operations by event, the K9-free scenes' 156 / 226 / 104): the
    regrouped issue at or below the issue in place on every bounce, and
    below it over the render."""
    if name == "w6 fog":
        ts, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_QUAD, W, H)
        ts, kw = dataclasses.replace(ts, **FOG), {}
    else:
        ts, (pos, target, fov), kw = tfeatures.FEATURE_CASES[name]()
        cam = define_camera(pos, target, fov, W, H)
    lanes, n_threads = regroup.kernel_lanes(W, H, False)
    live, per_bounce = {}, []
    primary, draw, real = wavefront._primary_rays, prng.bounce_uniforms, wavefront.shade_bounce

    def primary_caught(camera, config, key, pixel_idx, s):
        live["mask"] = s < 2
        return primary(camera, config, key, pixel_idx, s)

    def draw_caught(stream, bounce):
        live["bounce"] = bounce
        return draw(stream, bounce)

    def shade(sc, o, d, hit, u, uv=None, **kw_):
        ev = regroup.shade_events(sc, hit, u, live["bounce"], live["mask"])
        ops = torch.tensor([156, 226, 104, 0])[ev]
        per_bounce.append(regroup.warp_branch_issue(ev, ops, lanes, n_threads))
        return real(sc, o, d, hit, u, uv=uv, **kw_)

    monkeypatch.setattr(wavefront, "_primary_rays", primary_caught)
    monkeypatch.setattr(prng, "bounce_uniforms", draw_caught)
    monkeypatch.setattr(wavefront, "shade_bounce", shade)
    wavefront.render_chunk_wavefront(ts, cam, RenderConfig(W, H, pp=1, seed=0, **kw), 0, 0, 2,
                                     init_accum(W * H), torch.arange(W * H))
    assert per_bounce and all(b["after"] <= b["before"] for b in per_bounce)
    assert sum(b["after"] for b in per_bounce) < sum(b["before"] for b in per_bounce)
    assert sum(b["regrouped"] for b in per_bounce) > 0
