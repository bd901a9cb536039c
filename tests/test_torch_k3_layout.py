"""The plain model of the lockstep bounce laid out by estimator
(``pathtracer_tpu_torch/render/regroup.py``): each shading lane's lobe
(mirror, GGX, cosine, light) against JAX's rule on the same hits and draws,
the stable partition a block writes under the two-way key (specular,
diffuse), the four lobes and the block-lockstep loop's coin key, with the
"regroup only where it cuts" rule, on hand-made blocks; world 1's plain
lockstep render with every bounce shaded through the layout and back
bit-equal to ``render/lockstep.py::render_chunk_lockstep``; and the
replay's lane use and branch runs (``lockstep_tally``) at 64x36, 2 spp:
lane use packed at or above in place, branch runs laid out at or below in
place. Tolerance: none (bit-equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import shade as jshade
from pathtracer_tpu.ops import texture as jtex
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import lockstep, regroup
from pathtracer_tpu_torch.render.integrator import BounceOut
from pathtracer_tpu_torch.render.renderer import RenderConfig, init_accum
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import textures as ttextures
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils import prng
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W1 = tschema.WORLD_DEFAULT
W, H = 64, 36
NMR = dict(use_normal_maps=False, use_metalness_maps=False, use_roughness_maps=False)


@pytest.mark.parametrize("maps", [True, False], ids=["maps", "nmr"])
def test_lobes_match_jax_rule(maps):
    """estimator_lobes against shade_bounce's rule in JAX (integrator.py:
    b_specular = u[0] > 0.5, the roughness from the combined set's map
    where the material has one, smooth by effectively_smooth, the cosine on
    u[1] > 0.5) on the same hits, JAX's draws, material lookup and fetch,
    for rays from world 1's camera in random directions."""
    js = jworlds.finalize_world(W1, W, H, *([True] + [maps] * 3),
                                res_dir=ttextures.REFERENCE_RES_DIR)[0]
    ts, cam = tworlds.finalize_world(W1, W, H, *([True] + [maps] * 3))
    n = 4096
    rng = np.random.RandomState(3)
    d = rng.randn(n, 3).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2])  # most rays down onto the textured ground
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.asarray(cam.pos, np.float32), (n, 1))
    pixel, sample = rng.randint(0, W * H, n), rng.randint(0, 4, n)
    bounce = rng.randint(0, tschema.MAX_BOUNCE_COUNT, n)
    active = rng.rand(n) < 0.9

    to, td = (TVec3(*(torch.from_numpy(a[:, k].copy()) for k in range(3))) for a in (o, d))
    thit = tint.intersect_scene(ts, to, td)
    # JAX's rule on the port's hits (XLA:CPU contracts FMAs in the ground
    # sphere's test, so a few t differ in the last bits; test_torch_world1
    # holds the renders)
    jt, jmat = jnp.asarray(thit.t.numpy()), jnp.asarray(thit.mat.numpy())
    ju = jprng.bounce_uniforms(jprng.path_keys(0, jnp.asarray(pixel), jnp.asarray(sample)),
                               jnp.asarray(bounce))
    mat = jintegrator._material_lookup(js, jmat)
    emit = mat["emit"]
    surface = (jmat != 0) & ~((emit.x != 0.0) | (emit.y != 0.0) | (emit.z != 0.0))
    rough = mat["roughness"]
    if maps:
        hx = jnp.asarray(o[:, 0]) + jnp.asarray(d[:, 0]) * jt
        hy = jnp.asarray(o[:, 1]) + jnp.asarray(d[:, 1]) * jt
        rgh_c = jtex.bespoke_sample_combined(js, hx, hy)[2]
        rough = jnp.where(mat["roughness_idx"] != 0, rgh_c, rough)
    smooth = np.asarray(jshade.effectively_smooth(rough))
    spec, cos = np.asarray(ju[0] > 0.5), np.asarray(ju[1] > 0.5) | bool(js.just_cosine)
    want = np.where(spec, np.where(smooth, regroup.LOBE_MIRROR, regroup.LOBE_GGX),
                    np.where(cos, regroup.LOBE_COSINE, regroup.LOBE_LIGHT))
    shades = active & np.asarray(surface) & (bounce < tschema.MAX_BOUNCE_COUNT - 1)
    want = np.where(shades, want, regroup.LOBE_NONE)

    tu = prng.bounce_uniforms(prng.path_keys(0, torch.from_numpy(pixel),
                                             torch.from_numpy(sample)),
                              torch.from_numpy(bounce))
    for j, t_ in zip(ju, tu):
        np.testing.assert_array_equal(np.asarray(j), t_.numpy())
    got = regroup.estimator_lobes(ts, to, td, thit, tu, torch.from_numpy(bounce),
                                  torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want).tolist()) == set(regroup.LOBES) | {regroup.LOBE_NONE}
    keys = regroup.estimator_keys(got).numpy()
    np.testing.assert_array_equal(
        keys, np.choose(want, [0, 0, 1, 1, regroup.EV_NONE]))


def _block(*warps):
    """A block of 128 lanes from four warps' lane lists (32 each)."""
    return np.concatenate([np.asarray(w) for w in warps])


N = regroup.EV_NONE
S, D = regroup.KEY_SPECULAR, regroup.KEY_DIFFUSE


def test_layout_on_hand_made_blocks():
    """Three blocks of scanline warps under the two-way key. Block 0: every
    warp alternates specular and diffuse lanes: 8 key runs in place, 4 laid
    out, so it regroups, specular lanes to threads 0-63 and diffuse to
    64-127 in thread order. Block 1: a warp of specular, a warp of diffuse,
    two empty: 2 either way, so it stays. Block 2: three specular lanes in
    each warp: 4 in place, 1 laid out (packed into warp 0). The four-lobe
    key on block 1 with its warps split mirror / GGX and cosine / light
    stays in place too (4 either way)."""
    alt = [S, D] * 16
    keys = np.concatenate([
        _block(alt, alt, alt, alt),
        _block([S] * 32, [D] * 32, [N] * 32, [N] * 32),
        _block(*([S] * 3 + [N] * 29 for _ in range(4)))])
    lanes, n_threads = regroup.kernel_lanes(384, 1, False)
    shader, regrouped = regroup.regroup_order(torch.from_numpy(keys), lanes, n_threads,
                                              keys=regroup.ESTIMATOR_KEYS)
    assert regrouped.tolist() == [True, False, True]
    shader = shader.numpy()
    np.testing.assert_array_equal(shader[0:128:2], np.arange(64))
    np.testing.assert_array_equal(shader[1:128:2], np.arange(64, 128))
    np.testing.assert_array_equal(shader[128:256], np.arange(128, 256))
    spec2 = np.flatnonzero(keys[256:] == S) + 256
    np.testing.assert_array_equal(shader[spec2], np.arange(256, 268))
    assert len(np.unique(shader)) == 384

    lobes = keys[128:256].copy()
    lobes[:32] = [regroup.LOBE_MIRROR, regroup.LOBE_GGX] * 16
    lobes[32:64] = [regroup.LOBE_COSINE, regroup.LOBE_LIGHT] * 16
    lobes[64:] = regroup.LOBE_NONE
    lanes1, n1 = regroup.kernel_lanes(128, 1, False)
    _, laid = regroup.regroup_order(torch.from_numpy(lobes), lanes1, n1, keys=regroup.LOBES)
    assert laid.tolist() == [False]

    # the block-lockstep loop's key: the coin, every live path specular at
    # the depth limit, nothing for a finished path
    u = (torch.tensor([0.7, 0.2, 0.9, 0.1]),)
    alive = torch.tensor([True, True, False, True])
    assert regroup.coin_keys(u, 0, alive).tolist() == [S, D, N, D]
    assert regroup.coin_keys(u, tschema.MAX_BOUNCE_COUNT - 1, alive).tolist() == [S, S, N, S]


@pytest.mark.parametrize("layout, tiles", [("two_way", False), ("four_way", False),
                                           ("two_way", True)])
def test_laid_out_render_bit_equal(monkeypatch, layout, tiles):
    """render_chunk_lockstep on world 1 with every bounce's shade_bounce
    applied to its lanes laid out by the two-way key (or the four lobes)
    over the kernel's warp map and back: bit-equal to it without (sums,
    squares, counts, rays, NaNs), and some blocks regroup."""
    ts, cam = tworlds.finalize_world(W1, W, H)
    cfg = RenderConfig(W, H, pp=1, seed=0, use_russian_roulette=True)
    pix = torch.arange(W * H)
    want = lockstep.render_chunk_lockstep(ts, cam, cfg, 0, 0, 2, init_accum(W * H), pix)
    lanes, n_threads = regroup.kernel_lanes(W, H, tiles)
    seen, regrouped = {}, []
    real = lockstep.shade_bounce

    def observe(bounce, alive, o, d, hit, u):
        lobes = regroup.estimator_lobes(ts, o, d, hit, u, bounce, alive)
        seen["keys"] = (regroup.estimator_keys(lobes) if layout == "two_way" else lobes)

    def shade(sc, o, d, hit, u, uv=None, **kw):
        keys = regroup.ESTIMATOR_KEYS if layout == "two_way" else regroup.LOBES
        shader, laid = regroup.regroup_order(seen["keys"], lanes, n_threads, keys=keys)
        regrouped.append(int(laid.sum()))
        perm = torch.argsort(shader)
        inv = torch.argsort(perm)
        fwd = lambda v: TVec3(*(c[perm] for c in v)) if isinstance(v, TVec3) else v[perm]
        back = lambda v: TVec3(*(c[inv] for c in v)) if isinstance(v, TVec3) else v[inv]
        out = real(sc, fwd(o), fwd(d), type(hit)(*(fwd(f) for f in hit)),
                   tuple(fwd(x) for x in u), uv=uv, **kw)
        return BounceOut(*(back(f) for f in out))

    monkeypatch.setattr(lockstep, "shade_bounce", shade)
    got = lockstep.render_chunk_lockstep(ts, cam, cfg, 0, 0, 2, init_accum(W * H), pix,
                                         observe=observe)
    assert sum(regrouped) > 0
    for a, b in zip((*want.sum, *want.sum_sq, want.count), (*got.sum, *got.sum_sq, got.count)):
        assert torch.equal(a, b)
    assert int(want.rays_cast) == int(got.rays_cast)
    assert int(want.nan_count) == int(got.nan_count)


@pytest.mark.parametrize("tiles", [False, True], ids=["scanlines", "tiles"])
@pytest.mark.parametrize("maps", [True, False], ids=["maps", "nmr"])
def test_tally_figures(tiles, maps):
    """The replay at 64x36, samples 0-1 (the figures of the 720p replay,
    re-derived small): its rays are the plain render's; lane use with each
    block's live paths packed at or above lane use in place, and the coin
    layout's between them; the four lobes' branch runs laid out (two-way,
    four-way, by coin) at or below their runs in place, the four-way at or
    below the two-way; some blocks regroup."""
    ts, cam = tworlds.finalize_world(W1, W, H, *([True] + [maps] * 3))
    cfg = RenderConfig(W, H, pp=1, seed=0)
    t = regroup.lockstep_tally(ts, cam, cfg, 2, tiles=tiles)
    plain = lockstep.render_chunk_lockstep(ts, cam, cfg, 0, 0, 2, init_accum(W * H),
                                           torch.arange(W * H))
    assert t["lane_bounces"] == int(plain.rays_cast)
    assert 0.0 < t["lane_use"] <= t["lane_use_coin"] <= t["lane_use_compacted"] <= 1.0
    assert t["runs_in_place"] > t["runs_two_way"] >= t["runs_four_way"] > 0
    assert t["runs_in_place"] > t["runs_coin"] > 0
    assert 0 < t["blocks_regrouped"] <= t["blocks"]
