"""The bounce-lockstep loop (K3's plain version, render/lockstep.py) on
world 1: its trace against JAX's trace_fori on the same primary rays, the
lockstep render against the port's path-regeneration twin, exact resume,
and the port's default command on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.render import lockstep, wavefront
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import textures as ttextures
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils import prng as tprng
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W1 = tschema.WORLD_DEFAULT
W, H = 32, 18


def _gates(a, b, ca, cb, ra, rb):
    """The golden gates on per-pixel resolved radiance (3, N)."""
    d = np.abs(a - b).max(axis=0)
    assert np.median(d) < 1e-4, f"median |diff| {np.median(d)}"
    assert (d > 1e-2).mean() < 0.05, f"flips {(d > 1e-2).mean()}"
    np.testing.assert_array_equal(ca, cb)
    assert abs(ra - rb) <= 0.01 * ra, (ra, rb)
    assert b.max() > 0


@pytest.mark.parametrize("rr", [False, True])
def test_trace_lockstep_vs_jax_trace_fori(rr):
    """Samples 0-3 of world 1: the same primary rays (the port's) through
    the port's trace_lockstep and JAX's jitted trace_fori."""
    js, _ = jworlds.finalize_world(W1, W, H,
                                   res_dir=ttextures.REFERENCE_RES_DIR)
    ts, cam = tworlds.finalize_world(W1, W, H)
    cfg = trenderer.RenderConfig(W, H, pp=2, seed=0, use_russian_roulette=rr)
    pix = torch.arange(W * H)
    jtrace = jax.jit(lambda o, d, k: jintegrator.trace_fori(
        js, o, d, k, use_russian_roulette=rr))
    acc = {"port": [0.0, 0, 0], "jax": [0.0, 0, 0]}
    for s in range(4):
        sv = torch.full_like(pix, s)
        o, d = wavefront._primary_rays(cam, cfg, 0, pix, sv)
        rad, casts = lockstep.trace_lockstep(
            ts, o, d, tprng.path_keys(0, pix, sv), use_russian_roulette=rr)
        jo, jd = (tuple(jnp.asarray(c.numpy()) for c in v) for v in (o, d))
        keys = jprng.PathStream(jnp.zeros(W * H, jnp.uint32),
                                jnp.arange(W * H, dtype=jnp.uint32),
                                jnp.full(W * H, s, jnp.uint32))
        jrad, stats = jtrace(JVec3(*jo), JVec3(*jd), keys)
        for name, r, n in (("port", np.stack([c.numpy() for c in rad]),
                            int(casts.sum())),
                           ("jax", np.stack([np.asarray(c) for c in jrad]),
                            float(stats.rays_cast))):
            ok = ~np.isnan(r).any(axis=0)
            acc[name][0] = acc[name][0] + np.where(ok, r, 0.0)
            acc[name][1] = acc[name][1] + ok
            acc[name][2] += n
    (a, ca, ra), (b, cb, rb) = acc["jax"], acc["port"]
    _gates(a / np.maximum(ca, 1), b / np.maximum(cb, 1), ca, cb, ra, rb)


@pytest.mark.parametrize("case", ["default", "mips", "rr"])
def test_lockstep_equals_regen_twin(case):
    """Both schedules compute the same per-pixel values: the lockstep loop
    and the port's regeneration loop with the texture branch agree bit for
    bit on the CPU (and so within the golden gates)."""
    ts, cam = tworlds.finalize_world(W1, W, H)
    mip = 0.05 if case == "mips" else 0.0
    cfg = trenderer.RenderConfig(W, H, pp=2, seed=2, mip_scale=mip,
                                 use_russian_roulette=case == "rr")
    out = []
    for sched in ("lockstep", "regen"):
        out.append(cuda_backend.render_chunk_plain(
            ts, cam, dataclasses.replace(cfg, schedule=sched), 2, 0, 4,
            trenderer.init_accum(W * H)))
    a, b = out
    for x, y in zip(a.sum + a.sum_sq, b.sum + b.sum_sq):
        assert torch.equal(x, y)
    assert torch.equal(a.count, b.count)
    assert int(a.rays_cast) == int(b.rays_cast) > W * H * 4
    ra = torch.stack(list(a.sum)).numpy() / np.maximum(a.count.numpy(), 1)
    rb = torch.stack(list(b.sum)).numpy() / np.maximum(b.count.numpy(), 1)
    _gates(ra, rb, a.count.numpy(), b.count.numpy(), int(a.rays_cast),
           int(b.rays_cast))


@pytest.mark.parametrize("rr", [False, True])
def test_lockstep_equals_regen_in_fog(rr):
    """World 3 in a fog where last-bounce scatters are common: the lockstep
    loop's peeled last bounce adds shade_bounce's emission, zeroed where
    the fog's free flight scatters, so both plain loops accumulate the
    same sums (both draw the same numbers per pixel, sample and bounce)."""
    ts, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, W, H)
    ts = dataclasses.replace(ts, fog_sigma_t=0.01,
                             fog_albedo=(0.9, 0.9, 0.95), fog_g=0.5)
    cfg = trenderer.RenderConfig(W, H, pp=2, seed=1, use_russian_roulette=rr)
    pix = torch.arange(W * H)
    a = lockstep.render_chunk_lockstep(ts, cam, cfg, 1, 0, 4,
                                       trenderer.init_accum(W * H), pix)
    b = wavefront.render_chunk_wavefront(ts, cam, cfg, 1, 0, 4,
                                         trenderer.init_accum(W * H), pix)
    for x, y in zip(a.sum + a.sum_sq, b.sum + b.sum_sq):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    assert torch.equal(a.count, b.count)
    assert int(a.rays_cast) == int(b.rays_cast) > W * H * 4
    assert float(a.sum[0].max()) > 0.0


def test_render_chunk_uses_lockstep_for_world1(monkeypatch):
    """On CPU tensors a combined-set scene runs the lockstep loop, an
    untextured one the regeneration loop."""
    calls = []
    for mod, name in ((cuda_backend, "render_chunk_lockstep"),
                      (cuda_backend, "render_chunk_wavefront")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    for kind in (W1, tschema.WORLD_CORNELL_BOX):
        ts, cam = tworlds.finalize_world(kind, 8, 6)
        trenderer.render_chunk(ts, cam, trenderer.RenderConfig(8, 6, pp=1),
                               0, 0, 1, trenderer.init_accum(48))
    assert calls == ["render_chunk_lockstep", "render_chunk_wavefront"]


def test_world1_resume_exact():
    ts, cam = tworlds.finalize_world(W1, 16, 12)
    cfg = trenderer.RenderConfig(16, 12, pp=2, seed=3,
                                 use_russian_roulette=True)
    img1, pk1, st1 = trenderer.render_image(ts, cam, cfg, device="cpu")
    img2, pk2, st2 = trenderer.render_image(ts, cam, cfg, chunk_samples=1,
                                            device="cpu")
    part = trenderer.render_chunk(ts, cam, cfg, cfg.seed, 0, 3,
                                  trenderer.init_accum(16 * 12))
    _, _, st3 = trenderer.render_image(ts, cam, cfg, state=part, device="cpu")
    for st in (st2, st3):
        for a, b in zip(st1.sum + st1.sum_sq, st.sum + st.sum_sq):
            assert torch.equal(a, b)
        assert torch.equal(st1.count, st.count)
        assert int(st1.rays_cast) == int(st.rays_cast)
    assert torch.equal(pk1, pk2) and torch.equal(img1, img2)


@pytest.mark.parametrize("flags", [[], ["-nmr"], ["-n", "--tbn"],
                                   ["--mips"], ["-d", "-m"]])
def test_default_command_renders_world1(tmp_path, capsys, flags):
    """No -w: world 1. The map flags no longer raise."""
    from pathtracer_tpu_torch.cli import main
    out = tmp_path / "w1.bmp"
    assert main(["--device", "cpu", "--size", "32x18", "-p1", "--out",
                 str(out)] + flags) == 0
    assert out.stat().st_size == 54 + 4 + 32 * 18 * 4
    text = capsys.readouterr().out
    assert "camera located at c->pos = (0.000000,-10.000000,1.000000)" in text
    assert "Done. Image written" in text


def test_cli_map_flags_change_the_image(tmp_path):
    from pathtracer_tpu_torch.cli import main
    imgs = []
    for flags in ([], ["-nmr"]):
        out = tmp_path / f"w1{len(flags)}.bmp"
        main(["--device", "cpu", "--size", "16x9", "-p1", "--out",
              str(out)] + flags)
        imgs.append(out.read_bytes())
    assert imgs[0] != imgs[1]


def test_thin_lens_regen_lens_is_refused():
    """The textured lens has no instantiation under the other schedule."""
    ts, cam = tworlds.finalize_world(W1, 8, 6, use_pinhole=False)
    assert cuda_backend.variant(ts, cam) == "textured_lens"
    with pytest.raises(NotImplementedError, match="pinhole only"):
        cuda_backend.render_chunk_plain(
            ts, cam, trenderer.RenderConfig(
                8, 6, pp=1, schedule=cuda_backend.OTHER_SCHEDULE),
            0, 0, 1, trenderer.init_accum(48))
