"""The port's host layer on the CPU against the JAX package: the CLI's
``--denoise --exposure --flip --png --probe-pixel`` (one JAX CLI run at 8x8,
``-p1 -w3``, shared by the module; BMP and PNG bytes equal, the probe line
equal), the a-trous denoiser and its variance guide (rtol 1e-5, atol
1e-6), checkpoints across both packages (arrays equal; a resumed render
equal to the uninterrupted one bit for bit), ``--checkpoint --preview
--live --profile``, ``adapt_chunk_s``, the compare tool (output and exit
code equal to JAX's), and the flags the port accepts.
"""

import contextlib
import io
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import cli as jcli
from pathtracer_tpu import compare as jcompare
from pathtracer_tpu.render import denoise as jdenoise
from pathtracer_tpu.render import progressive as jprogressive
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch import cli as tcli
from pathtracer_tpu_torch import compare as tcompare
from pathtracer_tpu_torch.render import denoise as tdenoise
from pathtracer_tpu_torch.render import progressive as tprogressive
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

POST = ["-w3", "-p1", "--size", "8x8", "--denoise", "2", "--exposure", "1.5",
        "--flip", "xy", "--probe-pixel", "3,4"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """JAX's CLI with the post-process flags, on one device (its pixels do
    not depend on the mesh): (BMP bytes, PNG bytes, stdout)."""
    d = tmp_path_factory.mktemp("jax_cli")
    rc, text = _run(jcli.main, POST + ["--single-chip", "--out",
                                       str(d / "j.bmp"), "--png",
                                       str(d / "j.png")])
    assert rc == 0
    return (d / "j.bmp").read_bytes(), (d / "j.png").read_bytes(), text


def _probe(text):
    return [ln for ln in text.splitlines() if ln.startswith("probe pixel")]


def test_cli_post_process_bytes_vs_jax(jax_cli, tmp_path):
    """--denoise 2 --exposure 1.5 --flip xy with --png: the BMP's and the
    PNG's bytes equal JAX's CLI's, and the probe line is JAX's."""
    rc, text = _run(tcli.main, POST + ["--device", "cpu", "--out",
                                       str(tmp_path / "t.bmp"), "--png",
                                       str(tmp_path / "t.png")])
    assert rc == 0
    jbmp, jpng, jtext = jax_cli
    assert (tmp_path / "t.bmp").read_bytes() == jbmp
    assert (tmp_path / "t.png").read_bytes() == jpng
    assert _probe(text) == _probe(jtext) and len(_probe(text)) == 1
    assert re.search(r"\[perf\] .* scene=\S+s  render=\S+s  write=\S+s$",
                     text.strip().splitlines()[-1])


def test_cli_flags_cover_jax(tmp_path):
    """Every long flag of JAX's CLI is one of the port's; --single-chip
    renders, byte-equal to the render without it."""
    flags = lambda mod: set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"',
                                       open(mod.__file__).read()))
    assert flags(jcli) - flags(tcli) == set()
    assert not hasattr(tcli, "_NOT_PORTED")
    outs = []
    for extra in ([], ["--single-chip"]):
        path = tmp_path / f"x{len(extra)}.bmp"
        rc, text = _run(tcli.main, ["-w3", "-p1", "--size", "4x4", "--device",
                                    "cpu", "--out", str(path)] + extra)
        assert rc == 0 and "Using 1 device(s)." in text
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("argv, used", [
    (["-t3"], 3), (["-t20"], 8), ([], 8), (["-t4", "--single-chip"], 4),
    (["-t0"], 1),
])
def test_cli_renders_across_devices(tmp_path, argv, used):
    """The CLI's sharded branch through a device list (JAX's CLI,
    cli.py:177-183, 300-309): -t N takes the first min(N, devices) of the
    eight CPU devices given, which render_image_sharded renders across
    (--single-chip: render_image on the first); the BMP bytes equal the
    one-device render's, the preview's too (the padded state trimmed)."""
    base = ["-w3", "-p2", "--size", "25x17", "--device", "cpu", "--chunk",
            "1"]
    one, one_prev = tmp_path / "one.bmp", tmp_path / "one.png"
    assert _run(tcli.main, base + ["--out", str(one), "--preview",
                                   str(one_prev)])[0] == 0
    out, prev = tmp_path / "many.bmp", tmp_path / "prev.png"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(base + argv + ["--out", str(out), "--preview",
                                      str(prev)],
                       devices=[torch.device("cpu")] * 8)
    text = buf.getvalue()
    assert rc == 0
    assert "System has 8 device(s)." in text
    assert f"Using {used} device(s)." in text
    sharded = used > 1 and "--single-chip" not in argv
    assert (f"on {used} devices" in text) == sharded
    assert out.read_bytes() == one.read_bytes()
    assert prev.read_bytes() == one_prev.read_bytes()


def _images(seed, h=12, w=16):
    rng = np.random.RandomState(seed)
    img = (0.4 + 0.3 * rng.rand(h, w, 3)).astype(np.float32)
    img[:, w // 2:] += 1.2  # an edge
    var = (0.05 * rng.rand(h, w)).astype(np.float32)
    return img, var


@pytest.mark.parametrize("iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("guide", [False, True], ids=["plain", "guided"])
def test_atrous_denoise_vs_jax(iterations, guide):
    """The a-trous filter against JAX's on the same seeded 16x12 image with
    an edge, with and without the variance guide: rtol 1e-5, atol 1e-6
    (the exponentials' rounding); iteration 0 is the identity."""
    img, var = _images(iterations + 10 * guide)
    j = jdenoise.atrous_denoise(jnp.asarray(img),
                                jnp.asarray(var) if guide else None,
                                iterations=iterations)
    t = tdenoise.atrous_denoise(torch.from_numpy(img),
                                torch.from_numpy(var) if guide else None,
                                iterations=iterations)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)
    if iterations == 0:
        assert torch.equal(t, torch.from_numpy(img))


def _port_state(n=4):
    """(the port's accumulator of world 3 at 8x8 after ``n`` of its 4
    samples, the scene, the camera, the config)."""
    ts, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8)
    cfg = trenderer.RenderConfig(8, 8, pp=2, seed=0)
    st = trenderer.render_chunk(ts, cam, cfg, 0, 0, n, trenderer.init_accum(64))
    return st, ts, cam, cfg


def _jax_state(st):
    f = lambda t: jnp.asarray(t.numpy())
    return jrenderer.AccumState(
        sum=JVec3(*map(f, st.sum)), sum_sq=JVec3(*map(f, st.sum_sq)),
        count=f(st.count), nan_count=jnp.float32(int(st.nan_count)),
        rays_cast=jnp.float32(int(st.rays_cast)),
        samples_done=jnp.int32(st.samples_done))


def test_accum_variance_and_finalize_vs_jax():
    """``accum_variance`` and the denoised, exposed, tonemapped
    ``finalize`` on one accumulator (world 3, 8x8, 4 samples) against JAX's:
    the variance at rtol 1e-5, the packed pixels equal."""
    st, _, _, cfg = _port_state()
    jst = _jax_state(st)
    np.testing.assert_allclose(
        tdenoise.accum_variance(st, cfg).numpy(),
        np.asarray(jdenoise.accum_variance(jst, cfg)), rtol=1e-5, atol=1e-6)
    for kw in (dict(denoise=2, exposure=1.5), dict(denoise=3),
               dict(exposure=0.5), dict(debug_kind="variance", denoise=2)):
        tcfg = trenderer.RenderConfig(8, 8, pp=2, **kw)
        jcfg = jrenderer.RenderConfig(8, 8, pp=2, **kw)
        np.testing.assert_array_equal(
            trenderer.finalize(st, tcfg).numpy(),
            np.asarray(jrenderer.finalize(jst, jcfg)).astype(np.int64))


def test_checkpoint_from_jax_resumes_in_port(tmp_path):
    """A checkpoint JAX's ``save_checkpoint`` writes (its float32 counters)
    loads in the port, and the port's render resumed from it equals its
    uninterrupted render bit for bit."""
    part, ts, cam, cfg = _port_state(n=1)
    path = str(tmp_path / "j.npz")
    jprogressive.save_checkpoint(path, _jax_state(part))
    st, found = tprogressive.load_checkpoint(path, 64, device="cpu")
    assert found and st.samples_done == 1 == tprogressive.samples_done(st)
    assert st.rays_cast.dtype == torch.int64
    assert int(st.rays_cast) == int(part.rays_cast)
    _, _, resumed = trenderer.render_image(ts, cam, cfg, chunk_samples=1,
                                           state=st, device="cpu")
    full, _, _, _ = _port_state()
    for a, b in zip((*resumed.sum, *resumed.sum_sq, resumed.count,
                     resumed.rays_cast, resumed.nan_count),
                    (*full.sum, *full.sum_sq, full.count, full.rays_cast,
                     full.nan_count)):
        assert torch.equal(a, b)


def test_checkpoint_from_port_loads_in_jax(tmp_path):
    """A checkpoint the port writes loads in JAX with equal arrays: the sums
    and counts as float32, ``rays_cast`` and ``nan_count``, which the port
    writes as int64, as JAX's int32 (JAX runs without x64), and
    ``samples_done``."""
    st, _, _, _ = _port_state(n=2)
    path = str(tmp_path / "t.npz")
    tprogressive.save_checkpoint(path, st)
    with np.load(path) as z:
        assert z["rays_cast"].dtype == np.int64 and int(z["version"]) == 1
    jst, found = jprogressive.load_checkpoint(path, 64)
    assert found and jprogressive.samples_done(jst) == 2
    for a, b in zip((*jst.sum, *jst.sum_sq, jst.count),
                    (*st.sum, *st.sum_sq, st.count)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(jst.rays_cast).dtype == np.int32
    assert int(jst.rays_cast) == int(st.rays_cast)
    assert int(jst.nan_count) == int(st.nan_count)
    # a missing file or another pixel count: a fresh accumulator
    for p, n in ((str(tmp_path / "none.npz"), 64), (path, 63)):
        fresh, found = tprogressive.load_checkpoint(p, n, device="cpu")
        assert not found and fresh.samples_done == 0
        assert float(fresh.count.sum()) == 0.0


def test_cli_checkpoint_resume_equals_uninterrupted(tmp_path):
    """A render stopped after its first chunk (a progress callback that
    saves the checkpoint and raises) and resumed through the CLI's
    --checkpoint writes the uninterrupted run's BMP bytes, printing JAX's
    "Resuming from" line."""
    argv = ["-w3", "-p2", "--size", "8x8", "--chunk", "1", "--device", "cpu"]
    assert _run(tcli.main, argv + ["--out", str(tmp_path / "full.bmp")])[0] == 0
    ck = str(tmp_path / "ck.npz")
    ts, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8)

    def stop(s_done, s_total, st):
        tprogressive.save_checkpoint(ck, st)
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        trenderer.render_image(ts, cam, trenderer.RenderConfig(8, 8, pp=2),
                               chunk_samples=1, progress_cb=stop,
                               device="cpu")
    rc, text = _run(tcli.main, argv + ["--checkpoint", ck, "--out",
                                       str(tmp_path / "resumed.bmp")])
    assert rc == 0
    assert f"Resuming from {ck}: 1 samples done." in text
    assert ((tmp_path / "resumed.bmp").read_bytes()
            == (tmp_path / "full.bmp").read_bytes())
    assert tprogressive.load_checkpoint(ck, 64, device="cpu")[0].samples_done == 4


def test_cli_preview_live_profile(tmp_path):
    """--preview writes a PNG at each chunk; --live on a stdout that is not
    a terminal says so and renders; --profile writes a Chrome trace."""
    from PIL import Image
    prev = tmp_path / "prev.png"
    prof = tmp_path / "prof"
    seen = []
    orig = Image.Image.save

    def save(self, fp, *a, **k):
        seen.append(str(fp))
        return orig(self, fp, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Image.Image, "save", save)
        rc, text = _run(tcli.main, [
            "-w3", "-p2", "--size", "8x6", "--chunk", "1", "--device", "cpu",
            "--preview", str(prev), "--live", "--out", str(tmp_path / "o.bmp")])
    assert rc == 0
    assert _run(tcli.main, ["-w3", "-p1", "--size", "2x2", "--device", "cpu",
                            "--profile", str(prof), "--out",
                            str(tmp_path / "p.bmp")])[0] == 0
    assert seen.count(str(prev)) == 4 and Image.open(prev).size == (8, 6)
    assert "(--live: stdout is not a color terminal; disabled)" in text
    assert "  4/4 samples" in text
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_adapt_chunk_changes_no_sum():
    """``adapt_chunk_s`` (the --live cadence) halves an overshooting chunk
    after the first one, and the sums equal a render without it."""
    ts, cam = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8)
    cfg = trenderer.RenderConfig(8, 8, pp=4, seed=1)
    steps = []
    _, pk_a, a = trenderer.render_image(
        ts, cam, cfg, chunk_samples=4, device="cpu", adapt_chunk_s=1e-9,
        progress_cb=lambda s, t, st: steps.append(s))
    assert steps == [4, 8, 9, 10, 11, 12, 13, 14, 15, 16]
    _, pk_b, b = trenderer.render_image(ts, cam, cfg, device="cpu")
    for x, y in zip((*a.sum, *a.sum_sq, a.count), (*b.sum, *b.sum_sq,
                                                   b.count)):
        assert torch.equal(x, y)
    assert torch.equal(pk_a, pk_b)


@pytest.fixture(scope="module")
def bmps(tmp_path_factory):
    """Two 8x8 renders that differ, and a 6x8 one."""
    d = tmp_path_factory.mktemp("cmp")
    for name, argv in (("a", ["-w3", "-p1"]), ("b", ["-w6", "-p1"]),
                       ("c", ["-w3", "-p1", "--size", "6x8"])):
        size = [] if "--size" in argv else ["--size", "8x8"]
        assert _run(tcli.main, argv + size + [
            "--device", "cpu", "--out", str(d / f"{name}.bmp")])[0] == 0
    return {k: str(d / f"{k}.bmp") for k in "abc"}


@pytest.mark.parametrize("args", [
    ["a", "a"], ["a", "b"], ["a", "b", "--legacy"], ["a", "b", "--json"],
    ["a", "b", "--threshold", "0.5"], ["a", "b", "--threshold", "0.0001"],
    ["a", "b", "--json", "--legacy", "--threshold", "0.0001"],
    ["a", "c"], ["c", "a"], ["a", "missing"]],
    ids=["same", "differ", "legacy", "json", "threshold-pass",
         "threshold-fail", "json-legacy-fail", "width", "height", "missing"])
def test_compare_tool_vs_jax(bmps, tmp_path, args):
    """The port's compare tool prints what JAX's prints and exits as it
    does, on the same two BMPs."""
    a = (f"{tmp_path}/{args[0]}.bmp" if args[0] == "missing"
         else bmps[args[0]])
    b = (f"{tmp_path}/missing.bmp" if args[1] == "missing"
         else bmps[args[1]])
    if args[:2] == ["c", "a"]:
        # same width, other height: transpose-free 8x6 against 8x8
        assert _run(tcli.main, ["-w3", "-p1", "--size", "8x6", "--device",
                                "cpu", "--out", str(tmp_path / "d.bmp")])[0] == 0
        a = str(tmp_path / "d.bmp")
    argv = [a, b] + args[2:]
    jrc, jout = _run(jcompare.main, argv)
    trc, tout = _run(tcompare.main, argv)
    assert (trc, tout) == (jrc, jout)
    if args == ["a", "a"]:
        assert "Percentage Similarity: 100.000000 %" in tout
