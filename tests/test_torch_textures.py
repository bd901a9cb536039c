"""World 1's textures in the port against the JAX package: the maps and the
combined-set tables bit-equal, the combined fetch (K9's plain versions)
bit-equal to JAX's XLA fetch, and the CUDA kernel's tile addressing equal
to the flat words and to JAX's windowed Pallas fetch in interpret mode.

Both sides load the maps from the port's resource directory; where its
PNGs are absent both use the same procedural stand-ins."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pathtracer_tpu.ops import texture as jtex
from pathtracer_tpu.scene import textures as jtextures
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.ops import texture as ttex
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import textures as ttextures
from pathtracer_tpu_torch.scene import worlds as tworlds
from test_torch_scene import assert_tables_equal
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W1 = tschema.WORLD_DEFAULT
RES = ttextures.REFERENCE_RES_DIR


@pytest.fixture(scope="module")
def scenes():
    js, _ = jworlds.finalize_world(W1, 32, 18, res_dir=RES)
    ts, _ = tworlds.finalize_world(W1, 32, 18, res_dir=RES)
    return js, ts


def _uv(n=8 * 128, lim=130.0):
    rs = np.random.RandomState(7)
    return (rs.uniform(-lim, lim, n).astype(np.float32),
            rs.uniform(-lim, lim, n).astype(np.float32), rs)


def test_maps_bit_equal():
    """The four rusty-metal maps, their mip chains and the decimation."""
    a = jtextures.load_bespoke_textures(RES)
    b = ttextures.load_bespoke_textures(RES)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
        for p, q in zip(jtextures.generate_mipmap_chain(x),
                        ttextures.generate_mipmap_chain(y)):
            np.testing.assert_array_equal(p, q)


def test_world1_tables_bit_equal(scenes):
    """tex_tile, tex_comb_a/b, the pyramid rows and the material index
    columns equal JAX's; the converted JAX scene equals the port's, table
    by table and static by static."""
    js, ts = scenes
    for k in ("tex_tile", "tex_comb_a", "tex_comb_b", "mat_albedo_idx",
              "mat_metalness_idx", "mat_roughness_idx", "mat_normal_idx"):
        a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert ts.tex_mip_meta == js.tex_mip_meta and len(ts.tex_mip_meta) == 10
    np.testing.assert_array_equal(ts.tex_mip.numpy(),
                                  np.asarray(js.tex_mip_meta, np.int32))
    assert (ts.tex_combined, ts.tex_comb_w, ts.tex_comb_h, ts.tex_tiles_x,
            ts.n_textures) == (True, 512, 512, 64, 4)
    assert ts.tex_tile.shape == (5464, 128)
    assert ts.tex_comb_a.shape == (349525,)
    assert (ts.n_spheres, ts.n_planes, ts.n_materials) == (5, 0, 6)
    assert not ts.sph_clusters
    assert_tables_equal(js, ts)


@pytest.mark.parametrize("flags", [(True, True, True), (False, False, False),
                                   (False, True, False)])
def test_map_flags_reach_the_scene(flags):
    js, _ = jworlds.finalize_world(W1, 8, 8, *([True] + list(flags)),
                                   res_dir=RES)
    ts, _ = tworlds.finalize_world(W1, 8, 8, *([True] + list(flags)),
                                   res_dir=RES)
    names = ("use_normal_maps", "use_metalness_maps", "use_roughness_maps")
    assert tuple(getattr(ts, k) for k in names) == flags
    assert tuple(getattr(js, k) for k in names) == flags


def test_non_combined_textures_stay_unported():
    """A planar map outside the combined set takes the feature path (K10's
    planar form), with sphere clusters too (their feature form); a
    combined set with sphere clusters is the mixed variant
    ``clustered+textured``, and a bump map on it goes off the kernel
    (XLA-only in JAX): the kernel's wrapper refuses it, naming the torch
    ops that render it."""
    from pathtracer_tpu_torch.render import cuda_backend
    from pathtracer_tpu_torch.render.renderer import RenderConfig
    from pathtracer_tpu_torch.scene.camera import define_camera
    cam = define_camera((0.0, -10.0, 1.0), (0.0, 0.0, 0.0), 45.0, 8, 8)
    for idx in ((1, 0, 0, 0), (1, 2, 3, 4)):
        b = tschema.WorldBuilder()
        b.add_material(emit=(1.0, 1.0, 1.0))
        m = b.add_material(albedo_idx=idx[0], metalness_idx=idx[1],
                           roughness_idx=idx[2], normal_idx=idx[3])
        b.add_sphere((0.0, 0.0, 0.0), 1.0, m)
        for _ in range(max(idx)):
            b.add_texture(np.full((8, 8, 3), 0.5, np.float32))
        scene = b.finalize()
        if max(idx) == 1:
            assert scene.n_textures == 1 and not scene.tex_combined
            assert scene.planar_maps
        for i in range(80):
            b.add_sphere((3.0 * (i % 9), 3.0 * (i // 9), 0.0), 1.0, m)
        scene = b.finalize()
        assert scene.sph_clusters
        if max(idx) == 1:
            assert cuda_backend.variant(scene, cam) == "featclustered_pinhole"
            continue
        assert scene.tex_combined
        assert cuda_backend.variant(scene, cam) == "clustered+textured"
        bumped = dataclasses.replace(scene, any_bump=True)
        assert bumped.off_kernel
        with pytest.raises(NotImplementedError,
                           match="bump map beside a combined texture set "
                                 "on XLA only.*torch ops"):
            cuda_backend.check_supported(bumped, cam, RenderConfig(8, 8))


def _channels(out):
    alb, met, rgh, nrm = out
    return [np.asarray(c) for c in (*alb, met, rgh, *nrm)]


def test_combined_fetch_bit_equal_to_xla(scenes):
    """bespoke_sample_combined at level 0 for u, v ~ U(+-130)."""
    js, ts = scenes
    u, v, _ = _uv()
    a = _channels(jtex.bespoke_sample_combined(js, jnp.asarray(u),
                                               jnp.asarray(v)))
    b = _channels(ttex.bespoke_sample_combined(ts, torch.from_numpy(u),
                                               torch.from_numpy(v)))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("level", list(range(10)) + ["mixed"])
def test_combined_mip_fetch_bit_equal_to_xla(scenes, level):
    """bespoke_sample_combined_mip at every pyramid level and with a
    per-lane level."""
    js, ts = scenes
    u, v, rs = _uv()
    lod = (rs.randint(0, 10, u.shape) if level == "mixed"
           else np.full(u.shape, level)).astype(np.int32)
    a = _channels(jtex.bespoke_sample_combined_mip(
        js, jnp.asarray(u), jnp.asarray(v), jnp.asarray(lod)))
    b = _channels(ttex.bespoke_sample_combined_mip(
        ts, torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(lod)))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _jax_windowed_words(js, u, v, needs, lod=None):
    """JAX's bespoke_sample_combined_windowed(return_words=True) inside an
    interpret-mode pallas_call on one (8, 128) block, as
    tests/test_pallas.py and tests/test_mips.py run it."""
    R, C = 8, 128
    args = [jnp.asarray(u.reshape(R, C)), jnp.asarray(v.reshape(R, C)),
            jnp.asarray(needs.reshape(R, C).astype(np.int32))]
    if lod is not None:
        args.append(jnp.asarray(lod.reshape(R, C)))

    def kernel(*refs):
        u_ref, v_ref, n_ref = refs[:3]
        l_ref = refs[3] if lod is not None else None
        tab_ref = refs[len(args)]
        wa, wb, _, _ = jtex.bespoke_sample_combined_windowed(
            js, tab_ref, u_ref[:], v_ref[:], n_ref[:] != 0,
            return_words=True, lod=None if l_ref is None else l_ref[:])
        for r, val in zip(refs[len(args) + 1:], list(wa) + list(wb)):
            r[:] = val

    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((R, C), jnp.int32)] * 8,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * (len(args) + 1),
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 8,
        interpret=True,
    )(*args, js.tex_tile)
    return [np.asarray(o).reshape(-1) for o in outs]


def _flat_words(ts, u, v, lod=None):
    """The corner words straight from the flat tex_comb_a/b arrays."""
    if lod is None:
        x1, y1, x2, y2, _, _ = ttex._combined_coords(ts, u, v)
        off, w = 0, ts.tex_comb_w
    else:
        x1, y1, x2, y2, _, _, _, _, off, w = ttex._combined_coords_mip(
            ts, u, v, lod)
    A, B = ts.tex_comb_a, ts.tex_comb_b
    idx = [(off + y * w + x).long() for y, x in
           ((y1, x1), (y1, x2), (y2, x1), (y2, x2))]
    return [A[i].numpy() for i in idx] + [B[i].numpy() for i in idx]


@pytest.mark.parametrize("mip", [False, True])
def test_tile_addressing_matches_flat_and_windowed(scenes, mip):
    """The kernel's addressing (combined_at: each corner's (A, B) pair in
    tex_tile, a row of 64 pairs a tile) returns the flat words for every
    lane, and JAX's windowed fetch's words for every lane it fetches; at
    level 0 and with a per-lane level."""
    js, ts = scenes
    u, v, rs = _uv(lim=34.0 if mip else 130.0)
    needs = rs.rand(u.size) < 0.8
    lod = rs.randint(0, 10, u.shape).astype(np.int32) if mip else None
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    tl = None if lod is None else torch.from_numpy(lod)
    at = ttex.combined_at(ts, tu, tv, tl)
    corners, s, t = at
    for pair in corners:
        assert int(pair.min()) >= 0 and int(pair.max() // 64) < 5464
    wa, wb = ttex.combined_words(ts, at)
    got = [w.numpy() for w in wa + wb]
    for g, f in zip(got, _flat_words(ts, tu, tv, tl)):
        np.testing.assert_array_equal(g, f)
    for g, j in zip(got, _jax_windowed_words(js, u, v, needs, lod)):
        np.testing.assert_array_equal(g[needs], j[needs])
    # and the blend of those words is the fetch
    out = ttex._blend_combined(wa, wb, s, t)
    want = (ttex.bespoke_sample_combined(ts, tu, tv) if lod is None
            else ttex.bespoke_sample_combined_mip(ts, tu, tv, tl))
    for x, y in zip(_channels(out), _channels(want)):
        np.testing.assert_array_equal(x, y)


def test_tbn_flag_and_converted_statics(scenes):
    """--tbn is a static the converter carries across."""
    from test_torch_scene import jax_scene_to_port
    js, ts = scenes
    conv = jax_scene_to_port(js.replace(tbn_normal_maps=True))
    assert conv.tbn_normal_maps and not ts.tbn_normal_maps
    assert dataclasses.replace(ts, tbn_normal_maps=True).tbn_normal_maps
    np.testing.assert_array_equal(conv.tex_mip.numpy(), ts.tex_mip.numpy())
