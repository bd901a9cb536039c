"""K4, the axis-aligned boxes, against the JAX package on the CPU.

No world builds a box and JAX has no builder call for one, but JAX renders
a ``Scene`` whose box tables are set (``intersect_scene`` tests them after
the triangles, on XLA and in its kernel). Here JAX builds worlds 3, 2 and
6, gets box tables by ``.replace`` (test_torch_meshes.BOXES, padded as its
``finalize`` pads them) and ``scene/convert.py::scene_from_numpy`` carries
them to the port:

- ``ops/intersect.py::intersect_scene`` against JAX's on random rays at
  world 3 with two boxes and one in the air, rays that start inside a box,
  run along a face or have zero direction components: the same winners (material, normal),
  t within 8 ulps, and t bit-equal where a box wins;
- world 3 with its two boxes (through both cameras), world 2 with one box
  among its sphere clusters, world 6 in the CLI's fog with one box and
  world 1 with one in its textured ground's material (a base without a
  box form: the kernel's wrapper refuses it, its plain version renders
  it), rendered by JAX's XLA driver and by the port's plain version at
  32x18 (world 2 at 24x14, the others at 16x9), pp 2, under
  tests/test_golden.py's gates (test_torch_render.assert_golden_gates).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import cuda_backend, raygen
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils.vec import Vec3
from test_torch_meshes import BOXES, box_mat, box_tables
from test_torch_render import assert_golden_gates
from test_torch_scene import jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W1, W3, W2, W6 = (tschema.WORLD_DEFAULT, tschema.WORLD_CORNELL_BOX,
                  tschema.WORLD_BRDF_TEST, tschema.WORLD_CORNELL_QUAD)
FOG = dict(fog_sigma_t=0.0012, fog_albedo=(0.9, 0.9, 0.95), fog_g=0.5)


@pytest.fixture(scope="module", autouse=True)
def jax_large_table_forms():
    """World 2's XLA compile with JAX's large-table material gather and
    chunked sweeps (the same values; test_torch_mixed_bases.py does so):
    its 124 materials and 122 spheres otherwise unroll into a compile that
    outruns these tests' budget."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jintegrator, "_SELECT_LOOKUP_MAX", 16)
        mp.setattr(jint, "_UNROLL_MAX", 16)
        yield


def jax_with_boxes(js, boxes, mat=None):
    """JAX's scene with ``boxes`` in ``mat`` (by default its floor's
    material), by ``.replace``."""
    t = box_tables(boxes, box_mat(js) if mat is None else mat)
    vec = lambda a: JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    return js.replace(box_min=vec(t["box_min"]), box_max=vec(t["box_max"]),
                      box_mat=jnp.asarray(t["box_mat"]),
                      box_mask=jnp.asarray(t["box_mask"]),
                      n_boxes=t["n_boxes"])


def _rays(seed):
    """(o, d) (N, 3) float32 at world 3's boxes: random rays through the
    room, rays from inside each box, rays along each box's faces (a zero
    component across the face, from on its plane), and random rays with
    one or two zero components."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array([0.0, -800.0, 0.0]), np.array([800.0, 555.0, 555.0])

    def dirs(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    o = [rng.uniform(lo, hi, (2000, 3))]
    d = [dirs(2000)]
    for mn, mx in BOXES["w3"] + [AIR_BOX]:
        mn, mx = np.array(mn), np.array(mx)
        o.append(rng.uniform(mn, mx, (300, 3)))
        d.append(dirs(300))
        for axis in range(3):
            for coord in (mn[axis], mx[axis]):
                p = rng.uniform(mn - 50.0, mx + 50.0, (100, 3))
                p[:, axis] = coord
                v = dirs(100)
                v[:, axis] = 0.0
                o.append(p)
                d.append(v / np.linalg.norm(v, axis=1, keepdims=True))
    for zeros in ([0], [1], [2], [0, 1], [1, 2], [0, 2]):
        v = dirs(200)
        v[:, zeros] = 0.0
        o.append(rng.uniform(lo, hi, (200, 3)))
        d.append(v / np.linalg.norm(v, axis=1, keepdims=True))
    return (np.concatenate(o).astype(np.float32),
            np.concatenate(d).astype(np.float32))


# world 3's two boxes and one more in the air (a box on the floor never
# shows its front face, z-: the floor quad ties it and comes first)
AIR_BOX = ((300.0, 380.0, 400.0), (380.0, 460.0, 470.0))


def test_box_intersect_matches_jax():
    """The port's ``intersect_scene`` on world 3 with two boxes and one in
    the air against JAX's on the same rays: the same material and normal
    for every ray (box hits by the first face whose point lies in the box,
    JAX's order), t within 8 ulps, and t bit-equal where the port's winner
    is a box."""
    js, _ = jworlds.finalize_world(W3, 8, 8)
    js = jax_with_boxes(js, BOXES["w3"] + [AIR_BOX])
    ts = jax_scene_to_port(js)
    assert ts.n_boxes == 3 and ts.box_mat.shape == (8,)
    o, d = _rays(0)
    jvec = lambda a: JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))
    jh = jint.intersect_scene(js, jvec(o), jvec(d))
    to = Vec3(*(torch.from_numpy(o[:, i].copy()) for i in range(3)))
    td = Vec3(*(torch.from_numpy(d[:, i].copy()) for i in range(3)))
    th = tint.intersect_scene(ts, to, td)
    boxes = tint.intersect_boxes(ts, to, td, tint._miss(to))
    box_won = (boxes.t == th.t) & (boxes.t < tschema.F32_MAX)
    np.testing.assert_array_equal(th.mat.numpy(), np.asarray(jh.mat))
    tn = torch.stack(list(th.normal), 1).numpy()
    jn = np.stack([np.asarray(c) for c in jh.normal], 1)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-5)
    np.testing.assert_array_max_ulp(th.t.numpy(), np.asarray(jh.t), maxulp=8)
    won = box_won.numpy()
    np.testing.assert_array_equal(th.t.numpy()[won], np.asarray(jh.t)[won])
    np.testing.assert_array_equal(tn[won], jn[won])
    # the rays reach every face of both boxes, from outside and inside
    assert won.sum() > 1000
    faces = {tuple(n) for n in tn[won]}
    assert len(faces) == 6, faces


def _primary_box_hits(ts, cam, w, h):
    """How many of the camera's primary rays (the strata's centres) hit a
    box before anything else."""
    n = w * h
    half = torch.full((n,), 0.5)
    zero = torch.zeros(n, dtype=torch.int64)
    rays = raygen.pinhole_rays if cam.use_pinhole else raygen.thin_lens_rays
    o, d = rays(cam, w, h, 1, zero, zero, (half, half), torch.arange(n))
    hit = tint.intersect_scene(ts, o, d)
    boxes = tint.intersect_boxes(ts, o, d, tint._miss(o))
    return int(((boxes.t == hit.t) & (hit.t < tschema.F32_MAX)).sum())


# world 1's box, between its spheres, in its textured ground's material
# (the combined set's fetch on the box's faces)
W1_BOX = [((1.5, -2.5, 0.0), (2.5, -1.5, 1.0))]


@pytest.mark.parametrize("name, pinhole, w, h", [
    ("w3", True, 32, 18), ("w3", False, 16, 9), ("w2", True, 24, 14),
    ("w6 fog", True, 16, 9), ("w1", True, 16, 9)],
    ids=["w3", "w3-d", "w2", "w6-fog", "w1"])
def test_box_renders_match_jax(name, pinhole, w, h):
    """A JAX scene with boxes, carried to the port, rendered by JAX's XLA
    driver and the port's plain version (through ``render_chunk``, which
    routes it to the kernel's wrapper: on CPU tensors its plain version),
    4 samples at pp 2, under the golden gates. World 1's combined set has
    no box form: the kernel's wrapper refuses it on the card
    (``variant`` names the base), and its plain version renders it."""
    world, fog = name.split(" ")[0], name.endswith("fog")
    kind = {"w1": W1, "w3": W3, "w2": W2, "w6": W6}[world]
    js, jcam = jworlds.finalize_world(kind, w, h, use_pinhole=pinhole)
    if world == "w1":
        ground = int(np.argmax(np.asarray(js.sph_radius)[:js.n_spheres]))
        js = jax_with_boxes(js, W1_BOX, int(np.asarray(js.sph_mat)[ground]))
    else:
        js = jax_with_boxes(js, BOXES[world])
    if fog:
        js = js.replace(**FOG)
    ts = jax_scene_to_port(js)
    _, tcam = tworlds.finalize_world(kind, w, h, use_pinhole=pinhole)
    assert ts.n_boxes == js.n_boxes and ts.featured == fog
    assert _primary_box_hits(ts, tcam, w, h) > 0
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(w, h, pp=2, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(w * h))
    cfg = trenderer.RenderConfig(w, h, pp=2, seed=0)
    if world == "w1":
        assert ts.tex_combined
        with pytest.raises(NotImplementedError,
                           match="textured_pinhole_box: K4's box test has "
                                 "no form on this base"):
            cuda_backend.variant(ts, tcam)
    else:
        assert cuda_backend.variant(ts, tcam) == (
            "feature_pinhole_box" if fog else
            "clustered_pinhole_box" if world == "w2" else
            "brute_" + ("pinhole" if pinhole else "lens") + "_box")
    tst = trenderer.render_chunk(ts, tcam, cfg, 0, 0, 4,
                                 trenderer.init_accum(w * h))
    assert_golden_gates(jst, tst)
    assert int(tst.nan_count) == float(jst.nan_count)
    # the same scene without its boxes renders another image
    plain = trenderer.render_chunk(
        dataclasses.replace(ts, n_boxes=0), tcam, cfg, 0, 0, 4,
        trenderer.init_accum(w * h))
    assert not torch.equal(plain.sum.x, tst.sum.x)
