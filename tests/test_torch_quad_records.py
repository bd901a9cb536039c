"""The quads' precomputed records (``schema.quad_records``), which the
kernel's quad sweep and the quad light's next-event test read, on the CPU.

- The records of worlds 3 and 6 (the Cornell box's five quads; world 6's
  six, its light quad among them) hold, bit for bit, the values JAX's and the
  port's ``ray_planar_quad`` form per test from the quad alone: the baked
  unit normal, d = A . n_unit and w = cross(u, v) * (1 / |cross(u, v)|^2),
  and A, u, v as they are; the converter builds the same records from
  JAX's scene.
- The records' twin of the kernel's sweep (``ops/intersect.py::
  _intersect_quad_records``) against ``intersect_quads`` on rays aimed at
  the quads and rays grazing their edges and corners: t, material and
  normal bit-equal.
- A 32x18 render whose quad sweep takes the twin: bit-equal to the plain
  render, and under the golden gates against JAX's XLA driver.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils import prng as jprng
from pathtracer_tpu.utils import vec as jvec
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.utils import vec as tvec
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_render import assert_golden_gates
from test_torch_scene import jax_scene_to_port

WORLDS = {"w3": tschema.WORLD_CORNELL_BOX, "w6": tschema.WORLD_CORNELL_QUAD}


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test on one thread of PyTorch's CPU pool (many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quads(ts):
    """The scene's real quads: (A, u, v) as (n, 3) float32 arrays."""
    n = ts.n_quads
    cols = lambda v: torch.stack([c[:n] for c in v], 1).numpy()
    return cols(ts.quad_point), cols(ts.quad_u), cols(ts.quad_v)


@pytest.mark.parametrize("world", list(WORLDS))
def test_records_bit_equal_to_the_per_test_values(world):
    ts, _ = tworlds.finalize_world(WORLDS[world], 32, 18)
    js, _ = jworlds.finalize_world(WORLDS[world], 32, 18)
    n = ts.n_quads
    assert n == (6 if world == "w6" else 5)
    assert (ts.quad_light >= 0) == (world == "w6")
    rec = ts.quad_rec.numpy()[:n]
    A, u, v = _quads(ts)
    np.testing.assert_array_equal(rec[:, 8:11], A)
    np.testing.assert_array_equal(rec[:, 11:14], u)
    np.testing.assert_array_equal(rec[:, [14, 15, 7]], v)
    # the baked normal the kernel's test reads, JAX's too
    baked = torch.stack([c[:n] for c in ts.quad_n], 1).numpy()
    np.testing.assert_array_equal(rec[:, 0:3], baked)
    np.testing.assert_array_equal(
        np.stack([np.asarray(c)[:n] for c in js.quad_n], 1), baked)
    # ray_planar_quad's per-test values, JAX's (op by op) and the port's
    for mod, arr, back in ((jvec, jnp.asarray, np.asarray),
                           (tvec, torch.from_numpy, lambda x: x.numpy())):
        V = lambda x: mod.Vec3(*(arr(np.ascontiguousarray(x[:, k]))
                                 for k in range(3)))
        nn = mod.cross(V(u), V(v))
        n_unit = mod.normalize(nn, eps=1e-30)
        w = nn * (1.0 / mod.dot(nn, nn))
        np.testing.assert_array_equal(rec[:, 0:3], np.stack(
            [back(c) for c in n_unit], 1))
        np.testing.assert_array_equal(rec[:, 3], back(mod.dot(V(A), n_unit)))
        np.testing.assert_array_equal(rec[:, 4:7], np.stack(
            [back(c) for c in w], 1))
    # the converter's records from JAX's scene; the padding rows' w is 0
    assert torch.equal(jax_scene_to_port(js).quad_rec, ts.quad_rec)
    assert not ts.quad_rec[n:].any()


def _quad_rays(rng, A, u, v, n):
    """Rays at the quads (A, u, v, (q, 3)): half at random points of them
    from random points of the box, half at points of their edges and
    corners a few ulps inside or outside, grazing along the edge or
    crossing it: (o, d) as Vec3s of (n,) float32 tensors."""
    A, u, v = (x.astype(np.float64) for x in (A, u, v))
    q = rng.randint(0, len(A), n)
    a, b = rng.rand(n, 1), rng.rand(n, 1)
    edge = rng.rand(n) < 0.5
    # on an edge: one coordinate 0 or 1, nudged by 0 or a few ulps
    side = rng.randint(0, 4, n)
    nudge = rng.choice([0.0, 1e-7, -1e-7, 4e-7, -4e-7], n)[:, None]
    a = np.where(edge[:, None] & (side[:, None] < 2),
                 (side[:, None] == 1) + nudge, a)
    b = np.where(edge[:, None] & (side[:, None] >= 2),
                 (side[:, None] == 3) + nudge, b)
    p = A[q] + a * u[q] + b * v[q]
    o = rng.rand(n, 3) * 5.0 - np.asarray([2.5, 2.5, 0.0])
    graze = edge & (rng.rand(n) < 0.5)
    along = np.where((side < 2)[:, None], v[q], u[q])
    o[graze] = p[graze] - 2.0 * along[graze] / np.linalg.norm(
        along[graze], axis=1, keepdims=True)
    d = p - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    flat = lambda x: TVec3(*(torch.from_numpy(
        np.ascontiguousarray(x[:, k]).astype(np.float32)) for k in range(3)))
    return flat(o), flat(d)


@pytest.mark.parametrize("world", list(WORLDS))
def test_record_sweep_equals_intersect_quads(world):
    ts, _ = tworlds.finalize_world(WORLDS[world], 32, 18)
    o, d = _quad_rays(np.random.RandomState(5), *_quads(ts), 4096)
    miss = tint._miss(o)
    ref = tint.intersect_quads(ts, o, d, miss)
    got = tint._intersect_quad_records(ts, o, d, miss)
    assert int((ref.mat != 0).sum()) >= 3000
    assert torch.equal(got.t, ref.t) and torch.equal(got.mat, ref.mat)
    for a, b in zip(got.normal, ref.normal):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", list(WORLDS))
def test_render_through_the_records(world, monkeypatch):
    """A 32x18 render (pp=1, 4 samples) whose quad sweep takes the records'
    twin: bit-equal to the plain render, and under the golden gates against
    JAX's XLA wavefront renderer."""
    kind = WORLDS[world]
    ts, tcam = tworlds.finalize_world(kind, 32, 18)
    cfg = trenderer.RenderConfig(32, 18, pp=1, seed=0)
    plain = lambda: trenderer.render_chunk(ts, tcam, cfg, 0, 0, 4,
                                           trenderer.init_accum(32 * 18))
    ref = plain()
    monkeypatch.setattr(tint, "intersect_quads", tint._intersect_quad_records)
    got = plain()
    for a, b in [*zip(got.sum, ref.sum), (got.count, ref.count)]:
        assert torch.equal(a, b)
    assert int(got.rays_cast) == int(ref.rays_cast)
    js, jcam = jworlds.finalize_world(kind, 32, 18)
    jst = jrenderer.render_chunk(
        js, jcam, jrenderer.RenderConfig(32, 18, pp=1, seed=0),
        jprng.base_key(0), jnp.int32(0), 4, jrenderer.init_accum(32 * 18))
    assert_golden_gates(jst, got)
