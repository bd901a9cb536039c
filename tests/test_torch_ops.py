"""Ray generation, intersection and one bounce of shading: the port against
the JAX package (run op by op under ``jax.disable_jit``) on 512 seeded rays
per world.

Tolerance: sin/cos/pow and XLA's fused multiply-adds round differently from
PyTorch's kernels by an ulp or so, and an ulp can flip a discrete choice (a
hit at a silhouette, a coin at a boundary) on a rare lane. So each field
must agree within rtol 1e-4 / atol 1e-5 (integer and boolean fields
exactly) on at least 99.9% of lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jint
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.render import raygen as jraygen
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu.utils.vec import Vec3 as JVec3
from pathtracer_tpu_torch.ops import intersect as tint
from pathtracer_tpu_torch.render import integrator as tintegrator
from pathtracer_tpu_torch.render import raygen as traygen
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.utils.vec import Vec3 as TVec3
from test_torch_scene import jax_scene_to_port
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

N = 512
W, H, PP = 64, 36, 2
# a box around each world's geometry for the secondary-ray origins
BOUNDS = {
    tschema.WORLD_BRDF_TEST: ((-0.5, -0.5, 0.05), (5.5, 6.0, 1.5)),
    tschema.WORLD_CORNELL_BOX: ((1.0, 1.0, 1.0), (799.0, 554.0, 554.0)),
    tschema.WORLD_CORNELL_QUAD: ((1.0, 1.0, 1.0), (799.0, 554.0, 550.0)),
    tschema.WORLD_RAYTRACING_ONE_WEEKEND: ((-11.0, -11.0, 0.05),
                                           (11.0, 11.0, 1.5)),
}
WORLDS = list(BOUNDS)


def close_frac(a, b, rtol=1e-4, atol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "biu":
        return float((a == b).mean())
    return float(np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True).mean())


def assert_mostly_close(name, a, b):
    frac = close_frac(a, b)
    assert frac >= 0.999, f"{name}: only {frac:.4%} of lanes agree"


def t2n(v):
    return np.stack([c.numpy() for c in v]) if isinstance(v, TVec3) else v.numpy()


def j2n(v):
    return np.stack([np.asarray(c) for c in v]) if isinstance(v, JVec3) \
        else np.asarray(v)


def tvec(a):
    return TVec3(*(torch.from_numpy(np.array(c, np.float32)) for c in a))


def jvec(a):
    return JVec3(*(jnp.asarray(np.array(c, np.float32)) for c in a))


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    kind = request.param
    js, jcam = jworlds.finalize_world(kind, W, H)
    ts = jax_scene_to_port(js)
    rs = np.random.RandomState(kind)
    pix = rs.randint(0, W * H, size=N // 2).astype(np.int32)
    si, sj = (rs.randint(0, PP, size=N // 2).astype(np.int32) for _ in range(2))
    jit = [rs.rand(N // 2).astype(np.float32) for _ in range(2)]
    lo, hi = BOUNDS[kind]
    o2 = np.stack([rs.uniform(l, h, N // 2) for l, h in zip(lo, hi)]).astype(np.float32)
    d2 = rs.normal(size=(3, N // 2)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=0, keepdims=True)
    u = [rs.rand(N).astype(np.float32) for _ in range(8)]
    return dict(kind=kind, js=js, ts=ts, cam=jcam, pix=pix, si=si, sj=sj,
                jit=jit, o2=o2, d2=d2, u=u)


def test_pinhole_rays(world):
    w = world
    with jax.disable_jit():
        jo, jd = jraygen.pinhole_rays(
            w["cam"], W, H, PP, jnp.asarray(w["si"]), jnp.asarray(w["sj"]),
            tuple(jnp.asarray(a) for a in w["jit"]), jnp.asarray(w["pix"]))
    to, td = traygen.pinhole_rays(
        w["cam"], W, H, PP, torch.from_numpy(w["si"]),
        torch.from_numpy(w["sj"]), tuple(torch.from_numpy(a) for a in w["jit"]),
        torch.from_numpy(w["pix"]))
    np.testing.assert_array_equal(j2n(jo), t2n(to))
    np.testing.assert_allclose(j2n(jd), t2n(td), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", [tschema.WORLD_CORNELL_BOX,
                                  tschema.WORLD_RAYTRACING_ONE_WEEKEND])
def test_thin_lens_rays(kind):
    """The thin lens against JAX's on the w3 (-d) and w4 cameras: every
    Poisson-disk slot, seeded lens uniforms; |diff| <= 1e-6 on o and d."""
    _, cam = jworlds.finalize_world(kind, W, H, use_pinhole=False)
    assert not cam.use_pinhole
    rs = np.random.RandomState(30 + kind)
    pix = rs.randint(0, W * H, size=N).astype(np.int32)
    ri, ri2 = (rs.randint(0, 8, size=N).astype(np.int32) for _ in range(2))
    lens = [rs.rand(N).astype(np.float32) for _ in range(2)]
    with jax.disable_jit():
        jo, jd = jraygen.thin_lens_rays(
            cam, W, H, 8, jnp.asarray(ri), jnp.asarray(ri2),
            tuple(jnp.asarray(a) for a in lens), jnp.asarray(pix))
    to, td = traygen.thin_lens_rays(
        cam, W, H, 8, torch.from_numpy(ri), torch.from_numpy(ri2),
        tuple(torch.from_numpy(a) for a in lens), torch.from_numpy(pix))
    assert len(np.unique(ri * ri2 % traygen.NUM_POISSON)) == 12
    assert np.abs(j2n(jo) - t2n(to)).max() <= 1e-6
    assert np.abs(j2n(jd) - t2n(td)).max() <= 1e-6


def _rays(w):
    """Primary rays (port raygen) followed by random interior rays."""
    to, td = traygen.pinhole_rays(
        w["cam"], W, H, PP, torch.from_numpy(w["si"]),
        torch.from_numpy(w["sj"]), tuple(torch.from_numpy(a) for a in w["jit"]),
        torch.from_numpy(w["pix"]))
    o = np.concatenate([t2n(to), w["o2"]], axis=1)
    d = np.concatenate([t2n(td), w["d2"]], axis=1)
    return o, d


def test_intersect_scene(world):
    w = world
    o, d = _rays(w)
    with jax.disable_jit():
        jh = jint.intersect_scene(w["js"], jvec(o), jvec(d))
    th = tint.intersect_scene(w["ts"], tvec(o), tvec(d))
    assert_mostly_close("mat", j2n(jh.mat), t2n(th.mat))
    assert_mostly_close("t", j2n(jh.t), t2n(th.t))
    assert_mostly_close("normal", j2n(jh.normal), t2n(th.normal))
    assert (t2n(th.mat) != 0).mean() > 0.3  # the rays do hit geometry


def test_shade_bounce(world):
    """Both sides shade the same hits (the JAX ones) with the same uniforms."""
    w = world
    o, d = _rays(w)
    with jax.disable_jit():
        jh = jint.intersect_scene(w["js"], jvec(o), jvec(d))
        jout = jintegrator.shade_bounce(w["js"], jvec(o), jvec(d), jh,
                                        tuple(jnp.asarray(a) for a in w["u"]))
    th = tint.Hit(torch.from_numpy(j2n(jh.t).copy()),
                  torch.from_numpy(j2n(jh.mat).copy()), tvec(j2n(jh.normal)))
    tout = tintegrator.shade_bounce(w["ts"], tvec(o), tvec(d), th,
                                    tuple(torch.from_numpy(a) for a in w["u"]))
    for name in ("emit", "hitpoint", "L", "weight", "cont", "hit_sky",
                 "hit_light", "front_facing"):
        assert_mostly_close(name, j2n(getattr(jout, name)),
                            t2n(getattr(tout, name)))
    assert t2n(tout.cont).mean() > 0.2  # the estimator is exercised


def test_russian_roulette():
    rs = np.random.RandomState(5)
    thr = rs.uniform(0, 1.5, size=(3, N)).astype(np.float32)
    u = rs.rand(N).astype(np.float32)
    js, jt = jintegrator.russian_roulette(jvec(thr), jnp.asarray(u))
    ts, tt = tintegrator.russian_roulette(tvec(thr), torch.from_numpy(u))
    np.testing.assert_array_equal(j2n(js), t2n(ts))
    np.testing.assert_array_equal(j2n(jt), t2n(tt))


@pytest.fixture(scope="module")
def unit_vectors():
    rs = np.random.RandomState(21)

    def unit(n):
        v = rs.normal(size=(3, n)).astype(np.float32)
        v /= np.linalg.norm(v, axis=0, keepdims=True)
        return v

    N_, V_, L_ = unit(N), unit(N), unit(N)
    # keep the Hammon/Smith inputs in their domain (N.L, N.V > 0)
    V_ *= np.sign((N_ * V_).sum(0, keepdims=True))
    L_ *= np.sign((N_ * L_).sum(0, keepdims=True))
    H_ = (V_ + L_) / np.linalg.norm(V_ + L_, axis=0, keepdims=True)
    rough = rs.uniform(0.0, 1.0, N).astype(np.float32)
    return N_, V_, L_, H_.astype(np.float32), rough


def test_bsdf_terms(unit_vectors):
    from pathtracer_tpu.ops import shade as jshade
    from pathtracer_tpu_torch.ops import shade as tshade
    N_, V_, L_, H_, rough = unit_vectors
    jr, tr = jnp.asarray(rough), torch.from_numpy(rough)
    for name in ("ggx_d", "hammon_masking_shadowing", "brdf_specular_scalar"):
        args = {"ggx_d": (N_, H_), "hammon_masking_shadowing": (N_, L_, V_),
                "brdf_specular_scalar": (N_, L_, V_, H_)}[name]
        a = getattr(jshade, name)(*map(jvec, args), jr)
        b = getattr(tshade, name)(*map(tvec, args), tr)
        np.testing.assert_allclose(j2n(a), t2n(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    cos = np.abs((N_ * L_).sum(0)).astype(np.float32)
    metal = rough[::-1].copy()
    col = np.abs(V_)
    a = jshade.schlick_metal(jnp.float32(0.04), jnp.asarray(cos),
                             jnp.asarray(metal), jvec(col))
    b = tshade.schlick_metal(torch.tensor(0.04), torch.from_numpy(cos),
                             torch.from_numpy(metal), tvec(col))
    np.testing.assert_allclose(j2n(a), t2n(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        np.asarray(jshade.effectively_smooth(jr)),
        tshade.effectively_smooth(tr).numpy())


def test_ray_aabb_faces():
    """The box test behind intersect_boxes (no reference world fills the
    box table, so the scene sweep never reaches it)."""
    rs = np.random.RandomState(8)
    o = rs.uniform(-2, 2, size=(3, N)).astype(np.float32)
    d = rs.normal(size=(3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    lo, hi = np.full((3, 1), -0.5, np.float32), np.full((3, 1), 0.7, np.float32)
    jt, jhit, jface = jint.ray_aabb_faces(jvec(o), jvec(d), jvec(lo), jvec(hi))
    tt, thit, tface = tint.ray_aabb_faces(tvec(o), tvec(d), tvec(lo), tvec(hi))
    np.testing.assert_array_equal(j2n(jhit), t2n(thit))
    np.testing.assert_array_equal(j2n(jface), t2n(tface))
    np.testing.assert_allclose(j2n(jt), t2n(tt), rtol=1e-6, atol=1e-6)
    assert t2n(thit).mean() > 0.05  # some rays do hit the box
