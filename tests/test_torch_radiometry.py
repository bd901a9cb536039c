"""End-to-end radiometric gates on the port: the twins of
tests/test_radiometry.py.

The port's plain version renders the same three scenes (its own
``WorldBuilder`` and camera: a Lambertian plane lit by an emissive quad, by
an emissive sphere, and an emissive sphere in thin isotropic fog, each
under a black sky) at the same 24x16, 64 spp and seeds, and is held to the
same first-principles expectations that test_radiometry.py computes (its
stratum rays, numpy quadrature and single-scatter floor, imported from it):
pixels on the light equal its emission, the lit ground matches the
direct-lighting integral in total energy and in the signed median, and the
fog's glow sits in the single-scatter-floor/multi-scatter bracket. No JAX
render is run.
"""

import numpy as np

import test_radiometry as R
from pathtracer_tpu.scene.camera import define_camera as jdefine_camera
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene.camera import define_camera
from pathtracer_tpu_torch.scene.schema import WorldBuilder
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

W, H, PP = R.W, R.H, R.PP


def _stratum_rays():
    """The PP*PP stratum-centre rays per pixel of the scenes' camera
    (test_radiometry.stratum_rays on JAX's same camera)."""
    return R.stratum_rays(jdefine_camera((0.0, -5.0, 4.0), (0.0, 0.0, 0.0),
                                         40.0, W, H))


def _render(b, cam, seed):
    cfg = trenderer.RenderConfig(W, H, pp=PP, seed=seed)
    img = trenderer.render_image(b.finalize(), cam, cfg, device="cpu")[0]
    return img.numpy().reshape(W * H, 3)


def _ground_gates(img, kind, hits, integral, mean_tol):
    """test_radiometry's gates: light-interior pixels equal LE; on the
    clean ground the footprint-averaged quadrature's total energy within
    ``mean_tol`` and the signed median within 5%, the median |rel| under
    30%."""
    light_px = np.flatnonzero(np.all(kind == 2, axis=0))
    plane_px = np.flatnonzero(np.all(kind == 0, axis=0))
    assert len(light_px) >= 3, f"{len(light_px)} light-interior pixels"
    assert len(plane_px) >= 200, f"{len(plane_px)} clean ground pixels"
    np.testing.assert_allclose(
        img[light_px], np.broadcast_to(R.LE, (len(light_px), 3)), atol=1e-4)
    expect = np.zeros((len(plane_px), 3))
    for s in range(PP * PP):
        expect += integral(hits[s, plane_px])
    expect /= PP * PP
    got = img[plane_px]
    ratio = got.mean(axis=0) / expect.mean(axis=0)
    assert np.all(np.abs(ratio - 1.0) < mean_tol), (
        f"estimator energy off: mean ratio {ratio}")
    srel = (got - expect) / np.maximum(expect, 1e-6)
    assert np.abs(np.median(srel)) < 0.05, (
        f"pointwise bias: median signed rel {np.median(srel):.3f}")
    assert np.median(np.abs(srel)) < 0.3, "pointwise scatter blown up"


def test_quad_light_estimator_matches_quadrature():
    """The twin of test_radiometry.py:110: the quad light's NEE mixture."""
    b = WorldBuilder()
    b.add_material(emit=(0.0, 0.0, 0.0))  # black sky: direct light only
    anchor = b.add_material(albedo=(0, 0, 0))
    b.add_sphere((0.0, 0.0, -500.0), 0.5, anchor)  # spheres[0] anchor
    lm = b.add_material(albedo=(0, 0, 0), emit=tuple(R.LE))
    b.set_quad_light(b.add_quad(tuple(R.QP), tuple(R.QU), tuple(R.QV), lm))
    ground = b.add_material(albedo=(R.ALBEDO,) * 3, roughness=1.0, ior=1.0)
    b.add_plane((0.0, 0.0, 1.0), 0.0, ground)
    img = _render(b, define_camera((0.0, -5.0, 4.0), (0.0, 0.0, 0.0), 40.0,
                                   W, H), 11)
    kind, hits = R.classify_strata(*_stratum_rays())
    _ground_gates(img, kind, hits, R.direct_integral, 0.03)


def test_sphere_light_estimator_matches_quadrature():
    """The twin of test_radiometry.py:226: the sphere light's NEE, with the
    raw-frame PdfCos quirk."""
    b = WorldBuilder()
    b.add_material(emit=(0.0, 0.0, 0.0))
    lm = b.add_material(albedo=(0, 0, 0), emit=tuple(R.LE))
    b.add_sphere(tuple(R.SC), R.SR, lm)  # spheres[0] = the NEE target
    ground = b.add_material(albedo=(R.ALBEDO,) * 3, roughness=1.0, ior=1.0)
    b.add_plane((0.0, 0.0, 1.0), 0.0, ground)
    img = _render(b, define_camera((0.0, -5.0, 4.0), (0.0, 0.0, 0.0), 40.0,
                                   W, H), 13)
    kind, hits = R.classify_strata_sphere(*_stratum_rays())
    _ground_gates(img, kind, hits, R.direct_integral_sphere, 0.04)


def test_fog_glow_brackets_single_scatter_floor():
    """The twin of test_radiometry.py:334: an emissive sphere in thin
    isotropic fog at or above the single-scatter floor, within the
    multi-scatter allowance."""
    b = WorldBuilder()
    b.add_material(emit=(0.0, 0.0, 0.0))
    lm = b.add_material(albedo=(0, 0, 0), emit=tuple(R.LE))
    b.add_sphere(tuple(R.FC), R.FR, lm)
    b.set_fog(R.FSIG, albedo=(1.0, 1.0, 1.0), g=0.0)
    img = _render(b, define_camera((0.0, -5.0, 1.0), (0.0, 1.0, 1.0), 40.0,
                                   W, H), 17)
    o, d = R.stratum_rays(jdefine_camera((0.0, -5.0, 1.0), (0.0, 1.0, 1.0),
                                         40.0, W, H))
    expect = np.zeros((W * H, 3))
    strata = range(0, PP * PP, 16)
    for s in strata:
        expect += R._fog_expected(o[s], d[s])
    expect /= len(strata)
    ratio = img.mean(axis=0) / expect.mean(axis=0)
    assert np.all(ratio > 0.97) and np.all(ratio < 1.06), (
        f"fog estimator energy off: mean ratio {ratio}")
    srel = (img - expect) / np.maximum(expect, 1e-7)
    med = np.median(srel)
    assert -0.01 < med < 0.12, f"median signed rel {med:.3f}"
    miss = ~np.isfinite(R._sphere_t(o[0], d[0]))
    assert np.median(srel[miss]) > -0.01, (
        f"glow below the single-scatter floor: {np.median(srel[miss]):.3f}")
