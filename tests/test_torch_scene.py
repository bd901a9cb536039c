"""The port's numpy world builder against the JAX package's finalize_world,
table by table, through the converter the port uses for JAX scenes."""

import dataclasses

import numpy as np
import pytest

from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.convert import (
    JAX_PARENT_FIELDS, JAX_PARENT_STATICS, scene_from_numpy,
)
from test_torch_meshes import one_torch_thread  # noqa: F401 (autouse)

# -w2 metal/roughness grid (122 spheres), -w3 Cornell, -w6 Cornell quad
# light, -w4 RTIOW cover (484 spheres in 9 clusters, thin lens)
WORLDS = [tschema.WORLD_BRDF_TEST, tschema.WORLD_CORNELL_BOX,
          tschema.WORLD_CORNELL_QUAD, tschema.WORLD_RAYTRACING_ONE_WEEKEND]


def scene_fields(scene):
    """A port scene's tables as numpy arrays (Vec3 tables as (3, N))."""
    out = {k: np.stack([c.cpu().numpy() for c in getattr(scene, k)])
           for k in tschema.VEC_FIELDS}
    out.update({k: getattr(scene, k).cpu().numpy()
                for k in tschema.TENSOR_FIELDS})
    return out


def jax_scene_to_port(js):
    """A JAX Scene -> port Scene through its leaves as numpy arrays."""
    names = tschema.VEC_FIELDS + tschema.TENSOR_FIELDS + JAX_PARENT_FIELDS
    fields = {k: np.asarray(getattr(js, k)) for k in names}
    statics = {k: getattr(js, k) for k in tschema.STATIC_FIELDS
               + JAX_PARENT_STATICS if hasattr(js, k)}
    return scene_from_numpy(fields, statics)


def assert_tables_equal(js, ts):
    conv = jax_scene_to_port(js)
    a, b = scene_fields(conv), scene_fields(ts)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k == "quad_n":
            # at most 1 ulp (the same f32 ops; the JAX side is op-by-op)
            np.testing.assert_array_max_ulp(a[k], b[k], maxulp=1)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in tschema.STATIC_FIELDS:
        assert getattr(conv, k) == getattr(ts, k), k
    assert ts.n_materials == js.n_materials
    assert ts.mat_roughness.shape[0] % 128 == 0
    assert ts.sph_radius.shape[0] % 16 == 0


@pytest.mark.parametrize("kind", WORLDS)
def test_tables_equal(kind):
    js, _ = jworlds.finalize_world(kind, 32, 18)
    ts, _ = tworlds.finalize_world(kind, 32, 18)
    assert_tables_equal(js, ts)


@pytest.mark.parametrize("seed", [1337, 99])
def test_world4_tables_equal(seed):
    """World 4's random layout, materials and clusters for two seeds: 484
    spheres and 485 materials (512 rows) for the default seed."""
    kind = tschema.WORLD_RAYTRACING_ONE_WEEKEND
    js, _ = jworlds.finalize_world(kind, 16, 9, rtiow_seed=seed)
    ts, _ = tworlds.finalize_world(kind, 16, 9, rtiow_seed=seed)
    assert_tables_equal(js, ts)
    assert ts.just_cosine and len(ts.sph_clusters) > 1
    if seed == 1337:
        assert (ts.n_spheres, ts.n_materials) == (484, 485)
        assert ts.mat_roughness.shape[0] == 512


@pytest.mark.parametrize("kind", WORLDS)
@pytest.mark.parametrize("size", [(32, 18), (1280, 720), (18, 32)])
def test_camera_identical(kind, size):
    """The derived camera, pinhole and thin lens (world 4 forces the lens)."""
    for pinhole in (True, False):
        _, jcam = jworlds.finalize_world(kind, *size, use_pinhole=pinhole)
        _, tcam = tworlds.finalize_world(kind, *size, use_pinhole=pinhole)
        assert dataclasses.asdict(jcam) == dataclasses.asdict(tcam)
        lens = kind == tschema.WORLD_RAYTRACING_ONE_WEEKEND or not pinhole
        assert tcam.use_pinhole is not lens


def test_quad_light_and_sphere_light():
    s6, _ = tworlds.finalize_world(tschema.WORLD_CORNELL_QUAD, 8, 8)
    s3, _ = tworlds.finalize_world(tschema.WORLD_CORNELL_BOX, 8, 8)
    assert s6.quad_light == 2 and s3.quad_light == -1
    assert float(s3.sph_radius[0]) == 65.0  # spheres[0] is the light


@pytest.mark.parametrize("kind", [tschema.WORLD_MARIO])
def test_unported_worlds_raise(kind, tmp_path):
    """World 5 builds without its asset (mario.glb absent: no mesh, as in
    JAX) with JAX's tables; a mesh without UVs together with a combined
    texture set is ported (a mixed variant), and a UV mesh there is
    rendered off the kernel (XLA-only in JAX), as torch ops."""
    js, _ = jworlds.finalize_world(kind, 8, 8, res_dir=str(tmp_path))
    ts, _ = tworlds.finalize_world(kind, 8, 8, res_dir=str(tmp_path))
    assert ts.n_tris == 0
    assert_tables_equal(js, ts)
    w1, _ = tworlds.finalize_world(tschema.WORLD_DEFAULT, 8, 8)
    mesh = dataclasses.replace(w1, n_tris=100)
    uv_mesh = dataclasses.replace(mesh, has_mesh_uvs=True)
    assert uv_mesh.off_kernel
    assert not mesh.off_kernel


def test_thin_lens_raises():
    """The thin lens is ported on world 1 too; only the textured kernel
    under its yardstick schedule, instantiated for the pinhole alone,
    refuses it."""
    from pathtracer_tpu_torch.render import cuda_backend
    scene, cam = tworlds.finalize_world(tschema.WORLD_DEFAULT, 8, 8,
                                        use_pinhole=False)
    assert not cam.use_pinhole
    with pytest.raises(NotImplementedError, match="pinhole only"):
        cuda_backend.variant(scene, cam, cuda_backend.OTHER_SCHEDULE)


@pytest.mark.parametrize("kind", WORLDS)
def test_converted_scene_renders_the_same(kind):
    from pathtracer_tpu_torch.render import renderer as trenderer
    js, _ = jworlds.finalize_world(kind, 16, 9)
    ts, cam = tworlds.finalize_world(kind, 16, 9)
    cfg = trenderer.RenderConfig(16, 9, pp=2, seed=4)
    _, pa, a = trenderer.render_image(jax_scene_to_port(js), cam, cfg,
                                      device="cpu")
    _, pb, b = trenderer.render_image(ts, cam, cfg, device="cpu")
    for x, y in zip(a.sum, b.sum):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(pa.numpy(), pb.numpy())
    assert int(a.rays_cast) == int(b.rays_cast)
