"""The mesh scenes of the port's mesh-tier tests and chip_smoke.py, and
checks of them. This file imports no JAX, so the on-card tests
(tests/test_torch_cuda_kernel.py) use it too.

The meshes stand in for world 5's mario.glb, which is not in the
repository: the lat-long sphere of experiments/accel_crossover.py:51
(``tessellated_sphere``; its own copy here, not imported) at any size, and
world 7's UV sphere at other resolutions, each on world 5's ground plane
under its sun, seen through its camera.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.render import cuda_backend
from pathtracer_tpu_torch.scene import mixed_scenes
from pathtracer_tpu_torch.scene import schema as tschema
from pathtracer_tpu_torch.scene import worlds as tworlds
from pathtracer_tpu_torch.scene.camera import define_camera

W5 = tschema.WORLD_MARIO
NO_ASSET = "/nonexistent-res"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one thread of PyTorch's CPU pool. The port's tests run
    many small ops on a few thousand lanes, which the pool's threads slow
    several-fold beside JAX's thread pools and the other test workers
    (the uv736 fog render: 3.7 s of wall and 14.5 s of CPU on 8 threads,
    0.35 s on one). Every port test module imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lat_long_sphere(nlat, nlon, radius=1.0, center=(0.0, 0.0, 1.0)):
    """The lat-long sphere of experiments/accel_crossover.py:51
    (``tessellated_sphere``) with nlat x nlon quads, two triangles each, as
    a (T, 3, 3) soup wound outward (the pole rows carry degenerate ones)."""
    th = np.linspace(0, np.pi, nlat + 1)
    ph = np.linspace(0, 2 * np.pi, nlon + 1)
    P = np.zeros((nlat + 1, nlon + 1, 3), np.float32)
    P[..., 0] = radius * np.outer(np.sin(th), np.cos(ph)) + center[0]
    P[..., 1] = radius * np.outer(np.sin(th), np.sin(ph)) + center[1]
    P[..., 2] = radius * np.outer(np.cos(th), np.ones_like(ph)) + center[2]
    out = []
    for i in range(nlat):
        for j in range(nlon):
            a, b, c, d = P[i, j], P[i + 1, j], P[i + 1, j + 1], P[i, j + 1]
            out.append([a, b, c])
            out.append([a, c, d])
    return np.asarray(out, np.float32)


def tessellated_sphere(n_target, radius=1.0, center=(0.0, 0.0, 1.0)):
    """accel_crossover's ``tessellated_sphere``: ~n_target triangles
    (4 * nlat^2; 800 -> 784, 2000 -> 1936)."""
    nlat = max(4, int(np.sqrt(n_target / 4.0)))
    return lat_long_sphere(nlat, 2 * nlat, radius, center)


def uv_sphere(n_seg, n_ring):
    """World 7's UV sphere at another resolution: (T, 3, 3) points and
    (3T, 2) uvs (n_seg=16: 736 triangles)."""
    pts, uvs = tworlds._uv_sphere_mesh((0.0, 0.0, 1.4), 1.4, n_seg=n_seg,
                                       n_ring=n_ring)
    return pts.reshape(-1, 3, 3), uvs


def mesh_builder(worlds_mod, tris, uvs=None):
    """World 5's builder without its asset (sky, sun, ground plane) plus
    ``tris`` in one grey material, or with ``uvs`` wearing world 7's
    checker, through either package; returns (builder, camera params)."""
    b, cp = worlds_mod.build_world(W5, res_dir=NO_ASSET)
    if uvs is None:
        m = b.add_material(albedo=(0.7, 0.6, 0.5), roughness=0.6)
    else:
        m = b.add_material(albedo=(1.0, 1.0, 1.0), roughness=0.55,
                           albedo_idx=b.add_texture(
                               worlds_mod._mesh_uv_demo_texture()))
    b.set_mesh(tris.reshape(-1, 3), np.full((3 * len(tris),), m, np.int32),
               uvs=uvs)
    return b, cp


def mixed_mesh(kind, world=tschema.WORLD_BRDF_TEST):
    """(triangles (T, 3, 3), uvs or None) of a mixed scene's mesh at
    ``mixed_scenes.MESH_AT[world]``: the lat-long sphere in the brute tier
    (40 triangles), the static tier (784) or the streamed tier (1936; the
    DMA tier where it is forced), or world 7's UV sphere at 736 triangles
    (the static tier with UVs) or 1472 (the streamed tier with UVs; the
    DMA tier where it is forced)."""
    center, radius = mixed_scenes.MESH_AT[world]
    if kind.startswith("uv"):
        n_seg = {"uv736": 16, "uv1472": 32}[kind]
        pts, uvs = tworlds._uv_sphere_mesh(center, radius, n_seg=n_seg,
                                           n_ring=24)
        return pts.reshape(-1, 3, 3), uvs
    if kind == "brute":
        return lat_long_sphere(4, 5, radius, center), None
    n = {"static": 800, "streamed": 2000, "dma": 2000}[kind]
    return tessellated_sphere(n, radius, center), None


def mesh_scene(worlds_mod, tris, uvs=None, w=32, h=18, pinhole=True):
    """(scene, camera) of :func:`mesh_builder`'s world at w x h."""
    b, cp = mesh_builder(worlds_mod, tris, uvs)
    scene = b.finalize(world_kind=W5, view_origin=cp.pos)
    return scene, define_camera(cp.pos, cp.target, cp.fov, w, h,
                                use_pinhole=pinhole)


@pytest.mark.parametrize("n_target, n, kind", [
    (800, 784, "staticplain"), (19600, 19600, "meshplain"),
    (2000, 1936, "meshplain")])
def test_tessellated_sphere_sizes_and_tiers(n_target, n, kind):
    tris = tessellated_sphere(n_target)
    assert tris.shape == (n, 3, 3) and tris.dtype == np.float32
    scene, cam = mesh_scene(tworlds, tris)
    assert scene.n_tris == n and cuda_backend.mesh_kind(scene) == kind
    assert cuda_backend.variant(scene, cam) == kind + "_pinhole"


def test_meshes_face_outward():
    """cross(B - A, C - A) points away from the centre on every
    non-degenerate triangle (a back face would shade black)."""
    for tris, c in ((lat_long_sphere(4, 5), (0.0, 0.0, 1.0)),
                    (tessellated_sphere(800), (0.0, 0.0, 1.0)),
                    (uv_sphere(16, 24)[0], (0.0, 0.0, 1.4))):
        t = tris.astype(np.float64)
        n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        keep = np.linalg.norm(n, axis=1) > 1e-9
        out = (t.mean(axis=1) - c)[keep]
        assert ((n[keep] * out).sum(axis=1) > 0).all()
    pts, uvs = uv_sphere(16, 24)
    assert pts.shape == (736, 3, 3) and uvs.shape == (2208, 2)
    assert len(lat_long_sphere(4, 5)) == 40


def test_world5_builder_without_asset():
    """World 5's builder with its asset absent: sky, sun, ground plane, no
    mesh; the camera of the reference's world 5."""
    b, cp = tworlds.build_world(W5, res_dir=NO_ASSET)
    assert b.triangles is None and len(b.materials) == 3
    assert len(b.spheres) == 1 and len(b.planes) == 1
    assert (cp.pos, cp.target, cp.fov) == ((-5.0, -5.0, 1.0), (0.0, 0.0, 1.0),
                                           30.0)
