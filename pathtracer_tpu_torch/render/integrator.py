"""One bounce of the path integrator for opaque, fog-free scenes.

Counterpart of ``shade_bounce`` and ``russian_roulette`` in
``pathtracer_tpu/render/integrator.py`` (RayCast's surface interaction,
win32_main.cpp:576-792), lane-parallel with masks instead of branches:

- the 50/50 estimator split with the x2 correction weight;
- a mirror path for effectively smooth surfaces, px = 1;
- a diffuse estimator that mixes cosine-hemisphere and light sampling,
  px = 0.5*PdfCos + 0.5*PdfLight; the light is ``spheres[0]``, or the quad
  ``scene.quad_light`` (sampled with PdfValueQuad, its intersection at
  MIN_HIT_DISTANCE rather than the sweep's 0.02);
- the reference quirk that PdfCos is evaluated on the raw sample in
  whichever tangent frame produced it;
- GGX half-vector sampling with the D/pdf cancellation, px = 1;
- Schlick-metal Fresnel and kd = (1-ks)(1-metalness);
- the combined 4-map texture set (world 1, win32_main.cpp:613-644): a
  textured material's albedo, and where their ``use_*_maps`` flag is set
  its metalness, roughness and normal, come from one fused fetch
  (``ops/texture.py``) at the hit's world xy, at mip level 0 or, with
  ``mip_scale > 0``, at the level of the hit's footprint.

The material lookup is an indexed gather ``tab[mat]``; the JAX package's
select sweep and constant-column broadcast are TPU shapes of the same
lookup. Other texture sets, transmission, fog and bump maps raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import texture
from ..ops.intersect import Hit, ray_planar_quad, ray_sphere
from ..ops.sampling import (
    PI, cosine_hemisphere, from_tangent, ggx_half_vector, orthonormal_basis,
    pdf_cosine, pdf_quad, pdf_to_sphere, sample_to_quad, to_sphere,
)
from ..ops.shade import brdf_specular_scalar, effectively_smooth, schlick_metal
from ..scene.schema import MIN_HIT_DISTANCE, N_AIR, Scene
from ..utils.vec import Vec3, dot, gather, hadamard, normalize, sdiv
from ..utils.vec import where as vwhere

# Debug render kinds (debug_render_kind_t, win32_main.cpp:22-28).
REGULAR = "regular"
PRIMARY_RAY_NORMALS = "primary_ray_normals"
BOUNCE_COUNT = "bounce_count"
TERMINATION_CONDITION = "termination_condition"
VARIANCE = "variance"  # handled by the accumulator; integrator == REGULAR
DEBUG_KINDS = (REGULAR, PRIMARY_RAY_NORMALS, BOUNCE_COUNT,
               TERMINATION_CONDITION, VARIANCE)


class BounceOut(NamedTuple):
    """Result of shading one bounce at a batch of hits."""
    emit: Vec3            # material emission at the hit (add thr*emit)
    hitpoint: Vec3        # next ray origin
    L: Vec3               # next ray direction
    weight: Vec3          # throughput multiplier 2/px * brdfTerm
    cont: torch.Tensor    # path continues (surface hit, valid estimator draw)
    hit_sky: torch.Tensor
    hit_light: torch.Tensor
    front_facing: torch.Tensor
    shading_normal: Vec3


def mip_lod(scene: Scene, t: torch.Tensor, cos_theta_in: torch.Tensor,
            mip_scale: float) -> torch.Tensor:
    """Per-lane pyramid level (integrator.py:295-307 in JAX): the texels
    one pixel covers at distance t, widened by grazing incidence, as the
    count of levels l >= 1 with footprint >= 2^l."""
    k = float(np.float32(mip_scale * scene.tex_comb_w * 0.5))
    fp = t * k / torch.clamp_min(torch.abs(cos_theta_in), 0.1)
    lod = torch.zeros_like(t, dtype=torch.int32)
    for lk in range(1, len(scene.tex_mip_meta)):
        lod = lod + (fp >= 2.0 ** lk).to(torch.int32)
    return lod


def shade_bounce(scene: Scene, o: Vec3, d: Vec3, hit: Hit, u,
                 mip_scale: float = 0.0) -> BounceOut:
    """Material fetch, estimator selection and BSDF weight for one bounce.
    ``u`` holds the bounce's BOUNCE_SLOTS (N,) uniforms; ``mip_scale > 0``
    selects a mip level per hit (``--mips``). Raises for scene features not
    ported yet (triangles, transmission, fog, bump, other texture sets)."""
    missing = scene.unsupported()
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
    just_cosine = scene.just_cosine
    idx = hit.mat.long()

    emit = gather(scene.mat_emit, idx)
    hit_sky = hit.mat == 0
    hit_light = (emit.x != 0.0) | (emit.y != 0.0) | (emit.z != 0.0)
    surface = ~hit_sky & ~hit_light

    # --- geometric terms (win32_main.cpp:592-651) -------------------------
    N_geom = hit.normal
    cos_theta_in = dot(N_geom, d)
    cos_theta_in = torch.where(cos_theta_in > 0.0, -cos_theta_in, cos_theta_in)
    hitpoint = o + d * hit.t
    pure_bounce = d - N_geom * (2.0 * cos_theta_in)
    V = -d
    metalness = scene.mat_metalness[idx]
    roughness = scene.mat_roughness[idx]
    N = N_geom
    albedo = gather(scene.mat_albedo, idx)

    # the combined 4-map set (integrator.py:286-334 in JAX); cos_theta_in
    # and the mirror bounce keep N_geom, everything below takes N
    if scene.n_textures and scene.tex_combined:
        if mip_scale and scene.tex_mip_meta:
            alb_c, met_c, rgh_c, nrm_c = texture.bespoke_sample_combined_mip(
                scene, hitpoint.x, hitpoint.y,
                mip_lod(scene, hit.t, cos_theta_in, mip_scale))
        else:
            alb_c, met_c, rgh_c, nrm_c = texture.bespoke_sample_combined(
                scene, hitpoint.x, hitpoint.y)
        if scene.use_metalness_maps:
            metalness = torch.where(scene.mat_metalness_idx[idx] != 0, met_c,
                                    metalness)
        if scene.use_roughness_maps:
            roughness = torch.where(scene.mat_roughness_idx[idx] != 0, rgh_c,
                                    roughness)
        if scene.use_normal_maps:
            n_dec = Vec3(2.0 * nrm_c.x - 1.0, 2.0 * nrm_c.y - 1.0,
                         2.0 * nrm_c.z - 1.0)
            if scene.tbn_normal_maps:
                n_dec = from_tangent(n_dec, *orthonormal_basis(N_geom))
            N = vwhere(scene.mat_normal_idx[idx] != 0,
                       normalize(n_dec, eps=1e-30), N)
        albedo = vwhere(scene.mat_albedo_idx[idx] != 0, alb_c, albedo)

    ndotv = dot(N, V)
    front_facing = ndotv > 0.0

    # --- estimator (win32_main.cpp:660-792) --------------------------------
    b_specular = u[0] > 0.5
    b_sample_cosine = u[1] > 0.5
    smooth = effectively_smooth(roughness)
    tx, ty, tz = orthonormal_basis(N)

    # rough specular: GGX half vector in the N frame (:724-731)
    h_t = ggx_half_vector(u[2], u[3], roughness)
    H_spec = normalize(from_tangent(h_t, tx, ty, tz), eps=1e-30)
    L_spec = H_spec * (2.0 * dot(V, H_spec)) - V

    # diffuse: cosine or light sample (:676-722)
    light_center = Vec3(scene.sph_center.x[0], scene.sph_center.y[0],
                        scene.sph_center.z[0])
    light_radius = scene.sph_radius[0]
    cos_dir = cosine_hemisphere(u[2], u[3])
    use_cosine = (torch.ones_like(b_sample_cosine) if just_cosine
                  else b_sample_cosine)
    if scene.quad_light >= 0:
        qi = scene.quad_light
        qp = Vec3(scene.quad_point.x[qi], scene.quad_point.y[qi],
                  scene.quad_point.z[qi])
        ql_u = Vec3(scene.quad_u.x[qi], scene.quad_u.y[qi], scene.quad_u.z[qi])
        ql_v = Vec3(scene.quad_v.x[qi], scene.quad_v.y[qi], scene.quad_v.z[qi])
        L_quad = normalize(
            sample_to_quad(u[2], u[3], qp, ql_u, ql_v, hitpoint), eps=1e-30)
        cos_world = normalize(from_tangent(cos_dir, tx, ty, tz), eps=1e-30)
        L_diff = vwhere(use_cosine, cos_world, L_quad)
        pcos = torch.where(use_cosine, pdf_cosine(cos_dir),
                           sdiv(torch.clamp_min(dot(N, L_diff), 0.0), PI))
        tq, q_hit = ray_planar_quad(hitpoint, L_diff, qp, ql_u, ql_v,
                                    min_hit=MIN_HIT_DISTANCE)
        pimp = pdf_quad(tq, q_hit, L_diff, ql_u, ql_v)
        imp_valid = torch.ones_like(use_cosine)
    else:
        light_dir = light_center - hitpoint
        sph_dir, ts_valid = to_sphere(u[2], u[3], light_center, light_radius,
                                      hitpoint)
        lx, ly, lz = orthonormal_basis(light_dir)
        r_dir = vwhere(use_cosine, cos_dir, sph_dir)
        fx, fy, fz = (vwhere(use_cosine, tx, lx), vwhere(use_cosine, ty, ly),
                      vwhere(use_cosine, tz, lz))
        L_diff = normalize(from_tangent(r_dir, fx, fy, fz), eps=1e-30)
        # the raw-frame PdfCos quirk (:709) + the solid-angle light pdf
        pcos = pdf_cosine(r_dir)
        _, sph_hit, _ = ray_sphere(hitpoint, L_diff, light_center,
                                   light_radius, MIN_HIT_DISTANCE)
        pimp = pdf_to_sphere(sph_hit, light_center, light_radius, hitpoint)
        imp_valid = ts_valid
    px_diff = pcos if just_cosine else 0.5 * pcos + 0.5 * pimp
    diff_valid = (px_diff > 0.0) & (use_cosine | imp_valid)

    case_a = b_specular & smooth
    case_b = b_specular & ~smooth
    L = vwhere(case_a, pure_bounce, vwhere(case_b, L_spec, L_diff))
    H = vwhere(case_b, H_spec, normalize(L_diff + V, eps=1e-30))
    px = torch.where(b_specular, 1.0, px_diff)
    est_valid = b_specular | diff_valid

    ndotl = dot(N, L)
    in_hemisphere = ndotl > 0.0

    # Fresnel (win32_main.cpp:738-749)
    ior = scene.mat_ior[idx]
    q = (N_AIR - ior) / (N_AIR + ior)
    F0 = q * q
    hdotl = dot(H, L)
    hdotv = dot(H, V)
    ks_cos = torch.where(smooth, ndotl, hdotl)
    ks = schlick_metal(F0, ks_cos, metalness, gather(scene.mat_metal_color, idx))
    hv_ok = smooth | ((hdotv > 0.0) & (hdotl > 0.0))

    # kd with metal kill (win32_main.cpp:751-759)
    one_m = 1.0 - metalness
    kd = Vec3((1.0 - ks.x) * one_m, (1.0 - ks.y) * one_m, (1.0 - ks.z) * one_m)

    # brdfTerm (win32_main.cpp:761-773)
    brdf_diff = hadamard(kd, albedo) * sdiv(ndotl, PI)
    brdf_spec = ks * brdf_specular_scalar(N, L, V, H, roughness)
    brdf = vwhere(case_a, ks, vwhere(case_b, brdf_spec, brdf_diff))

    pos = px > 0.0
    inv_px = torch.where(pos, torch.reciprocal(torch.where(pos, px, 1.0)), 0.0)
    weight = brdf * (2.0 * inv_px)

    cont = surface & front_facing & in_hemisphere & hv_ok & est_valid
    return BounceOut(
        emit=emit, hitpoint=hitpoint, L=L, weight=weight, cont=cont,
        hit_sky=hit_sky, hit_light=hit_light, front_facing=front_facing,
        shading_normal=vwhere(surface, N, N_geom),
    )


def russian_roulette(throughput: Vec3, u_rr: torch.Tensor, q_min: float = 0.05):
    """Unbiased RR: survive with q = clamp(max channel, q_min, 1) and
    reweight by 1/q."""
    lum = torch.maximum(torch.maximum(throughput.x, throughput.y), throughput.z)
    q = torch.clamp(lum, q_min, 1.0)
    survive = u_rr < q
    inv_q = torch.reciprocal(q)
    return survive, Vec3(throughput.x * inv_q, throughput.y * inv_q,
                         throughput.z * inv_q)
