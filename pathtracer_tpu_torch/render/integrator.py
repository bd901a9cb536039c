"""One bounce of the path integrator.

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
  ``mip_scale > 0``, at the level of the hit's footprint;
- planar maps from the flat stack (``bespoke_sample``): metalness,
  roughness and normal maps, then bump maps tilting N against the height's
  forward difference, then the albedo map;
- mesh-UV albedo maps (world 7, win32_main.cpp:172's TODO realised by the
  JAX package): a hit whose winner is a UV triangle with an albedo map
  samples it at the winner's texel-space uv (``sample_texture``), and the
  texel modulates the untextured material albedo;
- the delta dielectric lobe of transmissive materials (reflect with
  Schlick's probability, else refract; total internal reflection
  reflects), with one RGB channel per path under dispersion;
- global homogeneous fog: a free flight shorter than the surface hit (sky
  hits always) scatters in the medium, with a 50/50 Henyey-Greenstein /
  light-sample mixture toward ``spheres[0]`` or the quad light.

The material lookup is an indexed gather ``tab[mat]``; the JAX package's
select sweep and constant-column broadcast are TPU shapes of the same
lookup.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import texture
from ..ops.intersect import Hit, ray_planar_quad, ray_sphere
from ..ops.sampling import (
    PI, cosine_hemisphere, from_tangent, ggx_half_vector,
    henyey_greenstein_sample, orthonormal_basis, pdf_cosine,
    pdf_henyey_greenstein, pdf_quad, pdf_to_sphere, sample_to_quad, to_sphere,
)
from ..ops.shade import (
    brdf_specular_scalar, effectively_smooth, find_refraction_direction,
    schlick_metal,
)
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


def fog_flight(scene: Scene, u, t: torch.Tensor):
    """The fog's free flight -ln(1 - u[5]) / sigma_t and whether it ends
    before the hit at ``t`` (a scatter; sky hits, t = F32_MAX, always)."""
    s_fl = sdiv(-torch.log(torch.clamp_min(1.0 - u[5], 1e-30)),
                scene.fog_sigma_t)
    return s_fl, s_fl < t


def shade_bounce(scene: Scene, o: Vec3, d: Vec3, hit: Hit, u,
                 mip_scale: float = 0.0, uv=None) -> BounceOut:
    """Material fetch, estimator selection and BSDF weight for one bounce.
    ``u`` holds the bounce's BOUNCE_SLOTS (N,) uniforms; ``mip_scale > 0``
    selects a mip level per hit (``--mips``); ``uv`` is
    ``intersect_scene_uv``'s (uvx, uvy, uv_ok) in a mesh-UV scene. Raises
    for scene features not ported yet (``Scene.unsupported``)."""
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
    elif scene.planar_maps:
        # planar maps over the flat stack (JAX :335-357), each at the hit's
        # world xy on its 1-based layer (0 = unbound, masked)
        def planar(field):
            i = field[idx]
            return i != 0, texture.bespoke_sample(
                scene, torch.clamp_min(i - 1, 0), hitpoint.x, hitpoint.y)
        if scene.use_metalness_maps:
            on, tex = planar(scene.mat_metalness_idx)
            metalness = torch.where(on, tex.x, metalness)
        if scene.use_roughness_maps:
            on, tex = planar(scene.mat_roughness_idx)
            roughness = torch.where(on, tex.x, roughness)
        if scene.use_normal_maps:
            on, tex = planar(scene.mat_normal_idx)
            n_dec = Vec3(2.0 * tex.x - 1.0, 2.0 * tex.y - 1.0,
                         2.0 * tex.z - 1.0)
            if scene.tbn_normal_maps:
                n_dec = from_tangent(n_dec, *orthonormal_basis(N_geom))
            N = vwhere(on, normalize(n_dec, eps=1e-30), N)
        on, tex = planar(scene.mat_albedo_idx)
        albedo = vwhere(on, tex, albedo)
    if scene.any_bump and scene.n_textures:
        # bump maps (JAX :358-387): tilt N, after any normal map, against
        # the height's forward difference in the planar frame
        b_idx = scene.mat_bump_idx[idx]
        h0, hx, hy = texture.bespoke_height3(
            scene, torch.clamp_min(b_idx - 1, 0), hitpoint.x, hitpoint.y)
        bs = scene.mat_bump_scale[idx]
        gx = sdiv(hx - h0, texture.BUMP_EPS) * bs
        gy = sdiv(hy - h0, texture.BUMP_EPS) * bs
        N = vwhere(b_idx != 0, normalize(Vec3(N.x - gx, N.y - gy, N.z),
                                         eps=1e-30), N)
    if uv is not None:
        # a lane whose winner is a UV triangle with an albedo map samples it
        # at the winner's uv, modulating the untextured material albedo
        # (JAX :499-518)
        uvx, uvy, uv_ok = uv
        alb_idx = scene.mat_albedo_idx[idx]
        tex_uv = texture.sample_texture(scene, torch.clamp_min(alb_idx - 1, 0),
                                        uvx, uvy)
        albedo = vwhere(uv_ok & (alb_idx != 0),
                        hadamard(gather(scene.mat_albedo, idx), tex_uv), albedo)

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

    if scene.any_transmissive:
        # the delta dielectric lobe (JAX :529-582): reflect with Schlick's
        # probability, else refract (TIR reflects); weight albedo, no x2;
        # transmissive lanes bypass the front-facing and hemisphere gates
        trans = scene.mat_transmission[idx] > 0.0
        cos_i = -cos_theta_in
        ior_t, F0_t = ior, F0
        if scene.any_dispersive:
            # one RGB channel per path (u[6]), refracted with ior +
            # dispersion*(c - 1); the throughput keeps that channel x3
            disp = scene.mat_dispersion[idx]
            ch = torch.clamp_max((u[6] * 3.0).to(torch.int32), 2)
            is_disp = disp > 0.0
            ior_t = torch.where(is_disp, ior + disp * (ch.to(torch.float32)
                                                       - 1.0), ior)
            q_t = (N_AIR - ior_t) / (N_AIR + ior_t)
            F0_t = torch.where(is_disp, q_t * q_t, F0)
        # lax.integer_pow(x, 5) is x * ((x*x) * (x*x))
        x = 1.0 - torch.clamp(cos_i, 0.0, 1.0)
        fres = F0_t + (1.0 - F0_t) * (x * ((x * x) * (x * x)))
        refr_dir, refracted = find_refraction_direction(d, N_geom, ior_t)
        mirror = d - N_geom * (2.0 * dot(N_geom, d))
        take_reflect = (u[0] < fres) | ~refracted
        L = vwhere(trans, vwhere(take_reflect, mirror, refr_dir), L)
        w_trans = albedo
        if scene.any_dispersive:
            mask = Vec3(*((ch == c).to(torch.float32) * 3.0 for c in range(3)))
            w_trans = vwhere(is_disp, hadamard(albedo, mask), albedo)
        weight = vwhere(trans, w_trans, weight)
        cont = (trans & surface) | (~trans & cont)

    if scene.fog_sigma_t > 0.0:
        # fog (JAX :584-652): free flight -ln(1 - u[5]) / sigma_t; a flight
        # shorter than the hit (sky: t = F32_MAX, always) scatters at
        # o + d*s with the 50/50 phase / light-sample mixture, weight
        # albedo * phase / px; the surface's slots u[1..3] are reused
        g = scene.fog_g
        s_fl, vol = fog_flight(scene, u, hit.t)
        vp = o + d * s_fl
        use_phase = u[1] > 0.5
        ph_t = henyey_greenstein_sample(u[2], u[3], g)
        L_phase = normalize(from_tangent(ph_t, *orthonormal_basis(d)),
                            eps=1e-30)
        if scene.quad_light >= 0:
            L_light = normalize(sample_to_quad(u[2], u[3], qp, ql_u, ql_v, vp),
                                eps=1e-30)
            L_vol = vwhere(use_phase, L_phase, L_light)
            tq_v, qh_v = ray_planar_quad(vp, L_vol, qp, ql_u, ql_v,
                                         min_hit=MIN_HIT_DISTANCE)
            p_light = pdf_quad(tq_v, qh_v, L_vol, ql_u, ql_v)
            imp_ok = torch.ones_like(use_phase)
        else:
            sph_t, imp_ok = to_sphere(u[2], u[3], light_center, light_radius,
                                      vp)
            L_light = normalize(from_tangent(
                sph_t, *orthonormal_basis(light_center - vp)), eps=1e-30)
            L_vol = vwhere(use_phase, L_phase, L_light)
            _, sph_ok, _ = ray_sphere(vp, L_vol, light_center, light_radius,
                                      MIN_HIT_DISTANCE)
            p_light = pdf_to_sphere(sph_ok, light_center, light_radius, vp)
        f_p = pdf_henyey_greenstein(dot(d, L_vol), g)
        px_v = 0.5 * f_p + 0.5 * p_light
        pos_v = px_v > 0.0
        vol_ok = pos_v & (use_phase | imp_ok)
        w_s = f_p * torch.where(pos_v, torch.reciprocal(
            torch.where(pos_v, px_v, 1.0)), 0.0)
        fa = scene.fog_albedo
        w_vol = Vec3(w_s * fa[0], w_s * fa[1], w_s * fa[2])
        z = torch.zeros_like(w_s)
        emit = vwhere(vol, Vec3(z, z, z), emit)
        hitpoint = vwhere(vol, vp, hitpoint)
        L = vwhere(vol, L_vol, L)
        weight = vwhere(vol, w_vol, weight)
        cont = (vol & vol_ok) | (~vol & cont)
        hit_sky = hit_sky & ~vol
        hit_light = hit_light & ~vol
        front_facing = front_facing | vol

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
