"""Advanced Pathtracer: the flagship integrator, wavefront form.

Counterpart of ``buas_pathtracer_tpu/integrators/advanced.py`` (``advanced``,
:139; reference advanced_integrator, integrators.cpp:581-821): the nested-
dielectric material stack with air at the bottom, Beer's-law absorption,
Fresnel reflect/refract, metallic and roughness, lambertian BRDF, NEE with
uniform or importance light picking, MIS on both sides (the balance
heuristic, or the reference's arithmetic with ``reference_mis``), the
caustics toggle and Russian roulette.

Ray state is SoA ``(N,)`` tensors advanced one bounce per iteration of a
Python loop under a live mask; the loop ends after ``max_bounce_count``
bounces or when no ray is alive.  The JAX package's staged compaction
(``BUAS_PHASE_BLOCKS``) is left out: its docs/PERFORMANCE.md round 4i
records it as bit-identical to this single loop.  Environment-map NEE is
not ported (``Scene.pack`` refuses environment maps).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core import sampler as smp
from ..core.vec import (EPSILON, PI, Vec3, dot, exp as vexp, full_like, lerp,
                        max3, normalize, reflect, v3, where as vwhere, zeros)
from ..models.scene import PackedScene, SceneSettings
from ..ops import traverse_wide
from ..ops.shading import (cbrt, evaluate_checker, fresnel_dielectric,
                           map_to_cosine_weighted_hemisphere,
                           map_to_hemisphere, refract, sample_on_unit_sphere)
from ..ops.traverse import BIG_T
from .common import (light_pick_pdf, light_radius_of_prim, light_rows,
                     pick_random_light_slot, random_point_on_light_rows,
                     sample_sky, slot_to_prim)

STACK_DEPTH = 8  # reference uses 64 (integrators.cpp:602)


def advanced(ps: PackedScene, settings: SceneSettings, sampler: smp.Sampler,
             ray_o: Vec3, ray_d: Vec3, n_lights: int = 0):
    """Returns (color Vec3, sampler, stats (3,) float32 [rays, node visits,
    triangle tests])."""
    n = ray_o.x.shape[0]
    dev = ray_o.x.device
    max_bounces = int(settings.max_bounce_count)
    strategy = int(settings.sampling_strategy)
    nee = bool(settings.next_event_estimation) and n_lights > 0
    use_mis = bool(settings.use_mis)
    is_lights = bool(settings.importance_sample_lights)
    is_diffuse = bool(settings.importance_sample_diffuse)
    rr = bool(settings.russian_roulette)
    caustics = bool(settings.caustics)
    ref_mis = bool(settings.reference_mis)

    o, d, s = ray_o, ray_d, sampler
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    throughput = full_like(ray_o, 1.0)
    total = zeros(n, dev)
    stack = torch.zeros((STACK_DEPTH, n), dtype=torch.int64, device=dev)
    stack_at = torch.zeros(n, dtype=torch.int64, device=dev)
    is_specular = torch.ones(n, dtype=torch.bool, device=dev)  # (:615)
    prev_n = zeros(n, dev)
    stats = torch.zeros(3, dtype=torch.float32, device=dev)
    lane = torch.arange(STACK_DEPTH, device=dev)[:, None]

    bounce = 0
    while bounce < max_bounces and bool(alive.any()):
        # dead rays walk with max_t = -1: they pass through the traversal
        hit = traverse_wide.intersect_scene(
            ps, o, d, max_t=torch.where(alive, BIG_T, -1.0))
        found = hit.valid & alive
        missed = ~hit.valid & alive
        stats = stats + torch.stack([alive.sum().to(torch.float32),
                                     hit.node_visits.to(torch.float32),
                                     hit.tri_tests.to(torch.float32)])

        # ---- miss: sky, terminate (integrators.cpp:813-816) ----
        total = vwhere(missed, total + throughput * sample_sky(ps, d), total)

        # ---- orientation + stack-relative materials (:617-638) ----
        cos_i0 = -dot(d, hit.n)
        inside = cos_i0 < 0.0
        N = vwhere(inside, -hit.n, hit.n)
        cos_theta_i = torch.abs(cos_i0)

        surf_mat = hit.mat_id
        top = torch.gather(stack, 0, stack_at[None, :])[0]
        below = torch.gather(stack, 0,
                             torch.clamp(stack_at - 1, min=0)[None, :])[0]
        mat_i = torch.where(inside, surf_mat, top)
        mat_t = torch.where(inside, below, surf_mat)
        miT = ps.mat16[mat_i].T  # (16, N)
        mtT = ps.mat16[mat_t].T
        t_code = mtT[15].to(torch.int64)  # flags | is_medium << 3

        # ---- Beer's law through the incident medium (:640-649) ----
        beer = vexp(Vec3(miT[6], miT[7], miT[8]) * (-hit.t))
        i_is_medium = miT[15].to(torch.int64) >= 8
        throughput = vwhere(found & i_is_medium, throughput * beer, throughput)

        # ---- emissive hit: direct or MIS-weighted, then terminate (:651-670)
        t_emissive = (t_code & 0x4) != 0
        emit = Vec3(mtT[3], mtT[4], mtT[5])
        if not nee:
            allow_direct = torch.ones(n, dtype=torch.bool, device=dev)
        elif caustics:
            allow_direct = is_specular
        else:
            allow_direct = is_specular & (bounce < 2)
        hit_emissive = found & t_emissive
        total = vwhere(hit_emissive & allow_direct,
                       total + throughput * emit, total)
        if nee and use_mis and bounce > 0:
            # BRDF-hit side of MIS: one-sample balance heuristic weight
            # brdf_pdf / (brdf_pdf + light_pdf_sa), light_pdf_sa the pdf NEE
            # would have used for this direction
            brdf_pdf = (dot(prev_n, d) / PI) if is_diffuse \
                else torch.full_like(d.x, 1.0 / (2.0 * PI))
            if ref_mis:
                light_pdf_ref = hit.t * hit.t / torch.clamp(cos_theta_i,
                                                            min=1e-12)
                w_brdf = 1.0 / torch.clamp(light_pdf_ref + brdf_pdf,
                                           min=1e-30)
            else:
                light_r = light_radius_of_prim(ps, hit.hit_id)
                area = 2.0 * PI * light_r * light_r
                # the shading point of the previous bounce is this origin
                pick_pdf = light_pick_pdf(ps, o, hit.hit_id, is_lights)
                light_pdf_sa = pick_pdf * hit.t * hit.t / torch.clamp(
                    cos_theta_i * area, min=1e-12)
                w_brdf = brdf_pdf / torch.clamp(brdf_pdf + light_pdf_sa,
                                                min=1e-30)
            mis_case = hit_emissive & ~allow_direct
            total = vwhere(mis_case, total + throughput * emit * w_brdf, total)

        # ---- fresnel split (:672-684) ----
        eta_i = miT[12]
        eta_t = torch.clamp(mtT[12], min=1e-6)
        eta_ratio = eta_i / eta_t
        reflectance, cos_theta_t = fresnel_dielectric(cos_theta_i, eta_i,
                                                      eta_t, eta_ratio)
        metallic = mtT[13]
        reflectance = lerp(reflectance, 1.0, metallic)

        s, reflect_test = smp.sample_1d(s, strategy,
                                        smp.SampleDimension.REFLECTANCE, bounce)
        do_reflect = reflect_test < reflectance

        # ---- reflect branch (:686-700) ----
        refl_d = reflect(d, N)
        state, u1 = rng.next_unilateral(s.state)
        state, u2 = rng.next_unilateral(state)
        state, u3 = rng.next_unilateral(state)
        s = s._replace(state=state)
        fuzz = sample_on_unit_sphere(u1, u2) * cbrt(u3)
        roughness = mtT[14]
        rough_d = normalize(refl_d * (1.0 + EPSILON) + fuzz * roughness)
        refl_d = vwhere(roughness > 0.0, rough_d, refl_d)
        refl_o = hit.p + refl_d * EPSILON
        albedo_t = Vec3(mtT[0], mtT[1], mtT[2])
        refl_tint = lerp(v3(1.0), albedo_t, metallic)

        # ---- refract branch (nested dielectrics, :702-723) ----
        t_is_medium = t_code >= 8
        do_refract = ~do_reflect & t_is_medium
        refr_d = refract(d, N, cos_theta_i, cos_theta_t, eta_ratio)
        refr_o = hit.p + refr_d * EPSILON
        pop = do_refract & found & inside & (stack_at > 0)
        push = do_refract & found & ~inside & (stack_at < STACK_DEPTH - 1)
        new_at = stack_at + push.to(torch.int64) - pop.to(torch.int64)
        write = push[None, :] & (lane == new_at[None, :])
        stack = torch.where(write, mat_t[None, :], stack)
        stack_at = new_at

        # ---- diffuse branch (:725-795) ----
        do_diffuse = ~do_reflect & ~t_is_medium
        albedo = evaluate_checker(albedo_t, Vec3(mtT[9], mtT[10], mtT[11]),
                                  (t_code & 0x2) != 0, hit.p)
        brdf = albedo * (1.0 / PI)

        # ---- next-event estimation: one shadow wave per bounce ----
        if nee:
            s, lp_u = smp.sample_1d(s, strategy,
                                    smp.SampleDimension.LIGHT_SELECTION, bounce)
            slot, light_rcp_pdf = pick_random_light_slot(ps, lp_u, hit.p,
                                                         is_lights)
            s, dl_u, dl_v = smp.sample_2d(
                s, strategy, smp.SampleDimension.DIRECT_LIGHTING, bounce)
            lT = light_rows(ps, slot)
            ls = random_point_on_light_rows(lT, dl_u, dl_v, hit.p)
            n_dot_l = dot(N, ls.L)
            nl_dot_l = -dot(ls.Nl, ls.L)
            facing = (n_dot_l > 0.0) & (nl_dot_l > 0.0) & do_diffuse & found \
                & ~t_emissive
            occluded = traverse_wide.intersect_shadow_ray(
                ps, hit.p + ls.L * EPSILON, ls.L,
                torch.where(facing, ls.dist - 2.0 * EPSILON, -1.0),
                slot_to_prim(ps, slot))
            visible = facing & ~occluded
            solid_angle = (nl_dot_l * ls.A) / torch.clamp(ls.dist_sq,
                                                          min=1e-12)
            # light_rcp_pdf is the PICK probability (integrators.cpp:163,175)
            light_pdf_sa = light_rcp_pdf / torch.clamp(solid_angle, min=1e-12)
            brdf_pdf = (n_dot_l / PI) if is_diffuse \
                else torch.full_like(n_dot_l, 1.0 / (2.0 * PI))
            if use_mis and ref_mis:
                pdf = (1.0 / torch.clamp(solid_angle, min=1e-12) + brdf_pdf) \
                    * light_rcp_pdf
            elif use_mis:
                pdf = light_pdf_sa + brdf_pdf
            else:
                pdf = light_pdf_sa
            lemit = Vec3(lT[13], lT[14], lT[15])
            contrib = throughput * brdf * lemit * (
                n_dot_l / torch.clamp(pdf, min=1e-30))
            total = vwhere(visible, total + contrib, total)
            stats = stats + torch.stack([
                facing.sum().to(torch.float32),
                torch.zeros((), device=dev), torch.zeros((), device=dev)])

        # ---- indirect bounce (:777-795) ----
        s, il_u, il_v = smp.sample_2d(
            s, strategy, smp.SampleDimension.INDIRECT_LIGHTING, bounce)
        if is_diffuse:
            R = map_to_cosine_weighted_hemisphere(N, il_u, il_v)
            diff_tp_scale = full_like(throughput, PI)
        else:
            R = map_to_hemisphere(N, il_u, il_v)
            c = 2.0 * PI * dot(N, R)
            diff_tp_scale = Vec3(c, c, c)
        diff_o = hit.p + N * EPSILON

        # ---- merge branches ----
        new_specular = ~do_diffuse
        new_d = vwhere(do_reflect, refl_d, vwhere(do_refract, refr_d, R))
        new_o = vwhere(do_reflect, refl_o, vwhere(do_refract, refr_o, diff_o))
        one = torch.ones_like(d.x)
        tp_mult = vwhere(do_reflect, refl_tint,
                         vwhere(do_refract, v3(one), diff_tp_scale * brdf))
        cont = found & ~t_emissive
        throughput = vwhere(cont, throughput * tp_mult, throughput)

        # ---- russian roulette (:801-811) ----
        if rr:
            p = torch.clamp(max3(throughput), 0.1, 0.9)
            s, rr_u = smp.sample_1d(s, strategy, smp.SampleDimension.ROULETTE,
                                    bounce)
            kill = cont & ~new_specular & (rr_u > p)
            boost = cont & ~new_specular & ~kill
            throughput = vwhere(boost, throughput * (1.0 / p), throughput)
            cont = cont & ~kill

        o = vwhere(cont, new_o, o)
        d = vwhere(cont, new_d, d)
        prev_n = vwhere(cont, N, prev_n)
        is_specular = torch.where(cont, new_specular, is_specular)
        alive = cont
        bounce += 1

    return total, s, stats
