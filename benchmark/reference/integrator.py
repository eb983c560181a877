"""The Advanced Pathtracer (integrators.cpp:581-821) over a batch of rays.

The nested-dielectric material stack with air at the bottom, Beer's-law
absorption, Fresnel reflection and refraction, metallic and roughness, the
lambertian BRDF, next-event estimation with importance-picked sphere
lights, MIS on both sides by the balance heuristic, the caustics switch and
Russian roulette.  Every ray carries its own state; the loop runs
``max_bounce_count`` bounces or until no ray lives.  Sample dimensions are
drawn in the source's order, so a ray's random numbers depend only on its
pixel and sample index.

With an environment map (``envmap.py``) a ray that misses sees the map
instead of the gradient sky, and, when next-event estimation and env NEE
are both on, every NEE bounce also samples the map: after the light's
draws, ``ENV_LIGHTING`` picks a direction from the map's alias table, a
shadow ray with no ignored primitive runs to ``BIG_T``, and the map's
radiance comes in weighted by the balance heuristic against the BRDF's
pdf.  A BRDF-sampled ray that then reaches the map weighs the same
heuristic from the other side; specular and primary rays see the map
whole.  The source stubbed env NEE (integrators.cpp:230-233), so this
follows the renderer's own extension, two details included: on a miss the
BRDF's pdf clamps its cosine at zero (at a light it does not), and env NEE
runs in a scene without lights too.
"""

from __future__ import annotations

import torch

from . import envmap, rng
from . import sampler as smp
from .scene import PRIM_SPHERE, RefScene
from .shading import (cbrt, checker, fresnel_dielectric,
                      map_to_cosine_weighted_hemisphere, map_to_hemisphere,
                      point_on_sphere_light, refract, sample_on_unit_sphere,
                      sky)
from .tracer import BIG_T, Tracer
from .vec import (EPSILON, PI, Vec3, dot, full_like, lerp, max3, normalize,
                  reflect, v3, vexp, where as vwhere, zeros)

STACK_DEPTH = 8


def _light_weights(rs: RefScene, p: Vec3):
    """(N, L) pick weights: max3(emission) * pi r^2 / dist^2 of each sphere
    light (0 for other lights)."""
    lp = rs.lights
    fwd = rs.prim_fwd[lp]
    vx = fwd[:, 3][None, :] - p.x[:, None]
    vy = fwd[:, 7][None, :] - p.y[:, None]
    vz = fwd[:, 11][None, :] - p.z[:, None]
    dist_sq = vx * vx + vy * vy + vz * vz
    lmat = rs.prim_mat[lp]
    e = rs.emission
    lmax = torch.maximum(e.x[lmat], torch.maximum(e.y[lmat], e.z[lmat]))
    r = rs.prim_r[lp]
    is_sph = (rs.prim_type[lp] == PRIM_SPHERE).to(torch.float32)
    return (lmax[None, :] * is_sph[None, :] * PI * r[None, :] ** 2
            / torch.clamp(dist_sq, min=1e-12))


def pick_light(rs: RefScene, u, p: Vec3, importance: bool):
    """(light slot, pick probability) (integrators.cpp:135-192)."""
    n_l = int(rs.lights.shape[0])
    if not importance or n_l == 1:
        slot = torch.clamp((u * n_l - 1e-3).to(torch.int64), 0, n_l - 1)
        return slot, torch.full_like(u, 1.0 / n_l)
    w = _light_weights(rs, p)
    cdf = [w[:, 0]]
    for k in range(1, n_l):
        cdf.append(cdf[-1] + w[:, k])
    total = cdf[-1]
    e = total * u
    slot = torch.zeros_like(u, dtype=torch.int64)
    for c in cdf:
        slot = slot + (c < e).to(torch.int64)
    slot = torch.clamp(slot, 0, n_l - 1)
    sel = torch.gather(w, 1, slot[:, None])[:, 0]
    return slot, sel / torch.clamp(total, min=1e-30)


def pick_pdf(rs: RefScene, p: Vec3, hit_prim, importance: bool):
    """The probability that ``pick_light`` at ``p`` picks ``hit_prim``."""
    n_l = int(rs.lights.shape[0])
    if not importance or n_l == 1:
        return torch.full_like(p.x, 1.0 / n_l)
    w = _light_weights(rs, p)
    total = w.sum(dim=-1)
    sel = (rs.lights[None, :] == hit_prim[:, None]).to(torch.float32)
    return (w * sel).sum(dim=-1) / torch.clamp(total, min=1e-30)


def light_radius(rs: RefScene, hit_prim):
    out = torch.zeros(hit_prim.shape, dtype=torch.float32,
                      device=hit_prim.device)
    for k in range(int(rs.lights.shape[0])):
        out = torch.where(hit_prim == rs.lights[k],
                          rs.prim_r[rs.lights[k]], out)
    return out


def _mat(rs: RefScene, m):
    """Material columns of ids ``m``."""
    g = lambda v: Vec3(v.x[m], v.y[m], v.z[m])  # noqa: E731
    return dict(albedo=g(rs.albedo), emission=g(rs.emission),
                absorb=g(rs.absorb), checker=g(rs.checker), ior=rs.ior[m],
                metallic=rs.metallic[m], roughness=rs.roughness[m],
                flags=rs.flags[m], is_medium=rs.is_medium[m])


def trace(rs: RefScene, tracer: Tracer, s: smp.Sampler, o: Vec3, d: Vec3):
    """The colour each ray (o, d) brings back; ``s`` the rays' sampler,
    already past the AA and DOF draws."""
    st = rs.settings
    n = o.x.shape[0]
    dev = o.x.device
    nee = bool(st["next_event_estimation"]) and int(rs.lights.shape[0]) > 0
    env = rs.env
    env_nee = bool(st["next_event_estimation"]) and env is not None \
        and bool(st["env_nee"])
    is_lights = bool(st["importance_sample_lights"])
    is_diffuse = bool(st["importance_sample_diffuse"])
    use_mis = bool(st["use_mis"])
    caustics = bool(st["caustics"])
    lane = torch.arange(STACK_DEPTH, device=dev)[:, None]

    alive = torch.ones(n, dtype=torch.bool, device=dev)
    tp = full_like(o, 1.0)
    total = zeros(n, dev)
    stack = torch.zeros((STACK_DEPTH, n), dtype=torch.int64, device=dev)
    stack_at = torch.zeros(n, dtype=torch.int64, device=dev)
    is_spec = torch.ones(n, dtype=torch.bool, device=dev)
    prev_n = zeros(n, dev)
    for bounce in range(int(st["max_bounce_count"])):
        if not bool(alive.any()):
            break
        hit = tracer.closest(o, d, torch.where(alive, BIG_T, -1.0))
        found = hit.valid & alive
        missed = ~hit.valid & alive
        bg = sky(d, rs.sky_bot, rs.sky_top) if env is None \
            else envmap.lookup(env, d)
        if env_nee:
            brdf_pdf = (torch.clamp(dot(prev_n, d), min=0.0) / PI) \
                if is_diffuse else 1.0 / (2.0 * PI)
            if use_mis:
                w_bg = brdf_pdf / torch.clamp(brdf_pdf + envmap.pdf(env, d),
                                              min=1e-30)
                w_bg = torch.where(is_spec, 1.0, w_bg)
            else:
                w_bg = is_spec.to(torch.float32)
            total = vwhere(missed, total + tp * bg * w_bg, total)
        else:
            total = vwhere(missed, total + tp * bg, total)

        # orientation and the materials on each side (the stack's top)
        cos_i0 = -dot(d, hit.n)
        inside = cos_i0 < 0.0
        N = vwhere(inside, -hit.n, hit.n)
        cos_i = torch.abs(cos_i0)
        top = torch.gather(stack, 0, stack_at[None, :])[0]
        below = torch.gather(stack, 0,
                             torch.clamp(stack_at - 1, min=0)[None, :])[0]
        mat_i = torch.where(inside, hit.mat_id, top)
        mat_t = torch.where(inside, below, hit.mat_id)
        mi, mt = _mat(rs, mat_i), _mat(rs, mat_t)

        # Beer's law through the medium the ray crossed
        beer = vexp(mi["absorb"] * (-hit.t))
        tp = vwhere(found & mi["is_medium"], tp * beer, tp)

        # an emitter: direct, or MIS-weighted against NEE, then the end
        t_emissive = (mt["flags"] & 0x4) != 0
        emit = mt["emission"]
        if not nee:
            allow = torch.ones(n, dtype=torch.bool, device=dev)
        elif caustics:
            allow = is_spec
        else:
            allow = is_spec & (bounce < 2)
        hit_emissive = found & t_emissive
        total = vwhere(hit_emissive & allow, total + tp * emit, total)
        if nee and use_mis and bounce > 0:
            brdf_pdf = (dot(prev_n, d) / PI) if is_diffuse \
                else torch.full_like(d.x, 1.0 / (2.0 * PI))
            r_l = light_radius(rs, hit.hit_id)
            area = 2.0 * PI * r_l * r_l
            pdf_sa = pick_pdf(rs, o, hit.hit_id, is_lights) * hit.t * hit.t \
                / torch.clamp(cos_i * area, min=1e-12)
            w_brdf = brdf_pdf / torch.clamp(brdf_pdf + pdf_sa, min=1e-30)
            total = vwhere(hit_emissive & ~allow,
                           total + tp * emit * w_brdf, total)

        # Fresnel: reflect or transmit
        eta_i = mi["ior"]
        eta_t = torch.clamp(mt["ior"], min=1e-6)
        eta_ratio = eta_i / eta_t
        refl, cos_t = fresnel_dielectric(cos_i, eta_i, eta_t, eta_ratio)
        metallic = mt["metallic"]
        refl = lerp(refl, 1.0, metallic)
        s, reflect_u = smp.sample_1d(s, smp.REFLECTANCE, bounce)
        do_reflect = reflect_u < refl

        refl_d = reflect(d, N)
        state, u1 = rng.next_unilateral(s.state)
        state, u2 = rng.next_unilateral(state)
        state, u3 = rng.next_unilateral(state)
        s = s._replace(state=state)
        fuzz = sample_on_unit_sphere(u1, u2) * cbrt(u3)
        rough = mt["roughness"]
        refl_d = vwhere(rough > 0.0,
                        normalize(refl_d * (1.0 + EPSILON) + fuzz * rough),
                        refl_d)
        refl_o = hit.p + refl_d * EPSILON
        refl_tint = lerp(v3(1.0), mt["albedo"], metallic)

        # refraction through nested dielectrics: push on entry, pop on exit
        t_medium = mt["is_medium"]
        do_refract = ~do_reflect & t_medium
        refr_d = refract(d, N, cos_i, cos_t, eta_ratio)
        refr_o = hit.p + refr_d * EPSILON
        pop = do_refract & found & inside & (stack_at > 0)
        push = do_refract & found & ~inside & (stack_at < STACK_DEPTH - 1)
        new_at = stack_at + push.to(torch.int64) - pop.to(torch.int64)
        stack = torch.where(push[None, :] & (lane == new_at[None, :]),
                            mat_t[None, :], stack)
        stack_at = new_at

        do_diffuse = ~do_reflect & ~t_medium
        albedo = checker(mt["albedo"], mt["checker"], (mt["flags"] & 0x2) != 0,
                         hit.p)
        brdf = albedo * (1.0 / PI)

        # next-event estimation towards one picked light
        if nee:
            s, lp_u = smp.sample_1d(s, smp.LIGHT_SELECTION, bounce)
            slot, pick = pick_light(rs, lp_u, hit.p, is_lights)
            s, dl_u, dl_v = smp.sample_2d(s, smp.DIRECT_LIGHTING, bounce)
            lprim = rs.lights[slot]
            ls = point_on_sphere_light(rs.prim_fwd[lprim].T, rs.prim_r[lprim],
                                       dl_u, dl_v, hit.p)
            n_dot_l = dot(N, ls.L)
            nl_dot_l = -dot(ls.Nl, ls.L)
            facing = (n_dot_l > 0.0) & (nl_dot_l > 0.0) & do_diffuse & found \
                & ~t_emissive
            occ = tracer.occluded(hit.p + ls.L * EPSILON, ls.L,
                                  torch.where(facing, ls.dist - 2.0 * EPSILON,
                                              -1.0), lprim)
            visible = facing & ~occ
            solid = (nl_dot_l * ls.A) / torch.clamp(ls.dist_sq, min=1e-12)
            light_sa = pick / torch.clamp(solid, min=1e-12)
            brdf_pdf = (n_dot_l / PI) if is_diffuse \
                else torch.full_like(n_dot_l, 1.0 / (2.0 * PI))
            pdf = light_sa + brdf_pdf if use_mis else light_sa
            lmat = rs.prim_mat[lprim]
            lemit = Vec3(rs.emission.x[lmat], rs.emission.y[lmat],
                         rs.emission.z[lmat])
            contrib = tp * brdf * lemit * (n_dot_l
                                           / torch.clamp(pdf, min=1e-30))
            total = vwhere(visible, total + contrib, total)

        # next-event estimation towards the environment map
        if env_nee:
            s, de_u, de_v = smp.sample_2d(s, smp.ENV_LIGHTING, bounce)
            d_e, pdf_e, rad_e = envmap.sample(env, de_u, de_v)
            n_dot_e = dot(N, d_e)
            facing = (n_dot_e > 0.0) & do_diffuse & found & ~t_emissive
            occ = tracer.occluded(hit.p + d_e * EPSILON, d_e,
                                  torch.where(facing, BIG_T, -1.0), None)
            if use_mis:
                pdf = pdf_e + ((n_dot_e / PI) if is_diffuse
                               else 1.0 / (2.0 * PI))
            else:
                pdf = pdf_e
            contrib = tp * brdf * rad_e * (n_dot_e
                                           / torch.clamp(pdf, min=1e-30))
            total = vwhere(facing & ~occ, total + contrib, total)

        # the indirect bounce
        s, il_u, il_v = smp.sample_2d(s, smp.INDIRECT_LIGHTING, bounce)
        if is_diffuse:
            R = map_to_cosine_weighted_hemisphere(N, il_u, il_v)
            diff_scale = full_like(tp, PI)
        else:
            R = map_to_hemisphere(N, il_u, il_v)
            c = 2.0 * PI * dot(N, R)
            diff_scale = Vec3(c, c, c)
        diff_o = hit.p + N * EPSILON

        new_spec = ~do_diffuse
        new_d = vwhere(do_reflect, refl_d, vwhere(do_refract, refr_d, R))
        new_o = vwhere(do_reflect, refl_o,
                       vwhere(do_refract, refr_o, diff_o))
        one = torch.ones_like(d.x)
        mult = vwhere(do_reflect, refl_tint,
                      vwhere(do_refract, v3(one), diff_scale * brdf))
        cont = found & ~t_emissive
        tp = vwhere(cont, tp * mult, tp)

        if bool(st["russian_roulette"]):
            p = torch.clamp(max3(tp), 0.1, 0.9)
            s, rr_u = smp.sample_1d(s, smp.ROULETTE, bounce)
            kill = cont & ~new_spec & (rr_u > p)
            boost = cont & ~new_spec & ~kill
            tp = vwhere(boost, tp * (1.0 / p), tp)
            cont = cont & ~kill

        alive = cont
        o = vwhere(cont, new_o, o)
        d = vwhere(cont, new_d, d)
        is_spec = torch.where(cont, new_spec, is_spec)
        prev_n = vwhere(cont, N, prev_n)
    return total
