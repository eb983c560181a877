"""Advanced Pathtracer: the flagship integrator, wavefront form.

Counterpart of ``buas_pathtracer_tpu/integrators/advanced.py`` (``advanced``,
:139; reference advanced_integrator, integrators.cpp:581-821): the nested-
dielectric material stack with air at the bottom, Beer's-law absorption,
Fresnel reflect/refract, metallic and roughness, lambertian BRDF, NEE with
uniform or importance light picking, MIS on both sides (the balance
heuristic, or the reference's arithmetic with ``reference_mis``), the
caustics toggle, Russian roulette, and environment-map NEE (alias-sampled
env directions, MIS-weighted against BRDF rays that reach the sky) whenever
the scene packed an environment map.

Ray state is SoA ``(N,)`` tensors advanced one bounce per iteration of a
Python loop under a live mask; the loop ends after ``max_bounce_count``
bounces or when no ray is alive.

A bounce is the closest-hit walk, the shading up to next-event
estimation (``_shade_hit``), NEE's samples and shadow walk (``_nee``) and
the rest of the shading (``_shade_next``).  On the card these are the CUDA
kernels ``shade_hit``, ``nee_sample`` (then the occlusion walk) and
``shade_next`` (``ops/shade_kernel.py``, ``csrc/shade.cu``,
``csrc/nee.cu``), which update the loop's state in place (the state is the
loop's own from its entry: the caller's rays and sampler are not written);
``_shade_hit_plain``, ``_nee_plain`` and ``_shade_next_plain`` are their
plain version, which CPU tensors take.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from ..core import sampler as smp
from ..core.vec import (EPSILON, PI, Vec3, dot, exp as vexp, full_like, lerp,
                        max3, normalize, reflect, v3, where as vwhere)
from ..models.scene import PackedScene, SceneSettings
from ..ops import envmap, shade_kernel, traverse_wide
from ..ops.shading import (cbrt, evaluate_checker, fresnel_dielectric,
                           map_to_cosine_weighted_hemisphere,
                           map_to_hemisphere, refract, sample_on_unit_sphere)
from ..ops.traverse import BIG_T
from ..utils import trace
from .common import (has_env, light_pick_pdf, light_radius_of_prim,
                     light_rows, pick_random_light_slot,
                     random_point_on_light_rows, sample_sky, slot_to_prim)

STACK_DEPTH = 8  # reference uses 64 (integrators.cpp:602)

class _Flags(NamedTuple):
    max_bounces: int
    strategy: int
    nee: bool
    env_nee: bool
    use_mis: bool
    is_lights: bool
    is_diffuse: bool
    rr: bool
    caustics: bool
    ref_mis: bool


class _State(NamedTuple):
    """Per-lane bounce state."""

    alive: torch.Tensor
    o: Vec3
    d: Vec3
    tp: Vec3
    total: Vec3
    s: smp.Sampler
    stack: torch.Tensor  # (STACK_DEPTH, N) int64 material ids
    stack_at: torch.Tensor
    is_spec: torch.Tensor
    prev_n: Vec3


def _flags(ps: PackedScene, settings: SceneSettings, n_lights: int):
    return _Flags(
        max_bounces=int(settings.max_bounce_count),
        strategy=int(settings.sampling_strategy),
        nee=bool(settings.next_event_estimation) and n_lights > 0,
        # env-map NEE: a second direct-light strategy whenever an env map
        # is packed (the reference stubbed it, integrators.cpp:230-233)
        env_nee=(bool(settings.next_event_estimation) and has_env(ps)
                 and bool(settings.env_nee)),
        use_mis=bool(settings.use_mis),
        is_lights=bool(settings.importance_sample_lights),
        is_diffuse=bool(settings.importance_sample_diffuse),
        rr=bool(settings.russian_roulette),
        caustics=bool(settings.caustics),
        ref_mis=bool(settings.reference_mis))


def _shadow(ps: PackedScene, queries):
    """Occlusion of each (o, d, max_t, ignored prim) query, all in one
    wave (the JAX package's form; on the H100 it measured no slower than a
    wave each, PERF.md)."""
    if len(queries) == 1:
        return [traverse_wide.intersect_shadow_ray(ps, *queries[0])]
    cat = torch.cat
    o = Vec3(*(cat([q[0][k] for q in queries]) for k in range(3)))
    d = Vec3(*(cat([q[1][k] for q in queries]) for k in range(3)))
    occ = traverse_wide.intersect_shadow_ray(
        ps, o, d, cat([q[2] for q in queries]), cat([q[3] for q in queries]))
    return list(torch.split(occ, [q[2].shape[0] for q in queries]))


class _Shade(NamedTuple):
    """What the hit's shading leaves for the NEE span and ``_shade_next``:
    the oriented normal, the lanes NEE serves (found, not emissive,
    diffuse), and the rest of the branch data: the plain version's values
    (``_Branches``), or the kernel's scratch (``ops/shade_kernel.py``)."""

    N: Vec3
    nee_lanes: torch.Tensor
    rest: object


class _Branches(NamedTuple):
    """The plain version's branch values between the two halves."""

    p: Vec3
    found: torch.Tensor
    t_emissive: torch.Tensor
    do_reflect: torch.Tensor
    do_refract: torch.Tensor
    do_diffuse: torch.Tensor
    refl_o: Vec3
    refl_d: Vec3
    refl_tint: Vec3
    refr_o: Vec3
    refr_d: Vec3
    brdf: Vec3


class _LightNee(NamedTuple):
    """The plain version's light sample and its shadow query's answer, as
    ``_shade_next_plain`` reads them."""

    facing: torch.Tensor
    occluded: torch.Tensor
    nl_dot_l: torch.Tensor
    area: torch.Tensor
    dist_sq: torch.Tensor
    rcp_pdf: torch.Tensor
    n_dot_l: torch.Tensor
    slot: torch.Tensor
    emission: Vec3


class _EnvNee(NamedTuple):
    facing: torch.Tensor
    occluded: torch.Tensor
    n_dot_e: torch.Tensor
    pdf: torch.Tensor
    radiance: Vec3


def _shade_hit_plain(ps: PackedScene, f: _Flags, st: _State, hit, stats,
                     bounce: int):
    """The shading of a bounce up to next-event estimation: the sky of the
    rays that missed, orientation and the stack's materials, Beer's law,
    emission and its MIS weight, Fresnel and the REFLECTANCE draw, the
    fuzz draws, the reflect and refract branches with the stack's push and
    pop, and the diffuse BRDF.  Returns (state, stats, _Shade)."""
    alive, o, d, throughput, total, s = (st.alive, st.o, st.d, st.tp,
                                         st.total, st.s)
    stack, stack_at, is_specular, prev_n = (st.stack, st.stack_at,
                                            st.is_spec, st.prev_n)
    n = alive.shape[0]
    dev = alive.device
    lane = torch.arange(STACK_DEPTH, device=dev)[:, None]
    strategy = f.strategy

    found = hit.valid & alive
    missed = ~hit.valid & alive
    stats = stats + torch.stack([alive.sum().to(torch.float32),
                                 hit.node_visits.to(torch.float32),
                                 hit.tri_tests.to(torch.float32)])

    # ---- miss: sky, terminate (integrators.cpp:813-816) ----
    sky = sample_sky(ps, d)
    if f.env_nee:
        # MIS against env NEE: BRDF-sampled rays that reach the sky weigh
        # brdf / (brdf + env) pdfs; specular and primary rays see the env
        # directly
        brdf_pdf_sky = (torch.clamp(dot(prev_n, d), min=0.0) / PI) \
            if f.is_diffuse else (1.0 / (2.0 * PI))
        if f.use_mis:
            he, we, _ = ps.env_pixels.shape
            e_pdf = envmap.env_pdf_table(ps.env_pdf_num, he, we, d)
            w_sky = brdf_pdf_sky / torch.clamp(brdf_pdf_sky + e_pdf,
                                               min=1e-30)
            w_sky = torch.where(is_specular, 1.0, w_sky)
        else:
            w_sky = is_specular.to(torch.float32)
        total = vwhere(missed, total + throughput * sky * w_sky, total)
    else:
        total = vwhere(missed, total + throughput * sky, total)

    # ---- orientation + stack-relative materials (:617-638) ----
    cos_i0 = -dot(d, hit.n)
    inside = cos_i0 < 0.0
    N = vwhere(inside, -hit.n, hit.n)
    cos_theta_i = torch.abs(cos_i0)

    surf_mat = hit.mat_id
    top = torch.gather(stack, 0, stack_at[None, :])[0]
    below = torch.gather(stack, 0, torch.clamp(stack_at - 1, min=0)[None, :])[0]
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
    if not f.nee:
        allow_direct = torch.ones(n, dtype=torch.bool, device=dev)
    elif f.caustics:
        allow_direct = is_specular
    else:
        allow_direct = is_specular & (bounce < 2)
    hit_emissive = found & t_emissive
    total = vwhere(hit_emissive & allow_direct, total + throughput * emit,
                   total)
    if f.nee and f.use_mis and bounce > 0:
        # BRDF-hit side of MIS: one-sample balance heuristic weight
        # brdf_pdf / (brdf_pdf + light_pdf_sa), light_pdf_sa the pdf NEE
        # would have used for this direction
        brdf_pdf = (dot(prev_n, d) / PI) if f.is_diffuse \
            else torch.full_like(d.x, 1.0 / (2.0 * PI))
        if f.ref_mis:
            light_pdf_ref = hit.t * hit.t / torch.clamp(cos_theta_i,
                                                        min=1e-12)
            w_brdf = 1.0 / torch.clamp(light_pdf_ref + brdf_pdf, min=1e-30)
        else:
            light_r = light_radius_of_prim(ps, hit.hit_id)
            area = 2.0 * PI * light_r * light_r
            # the shading point of the previous bounce is this origin
            pick_pdf = light_pick_pdf(ps, o, hit.hit_id, f.is_lights)
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
    reflectance, cos_theta_t = fresnel_dielectric(cos_theta_i, eta_i, eta_t,
                                                  eta_ratio)
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
    st = st._replace(tp=throughput, total=total, s=s, stack=stack,
                     stack_at=stack_at)
    rest = _Branches(hit.p, found, t_emissive, do_reflect, do_refract,
                     do_diffuse, refl_o, refl_d, refl_tint, refr_o, refr_d,
                     brdf)
    return st, stats, _Shade(N, do_diffuse & found & ~t_emissive, rest)


def _nee_queries(ps: PackedScene, f: _Flags, s: smp.Sampler, p: Vec3,
                 N: Vec3, lanes, bounce: int):
    """Next-event estimation's samples (light, then environment) for the
    lanes ``lanes``, and their shadow queries (o, d, max_t, ignored prim).
    Returns (sampler, _LightNee or None, _EnvNee or None, queries), the
    samples' ``occluded`` None."""
    n = lanes.shape[0]
    dev = lanes.device
    strategy = f.strategy
    queries = []
    light = env = None
    if f.nee:
        s, lp_u = smp.sample_1d(
            s, strategy, smp.SampleDimension.LIGHT_SELECTION, bounce)
        slot, light_rcp_pdf = pick_random_light_slot(ps, lp_u, p,
                                                     f.is_lights)
        s, dl_u, dl_v = smp.sample_2d(
            s, strategy, smp.SampleDimension.DIRECT_LIGHTING, bounce)
        lT = light_rows(ps, slot)
        ls = random_point_on_light_rows(lT, dl_u, dl_v, p)
        n_dot_l = dot(N, ls.L)
        nl_dot_l = -dot(ls.Nl, ls.L)
        facing = (n_dot_l > 0.0) & (nl_dot_l > 0.0) & lanes
        queries.append((p + ls.L * EPSILON, ls.L,
                        torch.where(facing, ls.dist - 2.0 * EPSILON, -1.0),
                        slot_to_prim(ps, slot)))
        light = _LightNee(facing, None, nl_dot_l, ls.A, ls.dist_sq,
                          light_rcp_pdf, n_dot_l, slot,
                          Vec3(lT[13], lT[14], lT[15]))
    if f.env_nee:
        s, e_u, e_v = smp.sample_2d(
            s, strategy, smp.SampleDimension.ENV_LIGHTING, bounce)
        d_e, pdf_e, rad_e = envmap.sample_env_alias(
            ps.env_alias_prob, ps.env_alias_idx, ps.env_pdf_num,
            ps.env_pixels, e_u, e_v)
        n_dot_e = dot(N, d_e)
        facing_e = (n_dot_e > 0.0) & lanes
        queries.append((p + d_e * EPSILON, d_e,
                        torch.where(facing_e, BIG_T, -1.0),
                        torch.full((n,), -1, dtype=torch.int64, device=dev)))
        env = _EnvNee(facing_e, None, n_dot_e, pdf_e, rad_e)
    return s, light, env, queries


def _nee_plain(ps: PackedScene, f: _Flags, s: smp.Sampler, p: Vec3, N: Vec3,
               lanes, bounce: int):
    """Next-event estimation's samples and their shadow queries (reference
    intersect_shadow_ray, intersection.cpp:600-604) in one wave, for the
    lanes ``lanes``.  Returns (sampler, _LightNee or None, _EnvNee or
    None)."""
    s, light, env, queries = _nee_queries(ps, f, s, p, N, lanes, bounce)
    occ = _shadow(ps, queries) if queries else []
    if light is not None:
        light = light._replace(occluded=occ[0])
    if env is not None:
        env = env._replace(occluded=occ[-1])
    return s, light, env


def _shadow_walk(ps: PackedScene, nee: shade_kernel.Nee):
    """The occlusion walk of ``nee_sample``'s wave: ``nee`` with the walk's
    prim."""
    return nee._replace(prim=traverse_wide.occlusion_walk(ps, *nee.rays()))


def _nee(ps: PackedScene, f: _Flags, st: _State, p: Vec3, sh: _Shade,
         bounce: int):
    """``_nee_plain`` on CPU tensors, with the hit point ``p``; on the card
    the ``nee_sample`` kernel, which draws from the state's RNG in place,
    then the occlusion walk of its wave.  Returns (state, NEE): (_LightNee
    or None, _EnvNee or None) on the CPU, a ``shade_kernel.Nee`` (None when
    NEE is off) on the card."""
    if st.alive.device.type != "cuda":
        s, light, env = _nee_plain(ps, f, st.s, p, sh.N, sh.nee_lanes,
                                   bounce)
        return st._replace(s=s), (light, env)
    if not (f.nee or f.env_nee):
        return st, None
    return st, _shadow_walk(
        ps, shade_kernel.nee_sample(ps, f, st, sh.rest, bounce))


def _shade_next_plain(ps: PackedScene, f: _Flags, st: _State, sh: _Shade,
                      light, env, stats, bounce: int):
    """The shading of a bounce after next-event estimation: the light and
    environment contributions, the INDIRECT_LIGHTING draw and its
    hemisphere, the branches' merge, Russian roulette and the new state.
    ``st.s`` is the sampler that NEE left.  Returns (state, stats)."""
    o, d, throughput, total, s = st.o, st.d, st.tp, st.total, st.s
    is_specular, prev_n = st.is_spec, st.prev_n
    dev = o.x.device
    strategy = f.strategy
    N = sh.N
    (p, found, t_emissive, do_reflect, do_refract, do_diffuse, refl_o,
     refl_d, refl_tint, refr_o, refr_d, brdf) = sh.rest

    if f.nee:
        facing, nl_dot_l, n_dot_l = light.facing, light.nl_dot_l, \
            light.n_dot_l
        light_rcp_pdf = light.rcp_pdf
        visible = facing & ~light.occluded
        solid_angle = (nl_dot_l * light.area) / torch.clamp(light.dist_sq,
                                                            min=1e-12)
        # light_rcp_pdf is the PICK probability (integrators.cpp:163,175)
        light_pdf_sa = light_rcp_pdf / torch.clamp(solid_angle, min=1e-12)
        brdf_pdf = (n_dot_l / PI) if f.is_diffuse \
            else torch.full_like(n_dot_l, 1.0 / (2.0 * PI))
        if f.use_mis and f.ref_mis:
            pdf = (1.0 / torch.clamp(solid_angle, min=1e-12) + brdf_pdf) \
                * light_rcp_pdf
        elif f.use_mis:
            pdf = light_pdf_sa + brdf_pdf
        else:
            pdf = light_pdf_sa
        lemit = light.emission
        contrib = throughput * brdf * lemit * (
            n_dot_l / torch.clamp(pdf, min=1e-30))
        total = vwhere(visible, total + contrib, total)
        stats = stats + torch.stack([
            facing.sum().to(torch.float32),
            torch.zeros((), device=dev), torch.zeros((), device=dev)])

    # ---- env-map NEE shading ----
    if f.env_nee:
        facing_e, n_dot_e, pdf_e, rad_e = (env.facing, env.n_dot_e, env.pdf,
                                           env.radiance)
        visible_e = facing_e & ~env.occluded
        if f.use_mis:
            brdf_pdf_e = (n_dot_e / PI) if f.is_diffuse \
                else (1.0 / (2.0 * PI))
            pdf_tot = pdf_e + brdf_pdf_e
        else:
            pdf_tot = pdf_e
        contrib_e = throughput * brdf * rad_e * (
            n_dot_e / torch.clamp(pdf_tot, min=1e-30))
        total = vwhere(visible_e, total + contrib_e, total)
        stats = stats + torch.stack([
            facing_e.sum().to(torch.float32),
            torch.zeros((), device=dev), torch.zeros((), device=dev)])

    # ---- indirect bounce (:777-795) ----
    s, il_u, il_v = smp.sample_2d(
        s, strategy, smp.SampleDimension.INDIRECT_LIGHTING, bounce)
    if f.is_diffuse:
        R = map_to_cosine_weighted_hemisphere(N, il_u, il_v)
        diff_tp_scale = full_like(throughput, PI)
    else:
        R = map_to_hemisphere(N, il_u, il_v)
        c = 2.0 * PI * dot(N, R)
        diff_tp_scale = Vec3(c, c, c)
    diff_o = p + N * EPSILON

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
    if f.rr:
        p = torch.clamp(max3(throughput), 0.1, 0.9)
        s, rr_u = smp.sample_1d(s, strategy, smp.SampleDimension.ROULETTE,
                                bounce)
        kill = cont & ~new_specular & (rr_u > p)
        boost = cont & ~new_specular & ~kill
        throughput = vwhere(boost, throughput * (1.0 / p), throughput)
        cont = cont & ~kill

    st = st._replace(
        alive=cont, o=vwhere(cont, new_o, o), d=vwhere(cont, new_d, d),
        tp=throughput, total=total, s=s,
        is_spec=torch.where(cont, new_specular, is_specular),
        prev_n=vwhere(cont, N, prev_n))
    return st, stats


def _shade_hit(ps: PackedScene, f: _Flags, st: _State, hit, stats,
               bounce: int):
    """``_shade_hit_plain`` on CPU tensors; on the card the ``shade_hit``
    kernel, which updates the loop's state and ``stats`` in place."""
    if st.alive.device.type != "cuda":
        return _shade_hit_plain(ps, f, st, hit, stats, bounce)
    scratch = shade_kernel.shade_hit(ps, f, st, hit, stats, bounce)
    return st, stats, _Shade(shade_kernel.normal(scratch),
                             shade_kernel.nee_lanes(scratch), scratch)


def _shade_next(ps: PackedScene, f: _Flags, st: _State, sh: _Shade, nee,
                stats, bounce: int):
    """``_shade_next_plain`` on CPU tensors; on the card the ``shade_next``
    kernel, in place as ``_shade_hit``.  ``nee`` is ``_nee``'s."""
    if st.alive.device.type != "cuda":
        return _shade_next_plain(ps, f, st, sh, *nee, stats, bounce)
    shade_kernel.shade_next(ps, f, st, sh.rest, nee, stats, bounce)
    return st, stats


def _bounce(ps: PackedScene, f: _Flags, st: _State, stats, bounce: int):
    """One bounce of every lane; returns the new state and stats.  Dead
    lanes pass through the traversal with max_t = -1."""
    with trace.span("pt.intersect"):
        hit = traverse_wide.intersect_scene(
            ps, st.o, st.d, max_t=torch.where(st.alive, BIG_T, -1.0))
    st, stats, sh = _shade_hit(ps, f, st, hit, stats, bounce)
    with trace.span("pt.nee"):
        st, nee = _nee(ps, f, st, hit.p, sh, bounce)
    return _shade_next(ps, f, st, sh, nee, stats, bounce)


def _loop(ps: PackedScene, f: _Flags, st: _State, stats):
    """Bounces while any lane lives, up to ``max_bounces``.  Each bounce
    goes into the frame record (``utils/trace.py``).  Returns (state,
    stats)."""
    for bounce in range(f.max_bounces):
        with trace.span("pt.bounce"):
            nlive = trace.wait("live_count", int, st.alive.sum())
            if nlive == 0:
                break
            trace.bounce(bounce, int(st.alive.shape[0]), nlive)
            st, stats = _bounce(ps, f, st, stats, bounce)
    return st, stats


def _entry_state(ray_o: Vec3, ray_d: Vec3, sampler: smp.Sampler) -> _State:
    """The loop's own state at its entry, one tensor a field (alive and
    the specular flag too): the kernels update it in place, never the
    caller's rays or sampler."""
    n = ray_o.x.shape[0]
    dev = ray_o.x.device
    fs = torch.zeros((15, n), dtype=torch.float32, device=dev)
    torch.stack([*ray_o, *ray_d], out=fs[:6])
    fs[6:9] = 1.0
    v = [Vec3(fs[3 * k], fs[3 * k + 1], fs[3 * k + 2]) for k in range(5)]
    ints = torch.zeros((STACK_DEPTH + 1, n), dtype=torch.int64, device=dev)
    flags = torch.ones((2, n), dtype=torch.bool, device=dev)
    return _State(
        alive=flags[0], o=v[0], d=v[1], tp=v[2], total=v[3],
        s=sampler._replace(state=sampler.state.clone()),
        stack=ints[1:], stack_at=ints[0],
        is_spec=flags[1],  # is_specular_bounce starts true (:615)
        prev_n=v[4])


def advanced(ps: PackedScene, settings: SceneSettings, sampler: smp.Sampler,
             ray_o: Vec3, ray_d: Vec3, n_lights: int = 0):
    """Returns (color Vec3, sampler, stats (3,) float32 [rays, node visits,
    triangle tests])."""
    f = _flags(ps, settings, n_lights)
    st = _entry_state(ray_o, ray_d, sampler)
    stats = torch.zeros(3, dtype=torch.float32, device=ray_o.x.device)
    st, stats = _loop(ps, f, st, stats)
    return st.total, st.s, stats
