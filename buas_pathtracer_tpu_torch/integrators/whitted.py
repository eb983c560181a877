"""Whitted-style integrator (integrators.cpp:311-426), wavefront form.

Counterpart of ``buas_pathtracer_tpu/integrators/whitted.py`` (``whitted``
:45).  The reference recurses and splits rays at dielectric surfaces into a
refraction and a reflection.  A wavefront cannot fork lanes, so it carries
one queued continuation lane per pixel: the first dielectric split a path
meets runs both branches, the parent lane the reflection with weight R and
the queued lane the refraction with weight 1 - R (the reference's
``lerp(refracted, reflected, R)``).  Deeper splits, with the queue slot
taken, choose one branch at random (reflect with probability R, weight 1).
A non-medium surface needs no split: its diffuse term is added locally with
weight 1 - R and the reflected ray carries R * metallic colour.

Direct light from every light with one sample each (:348-370), the ambient
term (:371), Beer's law leaving a medium (:341-346) and the "previous
material" rule inside media (:331-338) follow the reference.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core import sampler as smp
from ..core.vec import (EPSILON, PI, Vec3, dot, exp as vexp, full_like, lerp,
                        normalize, reflect, v3, where as vwhere, zeros)
from ..models.scene import PackedScene, SceneSettings
from ..ops import traverse_wide
from ..ops.shading import (cbrt, fresnel_dielectric, refract,
                           sample_on_unit_sphere)
from ..ops.traverse import BIG_T
from ..utils import trace
from .common import evaluate_material, random_point_on_light_rows, sample_sky


def _gv(v: Vec3, i) -> Vec3:
    return Vec3(v.x[i], v.y[i], v.z[i])


def whitted(ps: PackedScene, settings: SceneSettings, sampler: smp.Sampler,
            ray_o: Vec3, ray_d: Vec3, n_lights: int = 0,
            has_medium: bool = True):
    """Returns (color Vec3, sampler, stats (3,)).  ``has_medium`` False
    (no participating-medium surface in the scene) drops the queued lanes:
    such a scene never splits."""
    n_in = int(ray_o.x.shape[0])
    dev = ray_o.x.device
    max_bounces = int(settings.max_bounce_count)
    strategy = int(settings.sampling_strategy)
    L = int(ps.light_prim.shape[0]) if n_lights > 0 else 0
    use_split = bool(settings.whitted_true_split) and bool(has_medium)

    def cat(a, b):
        return torch.cat([a, b], dim=-1)

    if use_split:
        # lane i + n_in is pixel i's queued refraction, dormant until its
        # path's first dielectric split
        ray_o = Vec3(*(cat(c, c) for c in ray_o))
        ray_d = Vec3(*(cat(c, c) for c in ray_d))
        child_state = rng.seed_state(rng.hash_u32(sampler.state, 0x5C0FFEE5))
        sampler = smp.Sampler(cat(sampler.x, sampler.x),
                              cat(sampler.y, sampler.y), sampler.sample_index,
                              cat(sampler.state, child_state),
                              cat(sampler.bn, sampler.bn),
                              cat(sampler.pre, sampler.pre))
        n = 2 * n_in
        alive = torch.cat([torch.ones(n_in, dtype=torch.bool, device=dev),
                           torch.zeros(n_in, dtype=torch.bool, device=dev)])
    else:
        n = n_in
        alive = torch.ones(n, dtype=torch.bool, device=dev)

    o, d, s = ray_o, ray_d, sampler
    throughput = full_like(ray_o, 1.0)
    total = zeros(n, dev)
    prev_mat = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stats = torch.zeros(3, dtype=torch.float32, device=dev)
    child_used = torch.zeros(n_in, dtype=torch.bool, device=dev)

    bounce = 0
    while bounce < max_bounces and trace.wait("live_any", bool,
                                              alive.any()):
        hit = traverse_wide.intersect_scene(
            ps, o, d, max_t=torch.where(alive, BIG_T, -1.0))
        found = hit.valid & alive
        missed = ~hit.valid & alive
        stats = stats + torch.stack([alive.sum().to(torch.float32),
                                     hit.node_visits.to(torch.float32),
                                     hit.tri_tests.to(torch.float32)])

        total = vwhere(missed, total + throughput * sample_sky(ps, d), total)

        mat = hit.mat_id
        emissive = (ps.mat_flags[mat] & 0x4) != 0
        total = vwhere(found & emissive,
                       total + throughput * _gv(ps.mat_emission, mat), total)

        cos_i0 = -dot(d, hit.n)
        inside = cos_i0 < 0.0
        N = vwhere(inside, -hit.n, hit.n)
        cos_theta_i = torch.abs(cos_i0)
        eta_i = torch.where(inside, ps.mat_ior[mat], 1.0)
        eta_t = torch.where(inside, 1.0, torch.clamp(ps.mat_ior[mat],
                                                     min=1e-6))
        # inside a medium the surface material is the medium entered
        # (integrators.cpp:336-338)
        mat_eff = torch.where(inside & (prev_mat >= 0), prev_mat, mat)

        is_medium = ps.mat_is_medium[mat_eff]
        beer = vexp(_gv(ps.mat_absorb, mat_eff) * (-hit.t))
        tp_beer = vwhere(inside & is_medium, beer, v3(1.0))

        # ---- direct light from every light, one sample each (:348-371) --
        illum = zeros(n, dev)
        for li in range(L):
            light_idx = ps.light_prim[li].expand(n)
            s, u_, v_ = smp.sample_2d(s, strategy,
                                      smp.SampleDimension.DIRECT_LIGHTING, 0)
            lT = ps.light16[li][:, None]  # (16, 1): broadcasts over rays
            ls = random_point_on_light_rows(lT, u_, v_, hit.p)
            n_dot_l = dot(N, ls.L)
            nl_dot_l = -dot(ls.Nl, ls.L)
            facing = (n_dot_l > 0.0) & (nl_dot_l > 0.0) & found & ~emissive
            occ = traverse_wide.intersect_shadow_ray(
                ps, hit.p + ls.L * EPSILON, ls.L,
                torch.where(facing, ls.dist - 2.0 * EPSILON, -1.0),
                light_idx)
            lemit = Vec3(lT[13], lT[14], lT[15])
            c = lemit * (nl_dot_l * ls.A * n_dot_l
                         / torch.clamp(ls.dist_sq, min=1e-12))
            illum = vwhere(facing & ~occ, illum + c, illum)
            stats = stats + torch.stack([
                facing.sum().to(torch.float32),
                torch.zeros((), device=dev), torch.zeros((), device=dev)])
        illum = illum + ps.ambient_light

        brdf = evaluate_material(ps, mat_eff, hit.p) * (1.0 / PI)
        metallic = ps.mat_metallic[mat_eff]
        metallic_color = lerp(v3(1.0), _gv(ps.mat_albedo, mat_eff), metallic)

        eta_ratio = eta_i / eta_t
        reflectance, cos_theta_t = fresnel_dielectric(cos_theta_i, eta_i,
                                                      eta_t, eta_ratio)
        reflectance = lerp(reflectance, 1.0, metallic)

        # roughness fuzz on the reflected direction (:389-393)
        refl_d = reflect(d, N)
        state, u1 = rng.next_unilateral(s.state)
        state, u2 = rng.next_unilateral(state)
        state, u3 = rng.next_unilateral(state)
        state, branch_u = rng.next_unilateral(state)
        s = s._replace(state=state)
        fuzz = sample_on_unit_sphere(u1, u2) * cbrt(u3)
        roughness = ps.mat_roughness[mat_eff]
        rough_d = normalize(refl_d * (1.0 + EPSILON) + fuzz * roughness)
        refl_d = vwhere(roughness > 0.0, rough_d, refl_d)
        refr_d = refract(d, N, cos_theta_i, cos_theta_t, eta_ratio)

        live = found & ~emissive
        split_req = live & is_medium

        if use_split:
            # the first split of a first-half lane whose queue slot is free
            # forks for real; total internal reflection keeps the slot
            act = (split_req[:n_in] & ~child_used & ~alive[n_in:]
                   & (reflectance[:n_in] < 0.999))
            det = torch.cat([act, torch.zeros_like(act)])
            # the queued lane's values, from this bounce's input throughput
            ch_d = Vec3(*(c[:n_in] for c in refr_d))
            ch_tp_full = throughput * tp_beer * (1.0 - reflectance)
            ch_tp = Vec3(*(c[:n_in] for c in ch_tp_full))
            ch_o = Vec3(hit.p.x[:n_in] + ch_d.x * EPSILON,
                        hit.p.y[:n_in] + ch_d.y * EPSILON,
                        hit.p.z[:n_in] + ch_d.z * EPSILON)
            ch_prev = mat_eff[:n_in]
        else:
            det = torch.zeros(n, dtype=torch.bool, device=dev)

        # medium: a random branch where no split is queued
        pick_reflect = det | (branch_u < reflectance)
        med_tp_refl = vwhere(det, throughput * reflectance, throughput)
        med_d = vwhere(pick_reflect, refl_d, refr_d)
        med_tp = vwhere(pick_reflect, med_tp_refl, throughput * tp_beer)
        med_prev = torch.where(pick_reflect, -1, mat_eff)

        # non-medium: local diffuse + reflected continuation with weight R
        diffuse_term = throughput * tp_beer * brdf * illum
        significant = reflectance > 0.05
        local_w = torch.where(significant, 1.0 - reflectance, 1.0)
        total = vwhere(live & ~is_medium, total + diffuse_term * local_w,
                       total)
        nm_tp = throughput * metallic_color * reflectance

        cont = live & (is_medium | significant)
        new_d = vwhere(is_medium, med_d, refl_d)
        new_o = hit.p + new_d * EPSILON
        throughput = vwhere(cont, vwhere(is_medium, med_tp, nm_tp),
                            throughput)
        prev_mat = torch.where(cont & is_medium, med_prev, -1)
        o = vwhere(cont, new_o, o)
        d = vwhere(cont, new_d, d)

        if use_split:
            # enqueue the refraction: lane i's queued lane is i + n_in
            def enq(x, cv):
                return torch.cat([x[:n_in], torch.where(act, cv, x[n_in:])])

            o = Vec3(*(enq(a, b) for a, b in zip(o, ch_o)))
            d = Vec3(*(enq(a, b) for a, b in zip(d, ch_d)))
            throughput = Vec3(*(enq(a, b) for a, b in zip(throughput, ch_tp)))
            cont = enq(cont, torch.ones_like(act))
            prev_mat = enq(prev_mat, ch_prev)
            child_used = child_used | act
        alive = cont
        bounce += 1

    if not use_split:
        return total, s, stats
    # fold the queued lanes back onto their pixels
    total = Vec3(*(c[:n_in] + c[n_in:] for c in total))
    s_out = smp.Sampler(s.x[:n_in], s.y[:n_in], s.sample_index,
                        s.state[:n_in], s.bn[:, :n_in], s.pre[:, :n_in])
    return total, s_out, stats
