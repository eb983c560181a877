"""Ground-truth pathtracer (the reference's correctness oracle).

Counterpart of ``buas_pathtracer_tpu/integrators/ground_truth.py``
(``ground_truth_iterative`` :28; reference integrators.cpp:485-541): the
plain exponential-decay pathtracer, Fresnel reflect-or-diffuse with
uniform-hemisphere indirect rays, no NEE, MIS or Russian roulette.  The
reference's recursive twin (integrators.cpp:428-483) is the same program on
the wavefront core, so both registry names map here.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core import sampler as smp
from ..core.vec import EPSILON, PI, Vec3, dot, full_like, reflect, zeros
from ..core.vec import where as vwhere
from ..models.scene import PackedScene, SceneSettings
from ..ops import traverse_wide
from ..ops.shading import fresnel_dielectric, map_to_hemisphere
from ..ops.traverse import BIG_T
from ..utils import trace
from .common import evaluate_material, sample_sky


def ground_truth_iterative(ps: PackedScene, settings: SceneSettings,
                           sampler: smp.Sampler, ray_o: Vec3, ray_d: Vec3):
    """Returns (color Vec3, sampler, stats (3,))."""
    n = ray_o.x.shape[0]
    dev = ray_o.x.device
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    o, d = ray_o, ray_d
    throughput = full_like(ray_o, 1.0)
    total = zeros(n, dev)
    state = sampler.state
    stats = torch.zeros(3, dtype=torch.float32, device=dev)
    bounce = 0
    while bounce < int(settings.max_bounce_count) and trace.wait(
            "live_any", bool, alive.any()):
        hit = traverse_wide.intersect_scene(
            ps, o, d, max_t=torch.where(alive, BIG_T, -1.0))
        stats = stats + torch.stack([alive.sum().to(torch.float32),
                                     hit.node_visits.to(torch.float32),
                                     hit.tri_tests.to(torch.float32)])
        found = hit.valid & alive
        missed = ~hit.valid & alive

        # miss -> sky, terminate (integrators.cpp:532-535)
        total = vwhere(missed, total + throughput * sample_sky(ps, d), total)

        mat = hit.mat_id
        emissive = (ps.mat_flags[mat] & 0x4) != 0
        # emissive hit -> add, terminate (integrators.cpp:505-509)
        emit = Vec3(ps.mat_emission.x[mat], ps.mat_emission.y[mat],
                    ps.mat_emission.z[mat])
        total = vwhere(found & emissive, total + throughput * emit, total)

        # continue: Fresnel reflect-or-diffuse (integrators.cpp:511-530)
        state, r1 = rng.next_unilateral(state)
        state, r2 = rng.next_unilateral(state)
        state, r3 = rng.next_unilateral(state)
        eta_t = ps.mat_ior[mat]
        cos_theta_i = -dot(d, hit.n)
        refl, _ = fresnel_dielectric(cos_theta_i, 1.0, eta_t,
                                     1.0 / torch.clamp(eta_t, min=1e-6))
        do_reflect = r1 < refl
        refl_d = reflect(d, hit.n)
        R = map_to_hemisphere(hit.n, r2, r3)
        brdf = evaluate_material(ps, mat, hit.p) * (1.0 / PI)
        diff_tp = throughput * brdf * dot(R, hit.n) * (2.0 * PI)

        cont = found & ~emissive
        new_d = vwhere(do_reflect, refl_d, R)
        new_o = vwhere(do_reflect, hit.p + refl_d * EPSILON,
                       hit.p + hit.n * EPSILON)
        throughput = vwhere(cont & ~do_reflect, diff_tp, throughput)
        o = vwhere(cont, new_o, o)
        d = vwhere(cont, new_d, d)
        alive = cont
        bounce += 1
    # rays still alive after the last bounce add nothing, as the
    # reference's loop falling off its end
    return total, sampler._replace(state=state), stats
