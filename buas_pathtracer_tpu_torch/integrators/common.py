"""Shared integrator pieces: sky, material evaluation, light picking, NEE.

Counterpart of ``buas_pathtracer_tpu/integrators/common.py``:
  has_env                was an environment map packed
  sample_sky             integrators.cpp:272-295 (equirect environment map,
                         else the gradient sky)
  evaluate_material      integrators.cpp:297-308
  pick_random_light_slot integrators.cpp:135-192 (uniform, or importance by
                         max3(emission) * projected solid angle)
  light_pick_pdf         the pick probability for the BRDF side of MIS
  random_point_on_light_rows  integrators.cpp:199-228 (sphere lights)
The JAX package reads light rows through one-hot matmuls to avoid TPU
gathers; here they are plain indexing into ``light16``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import PI, Vec3, length_sq, normalize
from ..models.scene import PRIM_SPHERE, PackedScene
from ..ops import envmap
from ..ops.shading import (evaluate_checker, map_to_hemisphere,
                           sample_sky_gradient)


def has_env(ps: PackedScene) -> bool:
    """Was an environment map packed?  (The 1x1 placeholder means no.)"""
    return ps.env_pixels.shape[0] > 1 or ps.env_pixels.shape[1] > 1


def sample_sky(ps: PackedScene, ray_d: Vec3) -> Vec3:
    """integrators.cpp:272-295: equirect skydome lookup, else gradient."""
    if has_env(ps):
        return envmap.lookup_env(ps.env_pixels, ray_d)
    return sample_sky_gradient(ray_d, ps.sky_bot, ps.sky_top)


def evaluate_material(ps: PackedScene, mat_id, hit_p: Vec3) -> Vec3:
    """Albedo with the 4x4 world-XZ checker (integrators.cpp:297-308)."""
    albedo = Vec3(ps.mat_albedo.x[mat_id], ps.mat_albedo.y[mat_id],
                  ps.mat_albedo.z[mat_id])
    checker = Vec3(ps.mat_checker.x[mat_id], ps.mat_checker.y[mat_id],
                   ps.mat_checker.z[mat_id])
    use_checker = (ps.mat_flags[mat_id] & 0x2) != 0
    return evaluate_checker(albedo, checker, use_checker, hit_p)


def _light_pdfs(ps: PackedScene, I: Vec3):
    """(N, L) unnormalised pick weights: max3(emission) * pi r^2 / dist^2
    for sphere lights, 0 for others."""
    lp = ps.light_prim
    vx = ps.prim_fwd[lp, 3][None, :] - I.x[:, None]
    vy = ps.prim_fwd[lp, 7][None, :] - I.y[:, None]
    vz = ps.prim_fwd[lp, 11][None, :] - I.z[:, None]
    dist_sq = vx * vx + vy * vy + vz * vz
    emis = ps.mat_emission
    lmat = ps.prim_mat[lp]
    lmax = torch.maximum(emis.x[lmat], torch.maximum(emis.y[lmat],
                                                     emis.z[lmat]))
    r = ps.prim_r[lp]
    is_sph = (ps.prim_type[lp] == PRIM_SPHERE).to(torch.float32)
    return (lmax[None, :] * is_sph[None, :] * PI * r[None, :] ** 2
            / torch.clamp(dist_sq, min=1e-12))


def pick_random_light_slot(ps: PackedScene, u, I: Vec3, importance: bool):
    """Returns (light slot in [0, L), pick probability) per ray."""
    L = int(ps.light_prim.shape[0])
    if not importance or L == 1:
        slot = torch.clamp((u * L - 1e-3).to(torch.int64), 0, L - 1)
        return slot, torch.full_like(u, 1.0 / L)
    pdfs = _light_pdfs(ps, I)
    # running sums one light at a time (the same values as a cumsum): a
    # torch.cumsum over the narrow innermost dim ran as a slow scan on the
    # card, 12 ms per call at 2 M rays (PERF.md)
    cdf = [pdfs[:, 0]]
    for l in range(1, L):
        cdf.append(cdf[-1] + pdfs[:, l])
    total = cdf[-1]
    e = total * u
    slot = torch.zeros_like(u, dtype=torch.int64)
    for c in cdf:
        slot = slot + (c < e).to(torch.int64)
    slot = torch.clamp(slot, 0, L - 1)
    pdf_sel = torch.gather(pdfs, 1, slot[:, None])[:, 0]
    return slot, pdf_sel / torch.clamp(total, min=1e-30)


def light_pick_pdf(ps: PackedScene, I: Vec3, hit_prim, importance: bool):
    """Probability that ``pick_random_light_slot`` at ``I`` picks the light
    primitive ``hit_prim`` (0 when it is not a light)."""
    L = int(ps.light_prim.shape[0])
    if not importance or L == 1:
        return torch.full_like(I.x, 1.0 / L)
    pdfs = _light_pdfs(ps, I)
    # the pick's running sum, one light at a time: one order of addition,
    # which the shade_hit kernel keeps too
    total = pdfs[:, 0]
    for l in range(1, L):
        total = total + pdfs[:, l]
    sel = (ps.light_prim[None, :] == hit_prim[:, None]).to(torch.float32)
    return (pdfs * sel).sum(dim=-1) / torch.clamp(total, min=1e-30)


def light_rows(ps: PackedScene, slot):
    """(16, N) rows [fwd12 | r | emission3] of each ray's picked light."""
    return ps.light16[slot].T


def slot_to_prim(ps: PackedScene, slot):
    """Light slot -> primitive index (shadow-ray light exclusion,
    intersection.cpp:416)."""
    return ps.light_prim[slot]


def light_radius_of_prim(ps: PackedScene, hit_prim):
    """Radius of the light primitive ``hit_prim`` (0 if it is no light)."""
    out = torch.zeros(hit_prim.shape, dtype=torch.float32,
                      device=hit_prim.device)
    for l in range(int(ps.light_prim.shape[0])):
        out = torch.where(hit_prim == ps.light_prim[l], ps.light16[l, 12], out)
    return out


class LightSample(NamedTuple):
    L: Vec3  # unit direction to the sampled point
    Nl: Vec3  # light-surface normal at the point
    dist: torch.Tensor
    dist_sq: torch.Tensor
    A: torch.Tensor  # sampled area (2 pi r^2, visible hemisphere)


def random_point_on_light_rows(lT, u, v, I: Vec3) -> LightSample:
    """integrators.cpp:199-228 for the picked sphere light's (16, N) rows."""
    light_p = Vec3(lT[3], lT[7], lT[11])
    towards_light = normalize(light_p - I)
    r = lT[12]
    nl = map_to_hemisphere(-towards_light, u, v)
    p_local = nl * r
    p_world = Vec3(
        lT[0] * p_local.x + lT[1] * p_local.y + lT[2] * p_local.z + lT[3],
        lT[4] * p_local.x + lT[5] * p_local.y + lT[6] * p_local.z + lT[7],
        lT[8] * p_local.x + lT[9] * p_local.y + lT[10] * p_local.z + lT[11],
    )
    Lv = p_world - I
    dist_sq = length_sq(Lv)
    dist = torch.sqrt(dist_sq)
    Ldir = Lv / torch.clamp(dist, min=1e-30)
    A = 2.0 * PI * r * r
    return LightSample(Ldir, nl, dist, dist_sq, A)
