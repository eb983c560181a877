"""Debug integrators: Normals and Distances (integrators.cpp:543-579).

Counterpart of ``buas_pathtracer_tpu/integrators/debug.py``: visual oracles
of geometry, normals and traversal, one closest-hit wave each.
"""

from __future__ import annotations

import torch

from ..core import sampler as smp
from ..core.vec import Vec3, where as vwhere
from ..models.scene import PackedScene, SceneSettings
from ..ops import traverse_wide
from ..utils import trace
from .common import sample_sky


def _stats(ray_o: Vec3, hit):
    return torch.stack([trace.wait("stats", torch.tensor,
                                   float(ray_o.x.numel()),
                                   device=ray_o.x.device),
                        hit.node_visits.to(torch.float32),
                        hit.tri_tests.to(torch.float32)])


def normals(ps: PackedScene, settings: SceneSettings, sampler: smp.Sampler,
            ray_o: Vec3, ray_d: Vec3):
    hit = traverse_wide.intersect_scene(ps, ray_o, ray_d)
    shaded = (hit.n + 1.0) * 0.5
    return (vwhere(hit.valid, shaded, sample_sky(ps, ray_d)), sampler,
            _stats(ray_o, hit))


def distances(ps: PackedScene, settings: SceneSettings, sampler: smp.Sampler,
              ray_o: Vec3, ray_d: Vec3):
    hit = traverse_wide.intersect_scene(ps, ray_o, ray_d)
    g = 1.0 - torch.clamp(hit.t / 15.0, 0.0, 1.0)
    return (vwhere(hit.valid, Vec3(g, g, g), sample_sky(ps, ray_d)), sampler,
            _stats(ray_o, hit))
