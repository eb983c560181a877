"""Materials (host-side description).

Mirrors the reference Material/Medium structs (scene.h:5-29): albedo, checker
procedural texture, emission, ior, metallic, roughness, participating-medium
flag with Beer absorption color.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

Color = Tuple[float, float, float]

FLAG_MIRROR = 0x1
FLAG_CHECKERS = 0x2
FLAG_EMISSIVE = 0x4


@dataclass
class Material:
    flags: int = 0
    albedo: Color = (0.0, 0.0, 0.0)
    checker_color: Color = (0.0, 0.0, 0.0)
    emission_color: Color = (0.0, 0.0, 0.0)
    ior: float = 0.0
    metallic: float = 0.0
    roughness: float = 0.0
    is_participating_medium: bool = False
    absorb: Color = (0.0, 0.0, 0.0)

    def __post_init__(self):
        # add_material auto-flags emissive (scene.cpp:16-18)
        if sum(self.emission_color) > 0.0:
            self.flags |= FLAG_EMISSIVE


def diffuse(albedo: Color, ior: float, roughness: float = 0.0,
            checkers: bool = False, checker_color: Color = (0.1, 0.1, 0.1)) -> Material:
    """add_diffuse_material (scene.cpp:23-37)."""
    m = Material(albedo=albedo, ior=ior, roughness=roughness,
                 checker_color=checker_color)
    if checkers:
        m.flags |= FLAG_CHECKERS
    return m


def translucent(absorb: Color, ior: float, roughness: float = 0.0) -> Material:
    """add_translucent_material (scene.cpp:39-50)."""
    return Material(is_participating_medium=True, absorb=absorb, ior=ior,
                    roughness=roughness)


def emissive(emission_color: Color) -> Material:
    """add_emissive_material (scene.cpp:52-61)."""
    return Material(flags=FLAG_EMISSIVE, emission_color=emission_color)
