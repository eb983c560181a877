"""Frame timing stats: 15-slot min/avg/max ring buffers.

Counterpart of ``buas_pathtracer_tpu/utils/timing.py`` (``FrameHistory``
:17; the reference's FrameHistory, raytracer.cpp:764-792), which feeds the
viewer's title line (app/viewer.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

HISTORY_SLOTS = 15  # raytracer.cpp:768


@dataclass
class FrameHistory:
    samples: List[float] = field(default_factory=list)
    at: int = 0

    def push(self, seconds: float) -> None:
        if len(self.samples) < HISTORY_SLOTS:
            self.samples.append(seconds)
        else:
            self.samples[self.at] = seconds
        self.at = (self.at + 1) % HISTORY_SLOTS

    @property
    def min(self) -> float:
        return min(self.samples) if self.samples else 0.0

    @property
    def max(self) -> float:
        return max(self.samples) if self.samples else 0.0

    @property
    def avg(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    def title_line(self, spp: int) -> str:
        """The reference's window-title format (raytracer.cpp:2381-2387)."""
        fps = 1.0 / self.avg if self.avg > 0 else 0.0
        return (f"{spp} spp, fps: {fps:.2f}, render time: "
                f"min: {self.min * 1e3:.2f}ms, avg: {self.avg * 1e3:.2f}ms, "
                f"max: {self.max * 1e3:.2f}ms")
