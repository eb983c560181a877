"""Progressive renderer: accumulation across frames and the double-buffered
settings/camera commit protocol.

Counterpart of ``buas_pathtracer_tpu/runtime/progressive.py`` (:33-148),
after the reference's render_all_tiles (raytracer.cpp:692-757):
  * UI code edits ``new_settings`` / ``new_camera`` / ``new_filter``
    freely;
  * at a frame boundary the renderer compares them with the active copies
    and, on a change, commits them and resets the accumulation
    (discard_current_render + AccumulationBuffer.reset);
  * otherwise the frame accumulates on top (frame_count += spp).

A frame of several samples runs one sample pass at a time and checks the
protocol between passes, the reference's per-sample cancel.

On the device: the accumulation buffer and the passes' stats stay on the
renderer's device.  ``_needs_reset`` compares host values only, and the
stats are read once a frame (``last_stats``), so a pass adds no sync.
Each frame and the displays after it make one record of the tracer
(``utils/trace.py``).
"""

from __future__ import annotations

import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.camera import Camera
from ..models.scene import PostProcessSettings, Scene, SceneSettings
from ..utils import trace
from ..utils.image import write_bmp, write_png
from . import checkpoint as ckpt
from . import film, post
from .render import render_frame


class ProgressiveRenderer:
    """Single-device progressive renderer with the reference's commit
    protocol.  ``device`` None means the CUDA card."""

    def __init__(self, scene: Scene, w: int, h: int, device=None):
        self.device = resolve_device(device)
        self.scene = scene
        self.w, self.h = w, h
        self.ps = scene.pack(device=self.device)
        self.n_lights = scene.n_lights

        # active copies (committed at frame boundaries)
        self.settings: SceneSettings = scene.settings
        self.camera: Camera = scene.camera
        self.filter_name: str = scene.filter_name
        # writable copies (the reference's new_settings / new_camera; the
        # filter picker takes part like any setting, raytracer.cpp:700-724)
        self.new_settings: SceneSettings = scene.settings
        self.new_camera: Camera = scene.camera
        self.new_filter: str = scene.filter_name

        self.accum = film.new_accumulation_buffer(h, w, self.device)
        self.frame_count = 0  # accumulated spp (AccumulationBuffer.frame_count)
        self.last_stats = np.zeros(3)

    # -- commit protocol ---------------------------------------------------
    def _needs_reset(self) -> bool:
        return (self.new_settings != self.settings
                or self.new_filter != self.filter_name
                or ckpt.camera_leaves(self.new_camera)
                != ckpt.camera_leaves(self.camera))

    def _render_pass(self, settings) -> torch.Tensor:
        """One pass of ``settings.samples_per_pixel`` samples; returns its
        stats (3,) on the device."""
        self.accum, stats = render_frame(
            self.ps, settings, self.camera, self.accum, self.frame_count,
            h=self.h, w=self.w, n_lights=self.n_lights,
            filter_name=self.filter_name, has_medium=self.scene.has_medium,
            device=self.device)
        self.frame_count += int(settings.samples_per_pixel)
        return stats

    def render_one_frame(self) -> int:
        """One progressive frame; returns the accumulated spp so far.

        A frame of spp > 1 runs one sample pass at a time and checks the
        commit protocol between passes (the reference checks discard_render
        inside the sample loop, raytracer.cpp:423-425): a change aborts the
        frame within one pass, and the next call commits and resets.  The
        passes use the fused frame's sample indices in its order, so the
        image is bit-identical to ``render_frame`` with spp samples."""
        with trace.frame():
            if self._needs_reset():
                self.settings = self.new_settings
                self.camera = self.new_camera
                self.filter_name = self.new_filter
                self.accum = film.new_accumulation_buffer(self.h, self.w,
                                                          self.device)
                self.frame_count = 0
            spp = int(self.settings.samples_per_pixel)
            if spp == 1:
                stats = self._render_pass(self.settings)
            else:
                pass_settings = replace(self.settings, samples_per_pixel=1)
                stats = torch.zeros(3, dtype=torch.float32,
                                    device=self.device)
                for _ in range(spp):
                    if self._needs_reset():
                        break  # cooperative cancel: drop the partial frame
                    stats = stats + self._render_pass(pass_settings)
            self.last_stats = trace.wait("stats", stats.cpu).numpy().astype(
                np.float64)
        return self.frame_count

    # -- output --------------------------------------------------------------
    def resolve_hdr(self) -> np.ndarray:
        return trace.wait("readback", film.resolve(self.accum).cpu).numpy()

    def display_rgba8(self, post_settings: Optional[PostProcessSettings] = None
                      ) -> np.ndarray:
        """(H, W, 4) uint8 through ``post.post_process`` (the post kernel on
        the card)."""
        with trace.display():
            pp = post_settings or self.scene.post_settings
            img = post.post_process(self.accum, pp, device=self.device)
            return trace.wait("readback", img.cpu).numpy()

    def take_picture(self, spp: int, path: str, progress=None,
                     checkpoint_every: int = 0,
                     checkpoint_path: Optional[str] = None) -> float:
        """Offline render ("Take picture", raytracer.cpp:2037-2047): render
        frames until ``spp`` samples have accumulated, then write a PNG
        (``.png``) or BMP.  Returns the rendering's seconds.

        ``checkpoint_every`` > 0 saves the state every N spp to
        ``checkpoint_path`` (runtime/checkpoint.py); an existing
        ``checkpoint_path`` is resumed first."""
        if checkpoint_path and os.path.exists(checkpoint_path):
            ckpt.resume_into(self, checkpoint_path)
        t0 = time.perf_counter()
        last_ckpt = self.frame_count
        while self.frame_count < spp:
            self.render_one_frame()
            if progress:
                progress(self.frame_count, spp)
            if (checkpoint_every and checkpoint_path
                    and self.frame_count - last_ckpt >= checkpoint_every):
                ckpt.checkpoint_renderer(self, checkpoint_path)
                last_ckpt = self.frame_count
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        img = self.display_rgba8()
        (write_png if path.endswith(".png") else write_bmp)(path, img)
        return elapsed
