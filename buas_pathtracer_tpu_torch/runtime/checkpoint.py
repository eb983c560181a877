"""Render checkpoint and resume.

Counterpart of ``buas_pathtracer_tpu/runtime/checkpoint.py`` (:28-75).  The
accumulation buffer (colour sum and filter weight) with the committed
settings and camera is the whole state of a progressive render, so a
checkpoint holds exactly that, in the JAX package's ``.npz`` format: the
accumulation array, ``frame_count``, the camera's leaves in ``jax.tree``
order (the fields in order, a ``Vec3`` as x, y, z) as float32 0-d arrays,
and the ``SceneSettings`` as JSON.  A checkpoint written by either package
loads into the other.  Resume refuses a checkpoint whose size, settings or
camera differ from the renderer's: accumulating across them would blend two
images.
"""

from __future__ import annotations

import json
from dataclasses import asdict

import numpy as np
import torch

from ..core.vec import Vec3
from ..models.scene import SceneSettings


def camera_leaves(camera) -> list:
    """The camera's scalars in ``jax.tree.leaves`` order, as floats."""
    out = []
    for f in camera:
        out += [float(p) for p in ((f.x, f.y, f.z) if isinstance(f, Vec3)
                                   else (f,))]
    return out


def save_checkpoint(path: str, accum: torch.Tensor, frame_count: int,
                    settings: SceneSettings, camera) -> None:
    cam_leaves = [np.asarray(x, np.float32) for x in camera_leaves(camera)]
    np.savez_compressed(
        path,
        accum=accum.detach().cpu().numpy(),
        frame_count=np.int64(frame_count),
        settings=json.dumps(asdict(settings)),
        n_cam=len(cam_leaves),
        **{f"cam_{i}": leaf for i, leaf in enumerate(cam_leaves)},
    )


def load_checkpoint(path: str):
    """Returns (accum numpy array, frame_count int, settings, cam_leaves)."""
    with np.load(path, allow_pickle=False) as z:
        settings = SceneSettings(**json.loads(str(z["settings"])))
        cam_leaves = [z[f"cam_{i}"] for i in range(int(z["n_cam"]))]
        return z["accum"], int(z["frame_count"]), settings, cam_leaves


def resume_into(renderer, path: str) -> int:
    """Load a checkpoint into a ``ProgressiveRenderer``, on the renderer's
    device.  Refuses on a mismatch.  Returns the restored accumulated spp."""
    accum, frame_count, settings, cam_leaves = load_checkpoint(path)
    if accum.shape != (renderer.h, renderer.w, 4):
        raise ValueError(
            f"checkpoint is {accum.shape[1]}x{accum.shape[0]}, renderer is "
            f"{renderer.w}x{renderer.h}")
    if settings != renderer.new_settings:
        raise ValueError("checkpoint settings differ from the renderer's; "
                         "accumulating across different settings would blend "
                         "two different images")
    cur = [np.asarray(x, np.float32)
           for x in camera_leaves(renderer.new_camera)]
    if len(cam_leaves) != len(cur) or not all(
            np.allclose(a, b, atol=1e-6) for a, b in zip(cam_leaves, cur)):
        raise ValueError("checkpoint camera differs from the renderer's")
    renderer.settings = renderer.new_settings
    renderer.camera = renderer.new_camera
    renderer.accum = torch.from_numpy(np.ascontiguousarray(
        accum, np.float32)).to(renderer.device)
    renderer.frame_count = frame_count
    return frame_count


def checkpoint_renderer(renderer, path: str) -> None:
    save_checkpoint(path, renderer.accum, renderer.frame_count,
                    renderer.settings, renderer.camera)
