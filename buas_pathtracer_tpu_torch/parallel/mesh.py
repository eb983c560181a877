"""Row-sharded rendering over ``torch.distributed``.

Counterpart of ``buas_pathtracer_tpu/parallel/mesh.py``.  Pixel rows are
sharded over the ranks of a process group, one process a rank: rank i
renders the ``h / world`` rows starting at global row ``i * h / world`` at
their global pixel coordinates, with the scene packed on every rank.  The
traffic between ranks is explicit:

  * each pass, the ``[sample4 | jx | jy]`` rows within the filter radius r
    of a block's edge move to the neighbouring ranks (``_exchange_halo``,
    several ranks away when r exceeds the rows a rank holds; zero rows past
    the frame edge), and each rank splats its own rows with
    ``film.splat_pass_prepadded``, the single-device splat's arithmetic;
  * the traversal stats are summed over the ranks (``all_reduce``);
  * ``resolve`` gathers the rows into the whole image.

Every rank runs the single-device frame's arithmetic on its rows, so the
gathered image equals ``runtime.render.render_frame``'s bit for bit.

The transport is the group's: NCCL for ranks each on a card of its own,
gloo for CPU ranks and for ranks that share one card.  With gloo, the
tensors that cross ranks are copied to the host and back around each
collective (``_to_transport``); the walks, the splat
and post stay on the device.  ``spawn_ranks`` starts a world of ranks, one
process each, with the ``spawn`` start method and a file-store rendezvous
in a temporary directory.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..models.camera import camera_on
from ..models.scene import Scene
from ..ops.filters import find_filter
from ..runtime import film
from ..runtime.render import pixel_rows, sample_pass


@dataclass(frozen=True)
class RowMesh:
    """The group a ``ShardedRenderer`` runs on: this process's rank, the
    world size, the transport and the device of this rank."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    backend: str
    device: torch.device


def make_mesh(group=None, device=None) -> RowMesh:
    """The initialised default group (or ``group``) with this rank's device
    (None: the CUDA card).  NCCL needs a CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group or use spawn_ranks")
    dev = resolve_device(device)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group needs CUDA devices, got {dev}")
    return RowMesh(group, dist.get_rank(group), dist.get_world_size(group),
                   backend, dev)


def _to_transport(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy that the group's backend moves: gloo takes host
    tensors, so a CUDA tensor is copied to the host (and the results go
    back with ``.to(t.device)``)."""
    if mesh.backend == "gloo" and t.device.type == "cuda":
        return t.cpu()
    return t.contiguous().clone()


def _all_gather(mesh: RowMesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s device."""
    src = _to_transport(mesh, t)
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return [o.to(t.device) for o in out]


def _all_reduce_sum(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    buf = _to_transport(mesh, t)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


def _exchange_halo(blk: torch.Tensor, r: int, mesh: RowMesh) -> torch.Tensor:
    """(hl, W, C) rows of this rank -> (hl + 2r, W, C) with the r rows
    above and below filled from the neighbouring ranks, zeros past the
    frame edge (the single-device splat's zero padding).

    Each rank contributes its first and last ``min(r, hl)`` rows to one
    ``all_gather``; hop k takes ``cnt`` rows of the block k ranks away, as
    the JAX package's ``ppermute`` chain does (mesh.py:67-92)."""
    hl = int(blk.shape[0])
    if r == 0:
        return blk
    c = min(r, hl)
    edges = (_all_gather(mesh, torch.cat([blk[:c], blk[hl - c:]]))
             if mesh.size > 1 else [])
    top = blk.new_zeros((r,) + tuple(blk.shape[1:]))
    bot = blk.new_zeros((r,) + tuple(blk.shape[1:]))
    for k in range(1, -(-r // hl) + 1):
        cnt = min(hl, r - (k - 1) * hl)
        lo = r - (k - 1) * hl - cnt  # halo-local rows [lo, lo + cnt)
        if mesh.rank - k >= 0:  # the last cnt rows of the block above
            top[lo:lo + cnt] = edges[mesh.rank - k][2 * c - cnt:]
        if mesh.rank + k < mesh.size:  # the first cnt rows of the one below
            bot[(k - 1) * hl:(k - 1) * hl + cnt] = edges[mesh.rank + k][:cnt]
    return torch.cat([top, blk, bot])


class ShardedRenderer:
    """Row-sharded progressive renderer, one instance per rank.

    The accumulation buffer holds this rank's rows; the scene is packed on
    every rank.  ``step`` renders one frame (``samples_per_pixel`` passes),
    ``resolve`` gathers the (H, W, 3) image and ``reset`` starts over.
    ``pack_s`` is this rank's packing seconds and ``exchanges`` the count
    of its halo exchanges.  ``time_exchange`` sums their seconds into
    ``exchange_s``: it waits for the device and for every rank (a barrier)
    before each exchange and for the device after it, so the time is the
    exchange's alone and the frame pays for those waits.  ``split`` goes to
    ``Scene.pack``."""

    def __init__(self, scene: Scene, w: int, h: int, group=None, device=None,
                 filter_name: Optional[str] = None,
                 split: Optional[bool] = None, time_exchange: bool = False):
        self.mesh = make_mesh(group, device)
        n = self.mesh.size
        if h % n:
            raise ValueError(f"height {h} does not divide over {n} ranks")
        self.w, self.h, self.hl = w, h, h // n
        self.row0 = self.mesh.rank * self.hl
        self.scene = scene
        self.filter_name = filter_name or scene.filter_name
        dev = self.mesh.device
        t0 = time.perf_counter()
        self.ps = scene.pack(device=dev, split=split)
        self.pack_s = time.perf_counter() - t0
        self.cam = camera_on(scene.camera, dev)
        self.accum = film.new_accumulation_buffer(self.hl, w, dev)
        self.px, self.py = pixel_rows(self.row0, self.hl, w, dev)
        self.frame_index = 0
        self.time_exchange = time_exchange
        self.exchange_s, self.exchanges = 0.0, 0

    def _sync(self):
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    def _exchange(self, packed: torch.Tensor, r: int) -> torch.Tensor:
        self.exchanges += 1
        if not self.time_exchange:
            return _exchange_halo(packed, r, self.mesh)
        # wait for the device and the slowest rank first, so that
        # exchange_s times the exchange alone
        self._sync()
        if self.mesh.size > 1:
            dist.barrier(group=self.mesh.group)
        t0 = time.perf_counter()
        ext = _exchange_halo(packed, r, self.mesh)
        self._sync()
        self.exchange_s += time.perf_counter() - t0
        return ext

    def step(self) -> torch.Tensor:
        """Render one frame (spp passes) into this rank's rows.  Returns the
        stats (3,) [rays, node visits, triangle tests] summed over ranks."""
        settings = self.scene.settings
        filt = find_filter(self.filter_name)
        r = int(filt.radius) if filt.f is not None else 0
        stats = torch.zeros(3, dtype=torch.float32, device=self.mesh.device)
        for s_i in range(int(settings.samples_per_pixel)):
            cimg, jx, jy, st_ = sample_pass(
                self.ps, settings, self.cam, self.px, self.py,
                self.frame_index + s_i, h=self.h, w=self.w, rows=self.hl,
                n_lights=self.scene.n_lights,
                has_medium=self.scene.has_medium)
            stats = stats + st_
            sample = torch.stack([cimg.x, cimg.y, cimg.z,
                                  torch.ones_like(cimg.x)], dim=-1)
            if r > 0:
                # one exchange moves [sample4 | jx | jy] together
                packed = torch.cat([sample, jx[..., None], jy[..., None]],
                                   dim=-1)
                ext = self._exchange(packed, r)
                contrib = film.splat_pass_prepadded(
                    ext[..., :4], ext[..., 4], ext[..., 5], filt)
            else:
                contrib = sample
            self.accum = film.accumulate(self.accum, contrib)
        self.frame_index += int(settings.samples_per_pixel)
        return _all_reduce_sum(self.mesh, stats)

    def gather_accum(self) -> torch.Tensor:
        """The whole (H, W, 4) accumulation buffer, on every rank."""
        return torch.cat(_all_gather(self.mesh, self.accum))

    def resolve(self) -> np.ndarray:
        """The (H, W, 3) HDR image gathered from every rank (a collective:
        every rank calls it)."""
        return film.resolve(self.gather_accum()).cpu().numpy()

    def reset(self):
        self.accum = film.new_accumulation_buffer(self.hl, self.w,
                                                  self.mesh.device)
        self.frame_index = 0


def render_frames(mesh: RowMesh, scene: Scene, w: int, h: int, frames: int,
                  filter_name: Optional[str] = None,
                  split: Optional[bool] = None,
                  time_exchange: bool = False) -> dict:
    """One rank's part of a sharded render of ``frames`` frames.

    Returns, on every rank, this rank's ``pack_s``, whether it packed
    split tables, per-frame seconds ``frame_s``, the halo-exchange count
    and, with ``time_exchange``, their seconds; rank 0 also
    gets the gathered (H, W, 4) accumulation ``accum`` (a CPU tensor) and
    the summed ``stats`` of the last frame."""
    r = ShardedRenderer(scene, w, h, group=mesh.group, device=mesh.device,
                        filter_name=filter_name, split=split,
                        time_exchange=time_exchange)
    frame_s, stats = [], None
    for _ in range(frames):
        r._sync()
        t0 = time.perf_counter()
        stats = r.step()
        r._sync()
        frame_s.append(time.perf_counter() - t0)
    accum = r.gather_accum()
    return dict(rank=mesh.rank, rows=(r.row0, r.row0 + r.hl),
                pack_s=r.pack_s, split_tables=r.ps.v4_res is not None,
                frame_s=frame_s, exchange_s=r.exchange_s,
                exchanges=r.exchanges,
                accum=accum.cpu() if mesh.rank == 0 else None,
                stats=stats.cpu() if mesh.rank == 0 else None)


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               devices: Sequence[str], fn: Callable, args: tuple,
               outdir: str):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        res = fn(make_mesh(device=dev), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))


def spawn_ranks(fn: Callable, devices: Sequence[str], backend: str,
                args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``len(devices)`` ranks, rank i in its own
    process on ``devices[i]``, and return their results in rank order.

    ``fn`` is a module-level function (the ranks are started with the
    ``spawn`` method and unpickle it) and its results go through
    ``torch.save``.  ``backend`` is the caller's choice: "nccl" for ranks
    each on a card of its own, "gloo" for CPU ranks or ranks that share a
    card.  A rank that fails raises here with its traceback."""
    import torch.multiprocessing as tmp_mp
    world = len(devices)
    if backend == "nccl" and len(set(devices)) != world:
        raise ValueError(f"NCCL takes one card a rank, got {list(devices)}")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        tmp_mp.spawn(_rank_main, args=(world, init_method, backend,
                                       list(devices), fn, args, tmp),
                     nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{i}.pt"),
                           weights_only=False) for i in range(world)]
