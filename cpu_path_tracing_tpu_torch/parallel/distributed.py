"""Multi-process rendering on ``torch.distributed``.

Counterpart of ``cpu_path_tracing_tpu/parallel/distributed.py``, one
process (rank) a device:

* ``init_distributed`` joins the process group over a TCP rendezvous
  (``tcp://HOST:PORT`` of rank 0), from the arguments or torch's own
  environment variables, with a finite timeout: a rank that died makes the
  others' collectives fail after it instead of hanging.
* ``global_mesh`` lays the ranks out as a ('tiles', 'samples') grid.  Rank r
  renders the cells of tile ``r // n_samples`` for sample shard
  ``r % n_samples``, on its own device (``rank_device``).
* ``render_image_multihost`` (replicated mode): one ``all_gather`` of every
  rank's cell sums, the only collective of the render; each rank then adds
  the sample shards in order, divides and finalizes on its device, as
  ``parallel/render.py`` does in one process, so every rank holds the image.
* ``render_shard_multihost`` (shard mode): no collective at all.  Each rank
  writes its cell means to ``--shard-dir`` (``write_shards``); rank 0
  waits for the files, not for the ranks (``wait_for_shards``), and
  re-renders the spans of a rank that never wrote (``assemble_shards``,
  ``recover_missing_cells``).

The backend is gloo, on host tensors.  Ranks may share a card (NCCL refuses
two ranks on one device), and the one forward collective moves the
finished cell sums (37.7 MB for a 1024x768 image at 2x2 subpixels), which
go to the host for the image file anyway; the kernels still run on each
rank's card.

Shard files keep the JAX package's ``.npz`` keys (``starts``, ``stops``,
``means``, ``fingerprint``), names (``shard_00000.npz``) and fingerprint
(``render_fingerprint``), so a shard written by either package assembles in
the other.  Survivors of a lost rank follow the JAX protocol: rank 0
publishes the ``LOST_HOSTS`` sentinel before it re-renders, and every
survivor leaves with ``os._exit(0)`` (``cli._render_multihost``), past any
shutdown that would wait on the dead rank.

Launch one process a rank:

    python -m cpu_path_tracing_tpu_torch.cli render --scene box_mirror \\
        --coordinator HOST0:12345 --num-processes 2 --process-id $RANK ...

or ``scripts/torch_launch_multihost.sh`` for N local processes.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import sys
import time
import zipfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..models.scene import Scene
from ..render import finalize_image, render_cells_range
from .mesh import Mesh
from .render import samples_per_shard, sum_shards, tile_span

# Seconds a rank waits in the rendezvous and in a collective before it fails.
COLLECTIVE_TIMEOUT_S = 300.0


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the gloo process group.  Arguments fall back to torch's
    environment variables (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``), as the JAX package's fall back to ``JAX_*``."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator (HOST:PORT), the number of "
                         "processes and this process's id, or MASTER_ADDR/MASTER_PORT, "
                         "WORLD_SIZE and RANK")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def rank_device(kind: torch.device) -> torch.device:
    """This rank's device: the CPU for ``--device cpu``; for ``cuda`` without
    an index ``cuda:{LOCAL_RANK % device_count()}`` (``LOCAL_RANK`` defaults
    to the rank), so ranks on one host spread over its cards and share
    them when they outnumber the cards."""
    kind = torch.device(kind)
    if kind.type != "cuda" or kind.index is not None:
        return kind
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for this rank")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def global_mesh(n_samples: int = 1) -> Mesh:
    """('tiles', 'samples') grid over the ranks of the process group."""
    world = dist.get_world_size()
    if world % n_samples:
        raise ValueError(f"{world} processes not divisible by samples={n_samples}")
    return Mesh(tuple(tuple(range(t * n_samples, (t + 1) * n_samples))
                      for t in range(world // n_samples)))


def _my_shard(cfg: RenderConfig, mesh: Mesh):
    """(tile, sample shard, cells a tile) of this rank."""
    rank = dist.get_rank()
    for t, row in enumerate(mesh.devices):
        if rank in row:
            return t, row.index(rank), tile_span(cfg, mesh.shape["tiles"])
    raise ValueError(f"rank {rank} is not in the mesh")


def _shard_sums(scene: Scene, cfg: RenderConfig, mesh: Mesh):
    """This rank's sums [per, 3] over its sample shard, on its device."""
    t, s, per = _my_shard(cfg, mesh)
    spp_local = samples_per_shard(cfg, mesh.shape["samples"])
    ids = range(t * per, (t + 1) * per)
    return render_cells_range(scene, cfg, ids, s * spp_local, spp_local), t, per


def render_image_multihost(scene: Scene, cfg: RenderConfig, mesh: Optional[Mesh] = None):
    """Full-image render over the ranks; every rank returns the [H,W,3]
    image on its scene's device.  One all-gather of the ranks' cell sums
    (host copies) is the whole render's communication."""
    if mesh is None:
        mesh = global_mesh()
    host = _shard_sums(scene, cfg, mesh)[0].cpu()
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host)
    tiles = [sum_shards([parts[r] for r in row], scene.device) / cfg.spp
             for row in mesh.devices]
    return finalize_image(torch.cat(tiles, dim=0)[:cfg.num_cells], cfg)


def render_shard_multihost(scene: Scene, cfg: RenderConfig, mesh: Optional[Mesh] = None):
    """Zero-collective mode: this rank's cell means as
    ``[(cell_start, cell_stop, means[np.float32])]`` (empty for a tile of
    padding alone), for ``write_shards``.  The mesh has no sample axis here:
    adding sample shards would take a collective."""
    if mesh is None:
        mesh = global_mesh()
    if mesh.shape["samples"] != 1:
        raise ValueError("shard mode takes a tiles-only mesh (--mesh Nx1): summing a sample "
                         "axis needs a collective")
    sums, t, per = _shard_sums(scene, cfg, mesh)
    start = t * per
    if start >= cfg.num_cells:
        return []
    stop = min(start + per, cfg.num_cells)
    means = (sums / cfg.spp)[:stop - start]
    return [(start, stop, means.cpu().numpy().astype(np.float32))]


def render_fingerprint(scene: Scene, cfg: RenderConfig) -> str:
    """Identity of one shard-mode render, equal to the JAX package's: the
    per-sample fingerprint (``utils/checkpoint._fingerprint``) and the
    sample count.  Every shard file carries it, so a stale shard of another
    render in the same directory is neither waited for nor assembled."""
    from ..utils.checkpoint import _fingerprint

    h = hashlib.sha256()
    h.update(_fingerprint(scene, cfg).encode())
    h.update(str(cfg.spp).encode())
    return h.hexdigest()[:16]


def _shard_fingerprint_of(path: str) -> Optional[str]:
    """The fingerprint in a shard file; None for a file without one or one
    that cannot be read (partly written, foreign)."""
    try:
        with np.load(path) as z:
            if "fingerprint" in z.files:
                return str(z["fingerprint"])
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return None
    return None


def write_shards(out_dir: str, shards, cfg: RenderConfig, process_id: int,
                 fingerprint: Optional[str] = None) -> str:
    """Write this rank's shards as ``shard_<rank>.npz`` (atomic:
    ``os.replace`` of a temporary file)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"shard_{process_id:05d}.npz")
    tmp = path + ".tmp.npz"
    means = (np.concatenate([d for _, _, d in shards], axis=0) if shards
             else np.zeros((0, 3), np.float32))
    np.savez(tmp, starts=np.asarray([s for s, _, _ in shards], np.int64),
             stops=np.asarray([e for _, e, _ in shards], np.int64), means=means,
             fingerprint=np.asarray(fingerprint or ""))
    os.replace(tmp, path)
    return path


def _matching_shards(out_dir: str, fingerprint: Optional[str]) -> list:
    names = sorted(n for n in (os.listdir(out_dir) if os.path.isdir(out_dir) else [])
                   if n.startswith("shard_") and n.endswith(".npz") and ".tmp" not in n)
    if fingerprint is None:
        return names
    return [n for n in names if _shard_fingerprint_of(os.path.join(out_dir, n)) == fingerprint]


def wait_for_shards(out_dir: str, num_processes: int, timeout: float = 300.0,
                    poll: float = 0.25, fingerprint: Optional[str] = None) -> list:
    """Rank 0's wait in shard mode: poll for the ranks' shard files (a file
    that is there is complete) instead of a barrier a dead rank would never
    reach.  With ``fingerprint``, only this render's shards count.  Returns
    the files found, all of them or what was there at the timeout."""
    deadline = time.monotonic() + timeout
    while True:
        names = _matching_shards(out_dir, fingerprint)
        if len(names) >= num_processes or time.monotonic() >= deadline:
            return names
        time.sleep(poll)


# Rank 0, the only rank that sees a loss (in its wait), publishes it here so
# that the other survivors leave at once.
_LOST_SENTINEL = "LOST_HOSTS"


def signal_lost_hosts(out_dir: str) -> None:
    """Publish, atomically, that a rank was lost and survivors must leave."""
    tmp = os.path.join(out_dir, _LOST_SENTINEL + ".tmp")
    with open(tmp, "w") as fh:
        fh.write("1\n")
    os.replace(tmp, os.path.join(out_dir, _LOST_SENTINEL))


def wait_all_or_lost(out_dir: str, num_processes: int, timeout: float, poll: float = 0.25,
                     fingerprint: Optional[str] = None) -> str:
    """The other ranks' wait: 'complete' once every rank's shard is there,
    'lost' once rank 0 published a loss, 'timeout' otherwise (rank 0 itself
    may be gone)."""
    deadline = time.monotonic() + timeout
    while True:
        if os.path.exists(os.path.join(out_dir, _LOST_SENTINEL)):
            return "lost"
        if len(_matching_shards(out_dir, fingerprint)) >= num_processes:
            return "complete"
        if time.monotonic() >= deadline:
            return "timeout"
        time.sleep(poll)


def recover_missing_cells(cells: np.ndarray, scene: Scene, cfg: RenderConfig) -> list:
    """Re-render every missing (NaN) span of ``cells`` [num_cells, 3] in
    place, on the scene's device (the forward kernel on the card).  Keys
    depend only on (seed, cell, sample), so a span equals what the lost rank
    would have written on the same device, bit for bit.  Returns the
    recovered (start, stop) spans."""
    missing = np.flatnonzero(np.isnan(cells[:, 0]))
    spans = []
    if missing.size == 0:
        return spans
    breaks = np.flatnonzero(np.diff(missing) > 1)
    starts = np.concatenate([[0], breaks + 1])
    stops = np.concatenate([breaks, [missing.size - 1]])
    for a, b in zip(missing[starts], missing[stops]):
        a, b = int(a), int(b) + 1
        means = render_cells_range(scene, cfg, range(a, b), 0, cfg.spp) / cfg.spp
        cells[a:b] = means.cpu().numpy().astype(np.float32)
        spans.append((a, b))
    return spans


def assemble_shards(out_dir: str, cfg: RenderConfig, scene: Optional[Scene] = None,
                    fingerprint: Optional[str] = None):
    """The [H,W,3] image from the shard files of ``out_dir``, finalized on
    the scene's device, else the CPU.

    With ``scene`` the cells no shard holds are re-rendered
    (``recover_missing_cells``); without it they raise ``ValueError``.  With
    ``fingerprint`` a shard of another render is skipped with a warning."""
    cells = np.full((cfg.num_cells, 3), np.nan, np.float32)
    for name in _matching_shards(out_dir, None):
        path = os.path.join(out_dir, name)
        if fingerprint is not None:
            got = _shard_fingerprint_of(path)
            if got != fingerprint:
                print(f"assemble_shards: skipping stale shard {name} "
                      f"(fingerprint {got!r} != {fingerprint!r})", file=sys.stderr)
                continue
        with np.load(path) as z:
            off = 0
            for start, stop in zip(z["starts"], z["stops"]):
                n = int(stop - start)
                cells[start:stop] = z["means"][off:off + n]
                off += n
    if scene is not None:
        spans = recover_missing_cells(cells, scene, cfg)
        if spans:
            lost = sum(b - a for a, b in spans)
            print(f"recovered {lost} lost cells in {len(spans)} span(s): "
                  f"{spans[:4]}{'...' if len(spans) > 4 else ''}", file=sys.stderr)
    missing = np.flatnonzero(np.isnan(cells[:, 0]))
    if missing.size:
        raise ValueError(f"{missing.size} cells missing (first: {missing[0]}): a rank's shard "
                         "file was not written; re-render that shard")
    device = scene.device if scene is not None else torch.device("cpu")
    return finalize_image(torch.from_numpy(cells).to(device), cfg)
