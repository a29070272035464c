"""Multi-process deployment helpers on ``torch.distributed``.

Port of ``pyfeaturetrack_tpu/parallel/multihost.py``. Across processes the
port runs SPMD, one process per card: every process runs the same
program, ``initialize_cluster`` joins them into one process group (NCCL
between cards, gloo on the CPU), and the meshes of parallel/sharding.py
span its ranks.

Work placement for the tracker:

* frame-pair / feature / row sharding: build a mesh after
  ``initialize_cluster`` and call the sharded entries with the same global
  inputs on every process;
* chunked sequences (models/chunked.py): each process tracks the chunks in
  ``host_chunk_assignment`` locally, the per-chunk tables travel with ONE
  all-gather, and every process stitches the same global table;
* distributed BA: landmarks shard over a ``landmark`` mesh
  (``sfm.bundle_adjust(mesh=...)``): one combine of the camera system per
  iteration is the only collective.

A user starts N processes with ``torchrun --nproc_per_node N script.py``
and calls ``initialize_cluster()`` in each.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# The torchrun variables that name a cluster.
_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _summary(device) -> dict:
    on = dist.is_initialized()
    dev = torch.device(device)
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "local_devices": (torch.cuda.device_count() if dev.type == "cuda"
                          else 1),
        "global_devices": dist.get_world_size() if on else 1,
        "backend": dist.get_backend() if on else None,
    }


def initialize_cluster(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       auto: bool = True, *, device="cuda",
                       timeout: float | None = None) -> dict:
    """Join this process to the cluster's process group and return a
    summary (process index and count, local and global devices, backend).

    The backend is NCCL when ``device`` is the card (the port's default)
    and gloo when it is the CPU; NCCL is never swapped for gloo. Explicit
    arguments (the coordinator's "host:port" or an init URL such as
    "file:///path", the process count, this process's rank) go to
    ``init_process_group``. With none and ``auto``, the torchrun
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)
    is read; with no cluster in the environment this is the one-process
    summary and no group is made. A cluster that is named but cannot be
    joined within ``timeout`` seconds (torch's default when None) raises.
    On the card, each process takes card ``LOCAL_RANK`` (explicit
    arguments: ``process_id`` modulo the local card count)."""
    dev = torch.device(device)
    if dist.is_initialized():
        return _summary(dev)
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError("initialize_cluster: give coordinator_address, "
                             "num_processes and process_id together")
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
        local = rank % max(torch.cuda.device_count(), 1) \
            if dev.type == "cuda" else 0
    elif auto and all(k in os.environ for k in _CLUSTER_ENV):
        init = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", "0"))
    else:
        return _summary(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_cluster: the NCCL backend needs a "
                               "CUDA device; pass device='cpu' for gloo")
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    return _summary(dev)


def _rank_and_count() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_chunk_assignment(n_chunks: int) -> list[int]:
    """Chunk indices this process owns (contiguous block partition)."""
    p, n = _rank_and_count()
    per, extra = n_chunks // n, n_chunks % n
    start = p * per + min(p, extra)
    return list(range(start, start + per + (1 if p < extra else 0)))


def allgather_boundary_states(local_states: np.ndarray,
                              n_chunks: int | None = None) -> np.ndarray:
    """All-gather per-chunk arrays across processes.

    ``local_states``: [n_local_chunks, ...] (this process's chunks, in
    ``host_chunk_assignment`` order); ``n_chunks``: the global chunk count
    (default this process's count times the process count, right for even
    partitions only). Every process pads its block to the largest block
    (derived from ``n_chunks``: the partition is deterministic), one
    all-gather moves the even tiles, and the pad rows are dropped.
    Returns [n_chunks, ...] on every process, in the input's dtype (float32,
    float64, int32 or int64)."""
    local_states = np.asarray(local_states)
    _, n = _rank_and_count()
    if n == 1:
        return local_states
    if n_chunks is None:
        n_chunks = local_states.shape[0] * n
    per_max = -(-n_chunks // n)
    pad = per_max - local_states.shape[0]
    if pad:
        local_states = np.concatenate(
            [local_states, np.zeros((pad,) + local_states.shape[1:],
                                    local_states.dtype)], axis=0)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(np.ascontiguousarray(local_states)).to(dev)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t)
    per, extra = n_chunks // n, n_chunks % n
    return np.concatenate([parts[p][:per + (1 if p < extra else 0)]
                           .cpu().numpy() for p in range(n)], axis=0)


def track_sequence_multiprocess(frames, cfg=None, n_features: int = 150,
                                n_chunks: int | None = None,
                                replace_lost: bool = True,
                                stitch_tol: float = 1.0, *, device="cuda"):
    """Multi-process chunk-and-stitch sequence tracking: every process
    tracks only its chunks (``host_chunk_assignment``) with the port's
    ``track_sequence`` on ``device``, the per-chunk tables travel with ONE
    all-gather, and every process stitches the same global table with
    ``models/chunked.stitch_chunk_tables``, the function the one-process
    ``track_sequence_chunked`` uses, so the result equals
    ``track_sequence_chunked(frames)`` bit for bit. ``frames`` is the whole
    sequence on every process. Returns (table, col_ids) as it does."""
    from ..models.chunked import chunk_bounds, stitch_chunk_tables
    from ..models.sequence import track_sequence

    frames = list(frames)
    n_frames = len(frames)
    if n_chunks is None:
        n_chunks = _rank_and_count()[1]
    bounds = chunk_bounds(n_frames, n_chunks)
    mine = host_chunk_assignment(len(bounds))

    # every table padded to the longest chunk: one even-shaped tile each
    max_len = max(e - s for (s, e) in bounds)
    local = np.full((len(mine), max_len, n_features, 3), -1.0, np.float64)
    for row, k in enumerate(mine):
        s, e = bounds[k]
        ft, _ = track_sequence(frames[s:e], cfg=cfg, n_features=n_features,
                               replace_lost=replace_lost, device=device)
        for j, col in enumerate((ft.x, ft.y, ft.val)):
            local[row, :e - s, :, j] = col.cpu().numpy()

    gathered = allgather_boundary_states(
        local.reshape(len(mine), -1), n_chunks=len(bounds)).reshape(
            len(bounds), max_len, n_features, 3)
    tables = [(s, e, gathered[k, :e - s, :, 0], gathered[k, :e - s, :, 1],
               gathered[k, :e - s, :, 2].astype(np.int64))
              for k, (s, e) in enumerate(bounds)]
    return stitch_chunk_tables(tables, n_frames, n_features, stitch_tol)
