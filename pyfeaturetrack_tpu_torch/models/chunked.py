"""Chunk-parallel sequence tracking with boundary stitching.

SURVEY.md section 5.7; port of ``pyfeaturetrack_tpu/models/chunked.py``.
The sequence splits into chunks sharing ONE overlap frame, each chunk is
tracked independently (only the tracker state inside a chunk is serial),
and track identities are stitched at the shared boundary frames by
matching feature positions.

The output is a global track table: [n_frames, n_tracks] over the union of
stitched identities, equivalent in content to what a single sequential run
over the whole sequence produces (same per-chunk physics; identities that
persist across a boundary are linked when their boundary positions agree
within ``stitch_tol`` pixels).

``batched=True`` tracks the C chunks in lockstep on one device: every
frame step advances each chunk by one frame (the device step without the
affine stage, as in the JAX package's lockstep program). With ``chain``
> 1, on the card, each chain of steps is one replay of a captured graph
holding the C chunks' steps (``device_sequence.chain_lanes``, the
machinery of the batched streaming tracker).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TrackerConfig, create_config
from ..features import Lane
from ..ops.select import select_good_features_arrays
from ..ops.select_device import DEFAULT_TOP_K
from ..ops.track import as_frame, build_track_pyramids
from ..utils.staging import stage_raw
from .device_sequence import (chain_lanes, sequence_step_device,
                              warn_selection_exhausted)
from .sequence import track_sequence


def track_chunks_batched(chunk_frames, init_x, init_y, init_val,
                         cfg: TrackerConfig, replace_lost: bool = False,
                         chain: int = 1, *, device="cuda"):
    """Track C equal-length chunks in lockstep on ``device``.

    chunk_frames: [C, F, H, W] frames (chunk c's local frames) — a numpy
    array, or a LIST of F tensors [C, H, W] already on the device.
    init_*: [C, N] initial feature state at each chunk's frame 0.
    Returns (xs, ys, vals, exhausted): [C, F, N] per-frame tracked state
    (frame 0 is the initial selection) on the device, plus a device bool
    scalar set when a refill ran out of candidates (never, in the port).
    No host pulls between frames. ``replace_lost=True`` refills lost slots
    each step with the device selection (K4).

    ``chain`` > 1 advances that many frame steps per call (on the card one
    graph replay; the sub-chain tail runs per step). Math is identical for
    any chain.
    """
    if isinstance(chunk_frames, (list, tuple)):
        steps = list(chunk_frames)          # staged by the caller
    else:
        arr = np.asarray(chunk_frames)
        steps = [np.ascontiguousarray(arr[:, i]) for i in range(arr.shape[1])]
    dev = torch.device(device)
    # the lockstep body: build, track, refill; no affine stage
    lcfg = cfg.replace(affineConsistencyCheck=-1)
    first = stage_raw(steps[0], dev)
    dev = first.device
    lanes = []
    for c, f in enumerate(first):
        x, y, v = (torch.as_tensor(np.asarray(a[c]), dtype=dt, device=dev)
                   for a, dt in ((init_x, torch.float32),
                                 (init_y, torch.float32),
                                 (init_val, torch.int32)))
        lanes.append(Lane(build_track_pyramids(as_frame(f), lcfg), x, y, v))
    parts = [tuple(torch.stack([lane[j] for lane in lanes])[:, None]
                   for j in (1, 2, 3))]
    exhausted = torch.zeros((), dtype=torch.bool, device=dev)
    i = 1
    while i < len(steps):
        if chain > 1 and len(steps) - i >= chain:
            lanes, hist, ex = chain_lanes(
                lanes, [list(steps[i + j]) for j in range(chain)], lcfg,
                replace_lost)
            parts.append(hist)
            exhausted = exhausted | ex.any()
            i += chain
            continue
        batch = stage_raw(steps[i], dev)
        for c, f in enumerate(batch):
            pyr, x, y, v, _, _ = lanes[c]
            pyr, x, y, v, _, ex, _ = sequence_step_device(
                pyr, f, x, y, v, lcfg, replace_lost)
            lanes[c] = Lane(pyr, x, y, v)
            exhausted = exhausted | ex
        parts.append(tuple(torch.stack([lane[j] for lane in lanes])[:, None]
                           for j in (1, 2, 3)))
        i += 1
    out = tuple(torch.cat([p[j] for p in parts], dim=1) for j in range(3))
    return out + (exhausted,)


def chunk_bounds(n_frames: int, n_chunks: int) -> list[tuple[int, int]]:
    """Split [0, n_frames) into chunks sharing one boundary frame: chunk k
    spans [s_k, e_k) with s_{k+1} = e_k - 1 (the overlap frame)."""
    n_chunks = max(1, min(n_chunks, n_frames - 1))
    # distribute the n_frames-1 transitions evenly
    trans = n_frames - 1
    per = trans // n_chunks
    extra = trans % n_chunks
    bounds = []
    start = 0
    for k in range(n_chunks):
        steps = per + (1 if k < extra else 0)
        end = start + steps + 1
        bounds.append((start, end))
        start = end - 1
    return bounds


def _stitch_ids(prev_xy: np.ndarray, prev_ids: np.ndarray,
                next_xy: np.ndarray, tol: float) -> np.ndarray:
    """Match next-chunk features at the boundary frame to previous global
    ids by nearest position. Returns per-next-feature global id (-1 = new).
    """
    ids = np.full(next_xy.shape[0], -1, np.int64)
    if prev_xy.shape[0] == 0 or next_xy.shape[0] == 0:
        return ids
    d = np.abs(prev_xy[None, :, :] - next_xy[:, None, :]).max(axis=-1)
    best = d.argmin(axis=1)
    ok = d[np.arange(next_xy.shape[0]), best] <= tol
    ids[ok] = prev_ids[best[ok]]
    # a global id must not be claimed twice; keep the closest claimant
    for gid in np.unique(ids[ids >= 0]):
        claimants = np.nonzero(ids == gid)[0]
        if claimants.size > 1:
            keep = claimants[d[claimants, best[claimants]].argmin()]
            ids[claimants] = -1
            ids[keep] = gid
    return ids


def chunk_stack(frames, bounds, n_features: int, cfg, *, device="cuda"):
    """The lockstep inputs of ``bounds``' chunks: the [C, F, H, W] float32
    frame stack (a short chunk padded by repeating its last frame) and the
    [C, N, 3] initial selections (x, y, val), each chunk's first frame
    through the host API on ``device``."""
    max_len = max(e - s for (s, e) in bounds)
    stack = np.zeros((len(bounds), max_len) + np.shape(frames[0]),
                     np.float32)
    inits = np.zeros((len(bounds), n_features, 3), np.float64)
    for k, (s, e) in enumerate(bounds):
        chunk = frames[s:e]
        stack[k, :len(chunk)] = np.asarray(chunk, np.float32)
        stack[k, len(chunk):] = chunk[-1]  # pad: repeat last frame
        inits[k] = select_good_features_arrays(chunk[0], n_features, cfg,
                                               device=device)
    return stack, inits


def track_sequence_chunked(frames, cfg: Optional[TrackerConfig] = None,
                           n_features: int = 150, n_chunks: int = 2,
                           replace_lost: bool = True,
                           stitch_tol: float = 1.0,
                           batched: bool = False, chain: int = 1, *,
                           device="cuda"):
    """Track ``frames`` in ``n_chunks`` independent chunks and stitch.

    Returns (table, track_ids_per_chunk, metrics):
      table — dict with 'x', 'y', 'val' float/int arrays
      [n_frames, n_global_tracks]; columns are stitched global tracks.

    ``batched=False`` tracks chunk after chunk through the host API
    (``track_sequence``). ``batched=True`` advances ALL chunks in
    lockstep on the device (``track_chunks_batched``), each chunk's first
    selection through the host API; ``replace_lost`` is honoured there
    too by the device selection, with no host pulls between frames.
    ``chain`` > 1 (batched mode only) advances that many lockstep steps
    per call.
    """
    # stitch_tol: a continuing physical corner is re-detected by the next
    # chunk at an integer pixel while the left chunk tracked it to subpixel
    # drift — up to 0.5 px apart per axis; 1.0 px catches those without
    # ambiguity (mindist keeps distinct features >= mindist apart).
    frames = list(frames)
    n_frames = len(frames)
    cfg = cfg if cfg is not None else create_config()
    bounds = chunk_bounds(n_frames, n_chunks)

    chunk_tables = []
    all_metrics = []
    if batched:
        stack, inits = chunk_stack(frames, bounds, n_features, cfg,
                                   device=device)
        xs, ys, vs, exhausted = track_chunks_batched(
            stack, inits[..., 0], inits[..., 1],
            inits[..., 2].astype(np.int64), cfg,
            replace_lost=replace_lost, chain=chain, device=device)
        xs = xs.cpu().numpy().astype(np.float64)
        ys = ys.cpu().numpy().astype(np.float64)
        vs = vs.cpu().numpy().astype(np.int64)
        if replace_lost and bool(exhausted):  # table already pulled above
            warn_selection_exhausted("track_chunks_batched", DEFAULT_TOP_K)
        for k, (s, e) in enumerate(bounds):
            ln = e - s
            chunk_tables.append((s, e, xs[k, :ln], ys[k, :ln], vs[k, :ln]))
            all_metrics.append([])
    else:
        # every chunk independently (in a deployment, one per host)
        for (s, e) in bounds:
            ft, metrics = track_sequence(frames[s:e], cfg=cfg,
                                         n_features=n_features,
                                         replace_lost=replace_lost,
                                         device=device)
            chunk_tables.append((s, e, ft.x.cpu().numpy().astype(np.float64),
                                 ft.y.cpu().numpy().astype(np.float64),
                                 ft.val.cpu().numpy().astype(np.int64)))
            all_metrics.append(metrics)

    table, col_ids = stitch_chunk_tables(chunk_tables, n_frames,
                                         n_features, stitch_tol)
    return (table, col_ids, all_metrics)


def stitch_chunk_tables(chunk_tables, n_frames: int, n_features: int,
                        stitch_tol: float = 1.0):
    """Stitch per-chunk track tables into one global table.

    ``chunk_tables`` is a list of (s, e, x, y, v) with x/y [e-s, N]
    float64 and v [e-s, N] int64, chunks sharing one boundary frame
    (chunk_bounds). Pure host-side numpy: the piece each host runs after
    gathering every chunk's table in a multi-process deployment, and the
    same code single-process callers use. Returns (table dict, col_ids)."""
    next_gid = 0
    col_ids = []       # per chunk: global id of each feature column
    col_matched = []   # per chunk: column continues a previous-chunk track
    for k, (s, e, x, y, v) in enumerate(chunk_tables):
        ids = np.full(n_features, -1, np.int64)
        if k > 0:
            ps, pe, px, py, pv = chunk_tables[k - 1]
            # boundary frame = global frame s == local frame (pe-ps-1) of
            # chunk k-1 and local frame 0 of chunk k
            prev_live = pv[-1] >= 0
            prev_ids = col_ids[k - 1]
            live_mask = prev_live & (prev_ids >= 0)
            prev_xy = np.stack([px[-1][live_mask], py[-1][live_mask]], -1)
            cur_live = v[0] >= 0
            nxt_xy = np.stack([x[0][cur_live], y[0][cur_live]], -1)
            matched = _stitch_ids(prev_xy, prev_ids[live_mask], nxt_xy,
                                  stitch_tol)
            ids[np.nonzero(cur_live)[0]] = matched
        col_matched.append(ids >= 0)
        # assign fresh global ids to unmatched live columns
        for j in range(n_features):
            ever_live = (v[:, j] >= 0).any()
            if ever_live and ids[j] < 0:
                ids[j] = next_gid
                next_gid += 1
        col_ids.append(ids)

    # Merge into the global table.
    gx = np.full((n_frames, next_gid), -1.0)
    gy = np.full((n_frames, next_gid), -1.0)
    gv = np.full((n_frames, next_gid), -1, np.int64)
    for k, (s, e, x, y, v) in enumerate(chunk_tables):
        ids = col_ids[k]
        for j in range(n_features):
            gid = ids[j]
            if gid < 0:
                continue
            # the boundary frame belongs to the LEFT chunk for continued
            # tracks; fresh tracks born at this chunk's first frame keep
            # their first observation (the sequential run records it too)
            lo = 1 if (k > 0 and col_matched[k][j]) else 0
            rows = np.arange(s + lo, e)
            lrows = np.arange(lo, e - s)
            gx[rows, gid] = x[lrows, j]
            gy[rows, gid] = y[lrows, j]
            gv[rows, gid] = v[lrows, j]

    return {"x": gx, "y": gy, "val": gv}, col_ids
