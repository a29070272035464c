"""Device-resident sequence tracking with no per-frame host sync.

Reference parity: example3.py / SURVEY.md section 3.5 — the
select -> (track -> replace-lost)* recurrence; port of
``pyfeaturetrack_tpu/models/device_sequence.py``. Per frame:

1. K1 builds the new frame's pyramid and gradients;
2. K2 runs pyramidal LK for every live feature, one launch per track
   call (every level, the coarse-level break rule and the final
   classification);
3. when ``cfg.affineConsistencyCheck >= 0``, the affine-consistency stage
   (``ops/affine.affine_consistency_check``): templates are captured on a
   feature's first successful track and every later track is re-verified
   against its template under a warp by K6, carrying the AffineState
   (templates + warps) between steps;
4. refill: K3's min-eig map of the level-0 gradients, computed in step
   1's level-0 launch when ``cfg.smoothBeforeSelecting`` (the default),
   else by one eig-only level-0 launch of the raw frame
   (``ops/select.selection_eig_map``); K4 selects replacements for the
   lost slots in two launches (the candidate lattice with the kept
   features' pre-mask; the greedy chain and the slot fill); refilled slots
   lose their templates (``reset_affine``).

The refill gate. The JAX step refills under ``lax.cond(any(val < 0))``. In
eager PyTorch that test is a host sync every frame, so the port always
computes the map and launches K4, and K4 counts its budget (the number of
lost slots) on the device: with budget 0 its chain stops at once and every
slot comes back as it was, and ``reset_affine`` drops the templates of an
empty mask, so the results are identical to the gated step. The affine stage's
template capture is applied by mask for the same reason. The feature
table comes back to the host once, at the end of
``track_sequence_device``.

Chained steps. ``sequence_chain_device`` advances k frames per call, the
counterpart of the JAX package's jitted k-frame program. On CPU tensors
it is the steps one by one. On the card the k steps are one captured CUDA
graph (``_ChainGraph``), replayed once per k frames: the frames' copy to
the card, each step's pyramid build, K2, the affine stage, the refill and
the writes into the history rows, with no host work between them. The
graph holds the carried state (the pyramids, in two buffers the steps
alternate between; x, y, val; every AffineState field; the TrackCarry) in
its own buffers; a call whose state is not the one the graph handed out
last is copied in first, and every tensor a call returns is a copy, so a
later replay never changes what a caller holds. Host frames enter through
a pinned buffer of k frames in the staged dtype (``utils/staging``: uint8
stays uint8 and is cast on the card, inside the graph); frames already on
the card are copied into the graph's frame buffer before the replay.
``chain_lanes`` runs B independent lanes (streams, chunks) in one graph,
their steps in lane order within each frame.

Out of this port (raise NotImplementedError): ``image_dtype`` other than
float32.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable, Optional

import numpy as np
import torch

from ..config import TrackerConfig, create_config
from ..errors import KLTWarning
from ..features import KLT_NOT_FOUND, AffineState, FeatureState, reset_affine
from ..ops import (cuda_affine, cuda_eig, cuda_lk, cuda_lk_dense,
                   cuda_pyramid, cuda_select, cuda_suppress,
                   cuda_window_terms)
from ..ops.affine import affine_consistency_check, make_affine_state
from ..ops.cuda_lk import TrackCarry
from ..ops.cuda_pyramid import level_shapes, pyramid_numel, pyramid_views
from ..ops.select import selection_eig_map
from ..ops.select_device import (DEFAULT_TOP_K,
                                 select_features_from_eig_device)
from ..ops.track import (TrackPyramids, as_frame, build_track_pyramids,
                         track_features_pyramids_carry)
from ..utils import cuda
from ..utils.staging import host_frame, stage_raw


def _check_cfg(cfg) -> None:
    if cfg.image_dtype != "float32":
        raise NotImplementedError(
            f"image_dtype={cfg.image_dtype!r}: the port stores float32 "
            "pyramids only")


def _build_with_map(img: torch.Tensor, cfg, with_map: bool, out=None):
    """The frame's pyramids (built into ``out`` when given) and, with
    ``with_map``, its selection min-eig map (else None): from the build's
    level-0 launch when smoothBeforeSelecting, else one eig-only launch of
    the raw frame."""
    if not with_map:
        return build_track_pyramids(img, cfg, out=out), None
    if cfg.smoothBeforeSelecting:
        return build_track_pyramids(img, cfg, with_eig=True, out=out)
    return (build_track_pyramids(img, cfg, out=out),
            selection_eig_map(img, cfg))


def select_step_device(img, cfg, n_features: int,
                       top_k: int = DEFAULT_TOP_K, device=None):
    """Frame-0 step: build pyramids + select n_features on the device.

    ``img``: [H, W] tensor (used on its own device unless ``device`` is
    given) or array (sent to ``device``, default "cuda").
    Returns (pyr, x, y, val, aff, exhausted); ``aff`` is a fresh
    AffineState when ``cfg.affineConsistencyCheck >= 0``, else None, and
    ``exhausted`` is a False device scalar."""
    _check_cfg(cfg)
    img = as_frame(img, device)
    pyr, eig = _build_with_map(img, cfg, True)
    dev = img.device
    x0 = torch.full((n_features,), -1.0, dtype=torch.float32, device=dev)
    y0 = torch.full((n_features,), -1.0, dtype=torch.float32, device=dev)
    v0 = torch.full((n_features,), KLT_NOT_FOUND, dtype=torch.int32,
                    device=dev)
    x, y, val, _, exhausted = select_features_from_eig_device(
        eig, x0, y0, v0, cfg, replacing=False, top_k=top_k)
    aff = (make_affine_state(n_features, cfg, dev)
           if cfg.affineConsistencyCheck >= 0 else None)
    return pyr, x, y, val, aff, exhausted


def _step(pyr_prev, img_new, x, y, val, cfg, replace_lost, aff, carry,
          pyr_out=None):
    """One frame step on a float32 frame on the features' device (the body
    shared by ``sequence_step_device`` and the captured chain)."""
    pyr_new, eig = _build_with_map(img_new, cfg, replace_lost, out=pyr_out)
    nx, ny, nval, carry = track_features_pyramids_carry(
        pyr_prev, pyr_new, x, y, val, cfg, carry=carry)
    if cfg.affineConsistencyCheck >= 0:
        after = affine_consistency_check(
            pyr_prev, pyr_new, FeatureState(x, y, val, aff),
            FeatureState(nx, ny, nval, aff), cfg)
        nx, ny, nval, aff = after.x, after.y, after.val, after.aff
    exhausted = torch.zeros((), dtype=torch.bool, device=x.device)
    if replace_lost:
        # always launched; budget 0 (nothing lost) leaves every slot as is
        lost = nval < 0
        nx, ny, nval, _, exhausted = select_features_from_eig_device(
            eig, nx, ny, nval, cfg, replacing=True)
        if aff is not None:
            # refilled slots are fresh features: their templates recapture
            aff = reset_affine(aff, lost)
    return pyr_new, nx, ny, nval, aff, exhausted, carry


def sequence_step_device(pyr_prev: TrackPyramids, img_new, x: torch.Tensor,
                         y: torch.Tensor, val: torch.Tensor, cfg,
                         replace_lost: bool = True,
                         top_k: int = DEFAULT_TOP_K, aff=None, carry=None):
    """One frame step: track into ``img_new``, run the affine-consistency
    stage when configured, then refill lost slots, all on the feature
    arrays' device with no host sync.

    Returns (pyr_new, x, y, val, aff, exhausted, carry); thread ``aff``
    (the AffineState) and ``carry`` back with ``pyr_new`` (the port
    returns ``carry`` with ``ok`` cleared: no window reuse yet, identical
    results)."""
    del top_k          # the extraction scans every candidate
    _check_cfg(cfg)
    return _step(pyr_prev, as_frame(img_new, x.device), x, y, val, cfg,
                 replace_lost, aff, carry)


# ---------------------------------------------------------------------------
# Chained steps
# ---------------------------------------------------------------------------

def _chain_plain(lanes, frames, cfg, replace_lost):
    """The chain's plain version: the steps one by one, each frame's lanes
    in lane order. Returns (lanes, (hx, hy, hv) [B, k, N], exhausted
    [B])."""
    lanes = list(lanes)
    rows = [[] for _ in lanes]
    ex = [None] * len(lanes)
    for tick in frames:
        for b, img in enumerate(tick):
            pyr, x, y, val, aff, carry = lanes[b]
            pyr, x, y, val, aff, e, carry = _step(
                pyr, as_frame(img, x.device), x, y, val, cfg, replace_lost,
                aff, carry)
            lanes[b] = (pyr, x, y, val, aff, carry)
            rows[b].append((x, y, val))
            ex[b] = e if ex[b] is None else ex[b] | e
    hist = tuple(torch.stack([torch.stack([r[j] for r in lane_rows])
                              for lane_rows in rows]) for j in range(3))
    return lanes, hist, torch.stack(ex)


# Every kernel module's launch counters: a replay adds what its capture
# recorded (the capture itself launches nothing).
_COUNTERS = ((cuda_pyramid, "launches"), (cuda_pyramid, "eig_launches"),
             (cuda_lk, "launches"), (cuda_eig, "launches"),
             (cuda_select, "launches"), (cuda_suppress, "launches"),
             (cuda_affine, "launches"), (cuda_lk_dense, "launches"),
             (cuda_window_terms, "launches"))


def _counts() -> list:
    return [getattr(m, a) for m, a in _COUNTERS]


def _flat(lanes) -> list:
    """Every state tensor of the lanes, in a fixed order."""
    out = []
    for pyr, x, y, val, aff, carry in lanes:
        out += [*pyr.img, *pyr.gradx, *pyr.grady, x, y, val]
        if aff is not None:
            out += [t for t in aff if t is not None]
        if carry is not None:
            out += list(carry)
    return out


class _ChainGraph:
    """k frame steps of B lanes, captured in one CUDA graph on one device.

    The graph's own buffers hold the frames ([k, B, H, W] in the staged
    dtype, and a pinned host copy when frames come from the host) and the
    lanes' carried state, each lane's pyramid in two buffers that the steps
    alternate between (buffer 0 holds the state between replays)."""

    def __init__(self, cfg, lanes, k: int, frame_dtype, host: bool,
                 replace_lost: bool):
        pyr, x0, _, _, aff, carry = lanes[0]
        dev = x0.device
        b, n = len(lanes), x0.shape[0]
        h, w = pyr.img[0].shape
        self.cfg, self.k, self.b, self.replace_lost = cfg, k, b, replace_lost
        self.shapes = level_shapes(h, w, cfg.subsampling, cfg.nPyramidLevels)
        on = dict(device=dev)
        # zeroed frames and dead lanes: the warm-up step runs on them
        self.frames = torch.zeros((k, b, h, w), dtype=frame_dtype, **on)
        self.pinned = self.staged = None
        if host:
            self.pinned = torch.zeros((k, b, h, w), dtype=frame_dtype,
                                      pin_memory=True)
            self.pinned_np = self.pinned.numpy()
            # recorded in the graph once its frames are on the card
            self.staged = torch.cuda.Event(external=True)
        self.pyr_buf = torch.zeros((2, b, pyramid_numel(self.shapes)),
                                   dtype=torch.float32, **on)
        self.x = torch.full((b, n), -1.0, dtype=torch.float32, **on)
        self.y = torch.full((b, n), -1.0, dtype=torch.float32, **on)
        self.val = torch.full((b, n), KLT_NOT_FOUND, dtype=torch.int32,
                              **on)
        self.aff = None
        if aff is not None:
            shapes = [t.shape for t in aff[:7]] + [(n,)]
            dtypes = [t.dtype for t in aff[:7]] + [torch.int32]
            self.aff = AffineState(*(torch.zeros((b, *s), dtype=d, **on)
                                     for s, d in zip(shapes, dtypes)))
        self.carry = None
        if carry is not None:
            self.carry = TrackCarry(*(torch.zeros((b, *t.shape),
                                                  dtype=t.dtype, **on)
                                      for t in carry))
        self.hist = (torch.zeros((b, k, n), dtype=torch.float32, **on),
                     torch.zeros((b, k, n), dtype=torch.float32, **on),
                     torch.zeros((b, k, n), dtype=torch.int32, **on))
        self.exhausted = torch.zeros((b,), dtype=torch.bool, **on)
        self._held = None
        self._capture(dev)

    def _lane(self, b: int, buf: int = 0):
        return (TrackPyramids(*pyramid_views(self.pyr_buf[buf, b],
                                             self.shapes)),
                self.x[b], self.y[b], self.val[b],
                None if self.aff is None else
                AffineState(*(t[b] for t in self.aff)),
                None if self.carry is None else
                TrackCarry(*(t[b] for t in self.carry)))

    def _body(self) -> None:
        if self.pinned is not None:
            self.frames.copy_(self.pinned, non_blocking=True)
            self.staged.record()
        lanes = [self._lane(b) for b in range(self.b)]
        ex = []
        for j in range(self.k):
            out_buf = (j + 1) % 2
            for b in range(self.b):
                pyr, x, y, val, aff, carry = lanes[b]
                pyr, x, y, val, aff, e, carry = _step(
                    pyr, self.frames[j, b].to(torch.float32), x, y, val,
                    self.cfg, self.replace_lost, aff, carry,
                    pyr_out=self.pyr_buf[out_buf, b])
                lanes[b] = (pyr, x, y, val, aff, carry)
                for hist, t in zip(self.hist, (x, y, val)):
                    hist[b, j].copy_(t)
                ex.append(e)
        # one reduction per chain: a lane is exhausted if any step was
        self.exhausted.copy_(torch.stack(ex).view(self.k, self.b).any(0))
        for b, (_, x, y, val, aff, carry) in enumerate(lanes):
            self.x[b].copy_(x)
            self.y[b].copy_(y)
            self.val[b].copy_(val)
            if aff is not None:
                for dst, src in zip(self.aff, aff):
                    dst[b].copy_(src)
            if carry is not None:
                for dst, src in zip(self.carry, carry):
                    dst[b].copy_(src)
        if self.k % 2:
            self.pyr_buf[0].copy_(self.pyr_buf[1])

    def _capture(self, dev) -> None:
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # warm-up, outside the capture and on the capture stream: the
            # first kernel call builds and loads the library, makes the
            # taps and sets each kernel's shared-memory limit, and K1's
            # coarse launch allocates the grid-barrier state of this stream
            pyr, x, y, val, aff, carry = self._lane(0)
            _step(pyr, self.frames[0, 0].to(torch.float32), x, y, val,
                  self.cfg, self.replace_lost, aff, carry)
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a prefetch thread may stage frames meanwhile
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._body()
        after = _counts()
        self.deltas = [a - c for a, c in zip(after, before)]
        for (mod, attr), v in zip(_COUNTERS, before):
            setattr(mod, attr, v)

    def _holds(self, lanes) -> bool:
        """True when ``lanes`` are the state the last replay handed out,
        unchanged since: the graph's buffers already hold it."""
        if self._held is None:
            return False
        flat = _flat(lanes)
        return len(flat) == len(self._held) and all(
            t is h and t._version == v for t, (h, v) in zip(flat, self._held))

    def _load(self, lanes) -> None:
        for b, (pyr, x, y, val, aff, carry) in enumerate(lanes):
            dst = self._lane(b)
            for d_lv, s_lv in zip(dst[0], pyr):
                for d, s in zip(d_lv, s_lv):
                    d.copy_(s)
            for d, s in zip(dst[1:4], (x, y, val)):
                d.copy_(s)
            if aff is not None:
                for d, s in zip(dst[4], aff):
                    if s is None:           # nit: None is zeros
                        d.zero_()
                    else:
                        d.copy_(s)
            if carry is not None:
                for d, s in zip(dst[5], carry):
                    d.copy_(s)

    def _stage(self, frames) -> None:
        if self.pinned is not None:
            # the last replay has copied its frames out of the pinned buffer
            self.staged.synchronize()
            for j, tick in enumerate(frames):
                for b, f in enumerate(tick):
                    self.pinned_np[j, b] = f
        else:
            for j, tick in enumerate(frames):
                for b, f in enumerate(tick):
                    self.frames[j, b].copy_(f)

    def run(self, lanes, frames):
        """Replay on the current stream: (lanes, hist, exhausted), every
        tensor a copy of the graph's buffers."""
        self._stage(frames)
        if not self._holds(lanes):
            self._load(lanes)
        self.graph.replay()
        for (mod, attr), d in zip(_COUNTERS, self.deltas):
            setattr(mod, attr, getattr(mod, attr) + d)
        pyr_all = self.pyr_buf[0].clone()
        x, y, val = self.x.clone(), self.y.clone(), self.val.clone()
        aff = None if self.aff is None else [t.clone() for t in self.aff]
        carry = (None if self.carry is None
                 else [t.clone() for t in self.carry])
        out = [(TrackPyramids(*pyramid_views(pyr_all[b], self.shapes)),
                x[b], y[b], val[b],
                None if aff is None else AffineState(*(t[b] for t in aff)),
                None if carry is None else TrackCarry(*(t[b] for t in carry)))
               for b in range(self.b)]
        self._held = [(t, t._version) for t in _flat(out)]
        return (out, tuple(h.clone() for h in self.hist),
                self.exhausted.clone())


# Captured chains by (cfg, lanes, H, W, N, k, replace_lost, affine state,
# carry, frame dtype, host frames, device), least recently used first.
_GRAPHS: OrderedDict = OrderedDict()
GRAPH_CACHE_SIZE = 8
_graph_lock = threading.Lock()
_capture_streams: dict = {}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    stream = _capture_streams.get(dev.index)
    if stream is None:
        stream = _capture_streams[dev.index] = torch.cuda.Stream(dev)
    return stream


def _staged_frames(frames, dev):
    """The chain's frames as the graph takes them: (frames, dtype, host).
    Host frames become C-contiguous numpy arrays (uint8 kept when every
    frame is uint8, else float32); if any frame is already on the card,
    every frame is staged there."""
    flat = [f for tick in frames for f in tick]
    host = not any(isinstance(f, torch.Tensor) and f.is_cuda for f in flat)
    if host:
        arrs = [host_frame(f, True) for f in flat]
        uint8 = all(a.dtype == np.uint8 for a in arrs)
    else:
        arrs = [stage_raw(f, dev) for f in flat]
        uint8 = all(a.dtype == torch.uint8 for a in arrs)
    dtype = torch.uint8 if uint8 else torch.float32
    if host and not uint8:
        arrs = [a.astype(np.float32, copy=False) for a in arrs]
    b = len(frames[0])
    return ([arrs[j * b:(j + 1) * b] for j in range(len(frames))], dtype,
            host)


def _lane_tensors(lane):
    """Every tensor of a (pyr, x, y, val, aff, carry) lane state."""
    pyr, x, y, val, aff, carry = lane
    return (*pyr.img, *pyr.gradx, *pyr.grady, x, y, val,
            *(aff if aff is not None else ()),
            *(carry if carry is not None else ()))


def chain_lanes(lanes, frames, cfg, replace_lost: bool = True):
    """k frame steps for each of B independent lanes: ``lanes`` is a list
    of (pyr, x, y, val, aff, carry) states on one device, ``frames`` k
    sequences of B frames (arrays or tensors). Returns (lanes, (hx, hy,
    hv) [B, k, N], exhausted [B] bool). On CUDA tensors, one replay of the
    captured chain for this shape (captured at its first call); a replay
    records no gradients, so an input that requires grad raises
    ValueError there."""
    x0 = lanes[0][1]
    if not cuda.use_kernel(x0):
        return _chain_plain(lanes, frames, cfg, replace_lost)
    if cuda.records_grad(*(f for tick in frames for f in tick
                           if isinstance(f, torch.Tensor)),
                         *(t for lane in lanes for t in _lane_tensors(lane))):
        raise ValueError(
            "the chained step (sequence_chain_device, the streaming "
            "trackers) replays a captured CUDA graph, which records no "
            "gradients: detach its inputs, or differentiate the eager step "
            "(sequence_step_device)")
    frames, dtype, host = _staged_frames(frames, x0.device)
    h, w = lanes[0][0].img[0].shape
    for tick in frames:
        cuda.require(len(tick) == len(lanes) and all(
            tuple(f.shape) == (h, w) for f in tick),
            f"chain_lanes: every frame step takes {len(lanes)} frames of "
            f"{h}x{w}")
    key = (cfg, len(lanes), h, w, x0.shape[0], len(frames),
           bool(replace_lost), lanes[0][4] is not None,
           lanes[0][5] is not None, dtype, host, x0.device)
    with _graph_lock:
        graph = _GRAPHS.get(key)
        if graph is None:
            graph = _ChainGraph(cfg, lanes, len(frames), dtype, host,
                                replace_lost)
            _GRAPHS[key] = graph
            while len(_GRAPHS) > GRAPH_CACHE_SIZE:
                _GRAPHS.popitem(last=False)
        else:
            _GRAPHS.move_to_end(key)
        return graph.run(lanes, frames)


def sequence_chain_device(pyr_prev: TrackPyramids, imgs, x: torch.Tensor,
                          y: torch.Tensor, val: torch.Tensor, cfg,
                          replace_lost: bool = True,
                          top_k: int = DEFAULT_TOP_K, aff=None, carry=None):
    """Micro-chained steps: advance len(imgs) frames in one call, the same
    math as repeated ``sequence_step_device`` calls; on the card one replay
    of a captured CUDA graph (the module notes).

    Returns (pyr, hist, final, aff, exhausted, carry): hist = per-frame
    (x, y, val) stacked [k, N]; final = the last (x, y, val); exhausted =
    any step's refill ran out of candidates (never, in the port). Every
    returned tensor is the caller's own: a later call changes none of
    them."""
    del top_k
    _check_cfg(cfg)
    lanes, hist, ex = chain_lanes([(pyr_prev, x, y, val, aff, carry)],
                                  [[img] for img in imgs], cfg, replace_lost)
    pyr, x, y, val, aff, carry = lanes[0]
    return pyr, tuple(h[0] for h in hist), (x, y, val), aff, ex[0], carry


def warn_selection_exhausted(where: str, top_k: int) -> None:
    """Shared warning for a selection that ran out of candidates with free
    slots left. The port's K4 scans the whole candidate pool
    (``ops/select_device.py``), so its device selection never reports
    exhaustion; the warning keeps the JAX package's callers' shape."""
    KLTWarning("(%s) a selection ran out of candidates with free slots "
               "left (top_k %d)", where, top_k)


def stack_history_chunks(chunks) -> tuple:
    """Concatenate per-frame history chunks ([k, N] triplets from chained
    steps, [N] rows from single steps; tensors or arrays) into stacked
    [n_frames, N] numpy (x, y, val)."""
    out = []
    for j in range(3):
        col = [c[j] for c in chunks]
        if all(isinstance(c, torch.Tensor) for c in col):
            out.append(torch.cat([torch.atleast_2d(c) for c in col])
                       .cpu().numpy())
        else:
            out.append(np.concatenate(
                [np.atleast_2d(c.cpu().numpy() if isinstance(c, torch.Tensor)
                               else np.asarray(c)) for c in col], axis=0))
    return tuple(out)


def track_sequence_device(frames: Iterable, cfg: Optional[TrackerConfig]
                          = None, n_features: int = 150,
                          replace_lost: bool = True,
                          top_k: int = DEFAULT_TOP_K, chain: int = 1, *,
                          device="cuda"):
    """Track a whole sequence on ``device``; one host pull at the end.

    ``frames``: [H, W] arrays or tensors (uint8 or float). Returns (x, y,
    val) stacked [n_frames, n_features] numpy arrays — the FeatureTable
    contents of the reference's example3 loop. ``chain`` > 1 advances
    that many frames per call (``sequence_chain_device``: one graph replay
    on the card); a tail shorter than ``chain`` runs step by step.
    """
    cfg = (cfg if cfg is not None else create_config()).replace(
        sequentialMode=True).validated_window()
    frames = list(frames)
    pyr, x, y, val, aff, exhausted = select_step_device(
        stage_raw(frames[0], device), cfg, n_features, top_k)
    dev = x.device
    chunks = [(x, y, val)]
    carry = None
    i = 1
    while i < len(frames):
        if chain > 1 and len(frames) - i >= chain:
            pyr, hist, (x, y, val), aff, ex, carry = sequence_chain_device(
                pyr, frames[i:i + chain], x, y, val, cfg, replace_lost,
                top_k, aff, carry)
            chunks.append(hist)
            i += chain
        else:
            pyr, x, y, val, aff, ex, carry = sequence_step_device(
                pyr, stage_raw(frames[i], dev), x, y, val, cfg,
                replace_lost, top_k, aff, carry)
            chunks.append((x, y, val))
            i += 1
        exhausted = exhausted | ex
    table = stack_history_chunks(chunks)
    if bool(exhausted):
        warn_selection_exhausted("track_sequence_device", top_k)
    return table
