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
graph (``_ChainGraph``), replayed once per k frames: each step's pyramid
build, K2, the affine stage, the refill and the writes into the history
rows, with no host work between them. A lane's carried state is one
``features.Lane`` (pyramids, x, y, val, AffineState). The graph holds the
lanes' pyramids in two buffers the steps alternate between, and the rest
of their state as one list of ``[B, ...]`` buffers (``Lane.state``); a
call whose state is not the one the graph handed out last is copied in
first, and every tensor a call returns is a copy, so a later replay never
changes what a caller holds. The window carry (``TrackCarry``) stays at
the public edge: the port reuses no window, so ``sequence_step_device``
and ``sequence_chain_device`` return the carry they were given with
``ok`` cleared, the steps and the graph never see it, and a lane they
hand out carries None. The frames
reach the graph's frame buffer before the replay, in the staged dtype
(``utils/staging``: uint8 stays uint8 and is cast on the card, inside the
graph): a ``utils/staging.HostBlock`` of the chain's host frames in one
copy (the streaming trackers write theirs at feed; other host frames are
written into the graph's own, from a ``BlockRing`` of one), frames
already on the card one copy each.
``chain_lanes`` runs B independent lanes (streams, chunks) in one graph,
their steps in lane order within each frame.

Tracing (``utils/profiling``): the eager step's phases run in ``step.*``
spans, the chain's staging, replay and capture in ``chain.*`` spans; the
chain counts its captures, replays, block stages (replays whose frames
crossed as one ``HostBlock``), state loads and evictions, and every wait
of the host on the card counts under ``host_syncs``. A replay adds what
its capture recorded to the kernel modules' launch counters, and its K2
and K4 launches add to the device counters as eager ones do.

The pyramids are stored in ``cfg.image_dtype`` (float32 or bfloat16), the
captured chain's two pyramid buffers too; with bfloat16 storage the refill
map is K3's map of the stored level-0 gradients, upcast.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable, Optional

import numpy as np
import torch

from ..config import TrackerConfig, create_config
from ..errors import KLTWarning
from ..features import KLT_NOT_FOUND, FeatureState, Lane, reset_affine
from ..ops.affine import affine_consistency_check, make_affine_state
from ..ops.cuda_pyramid import (level_shapes, pyramid_numel, pyramid_views,
                                storage_dtype)
from ..ops.select import selection_eig_map
from ..ops.select_device import (DEFAULT_TOP_K,
                                 select_features_from_eig_device)
from ..ops.track import (TrackPyramids, as_frame, build_track_pyramids,
                         track_features_pyramids)
from ..utils import cuda
from ..utils.profiling import (count, device_counters, host_sync,
                               launch_counters, named_scope)
from ..utils.staging import (BlockRing, HostBlock, host_frame, stage_raw,
                             staged_dtype)


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


def _step(lane: Lane, img_new, cfg, replace_lost, pyr_out=None):
    """One frame step of ``lane`` on a float32 frame on its device (the
    body shared by ``sequence_step_device`` and the captured chain):
    (lane, exhausted)."""
    pyr_prev, x, y, val, aff = lane.pyr, lane.x, lane.y, lane.val, lane.aff
    with named_scope("step.pyramid"):
        pyr_new, eig = _build_with_map(img_new, cfg, replace_lost,
                                       out=pyr_out)
    with named_scope("step.track"):
        nx, ny, nval = track_features_pyramids(pyr_prev, pyr_new, x, y, val,
                                               cfg)
    if cfg.affineConsistencyCheck >= 0:
        with named_scope("step.affine"):
            after = affine_consistency_check(
                pyr_prev, pyr_new, FeatureState(x, y, val, aff),
                FeatureState(nx, ny, nval, aff), cfg)
        nx, ny, nval, aff = after.x, after.y, after.val, after.aff
    with named_scope("step.refill"):
        exhausted = torch.zeros((), dtype=torch.bool, device=x.device)
        if replace_lost:
            # always launched; budget 0 (nothing lost) leaves every slot as is
            lost = nval < 0
            nx, ny, nval, _, exhausted = select_features_from_eig_device(
                eig, nx, ny, nval, cfg, replacing=True)
            if aff is not None:
                # refilled slots are fresh features: their templates
                # recapture
                aff = reset_affine(aff, lost)
    return Lane(pyr_new, nx, ny, nval, aff), exhausted


def _carry_out(carry):
    """A window carry as the port hands it back: ``ok`` cleared (no window
    reuse yet, identical results), None for None."""
    return None if carry is None else carry._replace(
        ok=torch.zeros_like(carry.ok))


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
    lane, exhausted = _step(Lane(pyr_prev, x, y, val, aff),
                            as_frame(img_new, x.device), cfg, replace_lost)
    return (*lane[:5], exhausted, _carry_out(carry))


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
            lanes[b], e = _step(lanes[b], as_frame(img, lanes[b].x.device),
                                cfg, replace_lost)
            rows[b].append(lanes[b][1:4])
            ex[b] = e if ex[b] is None else ex[b] | e
    hist = tuple(torch.stack([torch.stack([r[j] for r in lane_rows])
                              for lane_rows in rows]) for j in range(3))
    return lanes, hist, torch.stack(ex)


class _ChainGraph:
    """k frame steps of B lanes, captured in one CUDA graph on one device.

    The graph's own buffers hold the frames ([k, B, H, W] in the staged
    dtype) and the lanes' carried state: each lane's pyramid in two buffers
    that the steps alternate between (buffer 0 holds the state between
    replays), the rest as ``state``, one ``[B, ...]`` buffer for each
    tensor of ``Lane.state``. Host frames that come without a block of
    their own are written into the graph's block (a ``BlockRing`` of
    one)."""

    def __init__(self, cfg, lanes, k: int, frame_dtype, replace_lost: bool):
        dev = lanes[0].x.device
        b = len(lanes)
        h, w = lanes[0].pyr.img[0].shape
        self.cfg, self.k, self.b, self.replace_lost = cfg, k, b, replace_lost
        self.shapes = level_shapes(h, w, cfg.subsampling, cfg.nPyramidLevels)
        # zeroed frames and dead lanes: the warm-up step runs on them
        self.frames = torch.zeros((k, b, h, w), dtype=frame_dtype,
                                  device=dev)
        self.ring = BlockRing(1, dev)
        self.pyr_buf = torch.zeros((2, b, pyramid_numel(self.shapes)),
                                   dtype=storage_dtype(cfg), device=dev)
        self.state = [torch.zeros((b, *t.shape), dtype=t.dtype, device=dev)
                      for t in lanes[0].state()]
        dead = Lane.from_state(None, self.state)
        dead.x.fill_(-1.0)
        dead.y.fill_(-1.0)
        dead.val.fill_(KLT_NOT_FOUND)
        n = lanes[0].x.shape[0]
        self.hist = (torch.zeros((b, k, n), dtype=torch.float32, device=dev),
                     torch.zeros((b, k, n), dtype=torch.float32, device=dev),
                     torch.zeros((b, k, n), dtype=torch.int32, device=dev))
        self.exhausted = torch.zeros((b,), dtype=torch.bool, device=dev)
        self._held = None
        # the replays add into the device counters the capture saw
        device_counters(dev)
        self._capture(dev)

    def _lane(self, b: int, pyr=None, state=None) -> Lane:
        """Lane ``b`` as views of ``pyr`` (default pyramid buffer 0) and
        ``state`` (default the graph's)."""
        pyr = self.pyr_buf[0] if pyr is None else pyr
        return Lane.from_state(
            TrackPyramids(*pyramid_views(pyr[b], self.shapes)),
            [t[b] for t in (self.state if state is None else state)])

    def _body(self) -> None:
        lanes = [self._lane(b) for b in range(self.b)]
        ex = []
        for j in range(self.k):
            for b in range(self.b):
                lanes[b], e = _step(
                    lanes[b], self.frames[j, b].to(torch.float32), self.cfg,
                    self.replace_lost, pyr_out=self.pyr_buf[(j + 1) % 2, b])
                for hist, t in zip(self.hist, lanes[b][1:4]):
                    hist[b, j].copy_(t)
                ex.append(e)
        # one reduction per chain: a lane is exhausted if any step was
        self.exhausted.copy_(torch.stack(ex).view(self.k, self.b).any(0))
        for b, lane in enumerate(lanes):
            for dst, src in zip(self.state, lane.state()):
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
            _step(self._lane(0), self.frames[0, 0].to(torch.float32),
                  self.cfg, self.replace_lost)
        torch.cuda.current_stream(dev).wait_stream(stream)
        # the kernel modules' launch counters: a replay adds what its capture
        # recorded (the capture itself launches nothing)
        self.counters = launch_counters()
        before = [getattr(m, a) for m, a in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a prefetch thread may stage frames meanwhile
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._body()
        self.deltas = [getattr(m, a) - c
                       for (m, a), c in zip(self.counters, before)]
        for (mod, attr), v in zip(self.counters, before):
            setattr(mod, attr, v)

    def _holds(self, lanes) -> bool:
        """True when ``lanes`` are the state the last replay handed out,
        unchanged since: the graph's buffers already hold it."""
        if self._held is None:
            return False
        flat = [t for lane in lanes for t in lane.tensors()]
        return len(flat) == len(self._held) and all(
            t is h and t._version == v for t, (h, v) in zip(flat, self._held))

    def _load(self, lanes) -> None:
        for b, lane in enumerate(lanes):
            for dst, src in zip(self._lane(b).tensors(), lane.tensors()):
                dst.copy_(src)

    def _stage(self, frames) -> None:
        if not isinstance(frames, HostBlock) and isinstance(frames[0][0],
                                                            np.ndarray):
            # host frames without a block: into the graph's own
            block = self.ring.next(tuple(self.frames.shape),
                                   self.frames.dtype)
            for j, tick in enumerate(frames):
                for b, f in enumerate(tick):
                    block.array[j, b] = f
            frames = block
        if isinstance(frames, HostBlock):
            count("chain.block_stages")
            frames.copy_to(self.frames)
        else:
            for j, tick in enumerate(frames):
                for b, f in enumerate(tick):
                    self.frames[j, b].copy_(f)

    def run(self, lanes, frames):
        """Replay on the current stream: (lanes, hist, exhausted), every
        tensor a copy of the graph's buffers."""
        with named_scope("chain.stage"):
            self._stage(frames)
        with named_scope("chain.replay"):
            count("chain.replays")
            if not self._holds(lanes):
                count("chain.state_loads")
                self._load(lanes)
            self.graph.replay()
            for (mod, attr), d in zip(self.counters, self.deltas):
                setattr(mod, attr, getattr(mod, attr) + d)
            pyr = self.pyr_buf[0].clone()
            state = [t.clone() for t in self.state]
            out = [self._lane(b, pyr, state) for b in range(self.b)]
            self._held = [(t, t._version) for lane in out
                          for t in lane.tensors()]
            return (out, tuple(h.clone() for h in self.hist),
                    self.exhausted.clone())


# Captured chains by (cfg, lanes, H, W, N, k, replace_lost, affine state,
# frame dtype, device), least recently used first.
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
    """The chain's frames as the graph takes them, and their staged dtype:
    uint8 when every frame is uint8, else float32. Host frames stay as
    they are, to be converted as they are written into the graph's block;
    if any frame is already on the card, every frame is staged there."""
    if any(isinstance(f, torch.Tensor) and f.is_cuda
           for tick in frames for f in tick):
        frames = [[stage_raw(f, dev) for f in tick] for tick in frames]
    else:
        frames = [[host_frame(f) for f in tick] for tick in frames]
    uint8 = all(staged_dtype(f.dtype) == torch.uint8
                for tick in frames for f in tick)
    return frames, torch.uint8 if uint8 else torch.float32


def chain_lanes(lanes, frames, cfg, replace_lost: bool = True):
    """k frame steps for each of B independent lanes: ``lanes`` is a list
    of ``Lane``s on one device, ``frames`` k sequences of B frames (arrays
    or tensors) or a ``HostBlock`` of them. Returns (lanes, (hx, hy, hv)
    [B, k, N], exhausted [B] bool). On CUDA tensors, one replay of the
    captured chain for this shape (captured at its first call), which takes
    a block's frames in one copy; a replay records no gradients, so an
    input that requires grad raises ValueError there."""
    x0 = lanes[0].x
    block = frames if isinstance(frames, HostBlock) else None
    if block is not None:
        frames = block.tensor                   # [k, B, H, W], no grad
    if not cuda.use_kernel(x0):
        return _chain_plain(lanes, frames, cfg, replace_lost)
    given = () if block is not None else (
        f for tick in frames for f in tick if isinstance(f, torch.Tensor))
    if cuda.records_grad(*given,
                         *(t for lane in lanes for t in lane.tensors())):
        raise ValueError(
            "the chained step (sequence_chain_device, the streaming "
            "trackers) replays a captured CUDA graph, which records no "
            "gradients: detach its inputs, or differentiate the eager step "
            "(sequence_step_device)")
    h, w = lanes[0].pyr.img[0].shape
    takes = (f"chain_lanes: every frame step takes {len(lanes)} frames of "
             f"{h}x{w}")
    if block is not None:
        cuda.require(tuple(frames.shape[1:]) == (len(lanes), h, w), takes)
        dtype = frames.dtype
    else:
        frames, dtype = _staged_frames(frames, x0.device)
        for tick in frames:
            cuda.require(len(tick) == len(lanes) and all(
                tuple(f.shape) == (h, w) for f in tick), takes)
    key = (cfg, len(lanes), h, w, x0.shape[0], len(frames),
           bool(replace_lost), lanes[0].aff is not None, dtype, x0.device)
    with _graph_lock:
        graph = _GRAPHS.get(key)
        if graph is None:
            count("chain.captures")
            with named_scope("chain.capture"):
                graph = _ChainGraph(cfg, lanes, len(frames), dtype,
                                    replace_lost)
            _GRAPHS[key] = graph
            while len(_GRAPHS) > GRAPH_CACHE_SIZE:
                count("chain.evictions")
                _GRAPHS.popitem(last=False)
        else:
            _GRAPHS.move_to_end(key)
        return graph.run(lanes, frames if block is None else block)


def sequence_chain_device(pyr_prev: TrackPyramids, imgs, x: torch.Tensor,
                          y: torch.Tensor, val: torch.Tensor, cfg,
                          replace_lost: bool = True,
                          top_k: int = DEFAULT_TOP_K, aff=None, carry=None):
    """Micro-chained steps: advance len(imgs) frames in one call, the same
    math as repeated ``sequence_step_device`` calls; on the card one replay
    of a captured CUDA graph (the module notes).

    Returns (pyr, hist, final, aff, exhausted, carry): hist = per-frame
    (x, y, val) stacked [k, N]; final = the last (x, y, val); carry = the
    given one with ``ok`` cleared; exhausted = any step's refill ran out of
    candidates (never, in the port). Every returned tensor is the caller's
    own: a later call changes none of them."""
    del top_k
    lanes, hist, ex = chain_lanes([Lane(pyr_prev, x, y, val, aff)],
                                  [[img] for img in imgs], cfg, replace_lost)
    pyr, x, y, val, aff, _ = lanes[0]
    return (pyr, tuple(h[0] for h in hist), (x, y, val), aff, ex[0],
            _carry_out(carry))


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
    i = 1
    while i < len(frames):
        if chain > 1 and len(frames) - i >= chain:
            pyr, hist, (x, y, val), aff, ex, _ = sequence_chain_device(
                pyr, frames[i:i + chain], x, y, val, cfg, replace_lost,
                top_k, aff)
            chunks.append(hist)
            i += chain
        else:
            pyr, x, y, val, aff, ex, _ = sequence_step_device(
                pyr, stage_raw(frames[i], dev), x, y, val, cfg,
                replace_lost, top_k, aff)
            chunks.append((x, y, val))
            i += 1
        exhausted = exhausted | ex
    host_sync("sync.sequence_table", 3)
    table = stack_history_chunks(chunks)
    host_sync("sync.sequence_exhausted")
    if bool(exhausted):
        warn_selection_exhausted("track_sequence_device", top_k)
    return table
