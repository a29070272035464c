"""Live-video serving: overlapped host-to-device staging for the
device-resident sequence loop.

Reference parity: the reference (SURVEY.md section 3.5, example3.py)
reads each frame from disk synchronously before tracking it. Port of
``pyfeaturetrack_tpu/serving.py``:

- :class:`StreamingTracker` — an incremental (push-style) wrapper over
  ``models.device_sequence``: feed frames as they arrive, results stay on
  the card; pull the stacked track table at the end (or every
  ``emit_every`` frames when the deployment needs live positions).
- :class:`BatchedStreamingTracker` — B camera streams in lockstep.
- :func:`prefetch_to_device` — a bounded background-thread iterator that
  stages upcoming frames on the card ahead of their consumption.
- :func:`serve_stream` — a whole stream through a ``StreamingTracker``.

On the card. ``chain`` > 1 buffers that many frames and advances them with
one replay of the captured k-frame graph (``device_sequence.chain_lanes``:
for B streams, one graph holding the B streams' steps in stream order);
``chain`` 1, and a partial chain that :meth:`flush` (``emit_every``, a
drain) forces out, run the eager step. Staging (uint8 stays uint8 and is
cast on the card, any other dtype becomes float32):

- a chained stream's host frames, after the stream's first, are written
  at ``feed`` into slot j of the chain's pinned block
  (``utils/staging.HostBlock``, ``[chain, B, H, W]``), which the tracker's
  ``utils/staging.BlockRing`` of two hands out at a chain's first frame,
  once that block's last copy has run. A full chain's block crosses in one
  copy into the captured graph's frame buffer; a partial chain's filled
  slots cross in one copy too;
- every other frame is staged at once, one copy each
  (``utils/staging.stage_raw``: pinned host memory, a ``non_blocking``
  copy on the current stream): the first frame, ``chain`` 1, tensors
  already on the card, and a host frame whose shape or staged dtype
  differs from its chain's first.

``prefetch`` moves the staging to a worker thread, which copies each frame
on a side stream from a ``BlockRing`` of one-frame blocks; the consuming
stream waits on the frame's copy event, and the frames, on the card, are
staged one by one.

Tracing (``utils/profiling``): each fed item runs inside a ``serving.feed``
span, its staging (the block write or ``stage_raw``), eager steps, history
and pulls in spans of their own, and adds to the ``serving.ticks``
counter; each wait of the host on the card counts under ``host_syncs``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from .config import TrackerConfig, create_config
from .errors import KLTError
from .features import Lane
from .models.device_sequence import (chain_lanes, select_step_device,
                                     sequence_step_device,
                                     warn_selection_exhausted)
from .ops.select_device import DEFAULT_TOP_K
from .utils.profiling import count, host_sync, named_scope
from .utils.staging import (BlockRing, host_frame, stage_raw, staged_dtype,
                            target_device)

_STOP = object()


def prefetch_to_device(frames: Iterable, depth: int = 2, device="cuda",
                       stage_dtype=np.float32) -> Iterator[torch.Tensor]:
    """Iterate ``frames`` as tensors on ``device``, with up to ``depth``
    frames staged ahead of consumption.

    A daemon thread pulls the source's frames and stages them in
    ``stage_dtype`` (``np.uint8`` ships a quarter of float32's bytes; the
    tracker casts on the card). On the card it writes each host frame into
    the next of a ``utils/staging.BlockRing`` of ``depth`` one-frame
    blocks, which waits for that block's last copy, and copies it out on a
    side stream, recording an event right after it; the consumer's current
    stream waits on that frame's event (not the block's, which a later copy
    records again), and the frame is marked as used there
    (``record_stream``) so the caching allocator does not hand its memory
    out while the consumer still reads it. On the CPU each frame is one
    copy of its own, with no block. Exceptions in the source are re-raised
    at the consuming ``next()``."""
    if depth < 1:
        raise KLTError(f"(prefetch_to_device) depth must be >= 1, got {depth}")
    dev = target_device(device)
    dtype = staged_dtype(stage_dtype)
    q: queue.Queue = queue.Queue(maxsize=depth)
    cancelled = threading.Event()

    def stage_all():
        ring = BlockRing(depth, dev)
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            for f in frames:
                if cancelled.is_set():
                    return
                if isinstance(f, torch.Tensor) and f.device == dev:
                    out = f.to(dtype)
                elif side is None:
                    # the CPU: the frame's own copy, nothing to wait for
                    out = torch.tensor(host_frame(f), dtype=dtype)
                else:
                    arr = host_frame(f)
                    block = ring.next(arr.shape, dtype)
                    block.array[...] = arr
                    out = block.copy_to(torch.empty(arr.shape, dtype=dtype,
                                                    device=dev))
                done = None
                if side is not None:
                    done = torch.cuda.Event()
                    done.record(side)
                q.put((out, done))

    def worker():
        try:
            stage_all()
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            q.put(e)
            return
        q.put(_STOP)

    t = threading.Thread(target=worker, daemon=True, name="pft-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, BaseException):
                raise item
            out, done = item
            if done is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(done)
                out.record_stream(stream)
            yield out
    finally:
        # consumer abandoned the stream (break / exception / GC): unblock
        # a producer stuck on the full queue so it can exit and release
        # the staged frames + source iterator
        cancelled.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


class _StreamingBase:
    """Shared push-feed machinery for the streaming trackers: B lanes
    (streams) of device state, chain buffering, device-history
    bookkeeping with host migration on pull, exhaustion surfacing, and the
    flush/block/table/drain lifecycle. Subclasses define the wire format
    (``_coerce``: one fed item to B staged frames; ``_host_batch``: one
    fed host item as a [B, H, W] array) and the host row layout
    (``_host_rows``/``_empty_rows``)."""

    _name = "StreamingTracker"

    def __init__(self, cfg, n_features, replace_lost, top_k, chain, device):
        if chain < 1:
            raise KLTError(f"({self._name}) chain must be >= 1, got {chain}")
        self.cfg = (cfg if cfg is not None else create_config()).replace(
            sequentialMode=True).validated_window()
        self.n_features = int(n_features)
        self.replace_lost = bool(replace_lost)
        self.top_k = int(top_k)
        self.chain = int(chain)
        self.device = torch.device(device)
        self._ring = BlockRing(2, self.device)  # chain blocks, in turn
        self.resume(None, 0, False)

    def resume(self, lanes, n_frames: int, exhausted: bool) -> None:
        """Start over from ``lanes`` (a ``Lane`` per stream; None before
        the first frame) after ``n_frames`` frames, with the selection's
        exhaustion flag: the buffered chain (its frames and its block) and
        the history, on the card or already pulled, are dropped."""
        self._lanes = lanes
        self.n_frames = n_frames
        self._pending: list = []    # items awaiting a chain: B staged
                                    # frames, or a slot of self._block
        self._block = None          # the buffered chain's block
        self._chunks: list = []     # device history chunks, [B, k, N] each
        self._host_chunks: list = []  # history already pulled to host
        self._exhausted = (torch.ones((), dtype=torch.bool,
                                      device=lanes[0].x.device)
                           if exhausted else None)

    def _note_exhausted(self, ex) -> None:
        ex = ex.any()
        self._exhausted = (ex if self._exhausted is None
                           else self._exhausted | ex)

    def feed(self, item) -> Optional[tuple]:
        """Process one input (tensor on the card or host array)."""
        with named_scope("serving.feed"):
            with named_scope("serving.stage"):
                frames = self._stage(item)
            count("serving.ticks")
            if self._lanes is None:
                self._start(frames)
            else:
                self._pending.append(frames)
                if len(self._pending) >= self.chain:
                    self._advance(self._pending)
                    self._pending = []
            self.n_frames += 1
        return None

    def _stage(self, item):
        """``item`` as the chain buffer holds it: the slot of the chain's
        host block it was written into, or B frames staged one by one
        (module notes)."""
        if (self._lanes is None or self.chain == 1
                or isinstance(item, torch.Tensor)
                and (item.is_cuda or self.device.type == "cpu")):
            return self._coerce(item)
        batch = self._host_batch(item)
        shape = (self.chain, *batch.shape)
        dtype = staged_dtype(batch.dtype)
        if self._block is None:
            self._block = self._ring.next(shape, dtype)
        elif not self._block.holds(shape, dtype):
            return self._coerce(item)
        j = len(self._pending)
        self._block.array[j] = batch
        return j

    def _unblock(self, ticks: list, block) -> list:
        """``ticks`` with every block slot replaced by its B frames on the
        device: the filled slots cross in one copy."""
        if block is None:
            return ticks
        n = 1 + max(j for j in ticks if isinstance(j, int))
        staged = block.copy_to(torch.empty((n, *block.shape[1:]),
                                           dtype=block.dtype,
                                           device=block.device))
        return [list(staged[j]) if isinstance(j, int) else j for j in ticks]

    def _start(self, frames) -> None:
        self._lanes = []
        exhausted = []
        for f in frames:
            *lane, ex = select_step_device(f, self.cfg, self.n_features,
                                           self.top_k)
            self._lanes.append(Lane(*lane))
            exhausted.append(ex)
        self._chunks.append(tuple(
            torch.stack([lane[j] for lane in self._lanes])[:, None]
            for j in (1, 2, 3)))
        self._note_exhausted(torch.stack(exhausted))

    def _advance(self, ticks: list) -> None:
        # a full chain replays the captured k-frame graph, its frames one
        # block where every one is a slot of it; partial chains (flush/emit
        # tails) and chain 1 run the eager step
        block, self._block = self._block, None
        if len(ticks) == self.chain and self.chain > 1:
            frames = (block if all(isinstance(j, int) for j in ticks)
                      else self._unblock(ticks, block))
            lanes, hist, ex = chain_lanes(self._lanes, frames, self.cfg,
                                          self.replace_lost)
            # Lanes again where a chain hands back plain (pyr, x, y, val,
            # aff, carry) tuples, as the benchmark's planted faults do
            self._lanes = [Lane(*lane) for lane in lanes]
            with named_scope("serving.history"):
                self._chunks.append(hist)
                self._note_exhausted(ex)
            return
        for tick in self._unblock(ticks, block):
            exhausted = []
            for b, f in enumerate(tick):
                pyr, x, y, val, aff, _ = self._lanes[b]
                with named_scope("serving.step"):
                    *lane, ex, _ = sequence_step_device(
                        pyr, f, x, y, val, self.cfg, self.replace_lost,
                        self.top_k, aff)
                self._lanes[b] = Lane(*lane)
                exhausted.append(ex)
            with named_scope("serving.history"):
                self._chunks.append(tuple(
                    torch.stack([lane[j] for lane in self._lanes])[:, None]
                    for j in (1, 2, 3)))
                self._note_exhausted(torch.stack(exhausted))

    def affine_state(self, stream: int = 0):
        """Stream ``stream``'s AffineState (templates, anchors, warps,
        valid flags) as the last chain or step handed it out: None with the
        affine-consistency check off, or before the first frame. Read-only,
        with no copy and no host sync: a replay hands out copies of the
        graph's buffers and an eager step makes new tensors, so a later
        ``feed`` never changes what this returned (writing into it would
        make the next chain load the written state)."""
        if self._lanes is None:
            return None
        return self._lanes[stream].aff

    def flush(self) -> None:
        """Force out any buffered partial chain (ends a latency window);
        its frames run step by step."""
        if self._pending:
            self._advance(self._pending)
            self._pending = []

    def block(self) -> None:
        """Wait for all dispatched work (throughput-benchmark fence)."""
        self.flush()
        if self._lanes is not None and self.device.type == "cuda":
            host_sync("sync.block")
            torch.cuda.current_stream(self._lanes[0].x.device).synchronize()

    def _migrate_history(self) -> None:
        """Pull the device history chunks to the host (one copy per
        column), so device memory stays bounded by the pull cadence and
        each table() only transfers rows produced since the previous
        pull. Each read and copy waits for the card (``host_syncs``)."""
        with named_scope("serving.pull"):
            if self._exhausted is not None:
                host_sync("sync.pull_exhausted")
                if bool(self._exhausted):
                    warn_selection_exhausted(self._name, self.top_k)
                    self._exhausted = None          # warn once per pull
            if self._chunks:
                host_sync("sync.pull_copy", 3)
                cols = tuple(torch.cat([c[j] for c in self._chunks], dim=1)
                             .cpu().numpy() for j in range(3))
                self._host_chunks.append(self._host_rows(cols))
            self._chunks = []

    def table(self) -> tuple:
        """(x, y, val) numpy arrays, frames stacked on axis 0. History
        rows migrate to host on each call, so device memory is bounded by
        the pull cadence; the host copy still grows with the stream —
        long-lived servers should use :meth:`drain`."""
        self.flush()
        self._migrate_history()
        if not self._host_chunks:
            raise KLTError(f"({self._name}.table) no frames fed yet")
        cols = [[c[j] for c in self._host_chunks] for j in range(3)]
        return tuple(np.concatenate(col, axis=0) for col in cols)

    def drain(self) -> tuple:
        """Like :meth:`table`, but returns ONLY the rows accumulated
        since the previous drain/construction and releases them —
        bounded memory for unbounded (24/7) streams. An empty interval
        returns zero-row arrays."""
        self.flush()
        self._migrate_history()
        if not self._host_chunks:
            return self._empty_rows()
        cols = [[c[j] for c in self._host_chunks] for j in range(3)]
        self._host_chunks = []
        return tuple(np.concatenate(col, axis=0) for col in cols)


class StreamingTracker(_StreamingBase):
    """Push-style live tracking: ``feed`` frames as they arrive, state
    stays on the card between calls.

    The first fed frame runs feature selection; every later frame runs
    the full track -> affine-check -> replace-lost step
    (``models.device_sequence``). Frames are buffered until ``chain``
    are available, then advanced by one replay of the captured k-frame
    graph; call :meth:`flush` to force out a partial chain (e.g. at end
    of stream or when latency matters more than throughput).

    :meth:`table`/:meth:`drain` return [n_frames, n_features] numpy
    arrays (the FeatureTable layout of track_sequence_device).
    ``emit_every`` > 0 auto-pulls and returns the table every
    that-many frames from :meth:`feed` — use only where the deployment
    needs live positions: each pull waits for the card.
    """

    _name = "StreamingTracker"

    def __init__(self, cfg: Optional[TrackerConfig] = None,
                 n_features: int = 150, replace_lost: bool = True,
                 top_k: int = DEFAULT_TOP_K, chain: int = 1,
                 emit_every: int = 0, *, device="cuda"):
        super().__init__(cfg, n_features, replace_lost, top_k, chain, device)
        self.emit_every = int(emit_every)

    def _coerce(self, frame) -> list:
        return [stage_raw(frame, self.device)]

    def _host_batch(self, frame) -> np.ndarray:
        return host_frame(frame)[None]

    def _host_rows(self, cols) -> tuple:
        return tuple(c[0] for c in cols)        # [1, k, N] -> [k, N]

    def _empty_rows(self) -> tuple:
        n = self.n_features
        return (np.empty((0, n), np.float32),
                np.empty((0, n), np.float32),
                np.empty((0, n), np.int32))

    def feed(self, frame) -> Optional[tuple]:
        """Process one frame. Returns the stacked numpy table so far
        iff ``emit_every`` fired, else None."""
        super().feed(frame)
        if self.emit_every > 0 and self.n_frames % self.emit_every == 0:
            self.flush()
            return self.table()
        return None


class BatchedStreamingTracker(_StreamingBase):
    """Lockstep serving for B independent camera streams: every
    :meth:`feed` takes a [B, H, W] frame batch (one new frame per stream).
    With ``chain`` > 1, each chain of ticks is one replay of a captured
    graph that holds the B streams' steps in stream order; the kernels
    themselves run one stream per launch.

    Per-stream math is IDENTICAL to :class:`StreamingTracker` (the same
    step); the history layout gains a stream axis: :meth:`table` /
    :meth:`drain` return [n_frames, B, n_features].
    """

    _name = "BatchedStreamingTracker"

    def __init__(self, cfg: Optional[TrackerConfig] = None,
                 n_streams: int = 8, n_features: int = 150,
                 replace_lost: bool = True, top_k: int = DEFAULT_TOP_K,
                 chain: int = 1, *, device="cuda"):
        super().__init__(cfg, n_features, replace_lost, top_k, chain, device)
        self.n_streams = int(n_streams)

    def _checked(self, batch):
        if batch.ndim != 3 or batch.shape[0] != self.n_streams:
            raise KLTError(
                f"({self._name}.feed) expected a "
                f"[{self.n_streams}, H, W] frame batch, got "
                f"{tuple(batch.shape)}")
        return batch

    def _coerce(self, batch) -> list:
        if not isinstance(batch, torch.Tensor):
            batch = np.asarray(batch)
        # one copy per batch
        return list(stage_raw(self._checked(batch), self.device))

    def _host_batch(self, batch) -> np.ndarray:
        return self._checked(host_frame(batch))

    def _host_rows(self, cols) -> tuple:
        # [B, k, N] -> [k, B, N] host rows
        return tuple(np.moveaxis(c, 0, 1) for c in cols)

    def _empty_rows(self) -> tuple:
        b, n = self.n_streams, self.n_features
        return (np.empty((0, b, n), np.float32),
                np.empty((0, b, n), np.float32),
                np.empty((0, b, n), np.int32))


def serve_stream(frames: Iterable, cfg: Optional[TrackerConfig] = None,
                 n_features: int = 150, replace_lost: bool = True,
                 top_k: int = DEFAULT_TOP_K, chain: int = 1,
                 prefetch: int = 0, stage_uint8: bool = False, *,
                 device="cuda") -> tuple:
    """Track a frame stream end to end with host-to-device staging
    overlapped with the card's work.

    The streaming analogue of ``track_sequence_device``: identical math
    and return layout ((x, y, val) stacked numpy), but frames may come
    from any iterable (camera, decoder, ...). ``prefetch`` > 0 stages the
    source's frames in a background thread (``prefetch_to_device``, that
    many frames ahead). ``stage_uint8=True`` ships frames 8-bit (exact
    for uint8 sources — the reference's PGM lineage — and a quarter of the
    bytes); else float32. Tensors already on the card pass through."""
    tr = StreamingTracker(cfg, n_features, replace_lost=replace_lost,
                          top_k=top_k, chain=chain, device=device)
    stage_dtype = np.uint8 if stage_uint8 else np.float32
    dev = target_device(device)
    it = (prefetch_to_device(frames, depth=prefetch, device=dev,
                             stage_dtype=stage_dtype) if prefetch > 0
          else (f if isinstance(f, torch.Tensor) and f.device == dev
                else host_frame(f, stage_dtype) for f in frames))
    for frame in it:
        tr.feed(frame)
    return tr.table()
