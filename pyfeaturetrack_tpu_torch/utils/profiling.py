"""Tracing, counting and timing helpers (PyTorch port of
``pyfeaturetrack_tpu/utils/profiling.py``).

Spans. ``named_scope`` labels a region in profiler traces: under an active
``torch.profiler`` it is a ``record_function`` range, on the host timeline
to which the profiler aligns the card's kernels and copies; with no
profiler it is one shared no-op context, so the program's spans cost a
flag read when nobody traces. ``SPANS`` lists every span the program
opens. The spans of one fed frame or tick nest inside that call's
``serving.feed``; names carry no ids.

Counters, always on, plain integer adds:

* host counters (``count``): ``serving.ticks`` (``feed`` calls),
  ``chain.captures``, ``chain.replays``, ``chain.block_stages`` (replays
  whose frames crossed as one host block), ``chain.state_loads`` (replays
  whose state was copied in first), ``chain.evictions`` (captured chains
  dropped from the cache), ``vo.keyframes`` and ``vo.ba_observations``
  (observations of non-zero weight handed to the visual odometry's window
  BA), and ``host_syncs``, every wait of the host on the card, each also
  under its site's ``sync.<site>`` (``host_sync``);
* the kernel modules' launch counters, which each module registers when
  it is imported (``launch_counter``), as ``<module>.<name>``;
* device counters (``DEVICE_COUNTERS``), added by K2, K4 and K6 on the
  card into one int64 buffer per device (``device_counters``); K6's plain
  stage adds the same counts into its device's buffer (the CPU's too).

``counters()`` returns all three (one device-to-host copy per device; no
hot path calls it) and ``reset_counters()`` zeroes them. The counters are
process totals. ``host_sync`` takes a lock, since ``prefetch_to_device``'s
worker counts its waits while the feeding thread counts its own; ``count``
and the launch ints, on the hot path, take none, so two threads adding to
one of their names at once may lose an add.

``trace`` collects a ``torch.profiler`` trace of a region (host ops and,
with a card, its kernels) into a Chrome trace file. ``time_jitted`` times
calls with CUDA events on the card (a host clock on the CPU, where there is
no device time); ``device_time_per_call`` reads the device busy time of a
trace per call (``utils/traceview``), and raises where no kernel ran on a
card.
"""

from __future__ import annotations

import collections
import contextlib
import tempfile
import sys
import threading
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# Every span of the program: name -> (layer, what it covers, the metric or
# use that reads it). The benchmark's own ranges are ``feed``, ``drain``,
# ``tick`` and ``slice``; no span takes one of those names.
SPANS = {
    "serving.feed": (
        "serving", "_StreamingBase.feed: one fed frame (B frames a tick)",
        "parent of every span below; the traced breakdown"),
    "serving.stage": (
        "serving", "_StreamingBase._stage: a chained host frame written into "
        "its chain's host block (at a chain's first frame, the block "
        "utils/staging.BlockRing hands out after its wait), else the fed "
        "frames through utils/staging.stage_raw",
        "serving.stage_us_per_frame, serving.stage_ms_per_tick"),
    "serving.step": (
        "serving", "one stream's eager sequence_step_device in _advance",
        "serving.step_ms_per_tick"),
    "serving.history": (
        "serving", "a tick's or chain's history rows and exhausted flag",
        "the breakdown"),
    "serving.pull": (
        "serving", "_migrate_history: the exhausted read, the cat, the copies",
        "the breakdown; serving.host_syncs_per_tick counts its syncs"),
    "step.pyramid": (
        "device step", "_step: K1's pyramid build with K3's map",
        "the breakdown"),
    "step.track": (
        "device step", "_step: the K2 track call", "the breakdown"),
    "step.affine": (
        "device step", "_step: the affine-consistency stage (when configured)",
        "the breakdown"),
    "step.refill": (
        "device step", "_step: K4's refill and the templates' reset",
        "the breakdown"),
    "chain.stage": (
        "captured chain", "_ChainGraph._stage: the chain's frames copied "
        "into the graph's frame buffer: a host block in one copy (host "
        "frames that come without one first written into the graph's own, "
        "from its BlockRing of one), frames on the card one by one",
        "chain.stage_us_per_frame"),
    "chain.replay": (
        "captured chain", "_ChainGraph.run: the state check or load, the "
        "replay, the output clones", "chain.replay_us_per_frame"),
    "chain.capture": (
        "captured chain", "_ChainGraph.__init__: buffers, warm-up, capture",
        "operators: a graph captured again"),
    "vo.track": (
        "visual odometry", "VisualOdometry.feed's tracking of one frame: "
        "the device route's staging, chained call and one pull (the host "
        "route's step, refill and pulls)", "vo.track_us_per_frame"),
    "vo.keyframe": (
        "visual odometry", "VisualOdometry._push_keyframe: one keyframe's "
        "bookkeeping and geometry (bootstrap, or localize, triangulate, BA)",
        "vo.keyframe_ms"),
    "vo.localize": (
        "visual odometry", "_localize_new_keyframe: the visible landmarks, "
        "refine_pose (or PnP-RANSAC after a held pose) and its pull",
        "the breakdown"),
    "vo.triangulate": (
        "visual odometry", "_triangulate_new: the candidates, the batched "
        "DLT, its pull and the cheirality filter", "the breakdown"),
    "vo.ba": (
        "visual odometry", "_window_ba: the problem's assembly, "
        "bundle_adjust, its pull and the scale re-anchor",
        "vo.ba_ms_per_keyframe"),
}

_profiler_on = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def named_scope(name: str):
    """A context manager that names the enclosed work in profiler traces: a
    ``record_function`` range while a profiler runs, else the one shared
    no-op context."""
    return record_function(name) if _profiler_on() else _NO_SPAN


# Host counters by name (module docstring).
_host: collections.defaultdict = collections.defaultdict(int)
_host_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    _host[name] += n


def host_sync(site: str, n: int = 1) -> None:
    """Count ``n`` waits of the host on the card at ``site``
    (``sync.<where>``), under ``host_syncs`` and under the site."""
    with _host_lock:
        _host["host_syncs"] += n
        _host[site] += n


# The kernel modules' launch counters, (module name, attribute), in the
# order the modules registered them.
_launch: list = []


def launch_counter(module: str, *attrs: str) -> None:
    """Register the integer attributes ``attrs`` of the module ``module``
    (its ``__name__``, at import) as launch counters."""
    _launch.extend((module, a) for a in attrs if (module, a) not in _launch)


def launch_counters() -> list:
    """(module, attribute) of every registered launch counter."""
    return [(sys.modules[m], a) for m, a in _launch]


# The kernels' device counters, in the rows of csrc/common.cuh PftCounter:
# K2's Gauss-Newton steps and the (lane, level) pairs it entered; K4's
# acceptances and segment rescans on refills; the lanes K6's affine stage
# checked against their templates, their Gauss-Newton updates and the lanes
# it rejected.
DEVICE_COUNTERS = ("k2.gn_steps", "k2.lane_levels", "k4.refill_acceptances",
                   "k4.refill_rescans", "k6.checked_lanes", "k6.gn_steps",
                   "k6.rejections")
DEVICE_SLOTS = 64           # csrc/common.cuh PFT_COUNTER_SLOTS
_device: dict = {}
_device_lock = threading.Lock()


def device_counters(dev: torch.device):
    """The device counter buffer of device ``dev`` (int64 [counters, slots]),
    made at its first use. A captured CUDA graph adds into the buffer that
    existed when it was captured, so the buffer is made before any capture
    and only ever zeroed in place; while a capture runs on a card that has
    none yet, None (nothing counted)."""
    key = dev.index if dev.type == "cuda" else dev.type
    buf = _device.get(key)
    if buf is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return None
        with _device_lock:
            buf = _device.get(key)
            if buf is None:
                buf = _device[key] = torch.zeros(
                    (len(DEVICE_COUNTERS), DEVICE_SLOTS), dtype=torch.int64,
                    device=dev)
    return buf


def add_device_counts(buf: torch.Tensor, counts: dict) -> None:
    """Add each 0-dim tensor of ``counts`` ({device counter: n}) into slot
    0 of its row of ``buf`` (``device_counters``), on the buffer's device
    and with no host sync: a plain version counting what its kernel
    counts."""
    for name, n in counts.items():
        buf[DEVICE_COUNTERS.index(name), 0] += n


def counters() -> dict:
    """Every counter by name: the host counters, the launch counters and the
    device counters summed over devices (one device-to-host copy per card:
    a wait on the card, not counted)."""
    with _host_lock:
        out = dict(_host)
    for m, a in _launch:
        out[f"{m.rsplit('.', 1)[-1]}.{a}"] = getattr(sys.modules[m], a)
    totals = [0] * len(DEVICE_COUNTERS)
    for buf in list(_device.values()):
        totals = [t + v for t, v in zip(totals, buf.sum(1).tolist())]
    out.update(zip(DEVICE_COUNTERS, totals))
    return out


def reset_counters() -> None:
    """Zero every counter (the device buffers in place)."""
    with _host_lock:
        _host.clear()
    for mod, attr in launch_counters():
        setattr(mod, attr, 0)
    for buf in list(_device.values()):
        buf.zero_()


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Collect a torch.profiler trace of the block into
    ``log_dir/trace.json`` (Chrome trace format; CUDA kernels included
    when there is a card)."""
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def _outputs_on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_outputs_on_card(o) for o in out)
    return False


def time_jitted(fn, *args, iters: int = 50, warmup: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` after ``warmup`` calls: CUDA events
    around ``iters`` back-to-back calls when the outputs lie on the card
    (the host's launch time included where it exceeds the kernels'), a
    host clock ending in a synchronize otherwise."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if not _outputs_on_card(out):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def device_time_per_call(fn, *args, iters: int = 8) -> float:
    """Seconds of device time per call of ``fn(*args)``: the busy time of
    the device lane of a torch.profiler trace of ``iters`` calls
    (``utils/traceview.parse_device_trace``: kernels, copies and fills,
    their per-stream interval union) over ``iters``. Raises RuntimeError
    without a card or when the trace holds no device event: there is no
    device time to report."""
    from .traceview import capture_device_trace
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_per_call: no CUDA device; a host "
                           "time is not a device time")
    fn(*args)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        rep = capture_device_trace(lambda: fn(*args), n_calls=iters,
                                   trace_dir=tmp, settle_s=0.0)
    if not rep["op_events"]:
        raise RuntimeError("device_time_per_call: the trace holds no CUDA "
                           "kernel of the call")
    return rep["device_busy_ms"] / iters / 1e3
