"""Checkpoint / resume (PyTorch port of
``pyfeaturetrack_tpu/utils/checkpoint.py``).

The reference's persistence layer is its feature list / table file
formats (``utils/io.py``). For the framework state (tracker sequence
state, streaming state, visual odometry), checkpoints are ``torch.save``
files of plain trees, read back with ``torch.load(weights_only=True)``:
the JAX package writes Orbax pytree checkpoints instead.

What a file holds: dicts, lists and tuples of tensors and Python scalars.
``save_checkpoint`` turns NamedTuples into dicts of their fields (as an
Orbax restore gives them back) and numpy arrays into CPU tensors, because
a ``weights_only`` load refuses numpy arrays; no safe globals are
registered. ``restore_checkpoint`` maps tensors to ``map_location``
(default the CPU) and, given a ``template``, rebuilds its NamedTuples and
array types.

The ``resume_*`` functions take the port's own ``*_state`` dicts, the
dicts a restore returns, and the state dicts of the JAX package's
``*_state`` functions (JAX arrays, numpy arrays, NamedTuples or their
dicts): every leaf goes through ``numpy.asarray`` or stays a tensor, and
lands on the tracker's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..features import AffineState, FeatureState, Lane
from ..ops.track import TrackPyramids
from .convert import level_tensor
from .staging import target_device


def _plain_tree(obj):
    """NamedTuples -> dicts, numpy arrays and numpy scalars -> CPU tensors
    and Python scalars; tensors, dicts, lists and tuples kept."""
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, np.generic):
        return obj.item()
    if hasattr(obj, "_asdict"):
        return {k: _plain_tree(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: _plain_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain_tree(v) for v in obj)
    return obj


def save_checkpoint(path, pytree: Any) -> None:
    """Save a tree (FeatureTable, FeatureState, a ``*_state`` dict, ...)
    to the file ``path`` (overwritten; parent directories created)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_plain_tree(pytree), path)


def _like(template, obj):
    """``obj`` (a restored tree) in ``template``'s structure and types."""
    if template is None or obj is None:
        return obj
    if hasattr(template, "_asdict"):
        return type(template)(**{k: _like(v, obj[k])
                                 for k, v in template._asdict().items()})
    if isinstance(template, dict):
        return {k: _like(v, obj[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, o) for t, o in zip(template, obj))
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(obj).to(device=template.device,
                                       dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(obj.cpu().numpy() if isinstance(obj, torch.Tensor)
                          else obj, template.dtype)
    return obj


def restore_checkpoint(path, template: Any = None, *,
                       map_location="cpu") -> Any:
    """Restore a checkpoint's tree (tensors on ``map_location``);
    ``template`` (optional) gives the structure and array types to restore
    into."""
    tree = torch.load(Path(path).absolute(), map_location=map_location,
                      weights_only=True)
    return _like(template, tree)


# ---------------------------------------------------------------------------
# leaves of either package's state, onto a device
# ---------------------------------------------------------------------------

def _tensor(a, dev, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype or a.dtype).contiguous()
    return torch.as_tensor(np.array(a), device=dev, dtype=dtype)


def _fields(obj) -> dict:
    """A NamedTuple's or a dict's fields."""
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _host_bool(a) -> bool:
    return bool(a.item() if isinstance(a, torch.Tensor) else np.asarray(a))


def _host_int(a) -> int:
    return int(a.item() if isinstance(a, torch.Tensor) else np.asarray(a))


def _pyramids_from(obj, dev) -> TrackPyramids:
    """Pyramid levels in their storage dtype (``convert.level_tensor``:
    bfloat16 levels of either package stay bfloat16)."""
    f = _fields(obj)
    return TrackPyramids(*(tuple(level_tensor(t, dev) for t in f[k])
                           for k in ("img", "gradx", "grady")))


def _affine_from(obj, dev):
    if obj is None:
        return None
    f = _fields(obj)
    nit = f.get("nit")
    return AffineState(
        *(_tensor(f[k], dev, torch.float32)
          for k in ("img", "gradx", "grady", "x", "y", "A")),
        valid=_tensor(f["valid"], dev, torch.bool),
        nit=None if nit is None else _tensor(nit, dev, torch.int32))


def _features_from(obj, dev) -> FeatureState:
    f = _fields(obj)
    return FeatureState(x=_tensor(f["x"], dev, torch.float32),
                        y=_tensor(f["y"], dev, torch.float32),
                        val=_tensor(f["val"], dev, torch.int32),
                        aff=_affine_from(f.get("aff"), dev))


def _lane(pyr, x, y, val, aff, b, dev):
    """Stream ``b`` of a stacked (batched) state, or the whole state for
    ``b`` None, as a ``Lane``."""
    def pick(t):
        return t if b is None else t[b]
    pyr = _pyramids_from({k: [pick(t) for t in v]
                          for k, v in _fields(pyr).items()}, dev)
    if aff is not None:
        aff = {k: (None if v is None else pick(v))
               for k, v in _fields(aff).items()}
    return Lane(pyr, _tensor(pick(x), dev, torch.float32),
                _tensor(pick(y), dev, torch.float32),
                _tensor(pick(val), dev, torch.int32), _affine_from(aff, dev))


def _stacked(trees):
    """Per-stream trees (tuples / NamedTuples of tensors) stacked on a new
    axis 0, in the first tree's structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if first is None:
        return None
    if hasattr(first, "_asdict"):
        return type(first)(*(_stacked([t[i] for t in trees])
                             for i in range(len(first))))
    return tuple(_stacked([t[i] for t in trees]) for i in range(len(first)))


# ---------------------------------------------------------------------------
# SequenceTracker
# ---------------------------------------------------------------------------

def sequence_state(tracker) -> dict:
    """Snapshot a ``models.sequence.SequenceTracker`` for resume.

    The per-frame metrics history is not checkpointed (host-side
    observability only); ``n_frames_seen`` records how many frames the
    tracker had processed."""
    if tracker.fl is None or tracker._prev is None:
        raise ValueError(
            "sequence_state: tracker has not processed any frame yet")
    state = {"fl": tracker.fl, "prev": tracker._prev,
             "n_frames_seen": int(tracker.n_frames_seen)}
    if tracker._cache is not None:
        state["cache"] = tracker._cache
    return state


def resume_sequence(tracker, state: dict) -> None:
    """Restore a SequenceTracker from ``sequence_state`` output (the port's
    or the JAX package's), onto the tracker's device."""
    dev = target_device(tracker.device)
    tracker.fl = _features_from(state["fl"], dev)
    tracker._prev = _tensor(state["prev"], dev, torch.float32)
    # metrics are not checkpointed; the frame counter is, so a resumed
    # then checkpointed tracker does not undercount
    tracker.n_frames_seen = _host_int(state.get("n_frames_seen", 0))
    cache = state.get("cache")
    if cache is not None:
        tracker._cache = _pyramids_from(cache, dev)


# ---------------------------------------------------------------------------
# StreamingTracker / BatchedStreamingTracker
# ---------------------------------------------------------------------------

def streaming_state(tracker) -> dict:
    """Snapshot a ``serving.StreamingTracker`` or
    ``BatchedStreamingTracker`` for resume (the long-running serving
    failure-recovery path), in the JAX package's layout: a
    StreamingTracker's pyramids and (x, y, val) as they are, a batched
    tracker's stacked over the streams on axis 0.

    Buffered partial chains are flushed into the snapshot; the row history
    is not included (call ``drain()`` and persist its output alongside if
    the accumulated table matters across the restart). The window carry
    is not kept: results are the same without one."""
    if tracker._lanes is None:
        raise ValueError(
            "streaming_state: tracker has not processed any frame yet")
    tracker.flush()
    lanes = tracker._lanes
    batched = hasattr(tracker, "n_streams")
    pyr, x, y, val, aff = (
        _stacked([lane[j] for lane in lanes]) if batched else lanes[0][j]
        for j in range(5))
    state = {"pyr": pyr, "x": x, "y": y, "val": val,
             "n_frames": int(tracker.n_frames),
             # the selection-exhaustion flag survives the restart (the
             # warning still fires on the next pull after a resume)
             "exhausted": (False if tracker._exhausted is None
                           else bool(tracker._exhausted))}
    if aff is not None:
        state["aff"] = aff
    return state


def resume_streaming(tracker, state: dict) -> None:
    """Restore a StreamingTracker / BatchedStreamingTracker from
    ``streaming_state`` output (the port's or the JAX package's; the
    tracker constructed with the same config and feature count)."""
    dev = tracker.device
    if dev.type == "cuda":
        dev = target_device(dev)
    aff = state.get("aff")
    n = getattr(tracker, "n_streams", None)
    streams = [None] if n is None else range(n)
    # the rows of the abandoned timeline go with the tracker's buffers
    tracker.resume([_lane(state["pyr"], state["x"], state["y"], state["val"],
                          aff, b, dev) for b in streams],
                   _host_int(state["n_frames"]),
                   _host_bool(state.get("exhausted", False)))


# ---------------------------------------------------------------------------
# VisualOdometry
# ---------------------------------------------------------------------------

def vo_state(vo) -> dict:
    """Snapshot a ``sfm.vo.VisualOdometry`` for resume (long-stream
    failure recovery).

    Everything the next keyframe needs is captured: per-slot generation
    counters, keyframe snapshots (with their images in loop-closure
    mode, with their place signatures), poses, the landmark map, and the
    tracker's own state
    (``sequence_state`` for the host route; the device pyramids and
    feature arrays for ``device_loop``; frames of an unfinished keyframe
    interval are not checkpointed, matching the keyframe-grained output).
    The events log is observability only and left out."""
    n = vo.n_features
    st = {
        "gen": vo.gen.copy(),
        "n_frames": int(vo.n_frames),
        "initialized": bool(vo.initialized),
        "kf_frames": np.asarray([k["frame"] for k in vo.kf], np.int64),
        "kf_x": (np.stack([k["x"] for k in vo.kf]) if vo.kf
                 else np.zeros((0, n))),
        "kf_y": (np.stack([k["y"] for k in vo.kf]) if vo.kf
                 else np.zeros((0, n))),
        "kf_gen": (np.stack([k["gen"] for k in vo.kf]) if vo.kf
                   else np.zeros((0, n), np.int64)),
        "kf_live": (np.stack([k["live"] for k in vo.kf]) if vo.kf
                    else np.zeros((0, n), bool)),
        "pose_R": (np.stack([p[0] for p in vo.poses]) if vo.poses
                   else np.zeros((0, 3, 3))),
        "pose_t": (np.stack([p[1] for p in vo.poses]) if vo.poses
                   else np.zeros((0, 3))),
        "lm_keys": np.asarray(sorted(vo.landmarks), np.int64).reshape(-1, 2),
        "pose_held": bool(getattr(vo, "_pose_held", False)),
    }
    st["lm_X"] = (np.stack([vo.landmarks[tuple(k)] for k in st["lm_keys"]])
                  if len(st["lm_keys"]) else np.zeros((0, 3)))
    if vo.loops_closed:
        st["loops_closed"] = np.asarray(vo.loops_closed,
                                        np.int64).reshape(-1, 2)
    if vo.kf and any(k.get("held") for k in vo.kf):
        st["kf_held"] = np.asarray([bool(k.get("held")) for k in vo.kf])
    if vo.kf and all(k.get("img") is not None for k in vo.kf):
        # loop-closure mode keeps keyframe images (re-observation needs
        # the old pixels); carry them so closure still works against
        # keyframes from before the resume
        st["kf_img"] = np.stack([k["img"] for k in vo.kf]).astype(np.float32)
        # the place signatures were taken from the frames as fed (their
        # float32 copies can round a float64 frame's)
        st["kf_sig"] = np.stack([k["sig"] for k in vo.kf])
    if vo.device_loop:
        if vo._dev_state is not None:
            pyr, x, y, val, aff = vo._dev_state
            st["dev"] = {"pyr": pyr, "x": x, "y": y, "val": val}
            if aff is not None:
                st["dev"]["aff"] = aff
        st["n_pending"] = len(vo._dev_buf)
    elif vo._tr.fl is not None:
        st["tracker"] = sequence_state(vo._tr)
    return st


def resume_vo(vo, state: dict) -> None:
    """Restore a VisualOdometry from ``vo_state`` output (the port's or the
    JAX package's; ``vo`` constructed with the same K, config, feature
    count and ``device_loop`` mode)."""
    from ..sfm.vo import _place_signature

    def host(a, dtype=None):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a if dtype is None else a.astype(dtype)

    vo.gen = host(state["gen"], np.int64).copy()
    # frames of an unfinished device-loop interval are not checkpointed:
    # the frame counter rewinds to the interval's start
    vo.n_frames = (_host_int(state["n_frames"])
                   - _host_int(state.get("n_pending", 0)))
    vo.initialized = _host_bool(state["initialized"])
    vo._pose_held = _host_bool(state.get("pose_held", False))
    frames = host(state["kf_frames"], np.int64)
    imgs = state.get("kf_img")
    sigs = state.get("kf_sig")
    held = host(state.get("kf_held", np.zeros(len(frames), bool)), bool)
    vo.kf = []
    for i in range(len(frames)):
        img = None if imgs is None else host(imgs[i], np.float32)
        vo.kf.append({"frame": int(frames[i]),
                      "x": host(state["kf_x"][i], np.float64),
                      "y": host(state["kf_y"][i], np.float64),
                      "gen": host(state["kf_gen"][i], np.int64),
                      "live": host(state["kf_live"][i], bool),
                      "held": bool(held[i]), "img": img,
                      "sig": (host(sigs[i], np.float32) if sigs is not None
                              else None if img is None
                              else _place_signature(img))})
    vo.loops_closed = [tuple(int(v) for v in row) for row in host(
        state.get("loops_closed", np.zeros((0, 2))), np.int64).reshape(-1, 2)]
    R, t = host(state["pose_R"], np.float64), host(state["pose_t"],
                                                   np.float64)
    vo.poses = [(R[i], t[i]) for i in range(len(R))]
    keys = host(state["lm_keys"], np.int64).reshape(-1, 2)
    X = host(state["lm_X"], np.float64).reshape(-1, 3)
    vo.landmarks = {(int(k[0]), int(k[1])): X[i].copy()
                    for i, k in enumerate(keys)}
    if vo.device_loop:
        d = state.get("dev")
        if d is not None:
            vo._dev_state = _lane(d["pyr"], d["x"], d["y"], d["val"],
                                  d.get("aff"), None, vo.device)[:5]
        vo._dev_buf = []
        vo._dev_carry = None
    elif "tracker" in state:
        resume_sequence(vo._tr, state["tracker"])
