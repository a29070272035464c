"""Multi-frame sequence tracking on the host API: the example3-shaped loop.

Reference parity: example3.py flow (SURVEY.md section 3.5): sequential-mode
tracking through a frame sequence with lost-feature replacement and a
feature-table history; port of ``pyfeaturetrack_tpu/models/sequence.py``:

    select(frame0) -> store(0)
    for i in 1..F-1:
        track(frame[i-1] -> frame[i])   # reusing cached pyramids
        replace_lost(frame[i])
        store(i)

Per frame this runs K1 (the new frame's pyramid), K2 (LK), K6 when
``cfg.affineConsistencyCheck >= 0``, and, when a feature was lost, the
selection eig map (K1 level 0, K3) and K5 (sort + greedy scan). It reads
the device as the JAX loop does: ``any(val < 0)`` before a refill, the
per-frame metrics, and the survivor count of ``KeyframeTracker``. The
device-resident route without host reads is ``track_sequence_device``;
both give the same feature table.

``subpixel_refine=True`` moves newly selected features (the first frame's
and the refilled slots) to their sub-pixel corners (``ops/refine.py``:
K1 level 0 for the gradients, then the plain-PyTorch iteration), as the
JAX package does; re-tracked features are never moved.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import TrackerConfig, create_config
from ..features import (STATUS_NAMES, FeatureState, FeatureTable,
                        create_feature_table, feature_state_to_numpy,
                        store_feature_list)
from ..ops.refine import refine_features_subpixel
from ..ops.select import replace_lost_features, select_good_features
from ..ops.track import as_frame, build_track_pyramids, fb_reject
from .tracker import KLTTrackFeatures


def frame_metrics(fl: FeatureState, elapsed_s: float | None = None) -> dict:
    """Per-frame tracking metrics (SURVEY.md section 5.5): counts by status
    code and, given ``elapsed_s``, features per second."""
    arr = feature_state_to_numpy(fl)
    val = arr[:, 2].astype(np.int64)
    counts = {name: int((val == code).sum())
              for code, name in STATUS_NAMES.items()}
    m = {"n_features": int(val.shape[0]),
         "n_live": int((val >= 0).sum()),
         "status_counts": counts}
    if elapsed_s is not None and elapsed_s > 0:
        m["elapsed_s"] = elapsed_s
        m["features_per_s"] = val.shape[0] / elapsed_s
    return m


def metrics_from_table(x, y, val) -> list[dict]:
    """Per-frame metrics from stacked [F, N] track arrays: the post-hoc
    observability path for the device-resident route, which pulls its
    whole history in one transfer."""
    val = np.asarray(val, np.int64)
    out = []
    for i in range(val.shape[0]):
        counts = {name: int((val[i] == code).sum())
                  for code, name in STATUS_NAMES.items()}
        out.append({"n_features": int(val.shape[1]),
                    "n_live": int((val[i] >= 0).sum()),
                    "n_refilled": int((val[i] > 0).sum()) if i else 0,
                    "status_counts": counts})
    return out


class SequenceTracker:
    """Streaming sequence tracker with explicit functional state. Frames
    go to ``device`` ("cuda" unless "cpu" is given)."""

    def __init__(self, cfg: Optional[TrackerConfig] = None,
                 n_features: int = 150, replace_lost: bool = True,
                 fb_max_displacement: Optional[float] = None,
                 subpixel_refine: bool = False, device=None):
        self.cfg = (cfg if cfg is not None
                    else create_config()).replace(sequentialMode=True)
        self.n_features = n_features
        self.replace_lost = replace_lost
        # beyond the reference: forward-backward gate (ops/track.fb_reject)
        # after each tracked frame when set
        self.fb_max_displacement = fb_max_displacement
        # beyond the reference: sub-pixel refinement (ops/refine.py) of
        # newly selected features (initial selection and refills)
        self.subpixel_refine = subpixel_refine
        self.device = device
        self.fl: Optional[FeatureState] = None
        self._cache = None
        self._prev = None
        self.metrics: list[dict] = []
        self.n_frames_seen = 0

    def _new_keyframe(self, frame):
        self._cache = build_track_pyramids(frame, self.cfg.validated_window())
        self._prev = frame

    def start(self, frame) -> FeatureState:
        frame = as_frame(frame, self.device)
        self._new_keyframe(frame)
        self.fl = select_good_features(frame, self.n_features, self.cfg)
        if self.subpixel_refine:
            self.fl = refine_features_subpixel(frame, self.fl, self.cfg)
        self.n_frames_seen += 1
        self.metrics.append(frame_metrics(self.fl))
        return self.fl

    def step(self, frame) -> FeatureState:
        if self.fl is None:
            return self.start(frame)
        frame = as_frame(frame, self.fl.x.device)
        t0 = time.perf_counter()
        fl_before, cache_before = self.fl, self._cache
        self.fl, self._cache = KLTTrackFeatures(
            self.cfg, self._prev, frame, self.fl, pyramid_last=self._cache)
        if self.fb_max_displacement is not None:
            nx, ny, nval, _ = fb_reject(
                cache_before, self._cache, fl_before.x, fl_before.y,
                self.fl.x, self.fl.y, self.fl.val,
                self.cfg.validated_window(),
                fb_max_displacement=float(self.fb_max_displacement))
            self.fl = self.fl._replace(x=nx, y=ny, val=nval)
        if self.replace_lost:
            dead_before = self.fl.val < 0
            self.fl = replace_lost_features(frame, self.fl, self.cfg)
            if self.subpixel_refine:
                refined = refine_features_subpixel(frame, self.fl, self.cfg)
                newly = dead_before & (self.fl.val >= 0)
                self.fl = self.fl._replace(
                    x=torch.where(newly, refined.x, self.fl.x),
                    y=torch.where(newly, refined.y, self.fl.y))
        elapsed = time.perf_counter() - t0
        self._prev = frame
        self.n_frames_seen += 1
        self.metrics.append(frame_metrics(self.fl, elapsed))
        return self.fl


class KeyframeTracker(SequenceTracker):
    """Drift-bounded tracking: every frame is tracked against the last
    KEYFRAME instead of the previous frame. A new keyframe is declared
    when fewer than ``min_survivors`` features survive, or every
    ``keyframe_interval`` frames; lost features are replaced at each new
    keyframe. Beyond the reference; the keyframe's pyramids are held as
    ``pyramid_last``."""

    def __init__(self, cfg=None, n_features: int = 150,
                 keyframe_interval: int = 8,
                 min_survivors: int | None = None, device=None):
        super().__init__(cfg, n_features=n_features, replace_lost=False,
                         device=device)
        self.keyframe_interval = keyframe_interval
        self.min_survivors = (min_survivors if min_survivors is not None
                              else max(1, n_features // 2))
        self._since_key = 0
        self._key_fl: Optional[FeatureState] = None

    def start(self, frame) -> FeatureState:
        fl = super().start(frame)
        self._key_fl = fl
        self._since_key = 0
        return fl

    def step(self, frame) -> FeatureState:
        if self.fl is None:
            return self.start(frame)
        frame = as_frame(frame, self.fl.x.device)
        t0 = time.perf_counter()
        # track the KEYFRAME's feature list into the current frame, from
        # the keyframe's cached pyramids
        fl, _ = KLTTrackFeatures(self.cfg, self._prev, frame, self._key_fl,
                                 pyramid_last=self._cache)
        self.fl = fl
        if fl.aff is not None:
            # templates captured in this step anchor in the KEYFRAME: carry
            # them back so later steps verify against them
            self._key_fl = self._key_fl._replace(aff=fl.aff)
        self._since_key += 1
        n_live = int((fl.val >= 0).sum())
        if (n_live < self.min_survivors
                or self._since_key >= self.keyframe_interval):
            # re-keyframe on the current frame: keep survivors' tracked
            # positions, refill lost slots, rebuild the pyramid cache
            self._new_keyframe(frame)
            fl = replace_lost_features(frame, fl, self.cfg)
            self.fl = fl
            self._key_fl = fl
            self._since_key = 0
        self.n_frames_seen += 1
        self.metrics.append(frame_metrics(self.fl,
                                          time.perf_counter() - t0))
        return self.fl


def track_sequence(frames: Iterable,
                   cfg: Optional[TrackerConfig] = None,
                   n_features: int = 150,
                   replace_lost: bool = True,
                   on_frame: Optional[Callable[[int, FeatureState], None]]
                   = None,
                   fb_max_displacement: Optional[float] = None,
                   subpixel_refine: bool = False, device=None
                   ) -> tuple[FeatureTable, list[dict]]:
    """Track through a whole sequence, returning the feature table (on the
    features' device) and the per-frame metrics.

    Reference parity: example3.py end-to-end flow. ``on_frame(i, fl)`` is
    called after each frame (e.g. to write overlay PPMs)."""
    frames = list(frames)
    st = SequenceTracker(cfg, n_features=n_features,
                         replace_lost=replace_lost,
                         fb_max_displacement=fb_max_displacement,
                         subpixel_refine=subpixel_refine, device=device)
    ft = None if frames else create_feature_table(
        0, n_features, device=device if device is not None else "cuda")
    for i, frame in enumerate(frames):
        fl = st.step(frame)
        if ft is None:
            ft = create_feature_table(len(frames), n_features,
                                      device=fl.x.device)
        ft = store_feature_list(fl, ft, i)
        if on_frame is not None:
            on_frame(i, fl)
    return ft, st.metrics
