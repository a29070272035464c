"""High-level tracker API: the ``KLT*`` facade and ``Tracker``.

Reference parity: every public ``KLT*`` entry point of TimSC/PyFeatureTrack
(klt.py, selectGoodFeatures.py, trackFeatures.py, storeFeatures.py) has a
same-named function here with matching semantics, plus an object API
(``Tracker``) that carries the config and the sequential-mode pyramid
cache. Port of ``pyfeaturetrack_tpu/models/tracker.py``.

Devices: a call that takes a numpy image runs on ``device`` ("cuda" unless
the caller passes "cpu"; a tensor image stays on its own device); a call
that takes a FeatureState runs on that state's device. CUDA tensors
launch the kernels (K1 pyramid, K2 LK, K3 eig map, K5 greedy scan, K6
affine check), CPU tensors take their plain versions.

  KLTCreateTrackingContext -> config.create_config
  KLTSelectGoodFeatures    -> ops/select.py (eig map, sort, K5)
  KLTReplaceLostFeatures   -> ops/select.py
  KLTTrackFeatures         -> ops/track.py (+ ops/affine.py)
  KLTCreateFeatureList/Table, KLTStoreFeatureList, KLTExtractFeatureList,
  KLTCountRemainingFeatures -> features.py
"""

from __future__ import annotations

from typing import Optional

from ..config import (TrackerConfig, change_pyramid, create_config,
                      print_config, update_border)
from ..errors import KLTError
from ..features import (FeatureState, FeatureTable, count_remaining_features,
                        create_feature_list, create_feature_table,
                        extract_feature_list, store_feature_list)
from ..ops.affine import affine_consistency_check
from ..ops.select import replace_lost_features, select_good_features
from ..ops.track import (TrackPyramids, as_frame, build_track_pyramids,
                         track_features)

# ---------------------------------------------------------------------------
# Reference-shaped functional API
# ---------------------------------------------------------------------------


def KLTCreateTrackingContext(**overrides) -> TrackerConfig:
    """Reference parity: klt.py -> KLTCreateTrackingContext."""
    return create_config(**overrides)


def KLTCreateFeatureList(n_features: int, **kw) -> FeatureState:
    """Reference parity: klt.py -> KLTCreateFeatureList (``device``,
    default "cuda", among ``kw``)."""
    return create_feature_list(n_features, **kw)


def KLTCreateFeatureTable(n_frames: int, n_features: int,
                          device="cuda") -> FeatureTable:
    """Reference parity: storeFeatures.py -> KLTCreateFeatureTable."""
    return create_feature_table(n_frames, n_features, device=device)


def KLTSelectGoodFeatures(cfg: TrackerConfig, img, n_features: int,
                          device=None) -> FeatureState:
    """Reference parity: selectGoodFeatures.py -> KLTSelectGoodFeatures."""
    return select_good_features(img, n_features, cfg, device)


def KLTReplaceLostFeatures(cfg: TrackerConfig, img, fl: FeatureState
                           ) -> FeatureState:
    """Reference parity: selectGoodFeatures.py -> KLTReplaceLostFeatures."""
    return replace_lost_features(img, fl, cfg)


def KLTChangeTCPyramid(cfg: TrackerConfig, search_range: int = 15
                       ) -> TrackerConfig:
    """Reference parity: klt.py -> KLTChangeTCPyramid (returns a new
    config instead of mutating)."""
    return update_border(change_pyramid(cfg, search_range))


def KLTUpdateTCBorder(cfg: TrackerConfig) -> TrackerConfig:
    """Reference parity: klt.py -> KLTUpdateTCBorder."""
    return update_border(cfg)


def KLTPrintTrackingContext(cfg: TrackerConfig) -> str:
    """Reference parity: klt.py -> KLTPrintTrackingContext."""
    return print_config(cfg)


def KLTTrackFeatures(cfg: TrackerConfig, img1, img2, fl: FeatureState,
                     pyramid_last: Optional[TrackPyramids] = None,
                     carry_last=None, return_carry: bool = False):
    """Reference parity: trackFeatures.py -> KLTTrackFeatures.

    The reference stashes frame 2's pyramids on the mutable context in
    sequential mode; here they are returned and passed back explicitly
    (``pyramid_last``). When ``cfg.affineConsistencyCheck >= 0`` the
    affine-consistency stage runs after translational tracking.
    ``carry_last``/``return_carry`` thread the level-0 window carry
    (``ops/cuda_lk.TrackCarry``) like the JAX signature; results are the
    same either way. Returns (fl, pyr2) or, with ``return_carry``, (fl,
    pyr2, carry)."""
    s1 = getattr(img1, "shape", None)
    s2 = getattr(img2, "shape", None)
    if s1 is not None and s2 is not None and tuple(s1) != tuple(s2):
        raise KLTError(
            f"(KLTTrackFeatures) frame size mismatch: {s1} vs {s2}")
    cfgv = cfg.validated_window()
    pyr1 = pyramid_last
    if pyr1 is None:
        pyr1 = build_track_pyramids(as_frame(img1, fl.x.device), cfgv)
    fl_after, pyr2, carry = track_features(img1, img2, fl, cfgv, pyr1=pyr1,
                                           carry=carry_last,
                                           return_carry=True)
    if cfgv.affineConsistencyCheck >= 0:
        fl_after = affine_consistency_check(pyr1, pyr2, fl, fl_after, cfgv)
    if return_carry:
        return fl_after, pyr2, carry
    return fl_after, pyr2


def KLTStoreFeatureList(fl: FeatureState, ft: FeatureTable, frame: int
                        ) -> FeatureTable:
    """Reference parity: storeFeatures.py -> KLTStoreFeatureList."""
    return store_feature_list(fl, ft, frame)


def KLTExtractFeatureList(ft: FeatureTable, frame: int) -> FeatureState:
    """Reference parity: storeFeatures.py -> KLTExtractFeatureList."""
    return extract_feature_list(ft, frame)


def KLTCountRemainingFeatures(fl: FeatureState) -> int:
    """Reference parity: klt.py -> KLTCountRemainingFeatures."""
    return int(count_remaining_features(fl))


# ---------------------------------------------------------------------------
# Object API
# ---------------------------------------------------------------------------

class Tracker:
    """Stateful convenience wrapper: config + sequential-mode pyramid cache.

    The equivalent of holding a reference ``KLT_TrackingContext`` with
    ``sequentialMode = True``, with the carried state explicit. Frames go
    to ``device`` ("cuda" unless "cpu" is given)."""

    def __init__(self, cfg: Optional[TrackerConfig] = None, device=None,
                 **overrides):
        self.cfg = cfg if cfg is not None else create_config(**overrides)
        self.device = device
        self._cache: Optional[TrackPyramids] = None
        self._prev_img = None

    def select(self, img, n_features: int) -> FeatureState:
        img = as_frame(img, self.device)
        self._prev_img = img
        if self.cfg.sequentialMode:
            self._cache = build_track_pyramids(img,
                                               self.cfg.validated_window())
        return select_good_features(img, n_features, self.cfg)

    def track(self, img, fl: FeatureState, prev_img=None) -> FeatureState:
        """Track ``fl`` from the previous frame into ``img``."""
        img = as_frame(img, fl.x.device)
        img1 = prev_img if prev_img is not None else self._prev_img
        if img1 is None:
            raise ValueError("track() before select(): no previous frame")
        # the cached pyramids belong to self._prev_img; an explicit
        # prev_img overrides the carried frame, so the cache is not used
        cache = (self._cache if self.cfg.sequentialMode
                 and prev_img is None else None)
        fl, pyr2 = KLTTrackFeatures(self.cfg, img1, img, fl,
                                    pyramid_last=cache)
        if self.cfg.sequentialMode:
            self._cache = pyr2
        self._prev_img = img
        return fl

    def replace_lost(self, img, fl: FeatureState) -> FeatureState:
        return replace_lost_features(img, fl, self.cfg)
