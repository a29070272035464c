"""Feature data model: structure-of-arrays feature state on torch tensors.

Reference parity: klt.py -> KLT_Feature / KLT_FeatureList (here one
structure-of-arrays NamedTuple, FeatureState) and storeFeatures.py ->
KLT_FeatureTable. Port of ``pyfeaturetrack_tpu/features.py``.

``val`` holds the min-eigenvalue after selection (>= 0) and the status code
after tracking, exactly like the reference. Status codes are bit-identical
(klt.py constants).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

KLT_TRACKED = 0
KLT_NOT_FOUND = -1
KLT_SMALL_DET = -2
KLT_MAX_ITERATIONS = -3
KLT_OOB = -4
KLT_LARGE_RESIDUE = -5
# Beyond-reference extension (the reference stops at -5): forward-
# backward consistency rejection (not in the port yet).
KLT_FB_INCONSISTENT = -6


class FeatureState(NamedTuple):
    """Structure-of-arrays feature list (= reference KLT_FeatureList)."""
    x: torch.Tensor    # [N] float32
    y: torch.Tensor    # [N] float32
    val: torch.Tensor  # [N] int32: eigenvalue after select, status after track

    @property
    def nFeatures(self) -> int:
        return self.x.shape[-1]


def feature_state_from_numpy(arr: np.ndarray,
                             device: str | torch.device = "cpu"
                             ) -> FeatureState:
    """(N,3) float array of (x, y, val) -> FeatureState."""
    a = np.asarray(arr)
    return FeatureState(
        x=torch.as_tensor(np.ascontiguousarray(a[:, 0], np.float32),
                          device=device),
        y=torch.as_tensor(np.ascontiguousarray(a[:, 1], np.float32),
                          device=device),
        val=torch.as_tensor(a[:, 2].astype(np.int64).astype(np.int32),
                            device=device),
    )


def feature_state_to_numpy(fl: FeatureState) -> np.ndarray:
    """FeatureState -> (N,3) float64 array of (x, y, val)."""
    return np.stack([
        fl.x.detach().cpu().numpy().astype(np.float64),
        fl.y.detach().cpu().numpy().astype(np.float64),
        fl.val.detach().cpu().numpy().astype(np.float64),
    ], axis=1)
