"""Feature data model: structure-of-arrays feature state on torch tensors.

Reference parity: klt.py -> KLT_Feature / KLT_FeatureList (here one
structure-of-arrays NamedTuple, FeatureState) and storeFeatures.py ->
KLT_FeatureTable. Port of ``pyfeaturetrack_tpu/features.py``.

``val`` holds the min-eigenvalue after selection (>= 0) and the status code
after tracking, exactly like the reference. Status codes are bit-identical
(klt.py constants).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


class AffineState(NamedTuple):
    """Per-feature first-frame template + warp for the consistency check.

    Reference parity: klt.py -> KLT_Feature aff_* fields. Templates are
    affine_window-sized bilinear samples centred on the feature; ``x``/``y``
    record the capture anchor (metadata: the matching math does not read
    them)."""
    img: torch.Tensor     # [N, T, T] template intensities
    gradx: torch.Tensor   # [N, T, T]
    grady: torch.Tensor   # [N, T, T]
    x: torch.Tensor       # [N] capture anchor (frame-1 position)
    y: torch.Tensor       # [N]
    A: torch.Tensor       # [N, 2, 2] warp, rows [[Axx, Axy], [Ayx, Ayy]]
    valid: torch.Tensor   # [N] bool: template captured
    # [N] int32 Gauss-Newton iteration hint of the JAX package's TPU
    # kernel (tile ordering); the math never reads it. None is normalized
    # to zeros at the affine stage.
    nit: Optional[torch.Tensor] = None


class FeatureState(NamedTuple):
    """Structure-of-arrays feature list (= reference KLT_FeatureList)."""
    x: torch.Tensor    # [N] float32
    y: torch.Tensor    # [N] float32
    val: torch.Tensor  # [N] int32: eigenvalue after select, status after track
    aff: Optional[AffineState] = None

    @property
    def nFeatures(self) -> int:
        return self.x.shape[-1]


def identity_warps(n: int, device) -> torch.Tensor:
    """[n, 2, 2] float32 identity warps."""
    return torch.eye(2, dtype=torch.float32, device=device).expand(
        n, 2, 2).contiguous()


def reset_affine(aff: AffineState, drop_mask: torch.Tensor) -> AffineState:
    """Invalidate templates for features in ``drop_mask`` (= the reference
    freeing aff_img and resetting the warp to identity on track loss)."""
    eye = identity_warps(aff.A.shape[0], aff.A.device)
    nit = aff.nit
    if nit is not None:
        nit = torch.where(drop_mask, 0, nit)
    return aff._replace(
        valid=aff.valid & ~drop_mask,
        A=torch.where(drop_mask[:, None, None], eye, aff.A),
        nit=nit)


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
