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

Out of this port so far (raise NotImplementedError): ``image_dtype`` other
than float32, and ``sequence_chain_device``.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..config import TrackerConfig, create_config
from ..features import KLT_NOT_FOUND, FeatureState, reset_affine
from ..ops.affine import affine_consistency_check, make_affine_state
from ..ops.select import selection_eig_map
from ..ops.select_device import (DEFAULT_TOP_K,
                                 select_features_from_eig_device)
from ..ops.track import (TrackPyramids, as_frame, build_track_pyramids,
                         track_features_pyramids_carry)


def _check_cfg(cfg) -> None:
    if cfg.image_dtype != "float32":
        raise NotImplementedError(
            f"image_dtype={cfg.image_dtype!r}: the port stores float32 "
            "pyramids only")


def _build_with_map(img: torch.Tensor, cfg, with_map: bool):
    """The frame's pyramids and, ``with_map``, its selection min-eig map
    (else None): from the build's level-0 launch when
    smoothBeforeSelecting, else one eig-only launch of the raw frame."""
    if not with_map:
        return build_track_pyramids(img, cfg), None
    if cfg.smoothBeforeSelecting:
        return build_track_pyramids(img, cfg, with_eig=True)
    return build_track_pyramids(img, cfg), selection_eig_map(img, cfg)


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
    _check_cfg(cfg)
    img_new = as_frame(img_new, x.device)
    pyr_new, eig = _build_with_map(img_new, cfg, replace_lost)
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
            eig, nx, ny, nval, cfg, replacing=True, top_k=top_k)
        if aff is not None:
            # refilled slots are fresh features: their templates recapture
            aff = reset_affine(aff, lost)
    return pyr_new, nx, ny, nval, aff, exhausted, carry


def sequence_chain_device(*args, **kwargs):
    """Micro-chained steps of the JAX package: not in the port yet."""
    raise NotImplementedError("sequence_chain_device is not in the port yet")


def track_sequence_device(frames: Iterable, cfg: Optional[TrackerConfig]
                          = None, n_features: int = 150,
                          replace_lost: bool = True,
                          top_k: int = DEFAULT_TOP_K, device="cuda"):
    """Track a whole sequence on ``device``; one host pull at the end.

    ``frames``: [H, W] arrays or tensors (uint8 or float). Returns (x, y,
    val) stacked [n_frames, n_features] numpy arrays — the FeatureTable
    contents of the reference's example3 loop.
    """
    cfg = (cfg if cfg is not None else create_config()).replace(
        sequentialMode=True).validated_window()
    frames = list(frames)
    pyr, x, y, val, aff, _ = select_step_device(frames[0], cfg, n_features,
                                                top_k, device=device)
    hist = [(x, y, val)]
    carry = None
    for frame in frames[1:]:
        pyr, x, y, val, aff, _, carry = sequence_step_device(
            pyr, frame, x, y, val, cfg, replace_lost, top_k, aff, carry)
        hist.append((x, y, val))
    return tuple(torch.stack([h[j] for h in hist]).cpu().numpy()
                 for j in range(3))
