"""Shi-Tomasi (min-eigenvalue) feature selection, the host API's route.

Reference parity: selectGoodFeatures.py -> KLTSelectGoodFeatures /
KLTReplaceLostFeatures / _KLTSelectGoodFeatures / _sortPointList /
_enforceMinimumDistance; port of ``pyfeaturetrack_tpu/ops/select.py``.

The JAX package builds the min-eig map on the device, sorts the candidate
lattice on the host and runs the greedy min-distance scan in C++
(``native/min_distance.cpp``). The port keeps every step on the feature
arrays' device:

1. ``selection_eig_map``: K3's map from one K1 level-0 launch that stores
   nothing else (ops/cuda_pyramid.level0_eig); the device-resident route
   takes the same map from its pyramid build's level-0 launch;
2. the candidate lattice, K4's stage A (``cuda_select.candidate_lattice``:
   borders, step, candidates below the bar zeroed and, when replacing, the
   kept features' mindist boxes zeroed, which equals the host stamping
   them first);
3. the priority order: ``torch.sort(-vals, stable=True)``, the order of
   ``np.argsort(-vals, kind="stable")`` (descending, ties in scan order);
4. K5's fused entry (ops/cuda_suppress.suppress_and_fill), one launch:
   the sort's outputs decoded into pixels and validity, the free slots
   counted for the budget, the greedy scan over the whole ordered list, and
   the r-th acceptance into the r-th free slot, as the host greedy's slot
   walk does.

The op-level names of the JAX module: ``compute_min_eig_map`` (the
float map, beside K3 in ops/cuda_eig.py), ``quantized_min_eig_map`` (K3's
standalone launch on given gradients) and ``selection_eig_map_core``
(K1's eig-only level-0 launch on an image).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import KLTGetVerbosity, KLTWarning, verbose_print
from ..features import (KLT_NOT_FOUND, FeatureState, create_feature_list,
                        feature_state_from_numpy,
                        feature_state_to_numpy, reset_affine)
from .cuda_eig import compute_min_eig_map, min_eig_map  # noqa: F401
from .cuda_pyramid import level0_eig, level_taps, pyramid_level, sigma_taps
from .cuda_select import candidate_lattice
from .cuda_suppress import suppress_and_fill
from .select_device import _candidate_grid, premask_radius
from .track import as_frame


def quantized_min_eig_map(gradx: torch.Tensor, grady: torch.Tensor,
                          window_width: int, window_height: int
                          ) -> torch.Tensor:
    """Min-eig map cast to the reference's int32 candidate values
    (truncation toward zero, clamped at the int limit). Gradients stored
    as bfloat16 are upcast: the structure-tensor sums are float32.

    K3's standalone launch (``cuda_eig.min_eig_map``, csrc/eig.cu) on
    CUDA tensors; ``cuda_eig.min_eig_reference`` on CPU tensors."""
    return min_eig_map(gradx.to(torch.float32).contiguous(),
                       grady.to(torch.float32).contiguous(),
                       int(window_width), int(window_height))


def selection_eig_map_core(img, *, window_width: int, window_height: int,
                           smooth_before: bool, smooth_sigma: float,
                           grad_sigma: float) -> torch.Tensor:
    """float image -> (optional smooth) -> gradients -> min-eig map, in
    one K1 level-0 launch that stores no gradient (``cuda_pyramid.
    level0_eig``, K3's arithmetic inside it). A numpy image goes to the
    card."""
    return level0_eig(as_frame(img), sigma_taps(smooth_sigma, grad_sigma),
                      smooth=bool(smooth_before),
                      window_width=int(window_width),
                      window_height=int(window_height))


def selection_eig_map(img: torch.Tensor, cfg, pyr=None) -> torch.Tensor:
    """int32 min-eig map for selection: K3 over the level-0 gradients of
    ``img``, pre-smoothed when smoothBeforeSelecting (the default), in one
    K1 level-0 launch that stores no gradient (``selection_eig_map_core``).
    With smoothBeforeSelecting the pyramid base is smoothed exactly so, and
    a frame's TrackPyramids ``pyr`` holds the same gradients: K3's
    standalone entry reads those (``quantized_min_eig_map``; the device
    route takes the map from the build instead,
    ``build_track_pyramids(..., with_eig=True)``)."""
    ww, wh = int(cfg.window_width), int(cfg.window_height)
    if pyr is not None and cfg.smoothBeforeSelecting:
        return quantized_min_eig_map(pyr.gradx[0], pyr.grady[0], ww, wh)
    return selection_eig_map_core(
        img, window_width=ww, window_height=wh,
        smooth_before=bool(cfg.smoothBeforeSelecting),
        smooth_sigma=cfg.smooth_sigma, grad_sigma=cfg.grad_sigma)


def _write_internal_images(img: torch.Tensor, cfg) -> None:
    """Debug-dump the smoothed image and gradients to PGM files.

    Reference parity: tc.writeInternalImages (klt_util.py ->
    _KLTWriteFloatImageToPGM): writes kltimg_sgfrlf.pgm and
    kltimg_sgfrlf_gx/_gy.pgm in the working directory."""
    from ..utils.io import float_image_to_pgm
    base, gx, gy, _ = pyramid_level(img, level_taps(cfg),
                                    smooth=bool(cfg.smoothBeforeSelecting),
                                    with_pyr=False)
    float_image_to_pgm("kltimg_sgfrlf.pgm", base.cpu().numpy(), scale=False)
    float_image_to_pgm("kltimg_sgfrlf_gx.pgm", gx.cpu().numpy())
    float_image_to_pgm("kltimg_sgfrlf_gy.pgm", gy.cpu().numpy())


def select_features_from_eig(eig: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor, val: torch.Tensor, cfg, *,
                             replacing: bool):
    """(Re)selection into the (x, y, val) feature arrays from an int32
    min-eig map through stage A, the sort and K5's fused entry (decode,
    scan, slot fill). ``replacing=False``:
    overwrite every slot; ``replacing=True``: keep val >= 0 slots and
    refill the rest. Returns (x, y, val)."""
    geom = _candidate_grid(cfg, eig.shape)
    *_, ny, nx = geom
    if ny == 0 or nx == 0:
        # no room for features: every free slot comes back empty
        free = (val < 0) if replacing else torch.ones_like(val,
                                                           dtype=torch.bool)
        return (torch.where(free, -1.0, x), torch.where(free, -1.0, y),
                torch.where(free, KLT_NOT_FOUND, val))
    cand = candidate_lattice(eig, x, y, val, geom,
                             min_eig=max(int(cfg.min_eigenvalue), 1),
                             radius=premask_radius(cfg, replacing)
                             ).cells[:, :nx]
    # the negation writes the padded lattice's view densely, so no copy
    neg, order = torch.sort((-cand).reshape(-1), stable=True)
    return suppress_and_fill(neg, order, geom=geom,
                             min_eig=max(int(cfg.min_eigenvalue), 1),
                             shape=tuple(eig.shape), mindist=int(cfg.mindist),
                             x=x, y=y, val=val, replacing=replacing)


def _select(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            val: torch.Tensor, cfg, *, replacing: bool):
    """The selection of _KLTSelectGoodFeatures on tensors: warnings and
    progress prints, the eig map, then ``select_features_from_eig``."""
    nrows, ncols = img.shape
    n_features = int(val.shape[0])
    mode = "Replacing" if replacing else "Selecting"
    verbose_print(f"(KLT) {mode} the {n_features} best features "
                  f"from a {ncols} by {nrows} image...  ")
    if cfg.writeInternalImages:
        _write_internal_images(img, cfg)
    *_, ny, nx = _candidate_grid(cfg, (nrows, ncols))
    if ny == 0 or nx == 0:
        KLTWarning("(select_good_features) no room for features "
                   "(border too large for image)")
    if not replacing and ny * nx < n_features:
        KLTWarning("(select_good_features) fewer candidate pixels (%d) than "
                   "requested features (%d)", ny * nx, n_features)
    eig = selection_eig_map(img, cfg)
    out = select_features_from_eig(eig, x, y, val, cfg, replacing=replacing)
    if KLTGetVerbosity() > 0:
        verbose_print(f"\t{int((out[2] >= 0).sum())} features found.")
    return out


def select_good_features(img, n_features: int, cfg,
                         device=None) -> FeatureState:
    """High-level selection returning a FeatureState.

    Reference parity: selectGoodFeatures.py -> KLTSelectGoodFeatures.
    ``img``: [H, W] array (sent to ``device``, default "cuda") or tensor
    (used on its own device unless ``device`` is given)."""
    img = as_frame(img, device)
    empty = create_feature_list(n_features, device=img.device)
    return FeatureState(*_select(img, empty.x, empty.y, empty.val, cfg,
                                 replacing=False))


def replace_lost_features(img, fl: FeatureState, cfg) -> FeatureState:
    """Reference parity: selectGoodFeatures.py -> KLTReplaceLostFeatures.

    Runs on ``fl``'s device. As in the JAX package, a list with no lost
    feature comes back unchanged (one host read of ``any(val < 0)``);
    refilled slots lose their affine templates."""
    lost = fl.val < 0
    out = fl
    if bool(lost.any()):
        img = as_frame(img, fl.x.device)
        nx, ny, nval = _select(img, fl.x, fl.y, fl.val, cfg, replacing=True)
        out = fl._replace(x=nx, y=ny, val=nval)
    if fl.aff is not None:
        # refilled (previously lost) slots are fresh features: their
        # first-frame templates are recaptured
        out = out._replace(aff=reset_affine(fl.aff, lost))
    return out


def select_good_features_arrays(img, n_features: int, cfg,
                                existing: np.ndarray | None = None,
                                device=None) -> np.ndarray:
    """Array-level selection: returns (N, 3) float64 of (x, y, val).

    Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures
    (mode SELECTING_ALL when ``existing`` is None, else REPLACING_SOME)."""
    img = as_frame(img, device)
    if existing is None:
        return feature_state_to_numpy(
            select_good_features(img, n_features, cfg))
    fl = feature_state_from_numpy(existing, device=img.device)
    return feature_state_to_numpy(FeatureState(
        *_select(img, fl.x, fl.y, fl.val, cfg, replacing=True)))


def replace_lost_features_arrays(img, feats: np.ndarray, cfg,
                                 device=None) -> np.ndarray:
    """Reference parity: selectGoodFeatures.py -> KLTReplaceLostFeatures."""
    feats = np.asarray(feats, dtype=np.float64)
    if (feats[:, 2] < 0).any():
        return select_good_features_arrays(img, feats.shape[0], cfg,
                                           existing=feats, device=device)
    return feats.copy()
