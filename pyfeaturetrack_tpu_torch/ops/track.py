"""Batched pyramidal Lucas-Kanade tracking.

Reference parity: trackFeatures.py -> KLTTrackFeatures / _trackFeature;
port of the pyramid build and level loop of
``pyfeaturetrack_tpu/ops/track.py``. A track call is K2
(ops/cuda_lk.track_pyramid: the coarse-to-fine level loop, the
coarse-level "broken" rule and the final classification, one launch on
CUDA); the pyramid build is K1 (ops/cuda_pyramid.pyramid_build: at most
two launches on CUDA).

``track_feature_level`` is one level for given positions: K2's per-level
launch (ops/cuda_lk.lk_level). ``track_features`` is the images-in entry
of the host API and
``fb_reject`` / ``track_features_pyramids_fb`` the forward-backward gate
(the backward pass is K2 from frame 2 to frame 1).

Guided tracking (``x_init``/``y_init``: the frame-2 search starts at an
external motion prior, e.g. landmark projections) goes through the same
K2 launch.

Storage (``cfg.image_dtype``): the levels are built in float32 and stored
as float32 or bfloat16 (``cuda_pyramid.storage_dtype``); K2 reads either
and upcasts each tap.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..errors import KLTGetVerbosity, verbose_print
from ..features import KLT_FB_INCONSISTENT, KLT_TRACKED, FeatureState
from .convolve import to_float_image
from .cuda_lk import TrackCarry, lk_level, track_pyramid
from .cuda_pyramid import level_taps, pyramid_build, storage_dtype


class TrackPyramids(NamedTuple):
    """Image + gradient pyramids for one frame (the sequential-mode cache).

    Reference parity: klt.py -> tc.pyramid_last / pyramid_last_gradx /
    pyramid_last_grady.
    """
    img: tuple[torch.Tensor, ...]
    gradx: tuple[torch.Tensor, ...]
    grady: tuple[torch.Tensor, ...]


# A frame as a contiguous float32 [H, W] tensor on its device (numpy
# arrays default to "cuda"): the KLT float conversion.
as_frame = to_float_image


def build_track_pyramids(img: torch.Tensor, cfg, *, with_eig: bool = False,
                         out: torch.Tensor | None = None):
    """float image -> smooth -> pyramid -> per-level gradients.

    Reference parity: trackFeatures.py -> KLTTrackFeatures pyramid-build
    phase. ``img`` is a float32 [H, W] tensor on the device to build on.
    The levels are stored in ``cfg.image_dtype`` (built in float32).
    ``with_eig``: also K3's int32 min-eig map of level 0's gradients for
    ``cfg``'s window (of the stored gradients, upcast), computed in the
    level-0 launch (the selection map when ``cfg.smoothBeforeSelecting``);
    returns (pyramids, map). ``out``: the pyramid buffer to build into
    (``cuda_pyramid.pyramid_build``).
    """
    built = pyramid_build(img.to(torch.float32).contiguous(), level_taps(cfg),
                          cfg.nPyramidLevels,
                          eig_window=((int(cfg.window_width),
                                       int(cfg.window_height))
                                      if with_eig else None), out=out,
                          dtype=storage_dtype(cfg))
    pyr = TrackPyramids(img=built[0], gradx=built[1], grady=built[2])
    return (pyr, built[3]) if with_eig else pyr


def build_track_pyramids_jit(img: torch.Tensor, cfg, **kwargs):
    """``build_track_pyramids``: the JAX package's jitted build. The port
    has no jit, so it is the same function under the JAX package's name."""
    return build_track_pyramids(img, cfg, **kwargs)


def track_feature_level(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2,
                        cfg, active_in):
    """One pyramid level of iterative translational LK for all features.

    Reference parity: trackFeatures.py -> _trackFeature, vectorized over
    features. ``active_in`` (bool [N]) masks features still being tracked
    (lanes with False pass through unchanged with status KLT_TRACKED).
    Returns (x2, y2, status, iteration) with status in {TRACKED, OOB,
    SMALL_DET, LARGE_RESIDUE, MAX_ITERATIONS}.

    K2's per-level launch (``cuda_lk.lk_level``, csrc/lk.cu
    ``pft_lk_level``) on CUDA tensors; ``cuda_lk.lk_level_reference`` on
    CPU tensors."""
    return lk_level(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2, cfg,
                    active_in)


def track_features_pyramids_carry(pyr1: TrackPyramids, pyr2: TrackPyramids,
                                  x: torch.Tensor, y: torch.Tensor,
                                  val: torch.Tensor, cfg, *, x_init=None,
                                  y_init=None, carry: TrackCarry | None = None):
    """Pyramidal LK over a feature batch given prebuilt pyramids, with the
    sequential window-carry signature of the JAX package.

    Returns (x, y, val, carry_out); lost features get (-1, -1, status).
    ``x_init``/``y_init`` (both or neither, float32 [N] level-0 pixels):
    the coarsest level's frame-2 start is ``x_init / s^L`` instead of
    ``x / s^L``; the frame-1 anchor stays ``x``. The port does not reuse
    carried windows yet: ``carry_out`` is None without a carry, else the
    carry with ``ok`` cleared, and results are identical either way.
    """
    starts = () if x_init is None and y_init is None else (x_init, y_init)
    new_x, new_y, new_val = track_pyramid(pyr1, pyr2, x, y, val, cfg,
                                          *starts)
    carry_out = None
    if carry is not None:
        carry_out = carry._replace(ok=torch.zeros_like(carry.ok))
    return new_x, new_y, new_val, carry_out


def track_features_pyramids(pyr1: TrackPyramids, pyr2: TrackPyramids,
                            x: torch.Tensor, y: torch.Tensor,
                            val: torch.Tensor, cfg, *, x_init=None,
                            y_init=None):
    """Pyramidal LK over a feature batch given prebuilt pyramids.

    Reference parity: trackFeatures.py -> KLTTrackFeatures feature loop +
    coarse-to-fine level loop. Returns (x, y, val); lost features get
    (-1, -1, status). ``x_init``/``y_init``: guided frame-2 starts
    (``track_features_pyramids_carry``).
    """
    nx, ny, nval, _ = track_features_pyramids_carry(
        pyr1, pyr2, x, y, val, cfg, x_init=x_init, y_init=y_init)
    return nx, ny, nval


def fb_reject(pyr1: TrackPyramids, pyr2: TrackPyramids, x0: torch.Tensor,
              y0: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
              nval: torch.Tensor, cfg, fb_max_displacement: float = 0.5):
    """Backward half of the forward-backward gate: given a completed
    forward track (x0, y0) -> (nx, ny, nval), re-track 2 -> 1 and reject
    lanes whose round trip misses (x0, y0) by more than
    ``fb_max_displacement`` px (or whose backward track fails). Rejected
    lanes get KLT_FB_INCONSISTENT and (-1, -1).

    Returns (x, y, val, fb_err); fb_err is the round-trip distance per
    lane (inf where the forward or backward track failed)."""
    # backward pass: lanes lost forward carry nval < 0 -> inactive
    bx, by, bval = track_features_pyramids(pyr2, pyr1, nx, ny, nval, cfg)
    fwd_ok = nval == KLT_TRACKED
    bwd_ok = bval == KLT_TRACKED
    err = torch.where(fwd_ok & bwd_ok, torch.hypot(bx - x0, by - y0),
                      torch.inf)
    bad = fwd_ok & (err > fb_max_displacement)
    return (torch.where(bad, -1.0, nx), torch.where(bad, -1.0, ny),
            torch.where(bad, KLT_FB_INCONSISTENT, nval), err)


def track_features_pyramids_fb(pyr1: TrackPyramids, pyr2: TrackPyramids,
                               x: torch.Tensor, y: torch.Tensor,
                               val: torch.Tensor, cfg,
                               fb_max_displacement: float = 0.5):
    """Forward-backward consistency tracking (beyond the reference): track
    1 -> 2, re-track the results 2 -> 1 and reject lanes whose round trip
    misses the start by more than ``fb_max_displacement`` px.

    Returns (x, y, val, fb_err) as ``fb_reject``."""
    nx, ny, nval = track_features_pyramids(pyr1, pyr2, x, y, val, cfg)
    return fb_reject(pyr1, pyr2, x, y, nx, ny, nval, cfg,
                     fb_max_displacement=fb_max_displacement)


def track_features(img1, img2, fl: FeatureState, cfg,
                   pyr1: TrackPyramids | None = None,
                   carry: TrackCarry | None = None,
                   return_carry: bool = False):
    """High-level tracking entry: images in, updated FeatureState out, on
    ``fl``'s device.

    Reference parity: trackFeatures.py -> KLTTrackFeatures. Returns
    (new_fl, pyr2) where ``pyr2`` is the frame-2 pyramid cache to pass back
    in sequential mode; with ``return_carry``, (new_fl, pyr2, carry)."""
    cfg = cfg.validated_window()
    dev = fl.x.device
    if pyr1 is None:
        pyr1 = build_track_pyramids(as_frame(img1, dev), cfg)
    pyr2 = build_track_pyramids(as_frame(img2, dev), cfg)
    nrows, ncols = pyr2.img[0].shape
    verbose_print(f"(KLT) Tracking {fl.nFeatures} features in a "
                  f"{ncols} by {nrows} image...  ")
    nx, ny, nval, carry_out = track_features_pyramids_carry(
        pyr1, pyr2, fl.x, fl.y, fl.val, cfg, carry=carry)
    out = fl._replace(x=nx, y=ny, val=nval)
    # the count is a host read: none while a CUDA graph is being captured
    if KLTGetVerbosity() > 0 and not (
            nval.is_cuda and torch.cuda.is_current_stream_capturing()):
        verbose_print(f"\t{int((nval >= 0).sum())} features "
                      "successfully tracked.")
    if return_carry:
        return out, pyr2, carry_out
    return out, pyr2
