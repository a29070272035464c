"""Batched pyramidal Lucas-Kanade tracking.

Reference parity: trackFeatures.py -> KLTTrackFeatures / _trackFeature;
port of the pyramid build and level loop of
``pyfeaturetrack_tpu/ops/track.py``. The per-level solve is K2
(ops/cuda_lk.lk_level, one launch per level on CUDA); the pyramid build is
K1 (ops/cuda_pyramid.pyramid_level). The coarse-to-fine level loop, the
coarse-level "broken" rule and the final classification are plain
PyTorch around them.

Out of this port so far (raise NotImplementedError): guided tracking
(``x_init``/``y_init``), the forward-backward gate (``fb_reject``), and
``image_dtype`` other than float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..features import KLT_OOB, KLT_SMALL_DET, KLT_TRACKED
from .cuda_lk import TrackCarry, lk_level
from .cuda_pyramid import level_taps, pyramid_level


class TrackPyramids(NamedTuple):
    """Image + gradient pyramids for one frame (the sequential-mode cache).

    Reference parity: klt.py -> tc.pyramid_last / pyramid_last_gradx /
    pyramid_last_grady.
    """
    img: tuple[torch.Tensor, ...]
    gradx: tuple[torch.Tensor, ...]
    grady: tuple[torch.Tensor, ...]


def _require_float32_images(cfg) -> None:
    if getattr(cfg, "image_dtype", "float32") != "float32":
        raise NotImplementedError(
            f"image_dtype={cfg.image_dtype!r}: the port stores float32 "
            "pyramids only")


def build_track_pyramids(img: torch.Tensor, cfg) -> TrackPyramids:
    """float image -> smooth -> pyramid -> per-level gradients.

    Reference parity: trackFeatures.py -> KLTTrackFeatures pyramid-build
    phase. ``img`` is a float32 [H, W] tensor on the device to build on.
    """
    _require_float32_images(cfg)
    taps = level_taps(cfg)
    n_levels = cfg.nPyramidLevels
    imgs, gxs, gys = [], [], []
    cur = img.to(torch.float32).contiguous()
    for level in range(n_levels):
        base, gx, gy, nxt = pyramid_level(cur, taps, smooth=level == 0,
                                          with_pyr=level < n_levels - 1)
        imgs.append(base)
        gxs.append(gx)
        gys.append(gy)
        cur = nxt
    return TrackPyramids(img=tuple(imgs), gradx=tuple(gxs), grady=tuple(gys))


def track_features_pyramids_carry(pyr1: TrackPyramids, pyr2: TrackPyramids,
                                  x: torch.Tensor, y: torch.Tensor,
                                  val: torch.Tensor, cfg, *, x_init=None,
                                  y_init=None, carry: TrackCarry | None = None):
    """Pyramidal LK over a feature batch given prebuilt pyramids, with the
    sequential window-carry signature of the JAX package.

    Returns (x, y, val, carry_out); lost features get (-1, -1, status).
    The port does not reuse carried windows yet: ``carry_out`` is None
    without a carry, else the carry with ``ok`` cleared, and results are
    identical either way.
    """
    if x_init is not None or y_init is not None:
        raise NotImplementedError("guided tracking (x_init/y_init) is not "
                                  "in the port yet")
    _require_float32_images(cfg)
    nrows, ncols = pyr1.img[0].shape
    s = float(cfg.subsampling)
    n_levels = cfg.nPyramidLevels

    live = val >= 0
    # a tensor divisor keeps CUDA from dividing by a reciprocal product
    scale = torch.full((), s ** n_levels, dtype=torch.float32,
                       device=x.device)
    xloc = x / scale
    yloc = y / scale
    xout, yout = xloc, yloc

    status = torch.full_like(val, KLT_TRACKED)
    # 'broken' freezes lanes that hit SMALL_DET / OOB at a coarser level
    # (the reference breaks out of the level loop for those two codes only).
    broken = torch.zeros_like(live)
    for r in range(n_levels - 1, -1, -1):
        xloc, yloc = xloc * s, yloc * s
        # lanes broken at a coarser level keep their break-level coords
        xout = torch.where(broken, xout, xout * s)
        yout = torch.where(broken, yout, yout * s)
        active = live & ~broken
        nx, ny, lvl_status, _ = lk_level(
            xloc, yloc, xout, yout,
            pyr1.img[r], pyr1.gradx[r], pyr1.grady[r],
            pyr2.img[r], pyr2.gradx[r], pyr2.grady[r], cfg, active)
        xout = torch.where(active, nx, xout)
        yout = torch.where(active, ny, yout)
        status = torch.where(active, lvl_status, status)
        broken = broken | (active & ((lvl_status == KLT_SMALL_DET) |
                                     (lvl_status == KLT_OOB)))

    # Final classification (reference: KLTTrackFeatures post-loop).
    out_of_view = ((xout < cfg.borderx) | (xout > ncols - 1 - cfg.borderx) |
                   (yout < cfg.bordery) | (yout > nrows - 1 - cfg.bordery))
    lost = (status != KLT_TRACKED) | out_of_view
    final_status = torch.where(
        status == KLT_OOB, KLT_OOB,
        torch.where(out_of_view, KLT_OOB, status))

    new_x = torch.where(live, torch.where(lost, -1.0, xout), x)
    new_y = torch.where(live, torch.where(lost, -1.0, yout), y)
    new_val = torch.where(live, final_status, val)
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
    (-1, -1, status).
    """
    nx, ny, nval, _ = track_features_pyramids_carry(
        pyr1, pyr2, x, y, val, cfg, x_init=x_init, y_init=y_init)
    return nx, ny, nval


def fb_reject(*args, **kwargs):
    """Forward-backward gate of the JAX package: not in the port yet."""
    raise NotImplementedError("fb_reject is not in the port yet")
