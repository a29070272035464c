"""Dense rectified-stereo disparity: the tracker's 1-D LK at every pixel.

Port of ``pyfeaturetrack_tpu/ops/disparity.py``. Conventions of the JAX
package: disparity d = x_L - x_R >= 0, the right-image window sits at
(x - d, y), metric depth z = fx * baseline / d. Each level is the 1-D
specialization of the tracker's level solve (K8's one-d mode,
ops/cuda_lk_dense.dense_level_1d); the coarsest level is seeded by an
integer-shift SSD sweep (``_hypothesis_init``, plain PyTorch, as it is
plain XLA in JAX); the left-right gate reuses the horizontal-flip trick
(``dense_disparity_lr``). ``lighting_insensitive`` is ignored, as on the
JAX package's default (XLA) route.

The entry points take numpy arrays or tensors: arrays run on "cuda"
unless ``device="cpu"`` is given (with no CUDA device that raises),
tensors on their own device. ``dense_depth`` ends on the host, as the
JAX package's does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..features import KLT_TRACKED
from .cuda_lk_dense import dense_level_1d, dense_level_1d_up
from .flow import level_images, run_level_steps
from .track import TrackPyramids, as_frame, build_track_pyramids


class DenseDisparity(NamedTuple):
    """Per-pixel disparity map + KLT status map for one rectified pair."""
    d: torch.Tensor       # [H, W] float32, disparity x_L - x_R (>= 0 valid)
    status: torch.Tensor  # [H, W] int32, KLT status codes


def _box_sum(a: torch.Tensor, hw: int, hh: int) -> torch.Tensor:
    """Zero-padded window sum over (2hh+1, 2hw+1) boxes, same shape: a
    float32 integral image, as in the JAX package (disparity.py:53-59).
    Its cumulative sums round in the order of the device's ``cumsum``,
    which need not be XLA's, so two nearly tied SSDs can swap."""
    pad = F.pad(a, (hw + 1, hw, hh + 1, hh))
    c = torch.cumsum(torch.cumsum(pad, dim=0), dim=1)
    wh, ww = 2 * hh + 1, 2 * hw + 1
    return c[wh:, ww:] - c[:-wh, ww:] - c[wh:, :-ww] + c[:-wh, :-ww]


def _hypothesis_init(img1: torch.Tensor, img2: torch.Tensor,
                     hypotheses: tuple[int, ...], hw: int,
                     hh: int) -> torch.Tensor:
    """Integer-disparity SSD sweep: per candidate shift h the window-summed
    (img1[y, x] - img2[y, x - h])^2; returns the per-pixel argmin (first
    on ties) as a float32 disparity map. Centres whose shifted window
    leaves the right image are priced out."""
    _, w_img = img1.shape
    xs = torch.arange(w_img, dtype=torch.float32, device=img1.device)[None, :]
    big = 3.4e38
    ssds = []
    for h in hypotheses:
        shifted = F.pad(img2, (h, 0))[:, :w_img]
        ssd = _box_sum((img1 - shifted) ** 2, hw, hh)
        ssds.append(ssd + torch.where(xs < h + hw, big, 0.0))
    best = torch.argmin(torch.stack(ssds), dim=0)
    # index -> disparity by selects: no host-to-device copy of the table
    d = torch.zeros(best.shape, dtype=torch.float32, device=best.device)
    for k, h in enumerate(hypotheses):
        d = torch.where(best == k, float(h), d)
    return d


def disparity_level(img1, gx1, gy1, img2, gx2, gy2, d, cfg):
    """One pyramid level of dense 1-D LK: refine the disparity map ``d``
    (right-image window at (x - d, y)). Returns (d, status) maps. K8's
    one-d mode on CUDA tensors, its plain version on CPU ones."""
    d, status, _ = dense_level_1d(img1, gx1, gy1, img2, gx2, gy2, d, cfg)
    return d, status


def dense_disparity_pyramids(pyr_l: TrackPyramids, pyr_r: TrackPyramids,
                             cfg, max_disparity: float = 64.0,
                             hypothesis_stride: int | None = None
                             ) -> DenseDisparity:
    """Coarse-to-fine dense disparity over prebuilt pyramids. The coarsest
    level seeds from the SSD hypothesis sweep; each finer level refines the
    upsampled map (K8 reads the coarser map and upsamples it itself). The
    status map is the finest level's."""
    return run_level_steps(disparity_level_steps(
        pyr_l, pyr_r, cfg, max_disparity, hypothesis_stride))


def disparity_level_steps(pyr_l: TrackPyramids, pyr_r: TrackPyramids, cfg,
                          max_disparity: float = 64.0,
                          hypothesis_stride: int | None = None, rows=None):
    """``dense_disparity_pyramids``'s level loop as a generator (the
    contract of ``flow.flow_level_steps``): per level it yields (d,
    status) and is sent back the level's whole maps; ``rows`` solves one
    band of each level. The SSD seed is always the WHOLE coarsest level's:
    its float32 integral image rounds in row order from row 0, so a band's
    own sums would give other bits than the whole map's."""
    s = float(cfg.subsampling)
    n_levels = cfg.nPyramidLevels
    hw, hh = cfg.window_width // 2, cfg.window_height // 2
    if hypothesis_stride is None:
        hypothesis_stride = hw + 1
    coarse_l = pyr_l.img[n_levels - 1]
    max_d_coarse = int(max_disparity / s ** (n_levels - 1))
    hypotheses = tuple(range(0, max_d_coarse + 1, int(hypothesis_stride)))
    if len(hypotheses) > 1:
        d = _hypothesis_init(coarse_l, pyr_r.img[n_levels - 1], hypotheses,
                             hw, hh)
    else:
        d = torch.zeros(coarse_l.shape, dtype=torch.float32,
                        device=coarse_l.device)
    status = None
    for r in range(n_levels - 1, -1, -1):
        lvl = level_images(pyr_l, pyr_r, r)
        band = None if rows is None else rows(int(lvl[0].shape[0]))
        if tuple(lvl[0].shape) == tuple(d.shape):
            out = dense_level_1d(*lvl, d, cfg, band=band)
        else:
            out = dense_level_1d_up(*lvl, d, s, cfg, band=band)
        d, status = yield out[:2]
    return DenseDisparity(d=d, status=status)


def _config(cfg):
    from ..config import create_config
    return (cfg or create_config()).validated_window()


def dense_disparity(left, right, cfg=None, max_disparity: float = 64.0,
                    device=None) -> DenseDisparity:
    """High-level entry: dense disparity map for one rectified pair."""
    cfg = _config(cfg)
    li = as_frame(left, device)
    p_l = build_track_pyramids(li, cfg)
    p_r = build_track_pyramids(as_frame(right, li.device), cfg)
    return dense_disparity_pyramids(p_l, p_r, cfg,
                                    max_disparity=float(max_disparity))


def disparity_lr_consistency(dl: DenseDisparity, dr: DenseDisparity,
                             max_err: float = 1.0,
                             min_disparity: float = 0.25,
                             max_disparity: float = 64.0):
    """Left-right consistency gate. ``dr`` is the right-reference map in
    right-image coordinates. err(p) = |d_L(p) - d_R(p - d_L(p))|; valid
    needs both statuses TRACKED at the linked pixels, err <= max_err and
    d_L within [min, max] disparity. Returns (err, valid) [H, W]."""
    h, w = dl.d.shape
    lx = torch.round(torch.arange(w, dtype=dl.d.dtype,
                                  device=dl.d.device)[None, :]
                     - dl.d).clamp(0, w - 1).long()
    ly = torch.arange(h, device=dl.d.device)[:, None].expand(h, w)
    err = (dl.d - dr.d[ly, lx]).abs()
    valid = ((dl.status == KLT_TRACKED) & (dr.status[ly, lx] == 0) &
             (err <= max_err) & (dl.d >= min_disparity) &
             (dl.d <= max_disparity))
    return err, valid


def dense_disparity_lr(left, right, cfg=None, max_disparity: float = 64.0,
                       max_err: float = 1.0, device=None):
    """Dense disparity with the left-right occlusion gate: (left-reference
    DenseDisparity, LR error map, valid mask). The right-reference pass runs
    on horizontally flipped images (matching right -> left is then again a
    positive-disparity problem)."""
    cfg = _config(cfg)
    li = as_frame(left, device)
    ri = as_frame(right, li.device)
    dl = dense_disparity_pyramids(build_track_pyramids(li, cfg),
                                  build_track_pyramids(ri, cfg), cfg,
                                  max_disparity=float(max_disparity))
    drf = dense_disparity_pyramids(
        build_track_pyramids(torch.fliplr(ri).contiguous(), cfg),
        build_track_pyramids(torch.fliplr(li).contiguous(), cfg), cfg,
        max_disparity=float(max_disparity))
    dr = DenseDisparity(d=torch.fliplr(drf.d), status=torch.fliplr(drf.status))
    err, valid = disparity_lr_consistency(dl, dr, max_err=max_err,
                                          max_disparity=max_disparity)
    return dl, err, valid


def dense_depth(left, right, K, baseline: float, cfg=None,
                max_disparity: float = 64.0, max_err: float = 1.0,
                device=None):
    """Metric dense depth map from one rectified pair: (depth [H, W]
    float32 with invalid pixels at 0, disparity map, valid mask), numpy
    arrays on the host. z = fx * baseline / d."""
    dl, _, valid = dense_disparity_lr(left, right, cfg,
                                      max_disparity=max_disparity,
                                      max_err=max_err, device=device)
    d = dl.d.cpu().numpy()
    v = valid.cpu().numpy()
    fx = float(np.asarray(K)[0, 0])
    depth = np.where(v, fx * float(baseline) / np.maximum(d, 1e-9),
                     0.0).astype(np.float32)
    return depth, d, v
