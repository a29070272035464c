"""Sub-pixel corner refinement (beyond the reference).

Port of ``pyfeaturetrack_tpu/ops/refine.py``: the gradient-orthogonality
iteration (Foerstner / OpenCV ``cornerSubPix``). For the true corner q,
every gradient in a neighbourhood is orthogonal to (q - p), so q solves
[sum grad grad^T] q = sum (grad grad^T) p over the window around q.

``refine_corners`` is plain PyTorch (an XLA function in JAX, no kernel):
all features iterate together through a fixed-trip loop with per-lane
convergence and out-of-bounds masks, per-tap bilinear window gathers
(``interp.gather_window``, refine.py:67-69) and closed-form 2x2 solves;
no host read. ``refine_features_subpixel`` takes its gradients from K1
level 0 with ``smooth=cfg.smoothBeforeSelecting``, the images the
selection's min-eig map reads (ops/select.selection_eig_map), which are
the JAX package's ``compute_gradients(compute_smoothed_image(...))``.
"""

from __future__ import annotations

import torch

from ..features import FeatureState
from .convolve import to_float_image
from .cuda_pyramid import level_taps, pyramid_level
from .interp import gather_window, window_coords


def refine_corners(gradx: torch.Tensor, grady: torch.Tensor,
                   x: torch.Tensor, y: torch.Tensor, *, half_win: int = 5,
                   n_iters: int = 5, min_displacement: float = 0.01,
                   eps: float = 1e-6):
    """Refine corner positions to sub-pixel accuracy on gradient images.

    ``gradx``/``grady``: [H, W] gradients; ``x``/``y``: [N] starts.
    Returns refined (x, y); lanes whose window would leave the image or
    whose structure tensor is degenerate (|det| < eps) keep their input.
    Each iteration moves at most the window radius."""
    nrows, ncols = gradx.shape
    hw = half_win

    def in_bounds(xf, yf):
        # window + bilinear tap must fit (floor+1 read on the high side)
        return ((xf - hw >= 0.0) & (xf + hw + 1.001 <= ncols - 1) &
                (yf - hw >= 0.0) & (yf + hw + 1.001 <= nrows - 1))

    cx = x.to(torch.float32)
    cy = y.to(torch.float32)
    active = torch.ones(cx.shape, dtype=torch.bool, device=cx.device)
    for _ in range(n_iters):
        ok = active & in_bounds(cx, cy)
        gxw = gather_window(gradx, cx, cy, hw, hw)   # [N, w, w]
        gyw = gather_window(grady, cx, cy, hw, hw)
        xs, ys = window_coords(cx, cy, hw, hw)       # sample coords
        gxx = (gxw * gxw).sum(dim=(-2, -1))
        gxy = (gxw * gyw).sum(dim=(-2, -1))
        gyy = (gyw * gyw).sum(dim=(-2, -1))
        bx = ((gxw * gxw) * xs + (gxw * gyw) * ys).sum(dim=(-2, -1))
        by = ((gxw * gyw) * xs + (gyw * gyw) * ys).sum(dim=(-2, -1))
        det = gxx * gyy - gxy * gxy
        degenerate = det.abs() < eps
        safe = torch.where(degenerate, 1.0, det)
        qx = (gyy * bx - gxy * by) / safe
        qy = (gxx * by - gxy * bx) / safe
        dx = (qx - cx).clamp(-float(hw), float(hw))
        dy = (qy - cy).clamp(-float(hw), float(hw))
        upd = ok & ~degenerate
        cx = torch.where(upd, cx + dx, cx)
        cy = torch.where(upd, cy + dy, cy)
        moving = (dx.abs() >= min_displacement) | (dy.abs() >= min_displacement)
        active = upd & moving
    return cx, cy


def refine_features_subpixel(img, fl: FeatureState, cfg, *, half_win: int = 5,
                             n_iters: int = 5) -> FeatureState:
    """Sub-pixel-refine a selected FeatureState against ``img`` (an array
    or tensor, taken to the features' device): every live feature
    (val >= 0) moves to its sub-pixel corner, dead lanes pass through."""
    fimg = to_float_image(img, fl.x.device)
    _, gradx, grady, _ = pyramid_level(
        fimg, level_taps(cfg), smooth=bool(cfg.smoothBeforeSelecting),
        with_pyr=False)
    rx, ry = refine_corners(gradx, grady, fl.x, fl.y, half_win=half_win,
                            n_iters=n_iters)
    live = fl.val >= 0
    return fl._replace(x=torch.where(live, rx, fl.x),
                       y=torch.where(live, ry, fl.y))
