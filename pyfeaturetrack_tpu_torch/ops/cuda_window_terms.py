"""K9: one LK iteration's window terms for a feature batch
(csrc/window_terms.cu) and its plain version.

Port of ``pyfeaturetrack_tpu/ops/pallas_lk.py`` (binned_window_terms):
per feature, the position clamped to [hw, W - hw - 1.001] x
[hh, H - hh - 1.001] (pallas_lk.py:166-167), the bilinear frame-2 windows
of img2, gx2 and gy2 there, diff = w1 - w2, gx = g1x + g2x, gy = g1y + g2y,
and (gxx, gxy, gyy, ex, ey) with ex and ey scaled by ``step_factor``. The
TPU kernel's row-slab binning, its sort and inverse permutation, and its
width >= 256, % 128 limit exist for Mosaic only and are not ported.

No path of either package calls it (the JAX package's LK level computes
these terms inside K2 / track_feature_level); it is held to the TPU kernel
and to ``xla_window_terms`` on the CPU and to its plain version on the
card. A CUDA tensor launches the kernel; a CPU tensor takes the plain
version, whose sums are ``tree_sum``, the kernel's warp order.
"""

from __future__ import annotations

import torch

from ..utils import cuda
from .cuda_lk import _f32, tree_sum
from .interp import gather_windows

# Kernel launches made by this wrapper.
launches = 0


def _clamp_bounds(shape, hw: int, hh: int):
    """The float32 upper clamp bounds W - hw - 1.001 and H - hh - 1.001
    (Python floats rounded once to float32, as JAX's weak types are)."""
    h, w = shape
    return _f32(w - hw - 1.001), _f32(h - hh - 1.001)


@cuda.plain_version
def window_terms_reference(img2, gx2, gy2, w1, g1x, g1y, x2, y2, *, hw: int,
                           hh: int, step_factor: float) -> torch.Tensor:
    """Plain version of K9: [N, 5] float32 (gxx, gxy, gyy, ex, ey)."""
    n = x2.shape[0]
    x_hi, y_hi = _clamp_bounds(img2.shape, hw, hh)
    xs = x2.clamp(min=float(hw), max=x_hi)
    ys = y2.clamp(min=float(hh), max=y_hi)
    w2, g2x, g2y = (t.reshape(n, -1) for t in
                    gather_windows((img2, gx2, gy2), xs, ys, hw, hh))
    dif = w1.reshape(n, -1) - w2
    gx = g1x.reshape(n, -1) + g2x
    gy = g1y.reshape(n, -1) + g2y
    step = _f32(step_factor)
    return torch.stack([tree_sum(gx * gx), tree_sum(gx * gy),
                        tree_sum(gy * gy), step * tree_sum(dif * gx),
                        step * tree_sum(dif * gy)], dim=-1)


def _launch(img2, gx2, gy2, w1, g1x, g1y, x2, y2, *, hw: int, hh: int,
            step_factor: float) -> torch.Tensor:
    """One pft_window_terms launch (none for an empty batch): [N, 5]."""
    global launches
    n = x2.shape[0]
    out = torch.empty((n, 5), dtype=torch.float32, device=x2.device)
    if n:
        x_hi, y_hi = _clamp_bounds(img2.shape, hw, hh)
        fn = cuda.function("pft_window_terms",
                           [cuda.c_ptr] * 8 + [cuda.c_int] * 5
                           + [cuda.c_float] * 3 + [cuda.c_ptr] * 2)
        rc = fn(*(t.data_ptr() for t in (img2, gx2, gy2, w1, g1x, g1y, x2,
                                          y2)),
                img2.shape[0], img2.shape[1], n, 2 * hw + 1, 2 * hh + 1,
                _f32(step_factor), x_hi, y_hi, out.data_ptr(),
                cuda.stream_ptr(x2.device))
        cuda.check(rc, "pft_window_terms")
        launches += 1
    return out


def window_terms(img2, gx2, gy2, w1, g1x, g1y, x2, y2, *, hw: int, hh: int,
                 step_factor: float) -> torch.Tensor:
    """One LK iteration's (gxx, gxy, gyy, ex, ey) per feature, [N, 5].

    ``img2``/``gx2``/``gy2``: float32 [H, W] frame-2 level images;
    ``w1``/``g1x``/``g1y``: float32 [N, 2hh+1, 2hw+1] frame-1 windows;
    ``x2``/``y2``: float32 [N] frame-2 positions (clamped into the image).
    One launch on CUDA, differentiable through the plain version's VJP."""
    feats = (w1, g1x, g1y, x2, y2)
    imgs = (img2, gx2, gy2)
    if not cuda.use_kernel(*imgs, *feats):
        return window_terms_reference(img2, gx2, gy2, w1, g1x, g1y, x2, y2,
                                      hw=hw, hh=hh, step_factor=step_factor)
    ww, wh = 2 * hw + 1, 2 * hh + 1
    n = x2.shape[0]
    cuda.require(all(t.dtype == torch.float32 and t.is_contiguous()
                     for t in imgs + feats)
                 and img2.dim() == 2
                 and all(t.shape == img2.shape for t in imgs)
                 and all(t.shape == (n, wh, ww) for t in feats[:3])
                 and all(t.shape == (n,) for t in feats[3:]),
                 "window_terms takes contiguous float32 [H, W] images, "
                 "[N, wh, ww] windows and [N] positions")

    def launch(*ts):
        return (_launch(*ts, hw=hw, hh=hh, step_factor=step_factor),)

    def plain(*ts):
        return (window_terms_reference(*ts, hw=hw, hh=hh,
                                       step_factor=step_factor),)

    return cuda.with_plain_vjp(launch, plain, *imgs, *feats)[0]
