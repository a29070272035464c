"""Shi-Tomasi (min-eigenvalue) map for feature selection (plain PyTorch).

Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures hot
loop; port of ``compute_min_eig_map`` / ``_EIG_LIMIT`` of
``pyfeaturetrack_tpu/ops/select.py``; its ``quantized_min_eig_map`` is K3,
``ops/cuda_eig.min_eig_map``. The host greedy
selection (``select_good_features`` through ``native/``) is not in the
port yet; the device-resident selection is ops/select_device.py.

The window sums are explicit shifted adds, rows then columns, in
ascending tap order: the order of the K3 kernel (csrc/eig.cu) and of the
JAX package's Pallas eig kernel. Every selection in the port ranks by
these values (a +-1 change in quantization reorders candidates).
"""

from __future__ import annotations

import torch

# Largest float32 strictly below 2^31: the float->int32 cast then
# saturates like the reference's int clamp instead of overflowing.
_EIG_LIMIT = 2147483520.0


def _window_sum(img: torch.Tensor, window_height: int,
                window_width: int) -> torch.Tensor:
    """Box-filter sum over fully interior windows, zero elsewhere (the
    oracle writes results only for fully-interior windows)."""
    h, w = img.shape
    hh, hw = window_height // 2, window_width // 2
    out = torch.zeros_like(img)
    mh, mw = h - window_height + 1, w - window_width + 1
    if mh <= 0 or mw <= 0:
        return out
    v = img[0:mh, :]
    for k in range(1, window_height):
        v = v + img[k:k + mh, :]
    s = v[:, 0:mw]
    for k in range(1, window_width):
        s = s + v[:, k:k + mw]
    out[hh:hh + mh, hw:hw + mw] = s
    return out


def compute_min_eig_map(gradx: torch.Tensor, grady: torch.Tensor,
                        window_width: int, window_height: int) -> torch.Tensor:
    """Per-pixel min eigenvalue of the windowed structure tensor (float32,
    zero border)."""
    gxx = _window_sum(gradx * gradx, window_height, window_width)
    gxy = _window_sum(gradx * grady, window_height, window_width)
    gyy = _window_sum(grady * grady, window_height, window_width)
    disc = torch.sqrt((gxx - gyy) * (gxx - gyy) + 4.0 * gxy * gxy)
    return ((gxx + gyy) - disc) * 0.5

