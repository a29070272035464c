"""Separable convolution, smoothing, and gradients (plain PyTorch).

Reference parity: convolve.py -> _convolveImageHoriz / _convolveImageVert /
_convolveSeparate / _KLTComputeSmoothedImage / _KLTComputeGradients; port
of ``pyfeaturetrack_tpu/ops/convolve.py``.

Semantics reproduced exactly:

* true convolution (kernel flipped relative to cross-correlation);
* output border of ``kernel_width // 2`` pixels is ZEROED on each side along
  the convolved axis, and a pass over an extent ``<= 2 * radius`` is all
  zero;
* separable order is horizontal first, then vertical;
* gradx = conv(img, deriv_x (x) gauss_y), grady = conv(img, gauss_x (x) deriv_y).

Each pass is an explicit shift-and-add in ascending tap order (the order
of the K1 kernel, csrc/pyramid.cu), never ``F.conv2d``: that keeps cuDNN's
TF32 default out of every parity path and makes the plain version and the
kernel agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import compute_kernels


def _conv1d(img: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Convolve the last-two-dims image along ``axis`` (0 = rows/vertical,
    1 = cols/horizontal) with zeroed borders."""
    krev = np.asarray(kernel, dtype=np.float32)[::-1]
    r = krev.shape[0] // 2
    dim = img.dim() - 2 + axis
    n = img.shape[dim]
    out = torch.zeros_like(img)
    if 2 * r >= n:
        return out
    m = n - 2 * r
    acc = float(krev[0]) * img.narrow(dim, 0, m)
    for t in range(1, 2 * r + 1):
        acc = acc + float(krev[t]) * img.narrow(dim, t, m)
    out.narrow(dim, r, m).copy_(acc)
    return out


def convolve_horiz(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Reference parity: convolve.py -> _convolveImageHoriz."""
    return _conv1d(img, kernel, axis=1)


def convolve_vert(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Reference parity: convolve.py -> _convolveImageVert."""
    return _conv1d(img, kernel, axis=0)


def convolve_separate(img: torch.Tensor, horiz_kernel: np.ndarray,
                      vert_kernel: np.ndarray) -> torch.Tensor:
    """Horizontal pass then vertical pass.

    Reference parity: convolve.py -> _convolveSeparate.
    """
    return convolve_vert(convolve_horiz(img, horiz_kernel), vert_kernel)


def compute_smoothed_image(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian smoothing with the trimmed kernel for ``sigma``.

    Reference parity: convolve.py -> _KLTComputeSmoothedImage.
    """
    gauss, _ = compute_kernels(float(sigma))
    return convolve_separate(img, gauss, gauss)


def to_float_image(img, device=None) -> torch.Tensor:
    """uint8 / any image -> contiguous float32 [H, W] tensor (values
    preserved, 0..255 scale). A tensor goes to ``device`` (default: its
    own), an array to ``device`` (default "cuda"; with no CUDA device that
    raises); a uint8 array crosses as bytes and is cast there.

    Reference parity: klt_util.py -> _KLTToFloatImage.
    """
    if isinstance(img, torch.Tensor):
        dev = torch.device(device) if device is not None else img.device
        return img.to(device=dev, dtype=torch.float32).contiguous()
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device")
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float32)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # e.g. a frame read from a buffer
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev).to(torch.float32)


def compute_gradients(img: torch.Tensor, sigma: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Derivative-of-Gaussian gradient pair (gradx, grady).

    Reference parity: convolve.py -> _KLTComputeGradients.
    """
    gauss, deriv = compute_kernels(float(sigma))
    return (convolve_separate(img, deriv, gauss),
            convolve_separate(img, gauss, deriv))
