"""Gaussian / derivative-of-Gaussian kernel construction.

Reference parity: convolve.py -> _computeKernels / _KLTGetKernelWidths.

Semantics reproduced exactly (see SURVEY.md section 2.1 "Convolution /
kernels" row):

* kernels evaluated on an integer lattice ``i in [-hw, hw]`` with
  ``hw = MAX_KERNEL_WIDTH // 2``;
* ``gauss[i] = exp(-i^2 / (2 sigma^2))``, ``deriv[i] = -i * gauss[i]``;
* both are trimmed symmetrically: entries where
  ``|data[i]| / max < factor (= 0.01)`` are dropped from both ends
  (the max of the derivative kernel is ``sigma * exp(-0.5)``);
* the Gaussian is normalized to sum to 1; the derivative kernel is divided
  by ``-sum(i * deriv[i])`` so that convolving a unit ramp yields 1;
* an error is raised if the trimmed width reaches MAX_KERNEL_WIDTH.

Verbatim port of ``pyfeaturetrack_tpu/ops/kernels.py``: construction runs
in NumPy (float32 arithmetic to match the reference's C-float heritage),
so both packages get bit-identical taps.
"""

from __future__ import annotations

import functools

import numpy as np

from ..errors import KLTError

MAX_KERNEL_WIDTH = 71

_TRIM_FACTOR = 0.01


@functools.lru_cache(maxsize=64)
def compute_kernels(sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """Return (gauss, gaussderiv) as float32 1-D arrays of odd length.

    Reference parity: convolve.py -> _computeKernels.
    """
    sigma = float(sigma)
    if sigma <= 0.0:
        raise KLTError(f"(compute_kernels) sigma must be positive, got {sigma}")

    hw = MAX_KERNEL_WIDTH // 2
    i = np.arange(-hw, hw + 1, dtype=np.float64)
    gauss = np.exp(-(i * i) / (2.0 * sigma * sigma)).astype(np.float32)
    deriv = (-i.astype(np.float32)) * gauss

    max_gauss = np.float32(1.0)
    max_deriv = np.float32(sigma * np.exp(-0.5))

    # Trim tails: walk inward from the left edge while below threshold;
    # widths shrink by 2 per step (symmetric trim).
    def trimmed_width(data: np.ndarray, maxval: np.float32) -> int:
        width = MAX_KERNEL_WIDTH
        k = 0
        while k <= hw and abs(data[k] / maxval) < _TRIM_FACTOR:
            width -= 2
            k += 1
        return width

    gw = trimmed_width(gauss, max_gauss)
    dw = trimmed_width(deriv, max_deriv)
    if gw >= MAX_KERNEL_WIDTH or dw >= MAX_KERNEL_WIDTH:
        raise KLTError(
            f"(compute_kernels) MAX_KERNEL_WIDTH {MAX_KERNEL_WIDTH} is too "
            f"small for a sigma of {sigma}"
        )
    if gw <= 0 or dw <= 0:
        # tiny sigma: every off-center derivative tap falls below the trim
        # threshold (the center tap is exactly 0), leaving no kernel
        raise KLTError(
            f"(compute_kernels) sigma {sigma} too small: trimmed kernel "
            f"widths are (gauss={gw}, deriv={dw})")

    gauss = gauss[(MAX_KERNEL_WIDTH - gw) // 2: (MAX_KERNEL_WIDTH - gw) // 2 + gw].copy()
    deriv = deriv[(MAX_KERNEL_WIDTH - dw) // 2: (MAX_KERNEL_WIDTH - dw) // 2 + dw].copy()

    # Normalize: gauss sums to 1; deriv so a unit ramp has derivative 1.
    gauss /= np.float32(gauss.sum())
    dhw = dw // 2
    idx = np.arange(-dhw, dhw + 1, dtype=np.float32)
    deriv /= np.float32(-(idx * deriv).sum())

    gauss.setflags(write=False)
    deriv.setflags(write=False)
    return gauss, deriv


def get_kernel_widths(sigma: float) -> tuple[int, int]:
    """Return (gauss_width, gaussderiv_width) for ``sigma``.

    Reference parity: convolve.py -> _KLTGetKernelWidths.
    """
    gauss, deriv = compute_kernels(sigma)
    return gauss.shape[0], deriv.shape[0]
