"""Image pyramid: per level, smooth then decimate with half-stride offset.

Reference parity: pyramid.py -> _KLTComputePyramid; port of
``pyfeaturetrack_tpu/ops/pyramid.py``:

* level 0 is the input image itself (no pre-smooth);
* each coarser level smooths the previous one with ``sigma = subsampling
  * sigma_fact`` and samples it at ``(subsampling*y + subsampling//2,
  subsampling*x + subsampling//2)``; its dims are ``prev // subsampling``
  (floor).

The op-level entries run K1's level launch (ops/cuda_pyramid.pyramid_level,
``smooth=False``) on a CUDA tensor and its plain version (ops/convolve.py's
shift-and-add passes, the same taps in the same order) on a CPU tensor.
The tracker's own build, with the pre-smooth and every gradient pair in at
most two launches, is ops/track.build_track_pyramids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .convolve import to_float_image


class Pyramid(NamedTuple):
    """Multi-level image pyramid. ``levels[0]`` is full resolution."""
    levels: tuple
    subsampling: int

    @property
    def nLevels(self) -> int:
        return len(self.levels)


def decimate(smoothed: torch.Tensor, subsampling: int) -> torch.Tensor:
    """``smoothed[subhalf::sub, subhalf::sub][:h//sub, :w//sub]``
    (pyramid.py:43-51 of the JAX package)."""
    sub = int(subsampling)
    subhalf = sub // 2
    h, w = smoothed.shape[-2] // sub, smoothed.shape[-1] // sub
    return smoothed[..., subhalf::sub, subhalf::sub][..., :h, :w].contiguous()


def compute_pyramid(img, subsampling: int, nlevels: int,
                    sigma_fact: float) -> Pyramid:
    """Build an ``nlevels``-deep pyramid of the float32 [H, W] ``img``.

    Reference parity: pyramid.py -> _KLTComputePyramid. Each coarser level
    is one K1 level launch on the level above (``pyramid_level`` with no
    pre-smooth: its decimated output; the launch's gradient pair is not
    kept). A numpy image goes to the card."""
    from .cuda_pyramid import pyramid_level, sigma_taps
    sub = int(subsampling)
    taps = sigma_taps(pyr_sigma=sub * float(sigma_fact), subsampling=sub)
    cur = to_float_image(img)
    levels = [cur]
    for _ in range(1, int(nlevels)):
        if cur.numel() == 0:
            cur = cur.new_zeros((cur.shape[0] // sub, cur.shape[1] // sub))
        else:
            cur = pyramid_level(cur, taps, smooth=False, with_pyr=True)[3]
        levels.append(cur)
    return Pyramid(levels=tuple(levels), subsampling=sub)


def compute_gradient_pyramids(pyr: Pyramid, grad_sigma: float
                              ) -> tuple[Pyramid, Pyramid]:
    """Per-level derivative-of-Gaussian gradients (gradx, grady) pyramids.

    Reference parity: trackFeatures.py -> KLTTrackFeatures pyramid-build
    phase (per-level _KLTComputeGradients calls). Each level's pair is one
    K1 level launch (``pyramid_level`` with neither pre-smooth nor
    decimation)."""
    from .cuda_pyramid import pyramid_level, sigma_taps
    taps = sigma_taps(grad_sigma=float(grad_sigma),
                      subsampling=pyr.subsampling)
    gxs, gys = [], []
    for level in pyr.levels:
        level = to_float_image(level)
        if level.numel() == 0:
            gx, gy = torch.zeros_like(level), torch.zeros_like(level)
        else:
            _, gx, gy, _ = pyramid_level(level, taps, smooth=False,
                                         with_pyr=False)
        gxs.append(gx)
        gys.append(gy)
    return (Pyramid(tuple(gxs), pyr.subsampling),
            Pyramid(tuple(gys), pyr.subsampling))
