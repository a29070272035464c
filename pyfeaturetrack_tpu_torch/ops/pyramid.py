"""Pyramid decimation (reference parity: pyramid.py -> _KLTComputePyramid).

Port of the decimation of ``pyfeaturetrack_tpu/ops/pyramid.py``: each
coarser level samples the smoothed previous level at
``(subsampling*y + subsampling//2, subsampling*x + subsampling//2)`` and
has dims ``prev // subsampling`` (floor). The smoothing and the level
loop are K1 (ops/cuda_pyramid.py) and ops/track.build_track_pyramids.
"""

from __future__ import annotations

import torch


def decimate(smoothed: torch.Tensor, subsampling: int) -> torch.Tensor:
    """``smoothed[subhalf::sub, subhalf::sub][:h//sub, :w//sub]``
    (pyramid.py:43-51 of the JAX package)."""
    sub = int(subsampling)
    subhalf = sub // 2
    h, w = smoothed.shape[-2] // sub, smoothed.shape[-1] // sub
    return smoothed[..., subhalf::sub, subhalf::sub][..., :h, :w].contiguous()
