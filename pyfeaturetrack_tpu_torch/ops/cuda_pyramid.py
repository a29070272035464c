"""K1: fused pyramid-level build (csrc/pyramid.cu) and its plain version.

Port of ``pyfeaturetrack_tpu/ops/pallas_pyramid.py`` (fused_level_build /
fused_level_build_tiled, driven by build_track_pyramids_pallas). One call
builds one pyramid level: the optional level-0 pre-smooth, the gradient
pair of the level's base image, and, for every level but the last, the
decimated pyramid-smoothed image that is the next level's base.

A CUDA tensor launches the kernel (two launches at level 0, one at every
later level); a CPU tensor takes ``pyramid_level_reference``, which
composes ops/convolve.py's shift-and-add passes in the kernel's order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import cuda
from .convolve import convolve_separate
from .kernels import compute_kernels
from .pyramid import decimate

# Kernel launches made by this wrapper (one per launch; see module doc).
launches = 0


class LevelTaps(NamedTuple):
    """The 1-D taps of a pyramid build (float32, unflipped) and their
    flipped copies, which the kernel takes (read-only: they are cached)."""
    smooth: np.ndarray      # level-0 pre-smooth gauss (smooth_sigma)
    grad_g: np.ndarray      # gradient gauss (grad_sigma)
    grad_d: np.ndarray      # gradient deriv (grad_sigma)
    pyr: np.ndarray         # pyramid smoothing gauss (sub * sigma_fact)
    subsampling: int
    rev: tuple              # (smooth, grad_g, grad_d, pyr), each k[::-1]


def _frozen(k: np.ndarray) -> np.ndarray:
    k = np.ascontiguousarray(k, np.float32)
    k.setflags(write=False)
    return k


@functools.lru_cache(maxsize=32)
def _taps(smooth_sigma: float, grad_sigma: float, pyr_sigma: float,
          subsampling: int) -> LevelTaps:
    smooth, _ = compute_kernels(smooth_sigma)
    grad_g, grad_d = compute_kernels(grad_sigma)
    pyr, _ = compute_kernels(pyr_sigma)
    fwd = tuple(_frozen(k) for k in (smooth, grad_g, grad_d, pyr))
    return LevelTaps(*fwd, subsampling, tuple(_frozen(k[::-1]) for k in fwd))


def level_taps(cfg) -> LevelTaps:
    """The taps of ``cfg``'s pyramid build, made once per distinct set of
    sigmas (a frame step builds no taps)."""
    return _taps(float(cfg.smooth_sigma), float(cfg.grad_sigma),
                 float(cfg.pyramid_sigma_fact * cfg.subsampling),
                 int(cfg.subsampling))


def pyramid_level_reference(img: torch.Tensor, taps: LevelTaps,
                            smooth: bool, with_pyr: bool):
    """Plain version of one K1 level. Returns (base, gradx, grady, next)
    with ``next`` None when ``with_pyr`` is False."""
    base = img
    if smooth:
        base = convolve_separate(img, taps.smooth, taps.smooth)
    gx = convolve_separate(base, taps.grad_d, taps.grad_g)
    gy = convolve_separate(base, taps.grad_g, taps.grad_d)
    nxt = None
    if with_pyr:
        nxt = decimate(convolve_separate(base, taps.pyr, taps.pyr),
                       taps.subsampling)
    return base, gx, gy, nxt


def _launch_smooth(img, out, krev):
    global launches
    fn = cuda.function("pft_pyramid_smooth", [cuda.c_ptr, cuda.c_ptr, cuda.c_int,
                                              cuda.c_int, cuda.c_ptr, cuda.c_int,
                                              cuda.c_ptr])
    h, w = img.shape
    rc = fn(img.data_ptr(), out.data_ptr(), h, w, krev.ctypes.data, krev.shape[0],
            cuda.stream_ptr(img.device))
    cuda.check(rc, "pft_pyramid_smooth")
    launches += 1


def _launch_level(base, gx, gy, dec, g, d, p, sub, h2, w2):
    global launches
    fn = cuda.function("pft_pyramid_level",
                       [cuda.c_ptr] * 4 + [cuda.c_int] * 2
                       + [cuda.c_ptr, cuda.c_int] * 3
                       + [cuda.c_int] * 3 + [cuda.c_ptr])
    h, w = base.shape
    rc = fn(base.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            dec.data_ptr() if dec is not None else None, h, w,
            g.ctypes.data, g.shape[0], d.ctypes.data, d.shape[0],
            p.ctypes.data if p is not None else None,
            p.shape[0] if p is not None else 0,
            sub, h2, w2, cuda.stream_ptr(base.device))
    cuda.check(rc, "pft_pyramid_level")
    launches += 1


def pyramid_level(img: torch.Tensor, taps: LevelTaps, smooth: bool,
                  with_pyr: bool):
    """One pyramid level: (base, gradx, grady, next-or-None).

    ``img``: float32 [H, W]. ``smooth``: apply the level-0 pre-smooth
    (base = smoothed img, else base = img). ``with_pyr``: also produce the
    next level's decimated base.
    """
    if not cuda.use_kernel(img):
        return pyramid_level_reference(img, taps, smooth, with_pyr)
    cuda.require(img.dtype == torch.float32 and img.dim() == 2
                 and img.is_contiguous() and img.numel() > 0,
                 "pyramid_level takes a non-empty contiguous float32 [H, W] "
                 "image")
    h, w = img.shape
    base = img
    if smooth:
        base = torch.empty_like(img)
        _launch_smooth(img, base, taps.rev[0])
    gx = torch.empty_like(img)
    gy = torch.empty_like(img)
    sub = taps.subsampling
    dec: Optional[torch.Tensor] = None
    if with_pyr:
        dec = torch.empty((h // sub, w // sub), dtype=torch.float32,
                          device=img.device)
    _launch_level(base, gx, gy, dec, taps.rev[1], taps.rev[2],
                  taps.rev[3] if with_pyr else None, sub, h // sub, w // sub)
    return base, gx, gy, dec
