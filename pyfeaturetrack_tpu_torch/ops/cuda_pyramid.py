"""K1: the pyramid build (csrc/pyramid.cu) and its plain versions.

Port of ``pyfeaturetrack_tpu/ops/pallas_pyramid.py`` (fused_level_build /
fused_level_build_tiled, driven by build_track_pyramids_pallas).

* ``pyramid_build``: a whole pyramid (the level-0 pre-smooth, every
  level's gradient pair, every decimated level) in at most two launches.
  Its plain version, ``pyramid_build_reference``, composes
  ``pyramid_level_reference`` over the levels.
  Asked for a window, its level-0 launch also returns K3's quantized
  min-eig map of level 0's gradients (csrc/eig_common.cuh); plain version
  ``min_eig_reference`` of the plain build's gradients.
* ``pyramid_level``: one level (the optional pre-smooth, the gradient pair
  and, for every level but the last, the decimated pyramid-smoothed image
  that is the next level's base) in one launch; plain version
  ``pyramid_level_reference``, which composes ops/convolve.py's
  shift-and-add passes in the kernel's order.
* ``level0_eig``: K3's map of a frame's level-0 gradients (with or without
  the pre-smooth) in one launch that writes nothing else; plain version
  ``level0_eig_reference``.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import cuda
from .convolve import convolve_separate
from .cuda_eig import min_eig_reference
from .kernels import compute_kernels
from .pyramid import decimate

# Kernel launches made by this module's wrappers (one per launch), and of
# those the level-0 launches that computed K3's map.
launches = 0
eig_launches = 0


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


@cuda.plain_version
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


@cuda.plain_version
def pyramid_build_reference(img: torch.Tensor, taps: LevelTaps,
                            n_levels: int):
    """Plain version of ``pyramid_build``: ``pyramid_level_reference``
    composed over the levels (pre-smooth at level 0 only)."""
    imgs, gxs, gys = [], [], []
    cur = img
    for level in range(n_levels):
        base, gx, gy, cur = pyramid_level_reference(
            cur, taps, smooth=level == 0, with_pyr=level < n_levels - 1)
        imgs.append(base)
        gxs.append(gx)
        gys.append(gy)
    return tuple(imgs), tuple(gxs), tuple(gys)


@cuda.plain_version
def level0_eig_reference(img: torch.Tensor, taps: LevelTaps, smooth: bool,
                         window_width: int,
                         window_height: int) -> torch.Tensor:
    """Plain version of ``level0_eig``: the level's gradient pair, then
    ``min_eig_reference``."""
    _, gx, gy, _ = pyramid_level_reference(img, taps, smooth, False)
    return min_eig_reference(gx, gy, window_width, window_height)


def _c_taps(taps: LevelTaps, smooth: bool, with_pyr: bool):
    """(pointer, count) of each flipped tap set the C entries take, with
    (None, 0) for a pass the launch does not run."""
    out = []
    for k, used in zip(taps.rev, (smooth, True, True, with_pyr)):
        out += [k.ctypes.data, k.shape[0]] if used else [None, 0]
    return out


_TAP_ARGS = [cuda.c_ptr, cuda.c_int] * 4

# Per (device, stream): the two-word grid-barrier state of
# pft_pyramid_build's coarse launch (zeroed once, left zero by every build).
_barriers: dict = {}


def _barrier(dev: torch.device) -> torch.Tensor:
    key = (dev.index, cuda.stream_ptr(dev))
    bar = _barriers.get(key)
    if bar is None:
        bar = _barriers[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return bar


def _require_image(img: torch.Tensor, what: str) -> None:
    cuda.require(img.dtype == torch.float32 and img.dim() == 2
                 and img.is_contiguous() and img.numel() > 0,
                 f"{what} takes a non-empty contiguous float32 [H, W] image")


def _launch_level(img: torch.Tensor, taps: LevelTaps, smooth: bool,
                  with_pyr: bool):
    """One K1 level launch: (base, gradx, grady, next-or-None)."""
    global launches
    h, w = img.shape
    sub = taps.subsampling
    base = torch.empty_like(img) if smooth else img
    gx = torch.empty_like(img)
    gy = torch.empty_like(img)
    dec: Optional[torch.Tensor] = None
    if with_pyr:
        dec = torch.empty((h // sub, w // sub), dtype=torch.float32,
                          device=img.device)
    fn = cuda.function("pft_pyramid_level",
                       [cuda.c_ptr] * 5 + [cuda.c_int] * 3 + _TAP_ARGS
                       + [cuda.c_int, cuda.c_ptr])
    rc = fn(img.data_ptr(), base.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            None if dec is None else dec.data_ptr(), h, w, int(smooth),
            *_c_taps(taps, smooth, with_pyr), sub,
            cuda.stream_ptr(img.device))
    cuda.check(rc, "pft_pyramid_level")
    launches += 1
    return base, gx, gy, dec


def pyramid_level(img: torch.Tensor, taps: LevelTaps, smooth: bool,
                  with_pyr: bool):
    """One pyramid level: (base, gradx, grady, next-or-None), one launch on
    CUDA (differentiable through the plain version's VJP).

    ``img``: float32 [H, W]. ``smooth``: apply the level-0 pre-smooth
    (base = smoothed img, else base = img). ``with_pyr``: also produce the
    next level's decimated base.
    """
    if not cuda.use_kernel(img):
        return pyramid_level_reference(img, taps, smooth, with_pyr)
    _require_image(img, "pyramid_level")

    def written(base, gx, gy, nxt):
        # the maps the launch writes (base is img itself without smoothing)
        return (((base,) if smooth else ()) + (gx, gy)
                + ((nxt,) if with_pyr else ()))

    outs = list(cuda.with_plain_vjp(
        lambda im: written(*_launch_level(im, taps, smooth, with_pyr)),
        lambda im: written(*pyramid_level_reference(im, taps, smooth,
                                                    with_pyr)), img))
    base = outs.pop(0) if smooth else img
    return base, outs[0], outs[1], outs[2] if with_pyr else None


def _require_window(window_width: int, window_height: int) -> None:
    cuda.require(window_width >= 1 and window_height >= 1
                 and window_width % 2 == 1 and window_height % 2 == 1,
                 f"K3's map takes an odd window, not {window_width}x"
                 f"{window_height}")


def level0_eig(img: torch.Tensor, taps: LevelTaps, smooth: bool,
               window_width: int, window_height: int) -> torch.Tensor:
    """K3's int32 [H, W] map of ``img``'s level-0 gradients (pre-smoothed
    when ``smooth``), one launch on CUDA that stores no gradient
    (csrc/pyramid.cu pft_pyramid_eig)."""
    global launches, eig_launches
    if not cuda.use_kernel(img):
        return level0_eig_reference(img, taps, smooth, window_width,
                                    window_height)
    _require_image(img, "level0_eig")
    _require_window(window_width, window_height)
    eig = torch.empty(img.shape, dtype=torch.int32, device=img.device)
    fn = cuda.function("pft_pyramid_eig",
                       [cuda.c_ptr] * 2 + [cuda.c_int] * 3 + _TAP_ARGS[:6]
                       + [cuda.c_int] * 2 + [cuda.c_ptr])
    rc = fn(img.data_ptr(), eig.data_ptr(), *img.shape, int(smooth),
            *_c_taps(taps, smooth, False)[:6], int(window_width),
            int(window_height), cuda.stream_ptr(img.device))
    cuda.check(rc, "pft_pyramid_eig")
    launches += 1
    eig_launches += 1
    return eig


def level_shapes(h: int, w: int, sub: int, n_levels: int):
    """[H_l, W_l] of every level: H_l = H_{l-1} // sub."""
    shapes = [(h, w)]
    for _ in range(1, n_levels):
        h, w = h // sub, w // sub
        shapes.append((h, w))
    return shapes


def pyramid_numel(shapes) -> int:
    """Floats of one pyramid buffer: image, gradx and grady of every level."""
    return sum(3 * h * w for h, w in shapes)


def pyramid_views(buf: torch.Tensor, shapes):
    """(imgs, gradxs, gradys) of a pyramid buffer of ``pyramid_numel``
    floats: level by level, the image, gradx and grady, each [H_l, W_l]."""
    levels, off = [], 0
    for h, w in shapes:
        n = h * w
        levels.append(tuple(buf[off + k * n:off + (k + 1) * n].view(h, w)
                            for k in range(3)))
        off += 3 * n
    return tuple(tuple(lv[k] for lv in levels) for k in range(3))


def _launch_build(img, taps: LevelTaps, n_levels: int, eig_window, out,
                  shapes):
    """One pft_pyramid_build call (two launches past one level): (buf,) or
    (buf, eig)."""
    global launches, eig_launches
    ww, wh = (0, 0) if eig_window is None else (int(v) for v in eig_window)
    eig = None if eig_window is None else torch.empty(
        img.shape, dtype=torch.int32, device=img.device)
    buf = out if out is not None else torch.empty(
        (pyramid_numel(shapes),), dtype=torch.float32, device=img.device)
    fn = cuda.function("pft_pyramid_build",
                       [cuda.c_ptr] * 2 + [cuda.c_int] * 4 + _TAP_ARGS
                       + [cuda.c_ptr] + [cuda.c_int] * 2 + [cuda.c_ptr] * 2)
    rc = fn(img.data_ptr(), buf.data_ptr(), *img.shape, n_levels,
            taps.subsampling, *_c_taps(taps, True, True),
            None if eig is None else eig.data_ptr(), ww, wh,
            _barrier(img.device).data_ptr(), cuda.stream_ptr(img.device))
    cuda.check(rc, "pft_pyramid_build")
    launches += 1 if n_levels == 1 else 2
    if eig is None:
        return (buf,)
    eig_launches += 1
    return buf, eig


def pyramid_build(img: torch.Tensor, taps: LevelTaps, n_levels: int,
                  eig_window: Optional[tuple] = None,
                  out: Optional[torch.Tensor] = None):
    """A whole pyramid: (imgs, gradxs, gradys), tuples of [H_l, W_l] levels,
    finest first; level 0's image is the pre-smoothed frame. On CUDA at
    most two launches, whatever ``n_levels`` (csrc/pyramid.cu
    pft_pyramid_build): level 0, then every coarser level. The levels are
    views of one buffer: ``out`` (float32, ``pyramid_numel`` of the
    levels, on the frame's device) when given, else a new one.

    ``eig_window``: (window_width, window_height), odd; then the level-0
    launch also computes K3's int32 map of level 0's gradients, returned
    last: (imgs, gradxs, gradys, eig).

    Differentiable on CUDA through the plain build's VJP (not with
    ``out``)."""
    shapes = level_shapes(*img.shape, taps.subsampling, n_levels)
    if out is not None:
        cuda.require(out.dtype == torch.float32 and out.is_contiguous()
                     and out.numel() == pyramid_numel(shapes)
                     and out.device == img.device,
                     "pyramid_build: out must be a contiguous float32 buffer "
                     "of the pyramid's size on the frame's device")
    if not cuda.use_kernel(img):
        levels = pyramid_build_reference(img, taps, n_levels)
        if out is not None:
            views = pyramid_views(out, shapes)
            for dst, src in zip(views, levels):
                for d, s in zip(dst, src):
                    d.copy_(s)
            levels = views
        if eig_window is None:
            return levels
        return levels + (min_eig_reference(levels[1][0], levels[2][0],
                                           *eig_window),)
    _require_image(img, "pyramid_build")
    cuda.require(n_levels >= 1, f"pyramid_build: {n_levels} levels")
    cuda.require(out is None or not cuda.records_grad(img),
                 "pyramid_build: an out buffer records no gradients; leave "
                 "out unset to differentiate the build")
    if eig_window is not None:
        _require_window(*(int(v) for v in eig_window))

    def launch(im):
        return _launch_build(im, taps, n_levels, eig_window, out, shapes)

    def plain(im):
        # the buffer's layout (pyramid_views); K3's integer map has no
        # gradient, so the backward leaves it out
        levels = pyramid_build_reference(im, taps, n_levels)
        return (torch.cat([t.reshape(-1) for lv in zip(*levels)
                           for t in lv]),)

    outs = cuda.with_plain_vjp(launch, plain, img)
    levels = pyramid_views(outs[0], shapes)
    return levels if eig_window is None else levels + (outs[1],)
