"""K8: one pyramid level of dense LK over the pixel grid (csrc/lk_dense.cu)
and its plain version.

Port of ``pyfeaturetrack_tpu/ops/pallas_lk_fused.py`` (fused_track_level),
which the JAX package's ``ops/flow.flow_level`` and, in its ``one_d``
mode, ``ops/disparity.disparity_level`` run over every pixel of a level.
The semantics are those of ``ops/track.track_feature_level`` with the
feature set = the pixel grid (x1 = column, y1 = row):

* ``dense_level``: 2-D flow, (u, v) maps in and out (flow.py:119-136);
* ``dense_level_1d``: disparity along the row, the d map in and out
  (disparity.py:134-178): the scalar step ``du = step_factor sum(diff gx) /
  gxx`` with gx = g1x + g2x, SMALL_DET when ``gxx < min_determinant``,
  convergence on |du| alone, bounds checked at (x2, y1). Only img and gx
  are read (the JAX code gathers gy1 and gy2 and never uses them).

Both start from level-sized maps. ``dense_level_up`` and
``dense_level_1d_up`` are the coarse-to-fine step of ``ops/flow`` and
``ops/disparity`` in one launch: they take the coarser level's maps and
start from ``interp.upsample_flow`` of them (the kernel computes it per
pixel), and ``dense_level_up`` with no maps starts from zero.

A CUDA tensor launches the kernel (one launch per call); a CPU tensor takes
the plain version: ``upsample_flow`` where the start is upsampled, then
K2's ``cuda_lk.lk_level_reference`` over chunks of the pixel grid, with
every window summed sequentially in row-major tap order from 0
(``seq_sum``), the kernel's order, so both give the same bits on the card.
"""

from __future__ import annotations

import torch

from ..utils import cuda
from .cuda_lk import _f32, lk_level_reference
from .interp import upsample_flow

# Pixels per plain-version chunk: its [chunk, wh+1, ww+1] patch gathers stay
# small on the card. A pixel's result does not depend on its chunk.
CHUNK = 32768

# Pixels per kernel block (rows, columns): a multiple of 4 by a multiple of
# 8 (each warp covers 4 x 8 pixels), at most 1024; 16 x 16 timed fastest at
# 480x640 (phase_clocks.py).
TILE = (16, 16)

# The kernel's start modes (csrc/lk_dense.cu StartMode).
START_MAP, START_ZERO, START_UP = 0, 1, 2

# Kernel launches made by this wrapper.
launches = 0


def seq_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of [..., P] over P in the kernel's order: from 0, one tap at a
    time in ascending (row-major) order."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


@cuda.plain_version
def _reference(imgs, u, v, cfg, one_d):
    """Plain version of one K8 level: (u or d, v or None, status,
    iteration) [H, W]."""
    nrows, ncols = imgs[0].shape
    dev = imgs[0].device
    x1 = torch.arange(ncols, dtype=torch.float32, device=dev).repeat(nrows)
    y1 = torch.arange(nrows, dtype=torch.float32,
                      device=dev).repeat_interleave(ncols)
    if one_d:
        x2, y2 = x1 - u.reshape(-1), y1
    else:
        x2, y2 = x1 + u.reshape(-1), y1 + v.reshape(-1)
    active = torch.ones((CHUNK,), dtype=torch.bool, device=dev)
    parts = [lk_level_reference(x1[s:s + CHUNK], y1[s:s + CHUNK],
                                x2[s:s + CHUNK], y2[s:s + CHUNK], *imgs, cfg,
                                active[:min(CHUNK, nrows * ncols - s)],
                                sum_fn=seq_sum, one_d=one_d)
             for s in range(0, nrows * ncols, CHUNK)]
    x, y, status, iteration = (torch.cat(p) for p in zip(*parts))

    def grid(t):
        return t.reshape(nrows, ncols)

    if one_d:
        return grid(x1 - x), None, grid(status), grid(iteration)
    return grid(x - x1), grid(y - y1), grid(status), grid(iteration)


def _launch(imgs, maps, start, coarse_shape, scale, cfg, one_d, out):
    global launches
    fn = cuda.function("pft_lk_dense_level",
                       [cuda.c_ptr] * 8 + [cuda.c_int] * 3
                       + [cuda.c_float] * 3 + [cuda.c_int] * 5
                       + [cuda.c_float] * 4 + [cuda.c_int] * 4
                       + [cuda.c_ptr] * 5)
    nrows, ncols = imgs[0].shape
    hc, wc = coarse_shape
    u, v = maps
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    rc = fn(*(t.data_ptr() for t in imgs), ptr(u), ptr(v), start, hc, wc,
            _f32(hc / nrows), _f32(wc / ncols), _f32(scale), nrows, ncols,
            cfg.window_width, cfg.window_height, cfg.max_iterations,
            _f32(cfg.min_displacement), _f32(cfg.min_determinant),
            _f32(cfg.max_residue), _f32(cfg.step_factor),
            int(bool(cfg.lighting_insensitive)), int(one_d), *TILE,
            *(ptr(t) for t in out), cuda.stream_ptr(imgs[0].device))
    cuda.check(rc, "pft_lk_dense_level")
    launches += 1


def _plain_level(imgs, u, v, cfg, one_d, scale):
    """The plain version of ``_level``: ``upsample_flow`` where the start is
    upsampled, then ``_reference``."""
    if scale is not None:
        shape = tuple(imgs[0].shape)
        if u is None:
            u = torch.zeros(shape, dtype=torch.float32,
                            device=imgs[0].device)
            v = torch.zeros_like(u)
        else:
            u = upsample_flow(u, shape, scale)
            v = None if one_d else upsample_flow(v, shape, scale)
    return _reference(imgs, u, v, cfg, one_d)


def _level(imgs, u, v, cfg, one_d, scale=None):
    """One level: ``scale`` None starts from level-sized maps, else from
    the coarser maps upsampled (u None: from zero). One launch on CUDA,
    differentiable in the level images and maps through the plain
    version's VJP."""
    shape = tuple(imgs[0].shape)
    maps = tuple(t for t in ((u,) if one_d else (u, v)) if t is not None)
    if not cuda.use_kernel(*imgs, *maps):
        return _plain_level(imgs, u, v, cfg, one_d, scale)
    ww, wh = cfg.window_width, cfg.window_height
    cuda.require(ww % 2 == 1 and wh % 2 == 1,
                 f"dense_level takes odd windows, got {ww}x{wh}")
    cuda.require(len(shape) == 2 and all(
        t.dtype == torch.float32 and t.shape == shape and t.is_contiguous()
        for t in imgs), "dense_level takes contiguous float32 [H, W] level "
        "images")
    cuda.require(all(t.dtype == torch.float32 and t.dim() == 2
                     and t.shape == maps[0].shape and t.is_contiguous()
                     for t in maps),
                 "dense_level takes contiguous float32 maps of one shape")
    if scale is None:
        start, coarse = START_MAP, shape
        cuda.require(maps[0].shape == shape, "dense_level: maps of the "
                     "level's shape")
    elif u is None:
        start, coarse = START_ZERO, shape
    else:
        start, coarse = START_UP, tuple(u.shape)
        cuda.require(coarse[0] * coarse[1] >= 2,
                     "dense_level_up: a coarser map of two pixels or more")

    def split(ts):
        # six level images, then the maps given (u, or u and v; none)
        m = ts[6:]
        return ts[:6], (m[0] if m else None), (m[1] if len(m) > 1 else None)

    def launch(*ts):
        ims, u, v = split(ts)
        dev = ims[0].device
        out = (torch.empty(shape, dtype=torch.float32, device=dev),
               None if one_d else torch.empty(shape, dtype=torch.float32,
                                              device=dev),
               torch.empty(shape, dtype=torch.int32, device=dev),
               torch.empty(shape, dtype=torch.int32, device=dev))
        if shape[0] * shape[1]:
            _launch(ims, (u, v), start, coarse,
                    1.0 if scale is None else scale, cfg, one_d, out)
        return tuple(t for t in out if t is not None)

    def plain(*ts):
        ims, u, v = split(ts)
        out = _plain_level(ims, u, v, cfg, one_d, scale)
        return tuple(t for t in out if t is not None)

    out = cuda.with_plain_vjp(launch, plain, *imgs, *maps)
    return out if not one_d else (out[0], None) + tuple(out[1:])


def dense_level(img1, gx1, gy1, img2, gx2, gy2, u, v, cfg):
    """One dense LK level over the pixel grid, started at grid + (u, v):
    (u, v, status, iteration) [H, W] (the contract of ``flow.flow_level``
    plus the iteration map). Six float32 [H, W] level images, float32 maps."""
    return _level((img1, gx1, gy1, img2, gx2, gy2), u, v, cfg, False)


def dense_level_1d(img1, gx1, gy1, img2, gx2, gy2, d, cfg):
    """One dense 1-D LK level: refine the disparity map ``d`` (right-image
    window at (x - d, y)): (d, status, iteration) [H, W] (the contract of
    ``disparity.disparity_level`` plus the iteration map). gy1 and gy2 are
    not read."""
    d, _, status, iteration = _level((img1, gx1, gy1, img2, gx2, gy2), d,
                                     None, cfg, True)
    return d, status, iteration


def dense_level_up(img1, gx1, gy1, img2, gx2, gy2, u, v, scale: float, cfg):
    """``dense_level`` started at grid + ``upsample_flow`` of the coarser
    level's (u, v) maps to this level's shape, times ``scale``; u and v
    None: started at the grid (zero flow). Returns (u, v, status,
    iteration) [H, W] at this level."""
    return _level((img1, gx1, gy1, img2, gx2, gy2), u, v, cfg, False,
                  float(scale))


def dense_level_1d_up(img1, gx1, gy1, img2, gx2, gy2, d, scale: float, cfg):
    """``dense_level_1d`` started from ``upsample_flow`` of the coarser
    level's disparity map ``d`` to this level's shape, times ``scale``.
    Returns (d, status, iteration) [H, W] at this level."""
    d, _, status, iteration = _level((img1, gx1, gy1, img2, gx2, gy2), d,
                                     None, cfg, True, float(scale))
    return d, status, iteration
