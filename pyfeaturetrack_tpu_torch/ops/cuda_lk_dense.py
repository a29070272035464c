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

Every entry takes ``band=(row0, rows)``: only rows [row0, row0 + rows) of
the level are solved and returned (band-sized maps), from the start the
whole map gives those pixels, with the bits a whole-level call gives them
(the row-sharded dense paths of ``parallel/sharding.py``, one band per
rank). ``band`` None is the whole level. The level images are float32 or
bfloat16 (``cfg.image_dtype``); each tap is upcast to float32 where it is
read, and the maps stay float32.

A CUDA tensor launches the kernel (one launch per call); a CPU tensor takes
the plain version: ``upsample_flow`` where the start is upsampled, then
K2's ``cuda_lk.lk_level_reference`` over chunks of the pixel grid, with
every window summed sequentially in row-major tap order from 0
(``seq_sum``), the kernel's order, so both give the same bits on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda, profiling
from .cuda_lk import _f32, _is_bf16, lk_level_reference
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

# Kernel launches made by this wrapper, and those of them on a row band
# narrower than the level.
launches = 0
band_launches = 0
profiling.launch_counter(__name__, "launches", "band_launches")


def seq_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of [..., P] over P in the kernel's order: from 0, one tap at a
    time in ascending (row-major) order."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def _rows(shape, band):
    """(row0, rows) of a level of ``shape`` for ``band`` (None: all)."""
    return (0, shape[0]) if band is None else (int(band[0]), int(band[1]))


def _reference(imgs, u, v, cfg, one_d, band=None):
    """Plain version of one K8 level: (u or d, v or None, status,
    iteration) [rows, W] over the band's rows (all rows for None), from
    level-sized maps."""
    row0, nrows = _rows(imgs[0].shape, band)
    ncols = imgs[0].shape[1]
    dev = imgs[0].device
    x1 = torch.arange(ncols, dtype=torch.float32, device=dev).repeat(nrows)
    y1 = torch.arange(row0, row0 + nrows, dtype=torch.float32,
                      device=dev).repeat_interleave(ncols)
    if one_d:
        x2, y2 = x1 - u[row0:row0 + nrows].reshape(-1), y1
    else:
        x2 = x1 + u[row0:row0 + nrows].reshape(-1)
        y2 = y1 + v[row0:row0 + nrows].reshape(-1)
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


def _launch(imgs, maps, start, coarse_shape, scale, cfg, one_d, out, band):
    global launches, band_launches
    fn = cuda.function("pft_lk_dense_level",
                       [cuda.c_ptr] * 8 + [cuda.c_int] * 4
                       + [cuda.c_float] * 3 + [cuda.c_int] * 5
                       + [cuda.c_float] * 4 + [cuda.c_int] * 6
                       + [cuda.c_ptr] * 5)
    nrows, ncols = imgs[0].shape
    row0, rows = _rows((nrows, ncols), band)
    hc, wc = coarse_shape
    u, v = maps
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    rc = fn(*(t.data_ptr() for t in imgs), ptr(u), ptr(v),
            int(imgs[0].dtype == torch.bfloat16), start, hc, wc,
            _f32(hc / nrows), _f32(wc / ncols), _f32(scale), nrows, ncols,
            cfg.window_width, cfg.window_height, cfg.max_iterations,
            _f32(cfg.min_displacement), _f32(cfg.min_determinant),
            _f32(cfg.max_residue), _f32(cfg.step_factor),
            int(bool(cfg.lighting_insensitive)), int(one_d), *TILE, row0,
            rows, *(ptr(t) for t in out), cuda.stream_ptr(imgs[0].device))
    cuda.check(rc, "pft_lk_dense_level")
    launches += 1
    band_launches += rows != nrows


def blocks_per_sm(cfg, start: int = START_UP, one_d: bool = False) -> int:
    """Blocks of a level launch with ``cfg``'s windows, ``start`` and TILE
    that one SM holds at once, from the CUDA occupancy calculator (the
    kernel's registers, threads and shared memory; no launch). A launch
    over ``rows`` x W pixels has ceil(W / TILE[1]) * ceil(rows / TILE[0])
    blocks."""
    fn = cuda.function("pft_lk_dense_blocks_per_sm",
                       [cuda.c_int] * 7 + [cuda.c_ptr])
    out = ctypes.c_int(0)
    rc = fn(start, cfg.window_width, cfg.window_height,
            int(bool(cfg.lighting_insensitive)), int(one_d), *TILE,
            ctypes.addressof(out))
    cuda.check(rc, "pft_lk_dense_blocks_per_sm")
    return out.value


def _plain_level(imgs, u, v, cfg, one_d, scale, band=None):
    """The plain version of ``_level``: ``upsample_flow`` (of the whole
    map) where the start is upsampled, then ``_reference`` over the
    band."""
    if scale is not None:
        shape = tuple(imgs[0].shape)
        if u is None:
            u = torch.zeros(shape, dtype=torch.float32,
                            device=imgs[0].device)
            v = torch.zeros_like(u)
        else:
            u = upsample_flow(u, shape, scale)
            v = None if one_d else upsample_flow(v, shape, scale)
    return _reference(imgs, u, v, cfg, one_d, band)


def _level(imgs, u, v, cfg, one_d, scale=None, band=None):
    """One level: ``scale`` None starts from level-sized maps, else from
    the coarser maps upsampled (u None: from zero); ``band`` (row0, rows)
    solves only those rows. One launch on CUDA, differentiable in the
    level images and maps through the plain version's VJP."""
    level_shape = tuple(imgs[0].shape)
    if band is not None:
        row0, rows = _rows(level_shape, band)
        if not (len(level_shape) == 2 and 0 <= row0 and 0 < rows
                and row0 + rows <= level_shape[0]):
            raise ValueError(f"band {tuple(band)} is not a run of rows of a "
                             f"{level_shape} level")
    shape = (_rows(level_shape, band)[1],) + level_shape[1:]
    maps = tuple(t for t in ((u,) if one_d else (u, v)) if t is not None)
    if not cuda.use_kernel(*imgs, *maps):
        return _plain_level(imgs, u, v, cfg, one_d, scale, band)
    ww, wh = cfg.window_width, cfg.window_height
    cuda.require(ww % 2 == 1 and wh % 2 == 1,
                 f"dense_level takes odd windows, got {ww}x{wh}")
    _is_bf16(imgs, "dense_level")
    cuda.require(len(level_shape) == 2 and all(
        t.shape == level_shape and t.is_contiguous() for t in imgs),
        "dense_level takes contiguous [H, W] level images of one shape")
    cuda.require(all(t.dtype == torch.float32 and t.dim() == 2
                     and t.shape == maps[0].shape and t.is_contiguous()
                     for t in maps),
                 "dense_level takes contiguous float32 maps of one shape")
    if scale is None:
        start, coarse = START_MAP, level_shape
        cuda.require(maps[0].shape == level_shape, "dense_level: maps of "
                     "the level's shape")
    elif u is None:
        start, coarse = START_ZERO, level_shape
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
                    1.0 if scale is None else scale, cfg, one_d, out, band)
        return tuple(t for t in out if t is not None)

    def plain(*ts):
        ims, u, v = split(ts)
        out = _plain_level(ims, u, v, cfg, one_d, scale, band)
        return tuple(t for t in out if t is not None)

    out = cuda.with_plain_vjp(launch, plain, *imgs, *maps)
    return out if not one_d else (out[0], None) + tuple(out[1:])


def dense_level(img1, gx1, gy1, img2, gx2, gy2, u, v, cfg, band=None):
    """One dense LK level over the pixel grid, started at grid + (u, v):
    (u, v, status, iteration) [H, W] (the contract of ``flow.flow_level``
    plus the iteration map), or [rows, W] over ``band``. Six [H, W] level
    images of one dtype (float32 or bfloat16, upcast at the tap), float32
    level-sized maps."""
    return _level((img1, gx1, gy1, img2, gx2, gy2), u, v, cfg, False,
                  band=band)


def dense_level_1d(img1, gx1, gy1, img2, gx2, gy2, d, cfg, band=None):
    """One dense 1-D LK level: refine the disparity map ``d`` (right-image
    window at (x - d, y)): (d, status, iteration) [H, W] (the contract of
    ``disparity.disparity_level`` plus the iteration map), or [rows, W]
    over ``band``. gy1 and gy2 are not read."""
    d, _, status, iteration = _level((img1, gx1, gy1, img2, gx2, gy2), d,
                                     None, cfg, True, band=band)
    return d, status, iteration


def dense_level_up(img1, gx1, gy1, img2, gx2, gy2, u, v, scale: float, cfg,
                   band=None):
    """``dense_level`` started at grid + ``upsample_flow`` of the coarser
    level's (u, v) maps to this level's shape, times ``scale``; u and v
    None: started at the grid (zero flow). Returns (u, v, status,
    iteration) [H, W] at this level, or [rows, W] over ``band``."""
    return _level((img1, gx1, gy1, img2, gx2, gy2), u, v, cfg, False,
                  float(scale), band)


def dense_level_1d_up(img1, gx1, gy1, img2, gx2, gy2, d, scale: float, cfg,
                      band=None):
    """``dense_level_1d`` started from ``upsample_flow`` of the coarser
    level's disparity map ``d`` to this level's shape, times ``scale``.
    Returns (d, status, iteration) [H, W] at this level, or [rows, W] over
    ``band``."""
    d, _, status, iteration = _level((img1, gx1, gy1, img2, gx2, gy2), d,
                                     None, cfg, True, float(scale), band)
    return d, status, iteration
