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

A CUDA tensor launches the kernel (one launch per call); a CPU tensor takes
the plain version: K2's ``cuda_lk.lk_level_reference`` over chunks of the
pixel grid, with every window summed sequentially in row-major tap order
from 0 (``seq_sum``), the kernel's order, so both give the same bits on the
card.
"""

from __future__ import annotations

import torch

from ..utils import cuda
from .cuda_lk import _f32, lk_level_reference

# Pixels per plain-version chunk: its [chunk, wh+1, ww+1] patch gathers stay
# small on the card. A pixel's result does not depend on its chunk.
CHUNK = 32768

# Kernel launches made by this wrapper.
launches = 0


def seq_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of [..., P] over P in the kernel's order: from 0, one tap at a
    time in ascending (row-major) order."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


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


def _launch(imgs, u, v, cfg, one_d, uo, vo, st, it):
    global launches
    fn = cuda.function("pft_lk_dense_level",
                       [cuda.c_ptr] * 8 + [cuda.c_int] * 5
                       + [cuda.c_float] * 4 + [cuda.c_int] * 2
                       + [cuda.c_ptr] * 5)
    nrows, ncols = imgs[0].shape
    rc = fn(*(t.data_ptr() for t in imgs), u.data_ptr(),
            None if v is None else v.data_ptr(),
            nrows, ncols, cfg.window_width, cfg.window_height,
            cfg.max_iterations, _f32(cfg.min_displacement),
            _f32(cfg.min_determinant), _f32(cfg.max_residue),
            _f32(cfg.step_factor), int(bool(cfg.lighting_insensitive)),
            int(one_d), uo.data_ptr(), None if vo is None else vo.data_ptr(),
            st.data_ptr(), it.data_ptr(), cuda.stream_ptr(u.device))
    cuda.check(rc, "pft_lk_dense_level")
    launches += 1


def _level(imgs, u, v, cfg, one_d):
    maps = (u,) if one_d else (u, v)
    if not cuda.use_kernel(*imgs, *maps):
        return _reference(imgs, u, v, cfg, one_d)
    ww, wh = cfg.window_width, cfg.window_height
    cuda.require(ww % 2 == 1 and wh % 2 == 1,
                 f"dense_level takes odd windows, got {ww}x{wh}")
    shape = imgs[0].shape
    cuda.require(len(shape) == 2 and all(
        t.dtype == torch.float32 and t.shape == shape and t.is_contiguous()
        for t in imgs + maps),
        "dense_level takes contiguous float32 [H, W] level images and maps")
    uo = torch.empty_like(u)
    vo = None if one_d else torch.empty_like(v)
    st = torch.empty(shape, dtype=torch.int32, device=u.device)
    it = torch.empty(shape, dtype=torch.int32, device=u.device)
    if u.numel():
        _launch(imgs, u, v, cfg, one_d, uo, vo, st, it)
    return uo, vo, st, it


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
