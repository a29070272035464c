"""K6: the affine-consistency Gauss-Newton batch (csrc/affine.cu) and its
dispatch.

Port of ``pyfeaturetrack_tpu/ops/pallas_affine_vec.py``
(``_vec_affine_raw`` / ``vec_affine_with_fallback``) and of its stale-lane
fallback ``pyfeaturetrack_tpu/ops/pallas_affine_fused.py``
(``fused_affine_track_batch``): one kernel covers both, because it samples
any warped footprint from global memory. Their semantics are
``ops/affine._affine_track_batch``, which is the plain version here.

A CUDA tensor launches the kernel (one launch per call); a CPU tensor
takes the plain version.
"""

from __future__ import annotations

import torch

from ..utils import cuda
from . import affine
from .cuda_lk import _f32

MAX_WINDOW_PIXELS = 256   # csrc/affine.cu: at most 8 window samples per lane

# Kernel launches made by this wrapper.
launches = 0


def _launch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg, xo, yo, Ao, st,
            nit):
    global launches
    fn = cuda.function("pft_affine_track",
                       [cuda.c_ptr] * 8 + [cuda.c_int] * 7
                       + [cuda.c_float] * 4 + [cuda.c_ptr] * 6)
    nrows, ncols = img2.shape
    rc = fn(*(t.data_ptr() for t in (tmpl, img2, gx2, gy2, x0, y0, A0,
                                      check)),
            nrows, ncols, x0.shape[0], cfg.affine_window_width,
            cfg.affine_window_height, int(cfg.affineConsistencyCheck),
            cfg.affine_max_iterations, _f32(cfg.affine_min_displacement),
            _f32(cfg.min_determinant), _f32(cfg.affine_max_residue),
            _f32(cfg.affine_max_displacement_differ),
            xo.data_ptr(), yo.data_ptr(), Ao.data_ptr(), st.data_ptr(),
            nit.data_ptr(), cuda.stream_ptr(img2.device))
    cuda.check(rc, "pft_affine_track")
    launches += 1


def affine_track_batch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg):
    """Affine Gauss-Newton for a feature batch: (x, y, A, status, nit).

    Same contract as ``ops/affine._affine_track_batch``: ``tmpl`` float32
    [N, wh, ww]; ``img2``/``gx2``/``gy2`` float32 [H, W]; ``x0``/``y0``
    float32 [N]; ``A0`` float32 [N, 2, 2]; ``check`` bool [N]."""
    feats = (tmpl, x0, y0, A0, check)
    imgs = (img2, gx2, gy2)
    if not cuda.use_kernel(*feats, *imgs):
        return affine._affine_track_batch(tmpl, img2, gx2, gy2, x0, y0, A0,
                                          check, cfg)
    ww, wh = cfg.affine_window_width, cfg.affine_window_height
    mode = int(cfg.affineConsistencyCheck)
    cuda.require(mode in (0, 1, 2), f"affineConsistencyCheck {mode} is not "
                 "a mode (0, 1 or 2)")
    cuda.require(ww % 2 == 1 and wh % 2 == 1 and ww * wh <= MAX_WINDOW_PIXELS,
                 f"affine kernel takes odd windows of at most "
                 f"{MAX_WINDOW_PIXELS} pixels, got {ww}x{wh}")
    n = x0.shape[0]
    cuda.require(tmpl.dtype == torch.float32 and tmpl.shape == (n, wh, ww)
                 and tmpl.is_contiguous(),
                 f"affine kernel takes contiguous float32 [N, {wh}, {ww}] "
                 "templates")
    cuda.require(all(t.dtype == torch.float32 and t.shape == (n,)
                     and t.is_contiguous() for t in (x0, y0))
                 and A0.dtype == torch.float32 and A0.shape == (n, 2, 2)
                 and A0.is_contiguous() and check.dtype == torch.bool
                 and check.shape == (n,) and check.is_contiguous(),
                 "affine kernel takes contiguous float32 [N] positions, "
                 "[N, 2, 2] warps and a bool [N] mask")
    shape = img2.shape
    cuda.require(len(shape) == 2 and shape[0] >= 2 and shape[1] >= 2 and all(
        t.dtype == torch.float32 and t.shape == shape and t.is_contiguous()
        for t in imgs), "affine kernel takes three contiguous float32 "
        "[H, W] images (H, W >= 2)")
    xo, yo = torch.empty_like(x0), torch.empty_like(y0)
    Ao = torch.empty_like(A0)
    st = torch.empty((n,), dtype=torch.int32, device=x0.device)
    nit = torch.empty((n,), dtype=torch.int32, device=x0.device)
    if n:
        _launch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg, xo, yo, Ao, st,
                nit)
    return xo, yo, Ao, st, nit
