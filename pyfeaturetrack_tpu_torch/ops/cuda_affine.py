"""K6: the affine-consistency Gauss-Newton batch and the whole affine
stage (csrc/affine.cu), and their dispatch.

Port of ``pyfeaturetrack_tpu/ops/pallas_affine_vec.py``
(``_vec_affine_raw`` / ``vec_affine_with_fallback``) and of its stale-lane
fallback ``pyfeaturetrack_tpu/ops/pallas_affine_fused.py``
(``fused_affine_track_batch``): one kernel covers both, because it samples
any warped footprint from global memory. Their semantics are
``ops/affine._affine_track_batch``, which is the plain version here.

* ``affine_track_batch``: the Gauss-Newton batch; plain version
  ``ops/affine._affine_track_batch``.
* ``affine_stage``: the stage of ``ops/affine.affine_consistency_check``
  (lost lanes, template capture, the check, the selects on the feature
  list and on all eight AffineState fields) in one launch; its plain
  version is that function's eager composition.

A CUDA tensor launches the kernel (one launch per call); a CPU tensor
takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..features import AffineState
from ..utils import cuda
from . import affine
from .cuda_lk import _f32

# Kernel launches made by this module's wrappers.
launches = 0


def _require_mode_and_window(cfg):
    ww, wh = cfg.affine_window_width, cfg.affine_window_height
    mode = int(cfg.affineConsistencyCheck)
    cuda.require(mode in (0, 1, 2), f"affineConsistencyCheck {mode} is not "
                 "a mode (0, 1 or 2)")
    cuda.require(ww % 2 == 1 and wh % 2 == 1,
                 f"affine kernel takes odd windows, got {ww}x{wh}")
    return ww, wh


def _gn_params(cfg):
    """The window, mode and Gauss-Newton settings both C entries take."""
    return (cfg.affine_window_width, cfg.affine_window_height,
            int(cfg.affineConsistencyCheck), cfg.affine_max_iterations,
            _f32(cfg.affine_min_displacement), _f32(cfg.min_determinant),
            _f32(cfg.affine_max_residue),
            _f32(cfg.affine_max_displacement_differ))


def _launch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg, xo, yo, Ao, st,
            nit):
    global launches
    fn = cuda.function("pft_affine_track",
                       [cuda.c_ptr] * 8 + [cuda.c_int] * 7
                       + [cuda.c_float] * 4 + [cuda.c_ptr] * 6)
    nrows, ncols = img2.shape
    rc = fn(*(t.data_ptr() for t in (tmpl, img2, gx2, gy2, x0, y0, A0,
                                      check)),
            nrows, ncols, x0.shape[0], *_gn_params(cfg),
            xo.data_ptr(), yo.data_ptr(), Ao.data_ptr(), st.data_ptr(),
            nit.data_ptr(), cuda.stream_ptr(img2.device))
    cuda.check(rc, "pft_affine_track")
    launches += 1


def affine_track_batch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg):
    """Affine Gauss-Newton for a feature batch: (x, y, A, status, nit).

    Same contract as ``ops/affine._affine_track_batch``: ``tmpl`` float32
    [N, wh, ww]; ``img2``/``gx2``/``gy2`` float32 [H, W]; ``x0``/``y0``
    float32 [N]; ``A0`` float32 [N, 2, 2]; ``check`` bool [N]. One launch
    on CUDA, differentiable in x, y and A through the plain version's
    VJP."""
    feats = (tmpl, x0, y0, A0, check)
    imgs = (img2, gx2, gy2)
    if not cuda.use_kernel(*feats, *imgs):
        return affine._affine_track_batch(tmpl, img2, gx2, gy2, x0, y0, A0,
                                          check, cfg)
    ww, wh = _require_mode_and_window(cfg)
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

    def launch(tmpl, img2, gx2, gy2, x0, y0, A0, check):
        xo, yo = torch.empty_like(x0), torch.empty_like(y0)
        Ao = torch.empty_like(A0)
        st = torch.empty((n,), dtype=torch.int32, device=x0.device)
        nit = torch.empty((n,), dtype=torch.int32, device=x0.device)
        if n:
            _launch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg, xo, yo,
                    Ao, st, nit)
        return xo, yo, Ao, st, nit

    def plain(*ts):
        return affine._affine_track_batch(*ts, cfg)

    return cuda.with_plain_vjp(launch, plain, tmpl, img2, gx2, gy2, x0, y0,
                               A0, check)


def _ptrs(tensors):
    """A host array of device pointers (kept alive by the caller)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_stage(ts, cfg):
    """One pft_affine_stage launch (none for an empty list) on the stage's
    inputs in ``affine_stage``'s order: (x, y, val, *AffineState)."""
    global launches
    imgs, feats, vals, state = ts[:6], ts[6:10], ts[10:12], ts[12:18]
    valid, nit = ts[18:]
    n = feats[2].shape[0]
    x, y = torch.empty_like(feats[2]), torch.empty_like(feats[3])
    val = torch.empty_like(vals[1])
    out = AffineState(*(torch.empty_like(t) for t in state),
                      valid=torch.empty_like(valid),
                      nit=torch.empty_like(nit))
    if n:
        fn = cuda.function("pft_affine_stage",
                           [cuda.c_ptr] * 6 + [cuda.c_int] * 6
                           + [cuda.c_int] + [cuda.c_float] * 4
                           + [cuda.c_ptr] * 5)
        tables = [_ptrs(t) for t in (imgs, feats, vals, state,
                                     (x, y) + tuple(out[:6]))]
        addr = [ctypes.addressof(t) for t in tables]
        rc = fn(*addr[:4], valid.data_ptr(), nit.data_ptr(),
                *imgs[0].shape, n, *_gn_params(cfg), addr[4],
                val.data_ptr(), out.valid.data_ptr(), out.nit.data_ptr(),
                cuda.stream_ptr(x.device))
        cuda.check(rc, "pft_affine_stage")
        launches += 1
    return (x, y, val) + tuple(out)


def affine_stage(pyr1, pyr2, fl_before, fl_after, aff: AffineState, cfg):
    """The affine stage, on the card in one launch: (x, y, val, AffineState),
    the values ``ops/affine.affine_consistency_check`` computes. ``aff``
    is sized for ``cfg`` with ``nit`` set; every tensor lies on one CUDA
    device. Differentiable in the float outputs (x, y and the AffineState's
    windows, anchors and warps) through the plain stage's VJP
    (``ops/affine.stage_reference``). CPU tensors take that plain
    version."""
    imgs = (pyr1.img[0], pyr1.gradx[0], pyr1.grady[0], pyr2.img[0],
            pyr2.gradx[0], pyr2.grady[0])
    if not cuda.use_kernel(fl_before.x, fl_after.x, aff.img, *imgs):
        return affine.stage_reference(
            imgs[:3], imgs[3:], (fl_before.x, fl_before.y), fl_before.val,
            (fl_after.x, fl_after.y), fl_after.val, aff, cfg)
    ww, wh = _require_mode_and_window(cfg)
    n = fl_after.nFeatures
    shape = imgs[0].shape
    cuda.require(len(shape) == 2 and shape[0] >= 2 and shape[1] >= 2 and all(
        t.dtype == torch.float32 and t.shape == shape and t.is_contiguous()
        for t in imgs), "affine stage takes level 0 of both pyramids as six "
        "contiguous float32 [H, W] images (H, W >= 2)")
    feats = (fl_before.x, fl_before.y, fl_after.x, fl_after.y)
    vals = (fl_before.val, fl_after.val)
    state = (aff.img, aff.gradx, aff.grady, aff.x, aff.y, aff.A)
    cuda.require(all(t.dtype == torch.float32 and t.shape == (n,)
                     and t.is_contiguous() for t in feats + state[3:5])
                 and all(t.dtype == torch.int32 and t.shape == (n,)
                         and t.is_contiguous() for t in vals + (aff.nit,))
                 and aff.valid.dtype == torch.bool
                 and aff.valid.shape == (n,) and aff.valid.is_contiguous()
                 and all(t.dtype == torch.float32 and t.shape == (n, wh, ww)
                         and t.is_contiguous() for t in state[:3])
                 and aff.A.dtype == torch.float32
                 and aff.A.shape == (n, 2, 2) and aff.A.is_contiguous(),
                 "affine stage takes contiguous feature lists (float32 x, y, "
                 "int32 val [N]) and an AffineState sized for the config")

    def launch(*ts):
        return _launch_stage(ts, cfg)

    def plain(*ts):
        x, y, val, aff = affine.stage_reference(
            ts[:3], ts[3:6], ts[6:8], ts[10], ts[8:10], ts[11],
            AffineState(*ts[12:]), cfg)
        return (x, y, val) + tuple(aff)

    outs = cuda.with_plain_vjp(launch, plain, *imgs, *feats, *vals, *state,
                               aff.valid, aff.nit)
    return outs[0], outs[1], outs[2], AffineState(*outs[3:])
