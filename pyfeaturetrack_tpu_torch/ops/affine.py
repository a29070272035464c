"""Batched affine-consistency check.

Reference parity: trackFeatures.py -> _am_trackFeatureAffine and its
helpers (SURVEY.md section 3.3); port of
``pyfeaturetrack_tpu/ops/affine.py``. After translational tracking, each
feature is re-verified (and refined) against its FIRST-frame template
under a warp:

  affineConsistencyCheck = 0 -> translation re-check    (2 params)
  affineConsistencyCheck = 1 -> similarity              (4 params)
  affineConsistencyCheck = 2 -> full affine             (6 params)

``_affine_track_batch`` is the batched Gauss-Newton loop in plain
PyTorch and the plain version of K6 (``ops/cuda_affine.py``,
``csrc/affine.cu``): every window sum is taken in the kernel's reduction
order (``tree_sum``) and the PxP systems are solved by
``linalg.gauss_solve_det``, so kernel and plain version give the same
bits. ``affine_consistency_check`` is the stage around it: on CUDA
tensors the whole stage is one K6 launch (``cuda_affine.affine_stage``);
on CPU tensors (or under ``utils.cuda.reference_path()``) its eager
composition here, the stage kernel's plain version, runs.
"""

from __future__ import annotations

import torch

from ..features import (KLT_LARGE_RESIDUE, KLT_OOB, KLT_SMALL_DET,
                        KLT_TRACKED, AffineState, FeatureState,
                        empty_affine_state, identity_warps)
from ..utils import cuda, profiling
from . import cuda_affine
from .cuda_lk import _f32, tree_sum
from .interp import bilinear, gather_window
from .linalg import gauss_solve_det

_ONE_PLUS_EPS = 1.001
# Template-capture hint value of the JAX package's TPU kernel (AffineState
# .nit): fresh templates are expected to take a few iterations.
_CAPTURE_NIT = 5


def make_affine_state(n_features: int, cfg, device="cuda") -> AffineState:
    """Empty affine template store sized for ``cfg``'s affine window, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return empty_affine_state(n_features, cfg.affine_window_height,
                              cfg.affine_window_width, device)


def _warp_coords(x, y, A, hw: int, hh: int):
    """Affine-warped window sample coordinates [N, h, w]:
    xs = x + A00 i + A01 j, ys = y + A10 i + A11 j, summed in that order."""
    ii = torch.arange(-hw, hw + 1, dtype=x.dtype, device=x.device)
    jj = torch.arange(-hh, hh + 1, dtype=x.dtype, device=x.device)
    ii, jj = ii[None, None, :], jj[None, :, None]
    xs = x[:, None, None] + A[:, 0, 0, None, None] * ii + A[:, 0, 1, None, None] * jj
    ys = y[:, None, None] + A[:, 1, 0, None, None] * ii + A[:, 1, 1, None, None] * jj
    return torch.broadcast_tensors(xs, ys)


def _warp_oob(xs, ys, ncols: int, nrows: int):
    """Any warped sample outside the image -> the lane is OOB."""
    eps = _f32(_ONE_PLUS_EPS)
    bad = ((xs < 0.0) | (ncols - xs < eps) | (ys < 0.0) | (nrows - ys < eps))
    return bad.flatten(1).any(dim=1)


def _jacobian(gxw, gyw, hw: int, hh: int, mode: int):
    """[N, P, h*w] Gauss-Newton Jacobian rows (oracle _jacobian)."""
    n = gxw.shape[0]
    ii = torch.arange(-hw, hw + 1, dtype=gxw.dtype, device=gxw.device)
    jj = torch.arange(-hh, hh + 1, dtype=gxw.dtype, device=gxw.device)
    ii = ii[None, None, :].expand(gxw.shape)
    jj = jj[None, :, None].expand(gxw.shape)
    if mode == 0:
        rows = [gxw, gyw]
    elif mode == 1:
        rows = [gxw * ii + gyw * jj, -gxw * jj + gyw * ii, gxw, gyw]
    else:
        rows = [gxw * ii, gyw * ii, gxw * jj, gyw * jj, gxw, gyw]
    return torch.stack([r.reshape(n, -1) for r in rows], dim=1)


def _normal_equations(J, diff):
    """(J J^T [N, P, P], J diff [N, P]), each entry a ``tree_sum``; the
    lower triangle mirrors the upper one."""
    p = J.shape[1]
    T = torch.empty((J.shape[0], p, p), dtype=J.dtype, device=J.device)
    for a in range(p):
        for b in range(a, p):
            T[:, a, b] = T[:, b, a] = tree_sum(J[:, a] * J[:, b])
    e = torch.stack([tree_sum(J[:, a] * diff) for a in range(p)], dim=1)
    return T, e


def _step(d, mode: int):
    """(dA [N, 2, 2], dx, dy) from the solution vector of the mode."""
    if mode == 0:
        return None, d[:, 0], d[:, 1]
    if mode == 1:
        dA = torch.stack([torch.stack([d[:, 0], -d[:, 1]], -1),
                          torch.stack([d[:, 1], d[:, 0]], -1)], -2)
        return dA, d[:, 2], d[:, 3]
    dA = torch.stack([torch.stack([d[:, 0], d[:, 2]], -1),
                      torch.stack([d[:, 1], d[:, 3]], -1)], -2)
    return dA, d[:, 4], d[:, 5]


def _affine_track_batch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg):
    """Plain version of K6: batched Gauss-Newton template matching
    (oracle am_track_feature_affine, vectorized; affine.py:100-177 of the
    JAX package).

    ``tmpl``: [N, wh, ww] templates; ``img2``/``gx2``/``gy2``: [H, W]
    level-0 image and gradients of the new frame; ``x0``/``y0`` [N] start
    positions, ``A0`` [N, 2, 2] start warps, ``check`` bool [N]. Returns
    (x, y, A, status, nit): ``nit`` counts the Gauss-Newton updates each
    lane took. Unchecked lanes pass through with status KLT_TRACKED."""
    mode = int(cfg.affineConsistencyCheck)
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    nrows, ncols = img2.shape
    n = x0.shape[0]
    tm = tmpl.reshape(n, -1)
    # a tensor divisor: CUDA divides by a Python scalar via its reciprocal
    n_px = torch.full((), float(tm.shape[1]), dtype=torch.float32,
                      device=x0.device)
    min_det = _f32(cfg.min_determinant)
    min_disp = _f32(cfg.affine_min_displacement)

    x, y, A = x0, y0, A0
    status = torch.full((n,), KLT_TRACKED, dtype=torch.int32, device=x0.device)
    nit = torch.zeros((n,), dtype=torch.int32, device=x0.device)
    active = check
    for _ in range(cfg.affine_max_iterations):
        xs, ys = _warp_coords(x, y, A, hw, hh)
        oob = _warp_oob(xs, ys, ncols, nrows)
        status = torch.where(active & oob, KLT_OOB, status)
        live = active & ~oob

        diff = tm - bilinear(img2, xs, ys).reshape(n, -1)
        J = _jacobian(bilinear(gx2, xs, ys), bilinear(gy2, xs, ys), hw, hh,
                      mode)
        d, det = gauss_solve_det(*_normal_equations(J, diff))
        small = det.abs() < min_det
        status = torch.where(live & small, KLT_SMALL_DET, status)
        live = live & ~small

        dA, dx, dy = _step(d, mode)
        x = torch.where(live, x + dx, x)
        y = torch.where(live, y + dy, y)
        if dA is not None:
            A = torch.where(live[:, None, None], A + dA, A)
        nit = torch.where(live, nit + 1, nit)
        converged = (dx.abs() < min_disp) & (dy.abs() < min_disp)
        active = live & ~converged

    # post-loop: final warp OOB, then residue, then drift
    xs, ys = _warp_coords(x, y, A, hw, hh)
    final_oob = _warp_oob(xs, ys, ncols, nrows)
    status = torch.where(check & (status == KLT_TRACKED) & final_oob,
                         KLT_OOB, status)
    residue = tree_sum((tm - bilinear(img2, xs, ys).reshape(n, -1)).abs()
                       ) / n_px
    tracked = check & (status == KLT_TRACKED)
    status = torch.where(tracked & (residue > _f32(cfg.affine_max_residue)),
                         KLT_LARGE_RESIDUE, status)
    drift = torch.maximum((x - x0).abs(), (y - y0).abs())
    tracked = check & (status == KLT_TRACKED)
    status = torch.where(
        tracked & (drift > _f32(cfg.affine_max_displacement_differ)),
        KLT_OOB, status)
    return x, y, A, status, nit


def affine_consistency_check(pyr1, pyr2, fl_before: FeatureState,
                             fl_after: FeatureState, cfg) -> FeatureState:
    """Post-tracking affine verification stage (affine.py:180-289 of the
    JAX package, its default XLA route).

    ``pyr1``/``pyr2``: TrackPyramids of the two frames (level 0 = smoothed
    image + gradients). ``fl_before`` holds the pre-track positions
    (template anchors), ``fl_after`` the translation-tracked result and
    the AffineState to update. The template capture runs every call and
    is applied by mask (the JAX stage skips it under ``lax.cond`` when no
    lane needs it; the results are the same, without a host sync). On
    CUDA tensors the stage is one launch of K6's stage kernel."""
    n = fl_after.nFeatures
    dev = fl_after.x.device
    aff = fl_after.aff
    if aff is None or aff.img.shape[-1] != cfg.affine_window_width:
        aff = make_affine_state(n, cfg, dev)
    if aff.nit is None:
        aff = aff._replace(nit=torch.zeros((n,), dtype=torch.int32,
                                           device=dev))
    x, y, val, aff = cuda_affine.affine_stage(pyr1, pyr2, fl_before, fl_after,
                                              aff, cfg)
    return fl_after._replace(x=x, y=y, val=val, aff=aff)


def stage_reference(level1, level2, before_xy, before_val, after_xy,
                    after_val, aff: AffineState, cfg, counts=None):
    """Plain version of K6's stage (``cuda_affine.affine_stage``): the
    eager composition of lost lanes, template capture, the check and the
    selects. ``level1``/``level2``: (img, gradx, grady) of each frame's
    level 0; ``aff`` sized for ``cfg`` with ``nit`` set. Returns (x, y,
    val, AffineState). ``counts``: a device counter buffer
    (``utils/profiling.device_counters``) to add the kernel's counts to
    (lanes checked, their Gauss-Newton updates, lanes rejected), or
    None."""
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    bx, by = before_xy
    ax, ay = after_xy
    n = ax.shape[0]
    dev = ax.device
    tracked = after_val == KLT_TRACKED
    # lanes lost by translational tracking lose their template
    eye = identity_warps(n, dev)
    lost = (before_val >= 0) & ~tracked
    aff = aff._replace(valid=aff.valid & ~lost,
                       A=torch.where(lost[:, None, None], eye, aff.A))

    # first successful track -> capture the template, skip the check
    need_capture = tracked & ~aff.valid
    cap = need_capture[:, None, None]
    t_img, t_gx, t_gy = (gather_window(im, bx, by, hw, hh) for im in level1)
    aff = AffineState(
        img=torch.where(cap, t_img, aff.img),
        gradx=torch.where(cap, t_gx, aff.gradx),
        grady=torch.where(cap, t_gy, aff.grady),
        x=torch.where(need_capture, bx, aff.x),
        y=torch.where(need_capture, by, aff.y),
        A=torch.where(cap, eye, aff.A),
        valid=aff.valid | need_capture,
        nit=torch.where(need_capture, _CAPTURE_NIT, aff.nit))

    check = tracked & aff.valid & ~need_capture
    x, y, A, status, nit = _affine_track_batch(aff.img, *level2, ax, ay,
                                               aff.A, check, cfg)

    failed = check & (status != KLT_TRACKED)
    if counts is not None:
        profiling.add_device_counts(counts, {
            "k6.checked_lanes": check.sum(),
            "k6.gn_steps": torch.where(check, nit, 0).sum(),
            "k6.rejections": failed.sum()})
    new_x = torch.where(check, torch.where(failed, -1.0, x), ax)
    new_y = torch.where(check, torch.where(failed, -1.0, y), ay)
    new_val = torch.where(failed, status, after_val)
    keep = (check & ~failed)[:, None, None]
    aff = aff._replace(A=torch.where(keep, A, aff.A),
                       valid=aff.valid & ~failed)
    return new_x, new_y, new_val, aff
