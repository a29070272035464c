"""Camera pose from 3D-2D correspondences: motion-only Gauss-Newton
("PnP refinement") and batched DLT-PnP RANSAC (plain PyTorch).

Port of ``pyfeaturetrack_tpu/sfm/pnp.py``. The GN normal equations are
one [6, 6] solve per iteration (ops/linalg Gauss-Jordan; Jacobians shared
with sfm/ba._obs_terms), and RANSAC is one batched tensor program: S
minimal 6-point DLT systems ([S, 12, 12] normal matrices, smallest
eigenvector by inverse power), rotations orthogonalized by a batched
Newton polar iteration, all S x N reprojection errors scored together.
Hypothesis subsets are drawn on the host in the JAX package's order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import gauss_solve_det, inv3x3
from .ba import _obs_terms
from .epipolar import normalize_points, sample_subsets, smallest_eigvec
from .geometry import f32, require_fp32, so3_exp, to_host


def refine_pose(K, R0, t0, X, uv, w, n_iters: int = 10,
                huber_delta: float | None = None, damping: float = 1e-6, *,
                device=None):
    """Motion-only GN: refine ONE camera pose against fixed landmarks.

    X [N, 3] world points, uv [N, 2] pixels, w [N] weights (0 masks).
    Returns (R, t, cost) tensors on the points' device (arrays go to
    ``device``, default "cuda"); cost is the weighted squared pixel error
    before the last step.
    """
    X = f32(X, device)
    dev = X.device
    require_fp32(dev)
    K, uv, w = f32(K, dev), f32(uv, dev), f32(w, dev)
    R, t = f32(R0, dev), f32(t0, dev)
    n = X.shape[0]
    cam_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    pt_idx = torch.arange(n, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        r, Jc, _, cost = _obs_terms(K, R[None], t[None], X, cam_idx, pt_idx,
                                    uv, w, huber_delta)
        Jf = Jc.reshape(-1, 6)
        H = torch.matmul(Jf.T, Jf)
        g = -torch.matmul(Jf.T, r.reshape(-1))
        H = H + damping * eye6 * (1.0 + torch.diagonal(H))
        dx, _ = gauss_solve_det(H, g)
        R = torch.matmul(so3_exp(dx[:3]), R)
        t = t + dx[3:]
    return R, t, cost


def _dlt_rows(X, x):
    """[..., N, 2, 12] DLT constraint rows for normalized pixels x and
    world points X; p = rows of P = [R | t] flattened row-major."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)     # [..., N, 4]
    zero = torch.zeros_like(Xh)
    ru = torch.cat([Xh, zero, -x[..., 0:1] * Xh], -1)
    rv = torch.cat([zero, Xh, -x[..., 1:2] * Xh], -1)
    return torch.stack([ru, rv], -2)


def _polar_orthogonalize(M: torch.Tensor, n_iter: int = 6) -> torch.Tensor:
    """Nearest rotation to near-orthogonal [..., 3, 3] batches by Newton
    polar iteration R <- 1.5 R - 0.5 R R^T R."""
    R = M
    for _ in range(n_iter):
        RtR = torch.matmul(R.transpose(-1, -2), R)
        R = 1.5 * R - 0.5 * torch.matmul(R, RtR)
    return R


def _pnp_core(x, X, valid, idx, thresh_sq):
    """All S minimal DLT hypotheses + scoring. Returns (R [S,3,3],
    t [S,3], err [S,N], counts [S])."""
    rows = _dlt_rows(X, x)                               # [N, 2, 12]
    hyp = rows[idx].reshape(idx.shape[0], -1, 12)        # [S, 12, 12]
    AtA = torch.matmul(hyp.transpose(1, 2), hyp)
    p = smallest_eigvec(AtA)                             # [S, 12]
    P = p.reshape(-1, 3, 4)
    M = P[:, :, :3]
    _, det = inv3x3(M)
    # fix projective sign/scale: det(M/s) = 1 for s = cbrt(det)
    s = torch.sign(det) * det.abs() ** (1.0 / 3.0)
    s = torch.where(s.abs() < 1e-12, 1e-12, s)[:, None, None]
    R = _polar_orthogonalize(M / s)
    t = P[:, :, 3] / s[:, :, 0]
    # reprojection in normalized coords
    Y = torch.matmul(R[:, None], X[None, :, :, None])[..., 0] + t[:, None]
    z = Y[..., 2]
    front = z > 1e-6
    zs = torch.where(front, z, 1.0)
    pred = Y[..., :2] / zs[..., None]
    err = ((pred - x[None]) ** 2).sum(-1)
    err = torch.where(front, err, torch.inf)
    inl = (err < thresh_sq) & valid[None]
    return R, t, err, inl.sum(-1)


def pnp_ransac(K, X, uv, valid=None, n_hypotheses: int = 256,
               thresh_px: float = 3.0, seed: int = 0,
               refine_iters: int = 10, *, device="cuda"):
    """Robust pose from [N, 3] world points and [N, 2] pixels, no prior,
    on ``device`` ("cuda" unless the caller passes "cpu").

    One batched program for hypotheses + scoring; the winner is refined
    by motion-only GN on its inliers. Returns (R, t, inliers) numpy.
    """
    X = f32(X, device if not isinstance(X, torch.Tensor) else None)
    dev = X.device
    require_fp32(dev)
    uv = f32(uv, dev)
    n = X.shape[0]
    vnp = (np.ones((n,), bool) if valid is None
           else to_host(valid).astype(bool))
    idx = sample_subsets(vnp, 6, n_hypotheses, seed, "pnp_ransac")
    Kn = np.asarray(K, np.float64)
    x = normalize_points(Kn, uv)
    thr = (thresh_px / float(0.5 * (Kn[0, 0] + Kn[1, 1]))) ** 2
    Rs, ts, err, counts = _pnp_core(x, X, torch.as_tensor(vnp, device=dev),
                                    torch.as_tensor(idx, device=dev), thr)
    best = int(np.argmax(to_host(counts)))
    inliers = to_host(err[best] < thr)
    R, t, _ = refine_pose(Kn, Rs[best], ts[best], X, uv,
                          torch.as_tensor(inliers & vnp, device=dev),
                          n_iters=refine_iters, huber_delta=2.0)
    return to_host(R, np.float64), to_host(t, np.float64), inliers
