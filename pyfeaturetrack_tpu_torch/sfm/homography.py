"""Two-view planar homography: batched 4-point DLT, RANSAC, analytic
decomposition, and H/E model selection for the bootstrap (plain
PyTorch).

Port of ``pyfeaturetrack_tpu/sfm/homography.py``. RANSAC is one batched
tensor program as in sfm/epipolar.py (S minimal 4-point DLT systems,
[S, 9, 9] normal matrices, smallest eigenvector by inverse power, all
S x N symmetric transfer errors at once); the decomposition of the
winning H is a one-time float64 numpy step. ``two_view_bootstrap_auto``
scores both models with truncated inlier scores and initializes from the
winner; a homography that is a pure rotation is reported degenerate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import inv3x3
from .epipolar import (_gram, cheirality_scores, normalize_points,
                       ransac_essential, recover_pose, sample_subsets,
                       sampson_error, smallest_eigvec)
from .geometry import as_device, f32, require_fp32, to_host


def _homography_rows(x1, x2):
    """DLT rows: [..., N, 2, 9] such that rows . vec(H) = 0 for the
    row-major flattening of H with x2 ~ H x1h (homogeneous)."""
    ones = torch.ones_like(x1[..., 0])
    zeros = torch.zeros_like(ones)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    r1 = torch.stack([u1, v1, ones, zeros, zeros, zeros,
                      -u2 * u1, -u2 * v1, -u2], -1)
    r2 = torch.stack([zeros, zeros, zeros, u1, v1, ones,
                      -v2 * u1, -v2 * v1, -v2], -1)
    return torch.stack([r1, r2], -2)


def homography_from_matches(x1, x2, w=None):
    """Least-squares homography from >= 4 normalized matches:
    H = argmin ||diag(w) A vec(H)||, ||H||_F = 1. Batched over leading
    dims. x2 ~ H x1h."""
    rows = _homography_rows(x1, x2)
    if w is not None:
        rows = rows * w[..., None, None]
    rows = rows.reshape(rows.shape[:-3] + (-1, 9))
    h = smallest_eigvec(_gram(rows))
    return h.reshape(h.shape[:-1] + (3, 3))


def transfer_errors(H, x1, x2):
    """Squared forward and backward transfer errors [..., N] in
    normalized-coordinate units: ||x2 - proj(H x1)||^2 and
    ||x1 - proj(H^-1 x2)||^2."""
    Hinv, _ = inv3x3(H)

    def one_way(M, a, b):
        ah = torch.cat([a, torch.ones_like(a[..., :1])], -1)
        p = torch.matmul(ah, M.transpose(-1, -2))
        z = p[..., 2]
        far = z.abs() < 1e-12
        safe = torch.where(far, 1e-12, z)
        d = p[..., :2] / safe[..., None] - b
        err = (d * d).sum(-1)
        # a transferred point at (or behind) infinity is never an inlier
        return torch.where(far, 1e12, err)

    return one_way(H, x1, x2), one_way(Hinv, x2, x1)


def _ransac_core_h(x1, x2, valid, idx, thresh_sq, refit_rounds: int = 2):
    """Solve all S 4-point hypotheses, score all S x N symmetric transfer
    errors, pick the best, refit on its inliers. Returns (H, inliers,
    best_count)."""
    rows = _homography_rows(x1, x2)                      # [N, 2, 9]
    hyp_rows = rows[idx].reshape(idx.shape[0], -1, 9)    # [S, 8, 9]
    Hs = smallest_eigvec(_gram(hyp_rows)).reshape(-1, 3, 3)
    ef, eb = transfer_errors(Hs, x1[None], x2[None])     # [S, N]
    inl = (ef < thresh_sq) & (eb < thresh_sq) & valid[None]
    counts = inl.sum(-1)
    best = torch.argmax(counts)
    H, inliers = Hs[best], inl[best]
    for _ in range(refit_rounds):
        H = homography_from_matches(x1, x2, inliers.to(x1.dtype))
        ef, eb = transfer_errors(H, x1, x2)
        inliers = (ef < thresh_sq) & (eb < thresh_sq) & valid
    return H, inliers, counts[best]


def ransac_homography(x1, x2, valid=None, n_hypotheses: int = 512,
                      thresh: float = 3e-3, seed: int = 0,
                      refit_rounds: int = 2, *, device=None):
    """Robust homography from normalized matches [N, 2]. ``thresh`` is the
    per-direction transfer-error gate in normalized units. Returns
    (H [3,3], inlier mask [N], best count) as tensors."""
    x1, x2 = f32(x1, device), f32(x2, device)
    dev = x1.device
    require_fp32(dev)
    n = x1.shape[0]
    vnp = (np.ones((n,), bool) if valid is None
           else to_host(valid).astype(bool))
    idx = sample_subsets(vnp, 4, n_hypotheses, seed, "ransac_homography")
    return _ransac_core_h(x1, x2, torch.as_tensor(vnp, device=dev),
                          torch.as_tensor(idx, device=dev),
                          float(thresh) ** 2, refit_rounds)


def decompose_homography(H, x1=None, x2=None, inliers=None,
                         rot_tol: float = 1e-3):
    """Analytic decomposition H = R + t n^T / d into motion candidates
    (host, float64: one SVD and one eigh, once per bootstrap).

    Returns ``(Rs [M,3,3], ts [M,3], ns [M,3], degenerate)`` in the
    convention of sfm/epipolar (world = camera-1 frame, x2 ~ H x1);
    ``degenerate=True`` flags a pure rotation (one candidate, t = 0).
    Method: Ma-Soatto-Kosecka-Sastry, Algorithm 5.2, with H's sign fixed
    so inlier points satisfy x2h . (H x1h) > 0.
    """
    H = np.asarray(to_host(H), np.float64)
    if H.shape != (3, 3):
        raise ValueError(f"(decompose_homography) expected one [3, 3] "
                         f"homography, got {H.shape}")
    sv = np.linalg.svd(H, compute_uv=False)
    H = H / sv[1]
    if x1 is not None and x2 is not None:
        x1 = to_host(x1, np.float64)
        x2 = to_host(x2, np.float64)
        m = (np.ones(len(x1), bool) if inliers is None
             else to_host(inliers).astype(bool))
        if m.any():
            x1h = np.concatenate([x1[m], np.ones((m.sum(), 1))], -1)
            x2h = np.concatenate([x2[m], np.ones((m.sum(), 1))], -1)
            s = np.median(np.einsum("ni,ni->n", x2h, x1h @ H.T))
            if s < 0:
                H = -H
    w, V = np.linalg.eigh(H.T @ H)          # ascending: s3^2, s2^2, s1^2
    s3s, _, s1s = np.maximum(w, 0.0)
    if np.sqrt(s1s) - np.sqrt(s3s) < rot_tol:
        U, _, Vt = np.linalg.svd(H)
        R = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
        return (R[None], np.zeros((1, 3)), np.zeros((1, 3)), True)
    v1, v2, v3 = V[:, 2], V[:, 1], V[:, 0]  # descending singular order
    denom = np.sqrt(max(s1s - s3s, 1e-30))
    a = np.sqrt(max(1.0 - s3s, 0.0)) / denom
    b = np.sqrt(max(s1s - 1.0, 0.0)) / denom
    cands = []
    for u in (a * v1 + b * v3, a * v1 - b * v3):
        U1 = np.stack([v2, u, np.cross(v2, u)], -1)
        W1 = np.stack([H @ v2, H @ u, np.cross(H @ v2, H @ u)], -1)
        R = W1 @ U1.T
        n = np.cross(v2, u)
        t = (H - R) @ n
        cands.append((R, t, n))
        cands.append((R, -t, -n))
    Rs = np.stack([c[0] for c in cands])
    ts = np.stack([c[1] for c in cands])
    ns = np.stack([c[2] for c in cands])
    return Rs, ts, ns, False


def recover_pose_homography(H, x1, x2, inliers, *, device=None):
    """Pick the decomposition candidate with the best cheirality over the
    inlier matches (plane-normal visibility n_z > 0 breaks the remaining
    twofold ambiguity). Returns (R, unit t, n, X [N,3] triangulated at
    ||t|| = 1, good mask, degenerate) as numpy."""
    x1, x2 = f32(x1, device), f32(x2, device)
    dev = x1.device
    Rs, ts, ns, degen = decompose_homography(H, x1, x2, inliers)
    if degen:
        n = x1.shape[0]
        return (Rs[0], ts[0], ns[0], np.zeros((n, 3)),
                np.zeros(n, bool), True)
    norms = np.linalg.norm(ts, axis=-1)
    norms = np.where(norms < 1e-12, 1.0, norms)
    tsu = ts / norms[:, None]
    scores, Xs, goods = cheirality_scores(
        f32(Rs, dev), f32(tsu, dev), x1, x2,
        as_device(inliers, torch.bool, dev))
    scores = to_host(scores).astype(np.float64)
    # the visible plane must face camera 1; among cheirality ties prefer
    # n_z > 0
    scores = scores + 0.25 * (ns[:, 2] > 0)
    k = int(np.argmax(scores))
    return (Rs[k].astype(np.float64), tsu[k].astype(np.float64),
            ns[k].astype(np.float64), to_host(Xs[k], np.float64),
            to_host(goods[k]), False)


def _model_scores(E, H, x1, x2, valid, thresh_sq):
    """Truncated inlier scores (ORB-SLAM style): sum of (T - err) over
    matches with err < T, for the epipolar and homography models."""
    v = valid.to(x1.dtype)
    se = sampson_error(E, x1, x2)
    s_e = (torch.clamp(thresh_sq - se, min=0.0) * v).sum()
    ef, eb = transfer_errors(H, x1, x2)
    s_h = ((torch.clamp(thresh_sq - ef, min=0.0)
            + torch.clamp(thresh_sq - eb, min=0.0)) * 0.5 * v).sum()
    return s_e, s_h


def two_view_bootstrap_auto(K, uv1, uv2, valid=None,
                            thresh_px: float = 2.0,
                            n_hypotheses: int = 512, seed: int = 0,
                            h_ratio: float = 0.45, *, device="cuda"):
    """Metric-up-to-scale bootstrap with H/E model selection, on
    ``device`` ("cuda" unless the caller passes "cpu").

    Returns the dict of epipolar.two_view_bootstrap plus ``model``
    ("E" or "H"), ``score_ratio`` (s_h / (s_h + s_e); homography wins
    above ``h_ratio``), ``degenerate``, and for the H route the plane
    normal ``n``.
    """
    K = np.asarray(K, np.float64)
    x1 = normalize_points(K, uv1, device=device)
    x2 = normalize_points(K, uv2, device=device)
    dev = x1.device
    f = float(0.5 * (K[0, 0] + K[1, 1]))
    thresh = thresh_px / f
    n = x1.shape[0]
    valid = (torch.ones((n,), dtype=torch.bool, device=dev) if valid is None
             else as_device(valid, torch.bool, dev))
    E, inl_e, _ = ransac_essential(x1, x2, valid=valid,
                                   n_hypotheses=n_hypotheses,
                                   thresh=thresh, seed=seed)
    H, inl_h, _ = ransac_homography(x1, x2, valid=valid,
                                    n_hypotheses=n_hypotheses,
                                    thresh=thresh, seed=seed)
    s_e, s_h = _model_scores(E, H, x1, x2, valid, float(thresh) ** 2)
    s_e, s_h = (float(v) for v in to_host(torch.stack([s_e, s_h])))
    ratio = s_h / max(s_h + s_e, 1e-30)
    if ratio > h_ratio:
        R, t, nrm, X, good, degen = recover_pose_homography(
            H, x1, x2, inl_h)
        return {"R": R, "t": t, "X": X, "inliers": to_host(inl_h),
                "good": good, "model": "H", "n": nrm,
                "score_ratio": ratio, "degenerate": degen,
                "E": None, "H": to_host(H, np.float64)}
    R, t, X, good = recover_pose(E, x1, x2, inl_e)
    return {"R": R, "t": t, "X": X, "inliers": to_host(inl_e),
            "good": good, "model": "E", "n": None,
            "score_ratio": ratio, "degenerate": False,
            "E": to_host(E, np.float64), "H": None}
