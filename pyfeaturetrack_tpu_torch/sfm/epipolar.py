"""Two-view epipolar geometry: batched 8-point essential matrix, RANSAC,
and relative-pose recovery (plain PyTorch).

Port of ``pyfeaturetrack_tpu/sfm/epipolar.py``. RANSAC is one batched
tensor program: S minimal 8-point subsets are solved together ([S, 9, 9]
normal matrices, smallest eigenvector by 16 fixed inverse-power steps on
the unpivoted Gauss-Jordan solver of ops/linalg), and all S x N Sampson
errors are a few batched products. The hypothesis subsets are drawn on
the host with ``np.random.default_rng(seed)`` in the JAX package's order,
so both packages score the same hypotheses. The only host steps are the
3x3 SVD of the winning E (numpy, float64) and the 4-way cheirality
argmax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import gauss_solve_det
from .geometry import as_device, f32, require_fp32, to_host
from .triangulate import triangulate_dlt


def normalize_points(K, uv, *, device=None) -> torch.Tensor:
    """Pixel coordinates [..., 2] -> normalized camera-plane coordinates
    (K^-1 applied; pinhole K with zero skew, as in geometry.project)."""
    uv = f32(uv, device)
    K = f32(K, uv.device)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def _epipolar_rows(x1, x2):
    """[..., N, 9] rows a s.t. a . vec(E) = x2h^T E x1h (homogeneous)."""
    ones = torch.ones_like(x1[..., 0])
    return torch.stack([
        x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
        x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
        x1[..., 0], x1[..., 1], ones,
    ], -1)


def _gram(rows):
    """[..., N, P] -> [..., P, P] rows^T rows."""
    return torch.matmul(rows.transpose(-1, -2), rows)


def smallest_eigvec(M: torch.Tensor, n_iter: int = 16) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    [..., P, P] batches, by ``n_iter`` fixed inverse-power steps on
    (M + eps I), each solve the unrolled Gauss-Jordan of ops/linalg."""
    p = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    A = M + (1e-9 * tr / p + 1e-12) * torch.eye(p, dtype=M.dtype,
                                                device=M.device)
    # fixed full-spectrum start vector (deterministic)
    v = torch.full(M.shape[:-1], 1.0, dtype=M.dtype, device=M.device) \
        + 0.01 * torch.arange(p, dtype=M.dtype, device=M.device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(n_iter):
        v, _ = gauss_solve_det(A, v)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)
    return v


def essential_from_matches(x1, x2, w=None) -> torch.Tensor:
    """Least-squares (unenforced) essential matrix from >= 8 normalized
    matches: E = argmin ||diag(w) A vec(E)||, ||E||_F = 1. Batched over
    leading dims."""
    rows = _epipolar_rows(x1, x2)
    if w is not None:
        rows = rows * w[..., None]
    e = smallest_eigvec(_gram(rows))
    return e.reshape(e.shape[:-1] + (3, 3))


def sampson_error(E, x1, x2) -> torch.Tensor:
    """First-order (Sampson) squared epipolar error [..., N] in
    normalized-coordinate units."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    Ex1 = torch.matmul(x1h, E.transpose(-1, -2))         # [..., N, 3]
    Etx2 = torch.matmul(x2h, E)                          # [..., N, 3]
    num = (x2h * Ex1).sum(-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return num / (den + 1e-30)


def _ransac_core(x1, x2, valid, idx, thresh_sq, refit_rounds: int = 2):
    """Solve all S hypotheses, score all S x N, pick the best,
    IRLS-refit on its inliers. Returns (E, inliers, best_count)."""
    rows = _epipolar_rows(x1, x2)                        # [N, 9]
    hyp_rows = rows[idx]                                 # [S, 8, 9]
    Es = smallest_eigvec(_gram(hyp_rows)).reshape(-1, 3, 3)
    err = sampson_error(Es, x1[None], x2[None])          # [S, N]
    inl = (err < thresh_sq) & valid[None]
    counts = inl.sum(-1)
    best = torch.argmax(counts)      # the first maximum, as jnp.argmax
    E, inliers = Es[best], inl[best]
    for _ in range(refit_rounds):
        E = essential_from_matches(x1, x2, inliers.to(x1.dtype))
        inliers = (sampson_error(E, x1, x2) < thresh_sq) & valid
    return E, inliers, counts[best]


def sample_subsets(valid, size: int, n_hypotheses: int, seed: int,
                   who: str) -> np.ndarray:
    """[S, size] minimal subsets of the valid indices, drawn on the host
    in the JAX package's order (one ``rng.choice`` per hypothesis)."""
    cand = np.nonzero(valid)[0]
    if cand.size < size:
        raise ValueError(f"({who}) need >= {size} valid "
                         f"{'points' if who == 'pnp_ransac' else 'matches'}"
                         f", got {cand.size}")
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(cand, size=size, replace=False)
                     for _ in range(n_hypotheses)])


def ransac_essential(x1, x2, valid=None, n_hypotheses: int = 512,
                     thresh: float = 3e-3, seed: int = 0,
                     refit_rounds: int = 2, *, device=None):
    """Robust essential matrix from normalized matches [N, 2].

    ``thresh`` is the Sampson distance gate in normalized units (a pixel
    threshold p at focal length f is p / f). Returns (E [3,3], inlier mask
    [N], best hypothesis count) as tensors on the matches' device."""
    x1, x2 = f32(x1, device), f32(x2, device)
    dev = x1.device
    require_fp32(dev)
    n = x1.shape[0]
    vnp = (np.ones((n,), bool) if valid is None
           else to_host(valid).astype(bool))
    idx = sample_subsets(vnp, 8, n_hypotheses, seed, "ransac_essential")
    return _ransac_core(x1, x2, torch.as_tensor(vnp, device=dev),
                        torch.as_tensor(idx, device=dev),
                        float(thresh) ** 2, refit_rounds)


def decompose_essential(E: np.ndarray):
    """E -> the four (R, t) candidates (host: one 3x3 SVD in float64).

    Convention matches geometry.project: world = camera-1 frame and
    (R, t) map world -> camera 2, x2 ~ K (R X + t). t has unit norm
    (monocular scale is unobservable)."""
    E = np.asarray(E, np.float64)
    if E.shape != (3, 3):
        raise ValueError(f"(decompose_essential) expected one [3, 3] "
                         f"essential matrix, got {E.shape}")
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1, R2 = U @ W @ Vt, U @ W.T @ Vt
    t = U[:, 2]
    return (np.stack([R1, R1, R2, R2]),
            np.stack([t, -t, t, -t]).astype(np.float64))


def cheirality_scores(Rs4, ts4, x1, x2, w):
    """Triangulate all matches under each of the M candidates and count
    points in front of BOTH cameras. Returns (scores [M], X [M, N, 3],
    good [M, N])."""
    dev = x1.device
    eye = torch.eye(3, dtype=x1.dtype, device=dev)
    uvs = torch.stack([x1, x2], dim=1)                   # [N, 2, 2]
    mask = w[:, None].expand(uvs.shape[:2])
    scores, Xs, goods = [], [], []
    for R, t in zip(Rs4, ts4):
        Rs = torch.stack([eye, R])
        ts = torch.stack([torch.zeros(3, dtype=x1.dtype, device=dev), t])
        X = triangulate_dlt(eye, Rs, ts, uvs, mask)
        d1 = X[:, 2]
        d2 = torch.matmul(X, R.T)[:, 2] + t[2]
        good = w & (d1 > 1e-6) & (d2 > 1e-6)
        scores.append(good.sum())
        Xs.append(X)
        goods.append(good)
    return torch.stack(scores), torch.stack(Xs), torch.stack(goods)


def recover_pose(E, x1, x2, inliers, *, device=None):
    """Pick the (R, t) candidate with the best cheirality over the inlier
    matches. Returns (R [3,3], unit t [3], X [N,3] triangulated at
    ||t|| = 1, good [N] cheirality-consistent inlier mask) as numpy."""
    x1, x2 = f32(x1, device), f32(x2, device)
    dev = x1.device
    Rs4, ts4 = decompose_essential(to_host(E))
    scores, Xs, goods = cheirality_scores(
        f32(Rs4, dev), f32(ts4, dev), x1, x2,
        as_device(inliers, torch.bool, dev))
    k = int(np.argmax(to_host(scores)))
    return (Rs4[k].astype(np.float64), ts4[k].astype(np.float64),
            to_host(Xs[k], np.float64), to_host(goods[k]))


def two_view_bootstrap(K, uv1, uv2, valid=None, thresh_px: float = 2.0,
                       n_hypotheses: int = 512, seed: int = 0, *,
                       device="cuda"):
    """Full metric-up-to-scale bootstrap from pixel matches (on
    ``device``, "cuda" unless the caller passes "cpu").

    Returns dict with R, t (unit baseline), X [N, 3] landmarks in the
    camera-1 = world frame, inliers (epipolar), good (epipolar AND
    cheirality), all numpy.
    """
    K = np.asarray(K, np.float64)
    x1 = normalize_points(K, uv1, device=device)
    x2 = normalize_points(K, uv2, device=device)
    f = float(0.5 * (K[0, 0] + K[1, 1]))
    E, inliers, count = ransac_essential(
        x1, x2, valid=valid, n_hypotheses=n_hypotheses,
        thresh=thresh_px / f, seed=seed)
    E = to_host(E)
    R, t, X, good = recover_pose(E, x1, x2, inliers)
    return {"R": R, "t": t, "X": X, "inliers": to_host(inliers),
            "good": good, "n_best_hypothesis": int(to_host(count)),
            "E": np.asarray(E, np.float64)}
