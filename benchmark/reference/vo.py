"""Plain keyframe geometry in float64 PyTorch: the benchmark's reference for
the visual odometry's three solves, and the trajectory's alignment.

Written from the algorithms the program states (motion-only Gauss-Newton
with Huber weights, batched linear triangulation through the normal
equations, and the window's damped Gauss-Newton bundle adjustment with
the first camera fixed), in float64, with every matrix product an IEEE
float64 product (``fp64`` turns TF32 off). It imports nothing of the
program and takes nothing the program made but the inputs of the solve it
repeats.

The bundle adjustment solves the FULL normal equations of cameras and
landmarks together (one dense Cholesky factorisation an iteration), not
the Schur-reduced camera system the program solves: the same problem,
the same damping rule and start, another route to the same steps. What is
kept from the program's statement of the method:

* a residual is the projection minus the pixel; an observation behind its
  camera (depth under 1e-4) weighs 0; with ``huber_delta`` each weight is
  scaled by sqrt(min(1, delta / |r|)) (IRLS), r and both Jacobians alike;
* the rotation moves on the left: R <- exp(dw) R, t <- t + dt, X <- X + dX;
* refine_pose damps its 6x6 system by ``damping * (1 + diag)``;
* the bundle adjustment damps each camera's and each landmark's diagonal
  block by ``damping * diag + 1e-9``, adds 1e-8 to the cameras' diagonal,
  and holds camera 0 where it is;
* triangulation solves A33 X = -a4 of each landmark's DLT normal matrix
  with 1e-6 added to A33's diagonal.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def fp64() -> None:
    """Every CUDA matrix product in full precision (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def t64(a, device) -> torch.Tensor:
    """``a`` (array or tensor) as a float64 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=F64)
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, [..., 3] -> [..., 3, 3]."""
    th = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (3, 3))
    safe = torch.clamp(th, min=1e-12)
    K = skew(w) / safe
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(th < 1e-12, eye + skew(w), R)


def observation_terms(K, R, t, X, cam, pt, uv, w, huber_delta):
    """Weighted residuals [M, 2] and Jacobians [M, 2, 6] (rotation, then
    translation) and [M, 2, 3] of every observation."""
    Rc, Xp = R[cam], X[pt]
    RX = (Rc @ Xp[..., None])[..., 0]
    Y = RX + t[cam]
    z = Y[:, 2]
    behind = z < 1e-4
    zs = torch.where(behind, torch.ones_like(z), z)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    r = torch.stack([fx * Y[:, 0] / zs + cx, fy * Y[:, 1] / zs + cy],
                    -1) - uv
    o = torch.zeros_like(z)
    dpi = torch.stack([
        torch.stack([fx / zs, o, -fx * Y[:, 0] / (zs * zs)], -1),
        torch.stack([o, fy / zs, -fy * Y[:, 1] / (zs * zs)], -1)], -2)
    weight = w * (~behind).to(F64)
    if huber_delta is not None:
        rn = torch.sqrt((r * r).sum(-1) + 1e-12)
        weight = weight * torch.sqrt(torch.clamp(huber_delta / rn, max=1.0))
    r = r * weight[:, None]
    dpi = dpi * weight[:, None, None]
    Jc = torch.cat([-(dpi @ skew(RX)), dpi], -1)
    Jp = dpi @ Rc
    return r, Jc, Jp


def refine_pose(K, R0, t0, X, uv, w, n_iters: int, huber_delta,
                damping: float = 1e-6, device="cpu"):
    """Motion-only Gauss-Newton of one camera against fixed landmarks:
    (R [3, 3], t [3]) float64."""
    K, R, t = t64(K, device), t64(R0, device), t64(t0, device)
    X, uv, w = t64(X, device), t64(uv, device), t64(w, device)
    n = X.shape[0]
    cam = torch.zeros(n, dtype=torch.int64, device=device)
    pt = torch.arange(n, device=device)
    for _ in range(n_iters):
        r, Jc, _ = observation_terms(K, R[None], t[None], X, cam, pt, uv, w,
                                     huber_delta)
        J = Jc.reshape(-1, 6)
        H = J.T @ J
        g = -(J.T @ r.reshape(-1))
        H = H + damping * torch.diag(1.0 + torch.diagonal(H))
        dx = torch.linalg.solve_ex(H, g)[0]
        R = so3_exp(dx[:3]) @ R
        t = t + dx[3:]
    return R, t


def triangulate_dlt(K, Rs, ts, uvs, mask, device="cpu") -> torch.Tensor:
    """[L, 3] landmarks from [L, C, 2] pixels seen by the masked cameras."""
    K, Rs, ts = t64(K, device), t64(Rs, device), t64(ts, device)
    uvs = t64(uvs, device)
    m = t64(np.asarray(mask, np.float64) if not isinstance(mask, torch.Tensor)
            else mask, device)[..., None]
    P = K @ torch.cat([Rs, ts[..., None]], -1)
    ru = (uvs[..., 0:1] * P[None, :, 2, :] - P[None, :, 0, :]) * m
    rv = (uvs[..., 1:2] * P[None, :, 2, :] - P[None, :, 1, :]) * m
    A = torch.cat([ru, rv], 1)
    AtA = A.transpose(1, 2) @ A
    M = AtA[:, :3, :3] + 1e-6 * torch.eye(3, dtype=F64, device=device)
    return torch.linalg.solve_ex(M, -AtA[:, :3, 3:])[0][..., 0]


def consistent(K, Rs, ts, uvs, mask, X, gate_px: float) -> torch.Tensor:
    """[L] bool: the points a map takes, each in front of every observing
    camera by 1e-3 and reprojected within ``gate_px`` of each of its
    pixels."""
    device = X.device
    K, Rs, ts, uvs = (t64(a, device) for a in (K, Rs, ts, uvs))
    m = torch.as_tensor(np.asarray(mask), device=device)
    Y = torch.einsum("cij,lj->lci", Rs, X) + ts[None]
    z = Y[..., 2]
    zs = torch.where(z >= 1e-3, z, torch.ones_like(z))
    u = K[0, 0] * Y[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Y[..., 1] / zs + K[1, 2]
    miss = torch.hypot(u - uvs[..., 0], v - uvs[..., 1])
    return ((z >= 1e-3) & (miss <= gate_px) | ~m).all(1)


def bundle_adjust(K, cam, pt, uv, w, R0, t0, X0, n_iters: int, huber_delta,
                  damping: float = 1e-3, device="cpu"):
    """The window's damped Gauss-Newton with camera 0 held, each step from
    the full normal equations of cameras 1..C-1 and every landmark:
    (R [C, 3, 3], t [C, 3], X [L, 3]) float64."""
    K = t64(K, device)
    cam = torch.as_tensor(cam, device=device).long()
    pt = torch.as_tensor(pt, device=device).long()
    uv, w = t64(uv, device), t64(w, device)
    R, t, X = t64(R0, device), t64(t0, device), t64(X0, device)
    C, L = R.shape[0], X.shape[0]
    nc = 6 * (C - 1)
    n = nc + 3 * L
    # rows of each observation's camera block (camera 0 has none) and of
    # its landmark block in the full system
    free = cam > 0
    crow = 6 * (cam - 1)
    prow = nc + 3 * pt
    a6 = torch.arange(6, device=device)
    a3 = torch.arange(3, device=device)
    for _ in range(n_iters):
        r, Jc, Jp = observation_terms(K, R, t, X, cam, pt, uv, w,
                                      huber_delta)
        H = torch.zeros((n, n), dtype=F64, device=device)
        g = torch.zeros(n, dtype=F64, device=device)
        Hpp = Jp.transpose(1, 2) @ Jp
        gp = -(Jp.transpose(1, 2) @ r[..., None])[..., 0]
        pi = prow[:, None] + a3[None]
        H.index_put_((pi[:, :, None].expand(-1, 3, 3),
                      pi[:, None, :].expand(-1, 3, 3)), Hpp, accumulate=True)
        g.index_put_((pi,), gp, accumulate=True)
        Hcc = Jc[free].transpose(1, 2) @ Jc[free]
        Hcp = Jc[free].transpose(1, 2) @ Jp[free]
        gc = -(Jc[free].transpose(1, 2) @ r[free][..., None])[..., 0]
        ci = crow[free][:, None] + a6[None]
        pf = pi[free]
        H.index_put_((ci[:, :, None].expand(-1, 6, 6),
                      ci[:, None, :].expand(-1, 6, 6)), Hcc, accumulate=True)
        H.index_put_((ci[:, :, None].expand(-1, 6, 3),
                      pf[:, None, :].expand(-1, 6, 3)), Hcp, accumulate=True)
        H.index_put_((pf[:, :, None].expand(-1, 3, 6),
                      ci[:, None, :].expand(-1, 3, 6)),
                     Hcp.transpose(1, 2), accumulate=True)
        g.index_put_((ci,), gc, accumulate=True)
        d = torch.diagonal(H).clone()
        extra = damping * d + 1e-9
        extra[:nc] += 1e-8
        H = H + torch.diag(extra)
        chol, info = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(g[:, None], chol)[:, 0]
        if int(info):
            dx = torch.full_like(dx, float("nan"))
        dc = torch.cat([torch.zeros(6, dtype=F64, device=device),
                        dx[:nc]]).reshape(C, 6)
        R = so3_exp(dc[:, :3]) @ R
        t = t + dc[:, 3:]
        X = X + dx[nc:].reshape(L, 3)
    return R, t, X


def centres(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera centres -R^T t of world->camera poses."""
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


def rotation_gap(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle in radians of Ra Rb^T, exact near zero (from the chord)."""
    chord = torch.linalg.matrix_norm(Ra - Rb)
    return 2.0 * torch.asin(torch.clamp(chord / (2.0 * np.sqrt(2.0)),
                                        max=1.0))


def ate_aligned(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of [N, 3] centres after the least-squares similarity (Umeyama)
    that maps them onto the ground truth; inf where a centre is not
    finite."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    if not np.isfinite(est).all():
        return float("inf")
    me, mg = est.mean(0), gt.mean(0)
    a, b = est - me, gt - mg
    cov = b.T @ a / len(est)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    Rm = U @ D @ Vt
    var = (a * a).sum() / len(est)
    s = np.trace(np.diag(S) @ D) / var if var > 0 else 1.0
    aligned = s * a @ Rm.T + mg
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))
