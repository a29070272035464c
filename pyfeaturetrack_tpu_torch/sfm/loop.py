"""Loop closure for the monocular VO front-end (PyTorch port of
``pyfeaturetrack_tpu/sfm/loop.py``).

1. Re-observe (guided wide-baseline matching): the old keyframe's mapped
   features are re-tracked into the new keyframe with K2's guided starts
   (``ops/track.track_features_pyramids(x_init=, y_init=)``): the search
   starts at each landmark's projection through the new keyframe's pose
   estimate, and a guided forward-backward round trip gates appearance
   consistency (``guided_retrack``).
2. Measure: PnP-RANSAC (sfm/pnp) of the new keyframe against the old
   keyframe's world landmarks, metric in the map's gauge.
3. Correct: a Sim(3)-style geodesic correction of the chain
   (``close_loop_sim3``, what VisualOdometry uses) or a pose-graph
   redistribution (``close_loop_poses``, sfm/posegraph).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.track import track_features_pyramids
from .geometry import f32, to_host
from .posegraph import odometry_graph, optimize_pose_graph


def guided_retrack(pyr_a, pyr_b, x_a, y_a, x_init, y_init, cfg,
                   fb_max_displacement: float = 1.0):
    """Track features anchored in frame A into frame B, starting the search
    at (x_init, y_init) (an external motion prior), then track the
    B-anchored template back with the search started at (x_a, y_a); the
    round-trip miss distance gates acceptance. Runs on the pyramids'
    device: two K2 launches with guided starts on the card.

    Returns (x_b, y_b, ok, err) numpy: positions in B, the acceptance
    mask, and the round-trip miss distance (inf where either track
    failed).
    """
    dev = pyr_a.img[0].device
    x_a, y_a = f32(x_a, dev), f32(y_a, dev)
    n = x_a.shape[0]
    val = torch.zeros((n,), dtype=torch.int32, device=dev)
    nx, ny, nv = track_features_pyramids(
        pyr_a, pyr_b, x_a, y_a, val, cfg,
        x_init=f32(x_init, dev), y_init=f32(y_init, dev))
    bx, by, bv = track_features_pyramids(
        pyr_b, pyr_a, nx, ny, nv, cfg, x_init=x_a, y_init=y_a)
    bx, by, nx_h, ny_h, nv_h, bv_h, xa_h, ya_h = to_host(
        torch.stack([bx, by, nx, ny, nv.to(torch.float32),
                     bv.to(torch.float32), x_a, y_a]))
    err = np.hypot(bx - xa_h, by - ya_h)
    err = np.where((nv_h == 0) & (bv_h == 0), err, np.inf)
    ok = err <= fb_max_displacement
    return nx_h, ny_h, ok, err


def close_loop_sim3(R, t, i: int, j: int, R_j_meas, t_j_meas):
    """Closed-form Sim(3)-style loop correction for monocular chains
    (host, float64; the JAX package's function line for line).

    Anchors at keyframe ``i``, applies the full correction at ``j`` (the
    PnP-measured pose in the old map's gauge), and each keyframe k in
    (i..j] by the fraction w_k of cumulative path length: centers
    c_k' = c_i + s^{w_k} Rot(u, w_k θ)(c_k - c_i) + w_k d, orientations
    R_k' = R_k Rot(u, w_k θ)^T, with (u, θ) the axis-angle of
    R_meas^T R_j, s the chord ratio clamped to [0.8, 1.25] and d the
    shim that makes the j correction exact. Returns (R, t, A, b): the
    corrected poses and the per-keyframe point warp p' = A_k p + b_k.
    """
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    m = R.shape[0]
    c = np.einsum("kij,kj->ki", -np.transpose(R, (0, 2, 1)), t)
    R_m = np.asarray(R_j_meas, np.float64)
    c_m = -R_m.T @ np.asarray(t_j_meas, np.float64)

    dR = R_m.T @ R[j]                      # world-side full rotation
    tr = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(tr))
    if th > 1e-9:
        u = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                      dR[1, 0] - dR[0, 1]], np.float64)
        n = np.linalg.norm(u)
        u = u / n if n > 1e-12 else np.array([0.0, 1.0, 0.0])
    else:
        u = np.array([0.0, 1.0, 0.0])

    def rot(w):
        a = w * th
        ux, uy, uz = u
        Kx = np.array([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]],
                      np.float64)
        return (np.eye(3) + np.sin(a) * Kx +
                (1.0 - np.cos(a)) * (Kx @ Kx))

    chord_est = float(np.linalg.norm(c[j] - c[i]))
    chord_meas = float(np.linalg.norm(c_m - c[i]))
    s = chord_meas / chord_est if chord_est > 1e-9 else 1.0
    s = float(np.clip(s, 0.8, 1.25))
    d = c_m - (c[i] + s * rot(1.0) @ (c[j] - c[i]))

    seg = np.linalg.norm(np.diff(c[i:j + 1], axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1] if cum[-1] > 1e-12 else 1.0

    Rn, tn = R.copy(), t.copy()
    A = np.tile(np.eye(3), (m, 1, 1))
    b = np.zeros((m, 3))
    for k in range(i + 1, m):
        w = float(cum[min(k - i, j - i)] / total) if k <= j else 1.0
        Wr = rot(w)
        Ak = (s ** w) * Wr
        bk = c[i] - Ak @ c[i] + w * d
        ck = Ak @ c[k] + bk
        Rk = R[k] @ Wr.T
        Rn[k] = Rk
        tn[k] = -Rk @ ck
        A[k] = Ak
        b[k] = bk
    return Rn, tn, A, b


def close_loop_poses(R, t, i: int, j: int, R_j_meas, t_j_meas,
                     n_iters: int = 20, w_loop: float = 4.0, *,
                     device="cuda"):
    """Pose-graph drift redistribution for one loop closure, on
    ``device`` ("cuda" unless the caller passes "cpu").

    ``R``/``t``: current keyframe poses [M, 3, 3]/[M, 3] (world->cam).
    The chain edges are the current consecutive relative transforms; the
    loop edge i->j (up-weighted by ``w_loop``) comes from the trusted old
    pose i and the PnP-measured pose of keyframe j. Returns corrected
    (R, t) numpy with pose 0 pinned.
    """
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    m = R.shape[0]
    R_rel = np.stack([R[k + 1] @ R[k].T for k in range(m - 1)])
    t_rel = np.stack([t[k + 1] - R_rel[k] @ t[k] for k in range(m - 1)])
    R_ij = np.asarray(R_j_meas, np.float64) @ R[i].T
    t_ij = np.asarray(t_j_meas, np.float64) - R_ij @ t[i]
    graph = odometry_graph(
        R_rel.astype(np.float32), t_rel.astype(np.float32),
        loop_edges=[(i, j, R_ij.astype(np.float32),
                     t_ij.astype(np.float32))], device=device)
    w_rot, w_trans = graph.w_rot.clone(), graph.w_trans.clone()
    w_rot[-1] = w_loop
    w_trans[-1] = w_loop
    graph = graph._replace(w_rot=w_rot, w_trans=w_trans)
    Rn, tn, _ = optimize_pose_graph(graph, R.astype(np.float32),
                                    t.astype(np.float32), n_iters=n_iters)
    return to_host(Rn, np.float64), to_host(tn, np.float64)
