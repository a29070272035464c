"""Trajectory interchange and odometry evaluation: TUM and KITTI
formats, ATE/RPE metrics (the port's own copy of
``pyfeaturetrack_tpu/utils/trajectory.py``, numpy only).

Beyond the reference (whose persistence layer stops at feature tables —
writeFeatures.py): the SfM/VO extensions need to exchange CAMERA
trajectories with standard tooling. Two formats cover the ecosystem:

* TUM RGB-D format: one line per pose, ``timestamp tx ty tz qx qy qz
  qw``, camera-to-world convention — consumed by evo, rgbd-benchmark
  tools, ORB-SLAM comparisons.
* KITTI odometry format: one line per pose, the 12 row-major entries of
  the 3x4 camera-to-world matrix [R | t] — consumed by the KITTI devkit.

Both writers take the VisualOdometry convention (R, t world->camera,
as in sfm/geometry.project) and convert: C = -R^T t, R_c2w = R^T.

Metrics mirror the standard definitions: ATE (after optional Umeyama
similarity alignment, sfm/pipeline.umeyama_align) and RPE — relative
pose error over a fixed frame delta, the drift metric the KITTI devkit
reports per path length; both translational and rotational parts.
"""

from __future__ import annotations

import numpy as np

from ..errors import KLTError


def _as_c2w(R, t):
    """(R, t) world->camera [M, 3, 3]/[M, 3] -> (R_c2w, centers)."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    Rc = np.transpose(R, (0, 2, 1))
    C = -np.einsum("kij,kj->ki", Rc, t)
    return Rc, C


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """[..., 3, 3] -> unit quaternion [..., 4] as (qx, qy, qz, qw),
    TUM component order. Shepperd's method (branch on the largest
    diagonal combination) — stable for all rotations."""
    R = np.asarray(R, np.float64)
    batch = R.shape[:-2]
    R = R.reshape(-1, 3, 3)
    q = np.empty((R.shape[0], 4))
    tr = np.trace(R, axis1=-2, axis2=-1)
    for i, M in enumerate(R):
        if tr[i] > 0:
            s = np.sqrt(tr[i] + 1.0) * 2.0
            q[i] = [(M[2, 1] - M[1, 2]) / s, (M[0, 2] - M[2, 0]) / s,
                    (M[1, 0] - M[0, 1]) / s, 0.25 * s]
        elif M[0, 0] >= M[1, 1] and M[0, 0] >= M[2, 2]:
            s = np.sqrt(1.0 + M[0, 0] - M[1, 1] - M[2, 2]) * 2.0
            q[i] = [0.25 * s, (M[0, 1] + M[1, 0]) / s,
                    (M[0, 2] + M[2, 0]) / s, (M[2, 1] - M[1, 2]) / s]
        elif M[1, 1] >= M[2, 2]:
            s = np.sqrt(1.0 + M[1, 1] - M[0, 0] - M[2, 2]) * 2.0
            q[i] = [(M[0, 1] + M[1, 0]) / s, 0.25 * s,
                    (M[1, 2] + M[2, 1]) / s, (M[0, 2] - M[2, 0]) / s]
        else:
            s = np.sqrt(1.0 + M[2, 2] - M[0, 0] - M[1, 1]) * 2.0
            q[i] = [(M[0, 2] + M[2, 0]) / s, (M[1, 2] + M[2, 1]) / s,
                    0.25 * s, (M[1, 0] - M[0, 1]) / s]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.reshape(batch + (4,))


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) [..., 4] -> [..., 3, 3]."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


def write_tum(path, R, t, timestamps=None) -> None:
    """Write a TUM-format trajectory from world->camera (R, t) stacks.
    ``timestamps`` defaults to the frame index."""
    Rc, C = _as_c2w(R, t)
    q = rotation_to_quaternion(Rc)
    ts = (np.arange(len(C), dtype=np.float64) if timestamps is None
          else np.asarray(timestamps, np.float64))
    if len(ts) != len(C):
        raise KLTError(f"(write_tum) {len(ts)} timestamps for "
                       f"{len(C)} poses")
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for k in range(len(C)):
            f.write(f"{ts[k]:.6f} "
                    + " ".join(f"{v:.9f}" for v in C[k])
                    + " " + " ".join(f"{v:.9f}" for v in q[k]) + "\n")


def read_tum(path):
    """Read a TUM-format trajectory. Returns (timestamps [M],
    R [M, 3, 3] world->camera, t [M, 3], centers [M, 3])."""
    ts, Cs, qs = [], [], []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 8:
                raise KLTError(f"(read_tum) {path}:{ln}: expected 8 "
                               f"fields, got {len(parts)}")
            try:
                vals = [float(p) for p in parts]
            except ValueError:
                raise KLTError(f"(read_tum) {path}:{ln}: non-numeric "
                               f"field") from None
            ts.append(vals[0])
            Cs.append(vals[1:4])
            qs.append(vals[4:8])
    if not ts:
        raise KLTError(f"(read_tum) {path}: no poses")
    C = np.asarray(Cs)
    Rc = quaternion_to_rotation(np.asarray(qs))
    R = np.transpose(Rc, (0, 2, 1))
    t = -np.einsum("kij,kj->ki", R, C)
    return np.asarray(ts), R, t, C


def write_kitti(path, R, t) -> None:
    """Write a KITTI odometry trajectory (12 row-major [R_c2w | C]
    entries per line) from world->camera (R, t) stacks."""
    Rc, C = _as_c2w(R, t)
    with open(path, "w") as f:
        for k in range(len(C)):
            P = np.concatenate([Rc[k], C[k][:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in P.reshape(-1)) + "\n")


def read_kitti(path):
    """Read a KITTI odometry trajectory. Returns (R [M, 3, 3]
    world->camera, t [M, 3], centers [M, 3])."""
    Rcs, Cs = [], []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 12:
                raise KLTError(f"(read_kitti) {path}:{ln}: expected 12 "
                               f"fields, got {len(parts)}")
            try:
                P = np.asarray([float(p) for p in parts]).reshape(3, 4)
            except ValueError:
                raise KLTError(f"(read_kitti) {path}:{ln}: non-numeric "
                               f"field") from None
            Rcs.append(P[:, :3])
            Cs.append(P[:, 3])
    if not Rcs:
        raise KLTError(f"(read_kitti) {path}: no poses")
    Rc = np.stack(Rcs)
    C = np.stack(Cs)
    R = np.transpose(Rc, (0, 2, 1))
    t = -np.einsum("kij,kj->ki", R, C)
    return R, t, C


def rpe(R, t, R_gt, t_gt, delta: int = 1):
    """Relative pose error over frame delta (KITTI-devkit style drift
    metric). Inputs are world->camera stacks. Returns
    (trans_err [M-delta] — norm of the relative-translation error,
    rot_err [M-delta] — relative-rotation angle error, radians)."""
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    R_gt = np.asarray(R_gt, np.float64)
    t_gt = np.asarray(t_gt, np.float64)
    m = len(R) - int(delta)
    if m < 1:
        raise KLTError(f"(rpe) need more than delta={delta} poses, "
                       f"got {len(R)}")
    te = np.empty(m)
    re = np.empty(m)
    for k in range(m):
        # relative motion camera_k -> camera_{k+delta}: T_b T_a^{-1}
        dR = R[k + delta] @ R[k].T
        dt = t[k + delta] - dR @ t[k]
        dRg = R_gt[k + delta] @ R_gt[k].T
        dtg = t_gt[k + delta] - dRg @ t_gt[k]
        Er = dRg.T @ dR
        te[k] = np.linalg.norm(dt - dtg)
        re[k] = np.arccos(np.clip((np.trace(Er) - 1.0) / 2.0, -1.0, 1.0))
    return te, re
