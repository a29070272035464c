"""Tracker -> SfM glue: feature tables to bundle-adjusted reconstructions
(PyTorch port of ``pyfeaturetrack_tpu/sfm/pipeline.py``).

KLT tracks (FeatureTable) -> observation set -> DLT triangulation from
initial poses -> Schur-complement bundle adjustment -> refined poses +
landmarks, with ATE metrics against ground truth (numpy, float64);
``run_sfm_windowed`` is the same pass through the windowed BA.
``run_sfm(mesh=...)`` shards the landmarks over the mesh's ``landmark``
axis (``ba.pad_problem_for_mesh``, ``bundle_adjust(mesh=...)``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ba import bundle_adjust, make_problem, pad_problem_for_mesh
from .ba_windowed import (bundle_adjust_windowed, column_runs, gate_windowed,
                          make_windowed_problem, triangulate_windowed,
                          windowed_from_feature_table)
from .geometry import f32, project, to_host
from .triangulate import triangulate_dlt


def observations_from_feature_table(ft, min_track_len: int = 2,
                                    return_runs: bool = False):
    """FeatureTable -> (cam_idx, pt_idx, uv, w) numpy observation arrays.

    Landmark identity is a maximal contiguous live run of a feature
    column (ba_windowed.column_runs). Runs shorter than ``min_track_len``
    keep their observations but are weighted out.
    """
    x = to_host(ft.x, np.float64)
    y = to_host(ft.y, np.float64)
    runs = column_runs(ft)
    frames, feats, pts, w = [], [], [], []
    for li, (j, s, ln) in enumerate(runs):
        frames.extend(range(s, s + ln))
        feats.extend([j] * ln)
        pts.extend([li] * ln)
        w.extend([1.0 if ln >= min_track_len else 0.0] * ln)
    frames = np.asarray(frames, np.int32)
    feats = np.asarray(feats, np.int32)
    uv = np.stack([x[frames, feats], y[frames, feats]], axis=-1)
    out = (frames, np.asarray(pts, np.int32),
           uv.astype(np.float32), np.asarray(w, np.float32))
    return out + (runs,) if return_runs else out


def initial_landmarks(K, Rs, ts, ft, min_track_len: int = 2, runs=None, *,
                      device="cuda"):
    """DLT-triangulate every landmark run from the given initial poses
    (on ``device``)."""
    if runs is None:
        runs = column_runs(ft)
    x = to_host(ft.x, np.float64)
    y = to_host(ft.y, np.float64)
    C = np.asarray(to_host(Rs)).shape[0]
    L = len(runs)
    uvs = np.zeros((L, C, 2), np.float64)
    mask = np.zeros((L, C), bool)
    for li, (j, s, ln) in enumerate(runs):
        uvs[li, s:s + ln, 0] = x[s:s + ln, j]
        uvs[li, s:s + ln, 1] = y[s:s + ln, j]
        mask[li, s:s + ln] = True
    return triangulate_dlt(K, Rs, ts, uvs, mask, device=device)


def run_sfm(ft, K, R0, t0, n_iters: int = 15, damping: float = 1e-3,
            min_track_len: int = 2, mesh=None,
            huber_delta: float | None = None,
            max_init_reproj_error: float | None = None, *, device="cuda"):
    """Full back-end pass over a feature table, on ``device`` ("cuda"
    unless the caller passes "cpu").

    Returns dict with refined (R, t, X) tensors, per-iteration costs, and
    the observation count. Non-finite triangulations are parked at a
    finite dummy with their observations weighted out;
    ``max_init_reproj_error`` gates observations whose reprojection error
    under the initial poses exceeds it. ``mesh`` enables the
    landmark-sharded BA (its ``landmark`` axis).
    """
    cam_idx, pt_idx, uv, w, runs = observations_from_feature_table(
        ft, min_track_len, return_runs=True)
    X0 = initial_landmarks(K, R0, t0, ft, min_track_len, runs=runs,
                           device=device)
    dev = X0.device
    finite_t = torch.isfinite(X0).all(-1)
    X0 = torch.where(finite_t[:, None], X0,
                     torch.tensor([0.0, 0.0, 1.0], dtype=X0.dtype,
                                  device=dev))
    w = w * to_host(finite_t)[pt_idx]

    if max_init_reproj_error is not None:
        ci = torch.as_tensor(cam_idx, dtype=torch.int64, device=dev)
        pi = torch.as_tensor(pt_idx, dtype=torch.int64, device=dev)
        uv_hat, depth = project(K, f32(R0, dev)[ci], f32(t0, dev)[ci],
                                X0[pi])
        err = np.linalg.norm(to_host(uv_hat) - uv, axis=-1)
        ok = (err <= max_init_reproj_error) & (to_host(depth) > 0)
        w = w * ok.astype(np.float32)

    problem = make_problem(K, cam_idx, pt_idx, uv, w, device=dev)
    n_points = int(X0.shape[0])
    if mesh is not None:
        from ..parallel.sharding import LANDMARK_AXIS, mesh_sizes
        problem, l_pad, _ = pad_problem_for_mesh(
            problem, n_points, mesh_sizes(mesh)[LANDMARK_AXIS])
        X0 = torch.cat([X0, X0.new_ones((l_pad, 3))])
    R, t, X, costs = bundle_adjust(problem, R0, t0, X0, n_iters=n_iters,
                                   damping=damping, mesh=mesh,
                                   huber_delta=huber_delta)
    return {"R": R, "t": t, "X": X[:n_points], "costs": costs,
            "n_observations": int((np.asarray(w) > 0).sum())}


def run_sfm_windowed(ft, K, R0, t0, n_iters: int = 15,
                     damping: float = 1e-3, min_track_len: int = 3,
                     huber_delta: float | None = 3.0,
                     max_init_reproj_error: float | None = 20.0,
                     point_only_iters: int = 3, solver: str = "dense",
                     precond_block: int = 1, *, device="cuda"):
    """Windowed block-sparse back-end pass (the production-scale path), on
    ``device`` ("cuda" unless the caller passes "cpu").

    Splits the table into contiguous track runs (a refilled slot is a new
    landmark), triangulates each run, gates observations whose initial
    reprojection error exceeds ``max_init_reproj_error``, warm-starts with
    camera-frozen point refinements, then runs robust windowed BA.
    Returns a dict with refined (R, t, X) tensors, per-iteration costs,
    the runs and the observation count.
    """
    c0, uv, w, runs = windowed_from_feature_table(ft, min_track_len)
    problem = make_windowed_problem(K, c0, uv, w, device=device)
    X0 = triangulate_windowed(K, R0, t0, problem.c0, problem.uv, problem.w)
    if max_init_reproj_error is not None:
        problem = gate_windowed(problem, R0, t0, X0, max_init_reproj_error)
    R, t, X, costs = bundle_adjust_windowed(
        problem, R0, t0, X0, n_iters=n_iters, damping=damping,
        huber_delta=huber_delta, point_only_iters=point_only_iters,
        solver=solver, precond_block=precond_block)
    return {"R": R, "t": t, "X": X, "costs": costs, "runs": runs,
            "n_observations": int((np.asarray(w) > 0).sum())}


def ate_rmse(t_est, t_gt) -> float:
    """Absolute trajectory error (RMSE over camera centers), evaluated in
    the shared gauge (camera 0 pinned by the BA)."""
    e = to_host(t_est, np.float64) - to_host(t_gt, np.float64)
    return float(np.sqrt((e * e).sum(axis=-1).mean()))


def umeyama_align(src, dst, with_scale: bool = True) -> np.ndarray:
    """Similarity-align trajectory ``src`` onto ``dst`` (Umeyama, float64
    numpy) and return the transformed src."""
    src = to_host(src, np.float64)
    dst = to_host(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (sc * sc).sum() / src.shape[0]
        s = float((D * S.diagonal()).sum() / max(var_s, 1e-12))
    else:
        s = 1.0
    return (s * (R @ sc.T)).T + mu_d


def ate_rmse_aligned(t_est, t_gt) -> float:
    """ATE after similarity alignment (monocular convention)."""
    return ate_rmse(umeyama_align(t_est, t_gt), t_gt)
