"""Pose-graph optimization over relative SE(3) constraints (plain
PyTorch).

Port of ``pyfeaturetrack_tpu/sfm/posegraph.py``. Poses are world-to-camera
(X_cam = R X_world + t). An edge (i, j) measures the relative transform
cam_i -> cam_j: R_ij = R_j R_i^T, t_ij = t_j - R_ij t_i, with residual
[log(R_meas^T R_ij_pred), t_ij_pred - t_meas]. Gauss-Newton with the
Jacobian taken by forward-mode autodiff (``torch.func.jacfwd``, as the
JAX package's ``jax.jacfwd``) w.r.t. a left-multiplicative tangent
perturbation xi [C, 6] at zero; the [6C, 6C] system is solved densely
with pose 0 pinned.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from ..utils.staging import target_device
from .geometry import as_device, f32, require_fp32, so3_exp, so3_log


class PoseGraph(NamedTuple):
    """Edges i->j with measured relative transforms and weights.

    edge_i/edge_j: [E] int64; R_meas: [E,3,3]; t_meas: [E,3];
    w_rot/w_trans: [E] weights.
    """
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    R_meas: torch.Tensor
    t_meas: torch.Tensor
    w_rot: torch.Tensor
    w_trans: torch.Tensor


def make_pose_graph(edge_i, edge_j, R_meas, t_meas, w_rot, w_trans, *,
                    device="cuda") -> PoseGraph:
    """A PoseGraph on ``device`` from arrays or tensors."""
    dev = target_device(device)
    R_meas = f32(R_meas, dev)
    return PoseGraph(edge_i=as_device(edge_i, torch.int64, dev),
                     edge_j=as_device(edge_j, torch.int64, dev),
                     R_meas=R_meas, t_meas=f32(t_meas, dev),
                     w_rot=f32(w_rot, dev), w_trans=f32(w_trans, dev))


def _edge_residuals(xi, R, t, graph: PoseGraph):
    """[E, 6] residuals under tangent perturbation xi [C, 6]."""
    Rp = torch.matmul(so3_exp(xi[:, :3]), R)
    tp = t + xi[:, 3:]
    Ri = Rp[graph.edge_i]
    Rj = Rp[graph.edge_j]
    ti = tp[graph.edge_i]
    tj = tp[graph.edge_j]
    R_rel = torch.matmul(Rj, Ri.transpose(1, 2))          # Rj Ri^T
    t_rel = tj - torch.matmul(R_rel, ti[..., None])[..., 0]
    r_R = so3_log(torch.matmul(graph.R_meas.transpose(1, 2), R_rel))
    r_t = t_rel - graph.t_meas
    return torch.cat([r_R * graph.w_rot[:, None],
                      r_t * graph.w_trans[:, None]], dim=-1)


def _pg_step(R, t, graph: PoseGraph, damping: float, fix_first: bool = True):
    n = R.shape[0]
    xi0 = torch.zeros((n, 6), dtype=R.dtype, device=R.device)
    r = _edge_residuals(xi0, R, t, graph)                 # [E, 6]
    J = jacfwd(_edge_residuals)(xi0, R, t, graph)         # [E, 6, C, 6]

    e = r.reshape(-1)
    Jf = J.reshape(e.shape[0], n * 6)
    H = torch.matmul(Jf.T, Jf)
    g = -torch.matmul(Jf.T, e)
    eye = torch.eye(n * 6, dtype=R.dtype, device=R.device)
    H = H + damping * torch.diag(torch.diagonal(H)) + 1e-9 * eye

    if fix_first:
        mask = torch.ones((n * 6,), dtype=R.dtype, device=R.device)
        mask[:6] = 0.0
        H = H * mask[:, None] * mask[None, :]
        a6 = torch.arange(6, device=R.device)
        H[a6, a6] = 1.0
        g = g * mask

    dx, info = torch.linalg.solve_ex(H, g)
    dx = torch.where(info == 0, dx, torch.nan).reshape(n, 6)
    R_new = torch.matmul(so3_exp(dx[:, :3]), R)
    t_new = t + dx[:, 3:]
    return R_new, t_new, (r * r).sum()


def optimize_pose_graph(graph: PoseGraph, R0, t0, n_iters: int = 10,
                        damping: float = 1e-4, fix_first: bool = True):
    """Run Gauss-Newton on the pose graph (on the graph's device).
    Returns (R, t, costs)."""
    dev = graph.R_meas.device
    require_fp32(dev)
    R, t = f32(R0, dev), f32(t0, dev)
    costs = []
    for _ in range(n_iters):
        R, t, cost = _pg_step(R, t, graph, damping, fix_first)
        costs.append(cost)
    return R, t, torch.stack(costs)


def odometry_graph(R_rel, t_rel, w_rot=1.0, w_trans=1.0,
                   loop_edges=None, *, device="cuda") -> PoseGraph:
    """Chain graph from per-step relative transforms [C-1, ...], plus
    optional loop-closure edges [(i, j, R_ij, t_ij), ...]."""
    n = len(R_rel)
    ei = list(range(n))
    ej = list(range(1, n + 1))
    Rm = [np.asarray(R_rel[i], np.float32) for i in range(n)]
    tm = [np.asarray(t_rel[i], np.float32) for i in range(n)]
    for (i, j, Rij, tij) in loop_edges or ():
        ei.append(i)
        ej.append(j)
        Rm.append(np.asarray(Rij, np.float32))
        tm.append(np.asarray(tij, np.float32))
    e = len(ei)
    return make_pose_graph(ei, ej, np.stack(Rm), np.stack(tm),
                           np.full((e,), w_rot, np.float32),
                           np.full((e,), w_trans, np.float32), device=device)
