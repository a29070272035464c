"""Bundle adjustment with Schur-complement reduction (plain PyTorch).

Port of the single-device path of ``pyfeaturetrack_tpu/sfm/ba.py``: the
classic block-sparse BA normal equations as batched tensor programs —

* per-observation residuals/Jacobians: one batched pipeline [M, ...];
* camera blocks U [C,6,6], landmark blocks V [L,3,3], cross blocks
  W [L,C,6,3] and the gradient halves: segmented sums over the
  observation axis;
* landmark marginalization: batched closed-form 3x3 inverses, then the
  reduced camera system S = U - W V^-1 W^T as batched products;
* a dense solve of the [6C, 6C] reduced system (``torch.linalg.solve_ex``),
  batched back-substitution for landmarks.

Determinism: the JAX package accumulates the blocks with scatter-adds;
on the card ``index_add_`` adds with atomics, so its float order (and a
visual odometry run's keyframe decisions downstream) would change from run
to run. Here each problem's observations are sorted by block once
(``segments``: a stable sort), placed into a padded [blocks, most
observations per block, ...] layout by plain (collision-free) stores, and
summed along that axis: the same bits on every run.

Landmark sharding (``mesh=``, JAX ``_gn_step_sharded_body``): each rank
of the mesh's ``landmark`` axis holds a contiguous block of landmarks and
exactly their observations (``pad_problem_for_mesh``), forms its blocks'
U, b_c, S_red, b_red and cost, and the camera system is combined ONCE per
iteration (``parallel/sharding.SumParts``: the ranks' partials summed in
rank order on every rank); each rank then solves the same camera system
and back-substitutes its landmarks, and X is gathered at the end. The
one-device route is the same body on a one-rank split.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..errors import KLTWarning
from ..ops.linalg import inv3x3
from ..utils.profiling import host_sync
from ..utils.staging import target_device
from .geometry import as_device, f32, require_fp32, skew, so3_exp, to_host


class BAProblem(NamedTuple):
    """Observation set for bundle adjustment.

    K: [3,3] intrinsics; cam_idx/pt_idx: [M] int64; uv: [M,2] pixels;
    w: [M] per-observation weight (0 disables an observation).
    """
    K: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    w: torch.Tensor


def make_problem(K, cam_idx, pt_idx, uv, w, *, device="cuda") -> BAProblem:
    """A BAProblem on ``device`` from arrays or tensors (float32 K, uv, w;
    int64 indices)."""
    dev = target_device(device)
    uv = f32(uv, dev)
    return BAProblem(K=f32(K, dev),
                     cam_idx=as_device(cam_idx, torch.int64, dev),
                     pt_idx=as_device(pt_idx, torch.int64, dev),
                     uv=uv, w=f32(w, dev))


class Segments(NamedTuple):
    """Observations grouped by block: ``order`` sorts them by ``key``
    (stable), ``key``/``rank`` are each sorted observation's block and its
    place in the block, ``n`` blocks of at most ``width`` observations."""
    order: torch.Tensor
    key: torch.Tensor
    rank: torch.Tensor
    n: int
    width: int


def segments(keys: torch.Tensor, n: int) -> Segments:
    """Group [M] int64 block keys in [0, n) (one host read: the width)."""
    order = torch.sort(keys, stable=True).indices
    ks = keys[order]
    blocks = torch.arange(n, device=keys.device)
    starts = torch.searchsorted(ks, blocks)
    ends = torch.searchsorted(ks, blocks, right=True)
    rank = torch.arange(ks.shape[0], device=keys.device) - starts[ks]
    if not ks.numel():
        return Segments(order, ks, rank, n, 0)
    host_sync("sync.ba_segments")
    width = int(to_host((ends - starts).max()))
    return Segments(order, ks, rank, n, width)


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """[M, ...] per-observation terms -> [n, ...] per-block sums, in one
    fixed order (deterministic on every device)."""
    buf = vals.new_zeros((seg.n, max(seg.width, 1)) + vals.shape[1:])
    buf[seg.key, seg.rank] = vals[seg.order]
    return buf.sum(1)


def _obs_terms(K, R, t, X, cam_idx, pt_idx, uv, w, huber_delta=None):
    """Residuals + Jacobians for every observation.

    Returns (r [M,2], Jc [M,2,6], Jp [M,2,3], cost scalar). The rotation
    perturbation is left-multiplicative on (R X): Y = exp(dw) R X + t + dt,
    so dY/dw = -skew(R X), dY/dt = I, dY/dX = R. ``huber_delta`` (float or
    None) enables IRLS Huber robustness: observations with residual norm
    above delta are downweighted by sqrt(delta/|r|).
    """
    Rc = R[cam_idx]
    tc = t[cam_idx]
    Xp = X[pt_idx]
    RX = torch.matmul(Rc, Xp[..., None])[..., 0]
    Y = RX + tc
    z = Y[..., 2]
    behind = z < 1e-4
    zs = torch.where(behind, 1.0, z)

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * Y[..., 0] / zs + cx
    v = fy * Y[..., 1] / zs + cy
    r = torch.stack([u, v], -1) - uv

    zero = torch.zeros_like(z)
    dpi = torch.stack([
        torch.stack([fx / zs, zero, -fx * Y[..., 0] / (zs * zs)], -1),
        torch.stack([zero, fy / zs, -fy * Y[..., 1] / (zs * zs)], -1),
    ], -2)  # [M, 2, 3]

    weight = (w * (~behind)).to(r.dtype)
    if huber_delta is not None:
        rn = torch.sqrt((r * r).sum(-1) + 1e-12)
        weight = weight * torch.sqrt(
            torch.clamp(float(huber_delta) / rn, max=1.0))
    weight = weight[:, None]
    r = r * weight
    dpi = dpi * weight[..., None]

    Jw = -torch.matmul(dpi, skew(RX))
    Jc = torch.cat([Jw, dpi], dim=-1)                    # [M, 2, 6]
    Jp = torch.matmul(dpi, Rc)                            # [M, 2, 3]
    cost = (r * r).sum()
    return r, Jc, Jp, cost


def _outer(a, b):
    """[M, 2, P], [M, 2, Q] -> [M, P, Q] sum over the residual rows."""
    return torch.matmul(a.transpose(1, 2), b)


def _build_blocks(r, Jc, Jp, segs, n_cameras: int, n_points: int):
    """U, V, W and the gradient halves, by segmented sums."""
    seg_c, seg_p, seg_pc = segs
    U = segment_sum(_outer(Jc, Jc), seg_c)
    V = segment_sum(_outer(Jp, Jp), seg_p)
    W = segment_sum(_outer(Jc, Jp), seg_pc).reshape(n_points, n_cameras,
                                                    6, 3)
    b_c = segment_sum(-torch.matmul(Jc.transpose(1, 2), r[..., None])[..., 0],
                      seg_c)
    b_p = segment_sum(-torch.matmul(Jp.transpose(1, 2), r[..., None])[..., 0],
                      seg_p)
    return U, V, W, b_c, b_p


def _damp(M, damping):
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + eye * (damping * diag[..., None] * eye + 1e-9)


def _reduce_and_solve(U, b_c, S_red, b_red, damping, fix_first: bool):
    """Assemble the reduced camera system and solve it. Returns (dx
    [C, 6], info): info != 0 marks a singular system (dx is then NaN, as
    the JAX package's solve gives it)."""
    n_cameras = U.shape[0]
    U = _damp(U, damping)
    ar = torch.arange(n_cameras, device=U.device)
    S = torch.zeros((n_cameras, 6, n_cameras, 6), dtype=U.dtype,
                    device=U.device)
    S[ar, :, ar, :] = U
    S = S - S_red
    b = b_c - b_red

    if fix_first:
        # gauge: pin camera 0 (zero its rows/cols, identity diagonal)
        mask = torch.ones((n_cameras, 6), dtype=U.dtype, device=U.device)
        mask[0] = 0.0
        S = S * mask[:, :, None, None] * mask[None, None, :, :]
        a6 = torch.arange(6, device=U.device)
        S[0, a6, 0, a6] = 1.0
        b = b * mask

    n = n_cameras * 6
    A = S.reshape(n, n) + 1e-8 * torch.eye(n, dtype=U.dtype, device=U.device)
    dx, info = torch.linalg.solve_ex(A, b.reshape(n))
    dx = torch.where(info == 0, dx, torch.nan)
    return dx.reshape(n_cameras, 6), info


def _local_system(K, R, t, X, problem, segs, damping, huber_delta=None):
    """The camera-system terms of the problem's landmarks, (U, b_c, S_red,
    b_red, cost), and their back-substitution factors (V_inv, W, b_p)."""
    n_cameras, n_points = R.shape[0], X.shape[0]
    r, Jc, Jp, cost = _obs_terms(K, R, t, X, problem.cam_idx,
                                 problem.pt_idx, problem.uv, problem.w,
                                 huber_delta)
    U, V, W, b_c, b_p = _build_blocks(r, Jc, Jp, segs, n_cameras, n_points)
    V = _damp(V, damping)
    V_inv, _ = inv3x3(V)

    T1 = torch.matmul(W, V_inv[:, None])                 # [L, C, 6, 3]
    # S_red[c,i,d,m] = sum_l,k T1[l,c,i,k] W[l,d,m,k]
    S_red = torch.matmul(
        T1.permute(1, 2, 0, 3).reshape(n_cameras * 6, n_points * 3),
        W.permute(0, 3, 1, 2).reshape(n_points * 3, n_cameras * 6),
    ).reshape(n_cameras, 6, n_cameras, 6)
    b_red = torch.matmul(
        T1.permute(1, 2, 0, 3).reshape(n_cameras * 6, n_points * 3),
        b_p.reshape(n_points * 3)).reshape(n_cameras, 6)
    return (U, b_c, S_red, b_red, cost), (V_inv, W, b_p)


def _solve_and_update(R, t, X, sys_terms, point_terms, damping,
                      fix_first: bool):
    """Solve the (combined) camera system, back-substitute the landmarks.
    Returns (R, t, X, cost, info)."""
    U, b_c, S_red, b_red, cost = sys_terms
    V_inv, W, b_p = point_terms
    n_points = X.shape[0]
    dx_c, info = _reduce_and_solve(U, b_c, S_red, b_red, damping, fix_first)

    # rhs_p[l,j] = b_p[l,j] - sum_c,i W[l,c,i,j] dx_c[c,i]
    rhs_p = b_p - torch.matmul(W.permute(0, 3, 1, 2).reshape(n_points, 3, -1),
                               dx_c.reshape(-1))
    dx_p = torch.matmul(V_inv, rhs_p[..., None])[..., 0]

    R_new = torch.matmul(so3_exp(dx_c[:, :3]), R)
    t_new = t + dx_c[:, 3:]
    X_new = X + dx_p
    return R_new, t_new, X_new, cost, info


def problem_segments(problem: BAProblem, n_cameras: int, n_points: int):
    """The camera, landmark and (landmark, camera) groupings of a
    problem's observations (fixed across iterations)."""
    return (segments(problem.cam_idx, n_cameras),
            segments(problem.pt_idx, n_points),
            segments(problem.pt_idx * n_cameras + problem.cam_idx,
                     n_points * n_cameras))


def _ba_body(coord, problem, R, t, X, n_iters, damping, fix_first, axis,
             n_ranks, huber_delta):
    """The landmark-sharded GN loop on one rank (parallel/sharding local
    body): this rank's landmark block and observations, one combine of the
    camera system per iteration, X gathered at the end."""
    from ..parallel.sharding import Gather, SumParts, block
    d = coord[axis]
    lb = block(d, n_ranks, X.shape[0], "landmarks")
    ob = block(d, n_ranks, problem.cam_idx.shape[0], "observations")
    local = BAProblem(problem.K, *(a[ob] for a in problem[1:]))
    X_loc = X[lb]
    n_cameras = int(R.shape[0])
    segs = problem_segments(local, n_cameras, int(X_loc.shape[0]))
    costs, infos = [], []
    for _ in range(n_iters):
        sys_terms, point_terms = _local_system(problem.K, R, t, X_loc, local,
                                               segs, damping, huber_delta)
        sys_terms = yield SumParts(sys_terms, axis, "camera_system")
        R, t, X_loc, cost, info = _solve_and_update(
            R, t, X_loc, sys_terms, point_terms, damping, fix_first)
        costs.append(cost)
        infos.append(info)
    (X,) = yield Gather((X_loc,), (0,), axis, "output")
    return R, t, X, costs, infos


def bundle_adjust(problem: BAProblem, R0, t0, X0, n_iters: int = 10,
                  damping: float = 1e-3, fix_first: bool = True,
                  mesh=None, axis: str = "landmark",
                  huber_delta: float | None = None):
    """Run ``n_iters`` damped Gauss-Newton steps on the problem's device.
    Returns (R, t, X, costs); ``costs`` is a device tensor of
    per-iteration observation costs (before each step).

    With ``mesh`` (a DeviceMesh or split with an ``axis`` dimension),
    landmarks and their observations shard over ``axis``: rank d holds
    landmarks [d L/D, (d+1) L/D) and exactly the observations that
    reference them, with shard-local indices, in equal blocks
    (``pad_problem_for_mesh`` arranges this). R, t, X and the costs come
    back whole on every rank.

    One host read per call beyond the grouping (``sync.ba_segments``, one a
    grouping): the solves' ``info`` (``sync.ba_info``), checked once at the
    end (a singular reduced system gives NaN updates,
    as in the JAX package, and a warning here).
    """
    from ..parallel import sharding
    dev = problem.uv.device
    require_fp32(dev)
    R, t, X = f32(R0, dev), f32(t0, dev), f32(X0, dev)
    if mesh is None:
        mesh = sharding.split_mesh((1,), (axis,), dev)
    sizes = sharding.mesh_sizes(mesh)
    if axis not in sizes:
        raise ValueError(f"bundle_adjust: the mesh has no {axis!r} axis "
                         f"({tuple(sizes)})")
    if sharding.mesh_device(mesh).type != dev.type:
        raise ValueError(f"bundle_adjust: the problem lies on {dev}, the "
                         f"mesh computes on {sharding.mesh_device(mesh)}")
    R, t, X, costs, infos = sharding.run_sharded(
        mesh, _ba_body, problem, R, t, X, n_iters, damping, fix_first, axis,
        sizes[axis], huber_delta)
    if infos:
        host_sync("sync.ba_info")
    if infos and bool(to_host(torch.stack(infos).ne(0).any())):
        KLTWarning("(bundle_adjust) a reduced camera system was singular; "
                   "its update is NaN")
    costs = (torch.stack(costs) if costs
             else torch.zeros((0,), dtype=torch.float32, device=dev))
    return R, t, X, costs


def pad_problem_for_mesh(problem: BAProblem, n_points: int, n_dev: int):
    """Reorder and pad observations so each of ``n_dev`` ranks owns a
    contiguous landmark block and exactly its observations (zero-weight
    pads), with pt_idx rebased to the block. Returns (padded problem,
    landmark padding count, observations per rank); ``n_points`` may grow
    to a multiple of ``n_dev``: pad X0 with that many rows. The JAX
    package's layout, on the problem's device."""
    dev = problem.uv.device
    cam_idx = to_host(problem.cam_idx)
    pt_idx = to_host(problem.pt_idx)
    uv = to_host(problem.uv)
    w = to_host(problem.w)
    l_pad = (-n_points) % n_dev
    l_per = (n_points + l_pad) // n_dev
    shard_of = pt_idx // l_per
    per_shard = [np.nonzero(shard_of == d)[0] for d in range(n_dev)]
    m_per = max(sel.size for sel in per_shard)
    ci = np.zeros((n_dev, m_per), np.int64)
    pi = np.zeros((n_dev, m_per), np.int64)
    uvp = np.zeros((n_dev, m_per, 2), np.float32)
    wp = np.zeros((n_dev, m_per), np.float32)
    for d, sel in enumerate(per_shard):
        k = sel.size
        ci[d, :k] = cam_idx[sel]
        pi[d, :k] = pt_idx[sel] - d * l_per
        uvp[d, :k] = uv[sel]
        wp[d, :k] = w[sel]
    out = BAProblem(K=problem.K,
                    cam_idx=torch.as_tensor(ci.reshape(-1), device=dev),
                    pt_idx=torch.as_tensor(pi.reshape(-1), device=dev),
                    uv=torch.as_tensor(uvp.reshape(-1, 2), device=dev),
                    w=torch.as_tensor(wp.reshape(-1), device=dev))
    return out, l_pad, m_per
