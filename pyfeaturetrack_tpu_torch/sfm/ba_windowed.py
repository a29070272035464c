"""Windowed (block-sparse) bundle adjustment (PyTorch port of
``pyfeaturetrack_tpu/sfm/ba_windowed.py``).

Tracks from the tracker are contiguous camera ranges (a feature is
observed from its first tracked frame until it is lost), so each
landmark's cross blocks W_{c,l} are nonzero only for cameras in a short
window [c0_l, c0_l + Kw). The dense formulation in ``sfm/ba.py`` holds W
as [L, C, 6, 3]; this module holds [L, Kw, 6, 3] and sums the Schur
products into the reduced camera system in banded form, S_band [C,
2 Kw - 1, 6, 6]: O(L Kw^2) block work instead of O(L C^2). The camera
solve is dense (``sfm/ba._reduce_and_solve`` on the densified band) or a
banded preconditioned conjugate gradient that never forms the [6C, 6C]
matrix (``solver="cg"``, optionally with [6g, 6g] camera-group
preconditioner blocks).

Determinism: where the JAX package sums with one-hot matmuls and rolls,
the port groups the landmarks by their first camera once
(``sfm/ba.segments``, a stable sort), sums each group along one axis
(``segment_sum``) and then shifts slot k's sums k rows down, in slot
order: the same bits on every run of the card (no atomics). Window slots
past the last camera carry zero weight and add nothing.

A feature slot that is lost and later refilled holds two physical
landmarks, so ``windowed_from_feature_table`` splits each column into
maximal contiguous live runs (``column_runs``), one landmark per run.

Landmark sharding (``mesh=``, JAX ``_gn_step_windowed_sharded_body``):
each rank of the ``landmark`` axis holds a contiguous block of landmark
rows (``pad_windowed_for_mesh`` pads their count to a multiple of the
ranks), runs the point-only warm start and assembles its banded camera
system locally; the band, the right-hand sides and the cost are combined
ONCE per GN step (``parallel/sharding.SumParts``, rank-order sums on
every rank), outside the CG's captured graph, and every rank then runs the
same camera solve and back-substitutes its landmarks. The one-device route
is the same body on a one-rank split.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..errors import KLTWarning
from ..ops.linalg import gauss_solve_det, inv3x3
from ..utils import cuda
from ..utils.staging import target_device
from .ba import _damp, _reduce_and_solve, segment_sum, segments
from .geometry import as_device, f32, require_fp32, skew, so3_exp, to_host
from .triangulate import triangulate_dlt

# CG iterations run between two host reads of the convergence flag.
CG_CHECK_EVERY = 8


class WindowedBAProblem(NamedTuple):
    """K-windowed observation set (the JAX package's layout): K [3,3];
    c0 [L] int64 first camera of each landmark's window; uv [L, Kw, 2]
    pixels at camera c0[l]+k; w [L, Kw] weights (0 pads)."""
    K: torch.Tensor
    c0: torch.Tensor
    uv: torch.Tensor
    w: torch.Tensor


def make_windowed_problem(K, c0, uv, w, *, device="cuda"
                          ) -> WindowedBAProblem:
    """A WindowedBAProblem on ``device`` from arrays or tensors (float32
    K, uv, w; int64 c0)."""
    dev = target_device(device)
    return WindowedBAProblem(K=f32(K, dev), c0=as_device(c0, torch.int64, dev),
                             uv=f32(uv, dev), w=f32(w, dev))


def column_runs(ft) -> list[tuple[int, int, int]]:
    """All maximal contiguous live runs of every feature column, split at
    re-selection frames. Returns [(column, start_frame, length), ...].

    A frame with val > 0 inside a live stretch is a fresh selection
    (replace-lost refills store the eigenvalue at the refill frame;
    tracked frames store 0): the slot then holds a different physical
    landmark, so the run splits there.
    """
    x = to_host(ft.x, np.float64)
    v = to_host(ft.val).astype(np.int64)
    live = (v >= 0) & (x >= 0)
    n_frames, n_cols = live.shape
    runs = []
    for j in range(n_cols):
        col = live[:, j]
        i = 0
        while i < n_frames:
            if col[i]:
                k = i + 1
                while k < n_frames and col[k] and v[k, j] <= 0:
                    k += 1
                runs.append((j, i, k - i))
                i = k  # k is end-of-table, a dead frame, or a re-selection
            else:
                i += 1
    return runs


def windowed_from_feature_table(ft, min_track_len: int = 2,
                                max_window: int | None = None):
    """FeatureTable -> (c0 [L] int32, uv [L, Kw, 2], w [L, Kw] numpy
    arrays, runs): one landmark per maximal contiguous live run of a
    column, runs a list of (column, start_frame, length). ``max_window``
    splits longer runs into segments of at most that many frames (no
    observation is dropped)."""
    x = to_host(ft.x, np.float64)
    y = to_host(ft.y, np.float64)
    runs = [r for r in column_runs(ft) if r[2] >= min_track_len]
    if not runs:
        raise ValueError("no tracks of sufficient length")
    if max_window is not None:
        split = []
        for (j, st, ln) in runs:
            off = 0
            while ln - off >= min_track_len:
                seg = min(max_window, ln - off)
                split.append((j, st + off, seg))
                off += seg
        runs = split
    kw = max(ln for (_, _, ln) in runs)
    L = len(runs)
    c0 = np.zeros((L,), np.int32)
    uv = np.zeros((L, kw, 2), np.float32)
    w = np.zeros((L, kw), np.float32)
    for li, (j, s, ln) in enumerate(runs):
        c0[li] = s
        uv[li, :ln, 0] = x[s:s + ln, j]
        uv[li, :ln, 1] = y[s:s + ln, j]
        w[li, :ln] = 1.0
    return c0, uv, w, runs


def triangulate_windowed(K, Rs, ts, c0, uv, w, *, device=None
                         ) -> torch.Tensor:
    """DLT-triangulate each windowed landmark from its own cameras: [L, 3]
    on the device of ``uv`` (arrays go to ``device``, default "cuda").
    The observation layout is built in numpy on the host, vectorized over
    the landmarks (a slot clipped onto the last camera is written after
    the slots before it, as the JAX package's per-landmark loop does)."""
    dev = uv.device if isinstance(uv, torch.Tensor) else target_device(
        device if device is not None else "cuda")
    require_fp32(dev)
    uv = to_host(uv, np.float32)
    L, kw, _ = uv.shape
    C = to_host(Rs).shape[0]
    cidx = np.clip(to_host(c0).astype(np.int64)[:, None]
                   + np.arange(kw)[None, :], 0, C - 1)
    wl = to_host(w) > 0
    rows = np.broadcast_to(np.arange(L)[:, None], (L, kw))
    uvs = np.zeros((L, C, 2), np.float32)
    mask = np.zeros((L, C), bool)
    uvs[rows[wl], cidx[wl]] = uv[wl]
    mask[rows[wl], cidx[wl]] = True
    return triangulate_dlt(K, Rs, ts, uvs, mask, device=dev)


def _window(c0, kw: int, n_cameras: int):
    """(cidx [L, Kw] clipped camera of each slot, in_range [L, Kw])."""
    c0 = c0.to(torch.int64)
    slots = c0[:, None] + torch.arange(kw, dtype=c0.dtype, device=c0.device)
    return slots.clamp(0, n_cameras - 1), slots < n_cameras


def _project_terms(K, R, t, X, cidx, in_range, uv, w, huber_delta=None):
    """Weighted residuals and the projection Jacobian of every window slot:
    (RX, Rc, r [L,Kw,2], dpi [L,Kw,2,3])."""
    Rc = R[cidx]                                           # [L, Kw, 3, 3]
    RX = _mv(Rc, X[:, None])
    Y = RX + t[cidx]
    z = Y[..., 2]
    behind = z < 1e-4
    zs = torch.where(behind, 1.0, z)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    r = torch.stack([fx * Y[..., 0] / zs + cx, fy * Y[..., 1] / zs + cy],
                    -1) - uv
    zero = torch.zeros_like(z)
    dpi = torch.stack([
        torch.stack([fx / zs, zero, -fx * Y[..., 0] / (zs * zs)], -1),
        torch.stack([zero, fy / zs, -fy * Y[..., 1] / (zs * zs)], -1),
    ], -2)                                                 # [L, Kw, 2, 3]
    # slots past the last camera are ignored whatever their weight
    weight = (w * (~behind) * in_range).to(r.dtype)
    if huber_delta is not None:
        rn = torch.sqrt((r * r).sum(-1) + 1e-12)
        weight = weight * torch.sqrt(
            torch.clamp(float(huber_delta) / rn, max=1.0))
    r = r * weight[..., None]
    dpi = dpi * weight[..., None, None]
    return RX, Rc, r, dpi


def _mm(a, b):
    """a @ b for batches of small matrices, [..., P, K] x [..., K, Q]: a
    broadcast product summed over K. cuBLAS's batched kernels for blocks
    this small took most of a config-5b iteration's device time on an
    H100 (PERF.md)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv(a, v):
    """a @ v for batches of small matrices and vectors, [..., P, K] x
    [..., K]."""
    return (a * v[..., None, :]).sum(-1)


def _outer(a, b):
    """[..., 2, P], [..., 2, Q] -> [..., P, Q] summed over the 2 rows."""
    return _mm(a.transpose(-1, -2), b)


def _by_row(blocks, seg, n_cameras: int):
    """[L, Kw, ...] blocks -> [C, ...] sums at row camera c0 + k: each
    slot's sums over the landmarks of one first camera (``seg``), shifted
    k rows down, added in slot order."""
    per = segment_sum(blocks, seg)                         # [C, Kw, ...]
    out = blocks.new_zeros((n_cameras,) + blocks.shape[2:])
    for k in range(min(blocks.shape[1], n_cameras)):
        out[k:] = out[k:] + per[:n_cameras - k, k]
    return out


def _windowed_camera_system(K, R, t, X, c0, uv, w, seg, damping,
                            n_cameras: int, huber_delta=None):
    """Per-landmark assembly of the windowed reduced camera system.

    Returns (U, b_c, S_band, b_red, cost), the camera side in banded form,
    and (V_inv, W, b_p, cidx), the per-landmark factors of the point
    back-substitution."""
    kw = uv.shape[1]
    cidx, in_range = _window(c0, kw, n_cameras)
    RX, Rc, r, dpi = _project_terms(K, R, t, X, cidx, in_range, uv, w,
                                    huber_delta)
    Jw = -_mm(dpi, skew(RX))
    Jc = torch.cat([Jw, dpi], dim=-1)                      # [L, Kw, 2, 6]
    Jp = _mm(dpi, Rc)                                      # [L, Kw, 2, 3]
    cost = (r * r).sum()

    U = _by_row(_outer(Jc, Jc), seg, n_cameras)
    V = _outer(Jp, Jp).sum(1)                              # [L, 3, 3]
    W = _outer(Jc, Jp)                                     # [L, Kw, 6, 3]
    b_c = _by_row(-_mv(Jc.transpose(-1, -2), r), seg, n_cameras)
    b_p = -_mv(Jp.transpose(-1, -2), r).sum(1)

    V_inv, _ = inv3x3(_damp(V, damping))
    T1 = _mm(W, V_inv[:, None])                            # [L, Kw, 6, 3]
    # S_blocks[l, k, b] = T1[l, k] W[l, b]^T couples cameras c0+k, c0+b
    S_blocks = _mm(T1[:, :, None], W[:, None].transpose(-1, -2))
    b_red = _by_row(_mv(T1, b_p[:, None]), seg, n_cameras)

    # the band: block (l, k, b) sits at row c0+k, offset b - k + half_band;
    # for each k the b-axis lands at offsets [half_band - k, half_band -
    # k + Kw)
    half_band = kw - 1
    per = segment_sum(S_blocks, seg)                       # [C,Kw,Kw,6,6]
    S_band = S_blocks.new_zeros((n_cameras, 2 * half_band + 1, 6, 6))
    for k in range(min(kw, n_cameras)):
        band = S_band[k:, half_band - k:half_band - k + kw]
        S_band[k:, half_band - k:half_band - k + kw] = \
            band + per[:n_cameras - k, k]
    return (U, b_c, S_band, b_red, cost), (V_inv, W, b_p, cidx)


def _dense_from_band(S_band, n_cameras: int):
    """[C, width, 6, 6] band -> [C, 6, C, 6] dense matrix: row c, column
    c + o - half_band. A gather of each (row, column) pair's band block,
    zero outside the band (no scatter, so the clipped boundary offsets
    cannot collide, and no host read)."""
    width = S_band.shape[1]
    half_band = width // 2
    ci = torch.arange(n_cameras, device=S_band.device)
    off = ci[None, :] - ci[:, None] + half_band            # [C, C]
    inside = (off >= 0) & (off < width)
    S = torch.where(inside[..., None, None],
                    S_band[ci[:, None], off.clamp(0, width - 1)], 0.0)
    return S.permute(0, 2, 1, 3)


def _group_inverse(A, half_band: int, g: int):
    """The camera-group preconditioner: each run of g cameras' in-band
    couplings as a dense [6g, 6g] block (identity on pad rows), inverted
    in one batched call. Returns (inverses [nG, 6g, 6g], info [nG])."""
    C, width = A.shape[:2]
    n_groups = -(-C // g)
    cp = n_groups * g
    dev = A.device
    pad = A.new_zeros((cp - C, width, 6, 6))
    pad[:, half_band] = torch.eye(6, dtype=A.dtype, device=dev)
    A_pad = torch.cat([A, pad], dim=0)
    ii = torch.arange(g, device=dev)
    off = ii[None, :] - ii[:, None] + half_band            # [g, g]
    valid = (off >= 0) & (off < width)
    cams = (torch.arange(n_groups, device=dev)[:, None, None] * g
            + ii[:, None])                                 # [nG, g, 1]
    Mg = torch.where(valid[None, :, :, None, None],
                     A_pad[cams, off.clamp(0, width - 1)[None]], 0.0)
    Mg = Mg.permute(0, 1, 3, 2, 4).reshape(n_groups, 6 * g, 6 * g)
    return torch.linalg.inv_ex(Mg)


class _CG(NamedTuple):
    """The PCG's operands and iterate. The iterate's tensors are updated in
    place, so a captured block of iterations replays on them."""
    A_rows: torch.Tensor   # [C, 6, width 6]: each row's band blocks
    win: torch.Tensor      # [C, width] int64: padded column of each block
    M: torch.Tensor        # [C, 6, 6] diagonal blocks or [nG, 6g, 6g]
                           # group inverses
    limit: torch.Tensor    # 0-d: tol^2 |b|^2
    x: torch.Tensor        # [C, 6]
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor       # 0-d
    k: torch.Tensor        # 0-d int32: iterations taken


def _cg_matvec(cg: _CG, v):
    """out[c] = sum_o A[c, o] v[c + o - half_band]: one product of the
    [C, 6, width 6] rows and the gathered [C, width 6] windows."""
    C, width = cg.win.shape
    pad = v.new_zeros((width // 2, 6))
    vg = torch.cat([pad, v, pad], dim=0)[cg.win]
    return _mv(cg.A_rows, vg.reshape(C, width * 6))


def _cg_prec(cg: _CG, r):
    """The preconditioner: Gauss-Jordan on each [6, 6] diagonal block, or
    one product with each camera group's [6g, 6g] inverse."""
    if cg.M.shape[-1] == 6:
        return gauss_solve_det(cg.M, r)[0]
    C = r.shape[0]
    cp = cg.M.shape[0] * cg.M.shape[-1] // 6
    rp = torch.cat([r, r.new_zeros((cp - C, 6))]).reshape(cg.M.shape[:2])
    return _mv(cg.M, rp).reshape(cp, 6)[:C]


def _cg_iterations(cg: _CG, n: int) -> None:
    """n PCG iterations on ``cg``'s iterate, in place. An iteration whose
    residual already meets the limit changes nothing, so the iterate and
    the count equal those of a loop that stopped there."""
    for _ in range(n):
        active = (cg.r * cg.r).sum() > cg.limit
        Ap = _cg_matvec(cg, cg.p)
        alpha = cg.rz / torch.clamp((cg.p * Ap).sum(), min=1e-30)
        x_new = cg.x + alpha * cg.p
        r_new = cg.r - alpha * Ap
        z_new = _cg_prec(cg, r_new)
        rz_new = (r_new * z_new).sum()
        beta = rz_new / torch.clamp(cg.rz, min=1e-30)
        p_new = z_new + beta * cg.p
        cg.x.copy_(torch.where(active, x_new, cg.x))
        cg.r.copy_(torch.where(active, r_new, cg.r))
        cg.p.copy_(torch.where(active, p_new, cg.p))
        cg.rz.copy_(torch.where(active, rz_new, cg.rz))
        cg.k.copy_(torch.where(active, cg.k + 1, cg.k))


class _CGGraph:
    """CG_CHECK_EVERY PCG iterations captured as one CUDA graph on buffers
    of one problem shape; a solve loads its operands and starting iterate
    into them (``load``) and replays the graph once per block."""

    def __init__(self, like: _CG):
        self.cg = _CG(*(torch.zeros_like(t) for t in like))
        dev = like.x.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            _cg_iterations(self.cg, CG_CHECK_EVERY)    # warm-up
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            _cg_iterations(self.cg, CG_CHECK_EVERY)

    def load(self, cg: _CG) -> _CG:
        for dst, src in zip(self.cg, cg):
            dst.copy_(src)
        return self.cg


# Captured CG blocks by operand shapes and device, least recently used first.
_CG_GRAPHS: OrderedDict = OrderedDict()
CG_GRAPH_CACHE_SIZE = 4
_cg_lock = threading.Lock()


def _cg_graph(cg: _CG) -> _CGGraph:
    key = tuple((tuple(t.shape), t.dtype) for t in cg) + (cg.x.device,)
    with _cg_lock:
        graph = _CG_GRAPHS.get(key)
        if graph is None:
            graph = _CG_GRAPHS[key] = _CGGraph(cg)
            while len(_CG_GRAPHS) > CG_GRAPH_CACHE_SIZE:
                _CG_GRAPHS.popitem(last=False)
        else:
            _CG_GRAPHS.move_to_end(key)
        return graph


def _banded_pcg_solve(U, b_c, S_band, b_red, damping, fix_first: bool,
                      half_band: int, n_cg: int = 200, tol: float = 1e-6,
                      precond_block: int = 1):
    """Solve the reduced camera system in banded form by preconditioned
    conjugate gradients, never forming the [6C, 6C] matrix. Returns
    (dx [C, 6], iterations (0-d int32), info (0-d int32, nonzero when a
    group inverse was singular)).

    ``precond_block`` = cameras per preconditioner group: 1 is block
    Jacobi on the [6, 6] diagonal; g > 1 inverts each run of g cameras'
    in-band couplings as a dense [6g, 6g] block once per solve. The
    iterations run in blocks of CG_CHECK_EVERY (``n_cg`` a multiple of
    it) that test convergence on the device (``_cg_iterations``); the host
    reads the flag once per block. On the card each block is one replay of
    a captured CUDA graph (``_CGGraph``); on the CPU, and under
    ``utils.cuda.reference_path()``, the same iterations run eagerly."""
    if n_cg % CG_CHECK_EVERY:
        raise ValueError(f"n_cg ({n_cg}) must be a multiple of "
                         f"{CG_CHECK_EVERY}")
    C = U.shape[0]
    width = 2 * half_band + 1
    dev = U.device
    eye6 = torch.eye(6, dtype=U.dtype, device=dev)

    # A = damped diag(U) - S_red (+ the dense path's 1e-8 ridge)
    A = -S_band
    A[:, half_band] = A[:, half_band] + (_damp(U, damping) + 1e-8 * eye6)
    b = b_c - b_red
    if fix_first:
        # gauge: pin camera 0 (zero its rows and columns, identity diagonal)
        c_of = (torch.arange(C, device=dev)[:, None]
                + torch.arange(width, device=dev)[None, :] - half_band)
        row_ok = (torch.arange(C, device=dev) != 0)[:, None, None, None]
        col_ok = (c_of != 0)[:, :, None, None]
        A = torch.where(row_ok & col_ok, A, 0.0)
        A[0, half_band] = eye6
        b = b.clone()
        b[0] = 0.0

    info = torch.zeros((), dtype=torch.int32, device=dev)
    if precond_block <= 1:
        M = A[:, half_band]
    else:
        M, inv_info = _group_inverse(A, half_band, int(precond_block))
        info = inv_info.ne(0).any().to(torch.int32)
    win = (torch.arange(C, device=dev)[:, None]
           + torch.arange(width, device=dev)[None, :])
    x = torch.zeros_like(b)
    cg = _CG(A.permute(0, 2, 1, 3).reshape(C, 6, width * 6), win, M,
             tol * tol * torch.clamp((b * b).sum(), min=1e-30), x, x, x,
             x.new_zeros(()), torch.zeros((), dtype=torch.int32,
                                          device=dev))
    r = b - _cg_matvec(cg, x)
    z = _cg_prec(cg, r)
    cg = cg._replace(r=r, p=z, rz=(r * z).sum())
    if cuda.use_kernel(x):
        graph = _cg_graph(cg)
        cg, block = graph.load(cg), graph.graph.replay
    else:
        cg = cg._replace(x=x.clone(), p=z.clone())

        def block():
            _cg_iterations(cg, CG_CHECK_EVERY)
    n_blocks = n_cg // CG_CHECK_EVERY
    for i in range(n_blocks):
        block()
        if i + 1 < n_blocks and not bool((cg.r * cg.r).sum() > cg.limit):
            break
    return cg.x.clone(), cg.k.clone(), info


def _windowed_solve_and_update(R, t, X, sys_terms, point_terms, damping,
                               n_cameras: int, fix_first: bool, solver: str,
                               precond_block: int):
    """Camera solve on the banded system, then the per-landmark
    back-substitution. Returns (R, t, X, cost, cg_iters, info)."""
    U, b_c, S_band, b_red, cost = sys_terms
    V_inv, W, b_p, cidx = point_terms
    half_band = S_band.shape[1] // 2
    if solver == "dense":
        dx_c, info = _reduce_and_solve(U, b_c,
                                       _dense_from_band(S_band, n_cameras),
                                       b_red, damping, fix_first)
        cg_iters = torch.zeros((), dtype=torch.int32, device=U.device)
    elif solver == "cg":
        dx_c, cg_iters, info = _banded_pcg_solve(
            U, b_c, S_band, b_red, damping, fix_first, half_band,
            precond_block=precond_block)
    else:
        raise ValueError(f"solver must be 'dense' or 'cg', got {solver!r}")

    L, kw = cidx.shape
    dxc_g = dx_c[cidx]                                     # [L, Kw, 6]
    # rhs_p[l, j] = b_p[l, j] - sum_k,i W[l, k, i, j] dx[c0 + k, i]
    rhs_p = b_p - _mv(W.reshape(L, kw * 6, 3).transpose(1, 2),
                      dxc_g.reshape(L, kw * 6))
    dx_p = _mv(V_inv, rhs_p)
    R_new = _mm(so3_exp(dx_c[:, :3]), R)
    return R_new, t + dx_c[:, 3:], X + dx_p, cost, cg_iters, info


def _points_only_step(K, R, t, X, c0, uv, w, damping, n_cameras: int):
    """Refine landmarks with the cameras frozen (each landmark an
    independent damped 3x3 solve): the warm start for weak triangulations
    (short baselines, noisy poses)."""
    cidx, in_range = _window(c0, uv.shape[1], n_cameras)
    _, Rc, r, dpi = _project_terms(K, R, t, X, cidx, in_range, uv, w)
    Jp = _mm(dpi, Rc)
    V = _outer(Jp, Jp).sum(1)
    b_p = -_mv(Jp.transpose(-1, -2), r).sum(1)
    V_inv, _ = inv3x3(_damp(V, damping))
    return X + _mv(V_inv, b_p)


def gate_windowed(problem: WindowedBAProblem, R0, t0, X0,
                  max_reproj_error: float) -> WindowedBAProblem:
    """Zero the weights of observations whose initial reprojection error
    exceeds the threshold (outlier tracks, bad triangulations)."""
    dev = problem.uv.device
    require_fp32(dev)
    R, t, X = f32(R0, dev), f32(t0, dev), f32(X0, dev)
    kw = problem.uv.shape[1]
    cidx, _ = _window(problem.c0, kw, int(R.shape[0]))
    Y = _mv(R[cidx], X[:, None]) + t[cidx]
    zs = torch.clamp(Y[..., 2], min=1e-4)
    K = problem.K
    u = K[0, 0] * Y[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Y[..., 1] / zs + K[1, 2]
    err = torch.sqrt((u - problem.uv[..., 0]) ** 2
                     + (v - problem.uv[..., 1]) ** 2)
    ok = (err <= max_reproj_error) & (Y[..., 2] > 0)
    return problem._replace(w=problem.w * ok.to(problem.w.dtype))


def _windowed_body(coord, problem, R, t, X, n_iters, damping, fix_first,
                   huber_delta, point_only_iters, solver, precond_block, axis,
                   n_ranks):
    """The landmark-sharded windowed GN loop on one rank (parallel/sharding
    local body): this rank's landmark rows, one combine of the banded
    camera system per GN step, X gathered at the end."""
    from ..parallel.sharding import Gather, SumParts, block
    lb = block(coord[axis], n_ranks, X.shape[0], "landmark rows")
    K = problem.K
    c0, uv, w = problem.c0[lb], problem.uv[lb], problem.w[lb]
    X_loc = X[lb]
    n_cameras = int(R.shape[0])
    for _ in range(point_only_iters):
        X_loc = _points_only_step(K, R, t, X_loc, c0, uv, w, damping,
                                  n_cameras)
    # first cameras past the last one hold only ignored slots
    seg = segments(c0.clamp(0, n_cameras - 1), n_cameras)
    costs, cg_iters, infos = [], [], []
    for _ in range(n_iters):
        sys_terms, point_terms = _windowed_camera_system(
            K, R, t, X_loc, c0, uv, w, seg, damping, n_cameras, huber_delta)
        sys_terms = yield SumParts(sys_terms, axis, "camera_system")
        R, t, X_loc, cost, k, info = _windowed_solve_and_update(
            R, t, X_loc, sys_terms, point_terms, damping, n_cameras,
            fix_first, solver, precond_block)
        costs.append(cost)
        cg_iters.append(k)
        infos.append(info)
    (X,) = yield Gather((X_loc,), (0,), axis, "output")
    return R, t, X, costs, cg_iters, infos


def bundle_adjust_windowed(problem: WindowedBAProblem, R0, t0, X0,
                           n_iters: int = 10, damping: float = 1e-3,
                           fix_first: bool = True,
                           huber_delta: float | None = None,
                           point_only_iters: int = 2,
                           solver: str = "dense",
                           precond_block: int = 1,
                           return_info: bool = False,
                           mesh=None, axis: str = "landmark"):
    """Run GN/LM with K-windowed sparsity on the problem's device. Returns
    (R, t, X, costs), ``costs`` a device tensor of per-iteration costs
    (before each step). ``point_only_iters`` camera-frozen landmark
    refinements run first.

    ``solver="dense"`` densifies the band and solves the [6C, 6C] reduced
    camera system (exact; a few hundred cameras). ``solver="cg"`` keeps
    it banded and runs preconditioned CG (O(C Kw) memory, thousands of
    cameras); ``precond_block`` > 1 groups the preconditioner into [6g,
    6g] camera blocks. ``return_info=True`` appends {"cg_iters": [n_iters]
    int32} (zeros for dense).

    With ``mesh`` (a DeviceMesh or split with an ``axis`` dimension), the
    landmark rows shard over ``axis`` in equal blocks (their count a
    multiple of the ranks: ``pad_windowed_for_mesh``); R, t, X and the
    costs come back whole on every rank.

    Host reads: the landmark grouping's width once per call, the CG flag
    once every ``CG_CHECK_EVERY`` iterations, and the solves' ``info`` at
    the end (a singular system gives NaN updates and a warning).
    """
    from ..parallel import sharding
    dev = problem.uv.device
    require_fp32(dev)
    R, t, X = f32(R0, dev), f32(t0, dev), f32(X0, dev)
    problem = problem._replace(c0=problem.c0.to(torch.int64))
    if mesh is None:
        mesh = sharding.split_mesh((1,), (axis,), dev)
    sizes = sharding.mesh_sizes(mesh)
    if axis not in sizes:
        raise ValueError(f"bundle_adjust_windowed: the mesh has no {axis!r} "
                         f"axis ({tuple(sizes)})")
    if sharding.mesh_device(mesh).type != dev.type:
        raise ValueError(f"bundle_adjust_windowed: the problem lies on {dev}, "
                         f"the mesh computes on {sharding.mesh_device(mesh)}")
    R, t, X, costs, cg_iters, infos = sharding.run_sharded(
        mesh, _windowed_body, problem, R, t, X, n_iters, damping, fix_first,
        huber_delta, point_only_iters, solver, precond_block, axis,
        sizes[axis])
    if infos and bool(to_host(torch.stack(infos).ne(0).any())):
        KLTWarning("(bundle_adjust_windowed) a camera system or a "
                   "preconditioner block was singular; its update is NaN")
    costs = (torch.stack(costs) if costs
             else torch.zeros((0,), dtype=torch.float32, device=dev))
    out = (R, t, X, costs)
    if return_info:
        out = out + ({"cg_iters": torch.stack(cg_iters) if cg_iters
                      else torch.zeros((0,), dtype=torch.int32,
                                       device=dev)},)
    return out


def pad_windowed_for_mesh(problem: WindowedBAProblem, X0, n_dev: int):
    """Pad landmarks (rows of the problem and of X0) to a multiple of
    ``n_dev`` with zero-weight windows. Returns (problem, X0, n_pad);
    slice the trailing n_pad rows off the X that BA returns. Zero weights
    make pad rows exact no-ops in the camera system."""
    L = int(problem.c0.shape[0])
    X0 = f32(X0, problem.uv.device)
    n_pad = (-L) % n_dev
    if n_pad == 0:
        return problem, X0, 0
    kw = int(problem.uv.shape[1])
    problem = problem._replace(
        c0=torch.cat([problem.c0, problem.c0.new_zeros((n_pad,))]),
        uv=torch.cat([problem.uv, problem.uv.new_zeros((n_pad, kw, 2))]),
        w=torch.cat([problem.w, problem.w.new_zeros((n_pad, kw))]))
    return problem, torch.cat([X0, X0.new_ones((n_pad, 3))]), n_pad
