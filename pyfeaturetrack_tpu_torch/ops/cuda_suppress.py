"""K5: greedy min-distance suppression over priority-ordered candidates
(csrc/suppress.cu) and its plain versions.

Port of ``pyfeaturetrack_tpu/ops/pallas_select.py`` (greedy_suppress_pallas),
which is the host greedy of ``ops/select.py`` (_enforce_minimum_distance)
as one kernel: in priority order, while fewer than ``budget`` candidates
were accepted, a valid candidate whose pixel is not yet covered is
accepted and covers the (2 (mindist - 1) + 1)^2 box around it, clipped to
the image (mindist 0 covers nothing). A candidate outside the image is
never accepted. Unlike the TPU kernel there is no cap on the radius or the
image size.

Two entries over the same scan:

* ``greedy_suppress``: candidate pixels and flags in; flags, the accepted
  lanes in acceptance order and their count out, under a budget read on
  the device (greedy_suppress_pallas' contract);
* ``suppress_and_fill``: the host API's selection after its sort
  (ops/select.py): the sort's outputs in, the candidates' pixels and
  validity decoded, the free slots counted for the budget, and the r-th
  acceptance written into the r-th free slot (``cuda_select.fill_slots``'
  rule).

A CUDA tensor launches the kernel (one launch per call, nothing read on
the host); a CPU tensor takes ``greedy_suppress_reference`` or
``suppress_and_fill_reference``.
"""

from __future__ import annotations

import torch

from ..utils import cuda
from .cuda_select import fill_slots, kept_positions

# Kernel launches made by this wrapper.
launches = 0

# Dynamic shared memory the kernel leaves for the coverage grid (227 KB on
# the H100, less its static buffers: csrc/suppress.cu SMEM_GRID_MAX); a
# larger grid lives in global memory.
SMEM_GRID_BYTES = 232448 - 8192


def grid_bytes(shape) -> int:
    """Bytes of the kernel's one-bit-per-pixel coverage grid."""
    h, w = shape
    return 4 * h * ((w + 31) // 32)


@cuda.plain_version
def greedy_suppress_reference(cand_x: torch.Tensor, cand_y: torch.Tensor,
                              valid: torch.Tensor, budget: torch.Tensor,
                              shape, mindist: int, max_out: int):
    """Plain version of K5: the host greedy's loop over the candidates.
    Returns (accepted bool [K], order int32 [max_out], n_acc int32 [1]) on
    the inputs' device."""
    h, w = shape
    d = int(mindist) - 1
    k = cand_x.shape[0]
    xs, ys, vs = cand_x.tolist(), cand_y.tolist(), valid.tolist()
    limit = min(int(budget.reshape(-1)[0]), max_out)
    occ = torch.zeros((h, w), dtype=torch.bool)
    accepted = torch.zeros(k, dtype=torch.bool)
    order = torch.zeros(max_out, dtype=torch.int32)
    n = 0
    for j in range(k):
        if n >= limit:
            break
        x, y = xs[j], ys[j]
        if not (vs[j] and 0 <= x < w and 0 <= y < h) or occ[y, x]:
            continue
        accepted[j] = True
        order[n] = j
        n += 1
        if d >= 0:
            occ[max(y - d, 0):y + d + 1, max(x - d, 0):x + d + 1] = True
    dev = cand_x.device
    return (accepted.to(dev), order.to(dev),
            torch.tensor([n], dtype=torch.int32, device=dev))


def _launch(cx, cy, valid, budget, shape, d, max_out, grid, accepted, order,
            n_acc):
    global launches
    fn = cuda.function("pft_greedy_suppress",
                       [cuda.c_ptr] * 3 + [cuda.c_int, cuda.c_ptr]
                       + [cuda.c_int] * 4 + [cuda.c_ptr] * 5)
    h, w = shape
    rc = fn(cx.data_ptr(), cy.data_ptr(), valid.data_ptr(), cx.shape[0],
            budget.data_ptr(), h, w, d, max_out,
            grid.data_ptr() if grid is not None else None,
            accepted.data_ptr(), order.data_ptr(), n_acc.data_ptr(),
            cuda.stream_ptr(cx.device))
    cuda.check(rc, "pft_greedy_suppress")
    launches += 1


def greedy_suppress(cand_x: torch.Tensor, cand_y: torch.Tensor,
                    valid: torch.Tensor, *, shape, mindist: int,
                    budget: torch.Tensor, max_out: int):
    """Greedy mindist acceptance over priority-ordered candidates.

    ``cand_x``/``cand_y``: int32 [K] pixel coordinates; ``valid``: bool
    [K]; ``shape``: the image (nrows, ncols); ``budget``: int32 [1] on the
    candidates' device (at most ``max_out`` acceptances are made).
    Returns (accepted bool [K], order int32 [max_out], n_acc int32 [1]):
    ``order[:n_acc]`` are the accepted lanes in acceptance order, the rest
    0. The kernel keeps its coverage grid in shared memory when it fits
    (``SMEM_GRID_BYTES``), else in a global scratch."""
    if not cuda.use_kernel(cand_x, cand_y, valid, budget):
        return greedy_suppress_reference(cand_x, cand_y, valid, budget, shape,
                                         mindist, max_out)
    k = cand_x.shape[0]
    cuda.require(all(t.dim() == 1 and t.shape[0] == k
                     for t in (cand_y, valid))
                 and cand_x.dtype == torch.int32
                 and cand_y.dtype == torch.int32
                 and valid.dtype == torch.bool,
                 "greedy_suppress takes int32 [K] x, y and a bool [K] valid")
    cuda.require(budget.dtype == torch.int32 and budget.numel() == 1,
                 "greedy_suppress takes an int32 [1] budget")
    h, w = (int(s) for s in shape)
    cuda.require(h > 0 and w > 0 and max_out >= 0 and k < 2 ** 31,
                 "greedy_suppress: a non-empty image, max_out >= 0")
    dev = cand_x.device
    scratch = _grid_scratch((h, w), dev)
    accepted = torch.empty((k,), dtype=torch.bool, device=dev)
    order = torch.empty((max_out,), dtype=torch.int32, device=dev)
    n_acc = torch.empty((1,), dtype=torch.int32, device=dev)
    _launch(cand_x.contiguous(), cand_y.contiguous(), valid.contiguous(),
            budget.contiguous(), (h, w), int(mindist) - 1, int(max_out),
            scratch, accepted, order, n_acc)
    return accepted, order, n_acc


def _grid_scratch(shape, dev):
    """The global-memory coverage grid when the grid does not fit shared
    memory, else None."""
    nbytes = grid_bytes(shape)
    if nbytes <= SMEM_GRID_BYTES:
        return None
    return torch.empty((nbytes // 4,), dtype=torch.int32, device=dev)


def decode_candidates(neg: torch.Tensor, order: torch.Tensor, geom,
                      min_eig: int):
    """The sorted candidate list of the host API: each lattice index's pixel
    (int32 x, y) and its value (``-neg``) with its validity (value >=
    ``min_eig``). ``geom``: (borderx, bordery, step, ny, nx)."""
    borderx, bordery, step, _, nx = geom
    vals = -neg
    cand_x = (borderx + (order % nx) * step).to(torch.int32)
    cand_y = (bordery + (order // nx) * step).to(torch.int32)
    return cand_x, cand_y, vals, vals >= min_eig


@cuda.plain_version
def suppress_and_fill_reference(neg, order, geom, min_eig, shape, mindist,
                                x, y, val, replacing):
    """Plain version of the fused entry: the decode, ``greedy_suppress``'s
    plain version under the free-slot budget, then ``fill_slots``."""
    cand_x, cand_y, vals, valid = decode_candidates(neg, order, geom, min_eig)
    free = (val < 0) if replacing else torch.ones_like(val, dtype=torch.bool)
    _, idx, n_acc = greedy_suppress_reference(
        cand_x, cand_y, valid, free.sum().to(torch.int32).reshape(1), shape,
        mindist, int(val.shape[0]))
    idx = idx.to(torch.int64)
    return fill_slots(n_acc, cand_x[idx], cand_y[idx], vals[idx], free, x, y,
                      val)[:3]


def _launch_fill(neg, order, geom, min_eig, shape, d, x, y, val, replacing,
                 grid, acc, out):
    global launches
    fn = cuda.function("pft_suppress_fill",
                       [cuda.c_ptr, cuda.c_ptr] + [cuda.c_int] * 9
                       + [cuda.c_ptr] * 3 + [cuda.c_int] * 2
                       + [cuda.c_ptr] * 6)
    borderx, bordery, step, _, nx = geom
    h, w = shape
    rc = fn(neg.data_ptr(), order.data_ptr(), neg.shape[0], borderx, bordery,
            step, nx, min_eig, h, w, d, x.data_ptr(), y.data_ptr(),
            val.data_ptr(), val.shape[0], int(bool(replacing)),
            grid.data_ptr() if grid is not None else None, acc.data_ptr(),
            *(t.data_ptr() for t in out), cuda.stream_ptr(neg.device))
    cuda.check(rc, "pft_suppress_fill")
    launches += 1


def suppress_and_fill(neg: torch.Tensor, order: torch.Tensor, *, geom,
                      min_eig: int, shape, mindist: int, x: torch.Tensor,
                      y: torch.Tensor, val: torch.Tensor, replacing: bool):
    """The host API's (re)selection after its sort, in one launch.

    ``neg``, ``order``: ``torch.sort(-lattice.reshape(-1), stable=True)``'s
    int32 values and int64 indices over the candidate lattice of ``geom``
    (borderx, bordery, step, ny, nx) in an image of ``shape``; ``min_eig``:
    the validity bar; ``x``, ``y`` (float32), ``val`` (int32): the feature
    slots, free where ``val < 0`` when ``replacing``, else all. The greedy
    scan accepts at most as many candidates as there are free slots; the
    r-th acceptance fills the r-th free slot, the other free slots become
    (-1, -1, KLT_NOT_FOUND). Returns the new (x, y, val); on CUDA the kept
    lanes' positions carry gradients (``cuda_select.kept_positions``)."""
    min_eig = int(min_eig)
    h, w = (int(s) for s in shape)
    if not cuda.use_kernel(neg, order, x, y, val):
        return suppress_and_fill_reference(neg, order, geom, min_eig, (h, w),
                                           mindist, x, y, val, replacing)
    k = neg.shape[0]
    n = val.shape[0]
    cuda.require(neg.dtype == torch.int32 and order.dtype == torch.int64
                 and neg.dim() == 1 and order.shape == (k,)
                 and neg.is_contiguous() and order.is_contiguous(),
                 "suppress_and_fill takes contiguous int32 keys and int64 "
                 "order [K]")
    cuda.require(x.dtype == y.dtype == torch.float32
                 and val.dtype == torch.int32 and x.shape == y.shape == (n,)
                 and all(t.is_contiguous() for t in (x, y, val)),
                 "suppress_and_fill takes contiguous float32 x, y and int32 "
                 "val [N]")
    cuda.require(h > 0 and w > 0 and geom[2] > 0 and geom[4] > 0
                 and k < 2 ** 31, "suppress_and_fill: a non-empty lattice")
    dev = neg.device

    def launch(x, y, val):
        out = (torch.empty_like(x), torch.empty_like(y),
               torch.empty_like(val))
        if n:
            _launch_fill(neg, order, geom, min_eig, (h, w), int(mindist) - 1,
                         x, y, val, replacing, _grid_scratch((h, w), dev),
                         torch.empty((n,), dtype=torch.int32, device=dev),
                         out)
        return out

    free = (val < 0) if replacing else torch.ones_like(val, dtype=torch.bool)
    return cuda.with_plain_vjp(launch, kept_positions(free), x, y, val)
