"""K5: greedy min-distance suppression over priority-ordered candidates
(csrc/suppress.cu) and its plain version.

Port of ``pyfeaturetrack_tpu/ops/pallas_select.py`` (greedy_suppress_pallas),
which is the host greedy of ``ops/select.py`` (_enforce_minimum_distance)
as one kernel: in priority order, while fewer than ``budget`` candidates
were accepted, a valid candidate whose pixel is not yet covered is
accepted and covers the (2 (mindist - 1) + 1)^2 box around it, clipped to
the image (mindist 0 covers nothing). A candidate outside the image is
never accepted. Unlike the TPU kernel there is no cap on the radius or the
image size.

A CUDA tensor launches the kernel (one launch per call): ``budget`` stays
on the device and the accepted lanes come back compacted in acceptance
order with their count as a device tensor, so the slot fill needs no host
sync. A CPU tensor takes ``greedy_suppress_reference``.
"""

from __future__ import annotations

import torch

from ..utils import cuda

# Kernel launches made by this wrapper.
launches = 0

# Dynamic shared memory one block can use on the H100 (227 KB): a larger
# coverage grid lives in global memory.
SMEM_GRID_BYTES = 232448


def grid_bytes(shape) -> int:
    """Bytes of the kernel's one-bit-per-pixel coverage grid."""
    h, w = shape
    return 4 * h * ((w + 31) // 32)


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
    nbytes = grid_bytes((h, w))
    scratch = None
    if nbytes > SMEM_GRID_BYTES:
        scratch = torch.empty((nbytes // 4,), dtype=torch.int32, device=dev)
    accepted = torch.empty((k,), dtype=torch.bool, device=dev)
    order = torch.empty((max_out,), dtype=torch.int32, device=dev)
    n_acc = torch.empty((1,), dtype=torch.int32, device=dev)
    _launch(cand_x.contiguous(), cand_y.contiguous(), valid.contiguous(),
            budget.contiguous(), (h, w), int(mindist) - 1, int(max_out),
            scratch, accepted, order, n_acc)
    return accepted, order, n_acc
