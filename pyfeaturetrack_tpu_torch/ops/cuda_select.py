"""K4: greedy min-distance extraction (csrc/extract.cu) and its plain
version.

Port of ``pyfeaturetrack_tpu/ops/pallas_select.py`` (greedy_extract_pallas):
straight from the int32 candidate map, repeat argmax (first occurrence in
row-major order) -> record -> zero the (2 dg + 1)^2 box, until the maximum
drops below ``min_eig`` or ``budget`` candidates were accepted. That is
the host greedy's acceptance sequence over the full candidate pool.

A CUDA tensor launches the kernel (one launch per call) on a scratch copy
of the map; ``budget`` stays on the device and ``n_acc`` comes back as a
device tensor, so a refill needs no host sync. A CPU tensor takes
``greedy_extract_reference``.
"""

from __future__ import annotations

import torch

from ..utils import cuda

# Kernel launches made by this wrapper.
launches = 0


def greedy_extract_reference(cand: torch.Tensor, min_eig: int, dg: int,
                             budget: torch.Tensor, max_out: int):
    """Plain version of K4: the obvious loop (``argmax`` returns the first
    maximum). Returns (rows, cols, vals) int32 [max_out] (lanes >= n_acc
    are zero) and n_acc int32 [1]."""
    m = cand.clone()
    ny, nx = m.shape
    dev = cand.device
    out = torch.zeros((3, max_out), dtype=torch.int32, device=dev)
    flat = m.view(-1)
    n = 0
    limit = min(int(budget.reshape(-1)[0]), max_out)
    while n < limit:
        i = int(torch.argmax(flat))
        v = int(flat[i])
        if v < min_eig:
            break
        r, c = divmod(i, nx)
        out[:, n] = torch.tensor([r, c, v], dtype=torch.int32)
        m[max(r - dg, 0):r + dg + 1, max(c - dg, 0):c + dg + 1] = 0
        n += 1
    return out[0], out[1], out[2], torch.tensor([n], dtype=torch.int32,
                                               device=dev)


def _launch(scratch, budget, min_eig, dg, max_out, rr, cc, vv, n_acc):
    global launches
    fn = cuda.function("pft_greedy_extract",
                       [cuda.c_ptr, cuda.c_int, cuda.c_int, cuda.c_ptr]
                       + [cuda.c_int] * 3 + [cuda.c_ptr] * 5)
    ny, nx = scratch.shape
    rc = fn(scratch.data_ptr(), ny, nx, budget.data_ptr(), min_eig, dg,
            max_out, rr.data_ptr(), cc.data_ptr(), vv.data_ptr(),
            n_acc.data_ptr(), cuda.stream_ptr(scratch.device))
    cuda.check(rc, "pft_greedy_extract")
    launches += 1


def greedy_extract(cand: torch.Tensor, *, min_eig: int, dg: int,
                   budget: torch.Tensor, max_out: int):
    """Greedy selection from the candidate-lattice map ``cand`` (int32
    [ny, nx], blocked cells already zeroed). ``dg``: box radius in lattice
    steps. ``budget``: int32 [1] on the map's device (at most ``max_out``
    acceptances are made). Returns (rows, cols, vals) int32 [max_out] in
    acceptance order and n_acc int32 [1]."""
    min_eig = max(int(min_eig), 1)
    if not cuda.use_kernel(cand, budget):
        return greedy_extract_reference(cand, min_eig, dg, budget, max_out)
    cuda.require(cand.dtype == torch.int32 and cand.dim() == 2
                 and cand.numel() > 0,
                 "greedy_extract takes a non-empty int32 [ny, nx] map")
    cuda.require(budget.dtype == torch.int32 and budget.numel() == 1,
                 "greedy_extract takes an int32 [1] budget")
    cuda.require(dg >= 0 and max_out >= 0, "greedy_extract: dg, max_out >= 0")
    scratch = cand.contiguous().clone()     # the kernel zeroes boxes in place
    dev = cand.device
    rr = torch.empty((max_out,), dtype=torch.int32, device=dev)
    cc = torch.empty_like(rr)
    vv = torch.empty_like(rr)
    n_acc = torch.empty((1,), dtype=torch.int32, device=dev)
    _launch(scratch, budget.contiguous(), min_eig, int(dg), int(max_out),
            rr, cc, vv, n_acc)
    return rr, cc, vv, n_acc
