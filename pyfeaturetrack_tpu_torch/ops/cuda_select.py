"""K4: the device route's (re)selection in two launches (csrc/extract.cu)
and the plain versions of both stages.

Port of ``pyfeaturetrack_tpu/ops/pallas_select.py`` (greedy_extract_pallas)
with the candidate pre-mask and the slot fill around it
(``pyfeaturetrack_tpu/ops/select_device.py:188-249``):

* stage A, ``candidate_lattice``: the strided candidate lattice read from
  the int32 eig map, cells below ``min_eig`` zeroed and, with ``radius >=
  0``, every cell within Chebyshev distance ``radius`` of a kept feature
  zeroed; returned with its maxima per segment of ``seg`` columns and per
  row (``Candidates``);
* stage B, ``greedy_fill``: the greedy chain (argmax, first occurrence in
  row-major order -> record -> zero the (2 dg + 1)^2 box, until the maximum
  drops below ``min_eig`` or the budget of free slots is used up: the host
  greedy's acceptance sequence over the full candidate pool), then the r-th
  acceptance into the r-th free slot.

``select_from_eig`` runs both; ``greedy_extract`` is the chain alone on a
given lattice map (stage A over the map, then stage B without slots).
A CUDA tensor launches the kernels, one per stage, with the budget counted
on the device, so a refill needs no host sync; a CPU tensor takes the plain
versions (``candidate_lattice_reference``; ``greedy_extract_reference`` and
``fill_slots``). On a refill, stage B adds its acceptances and segment
rescans to the card's device counters (``utils/profiling.DEVICE_COUNTERS``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..features import KLT_NOT_FOUND
from ..utils import cuda, profiling

# Kernel launches made by this module's wrappers (each stage counts one).
launches = 0
profiling.launch_counter(__name__, "launches")

# Stage B holds every segment maximum in shared memory, so the lattice's
# layout follows its shared-memory count (csrc/extract.cu chain_smem, with
# ACC_CHUNK acceptances buffered), which refuses a lattice that does not
# fit. Where the box bitmap goes is the C entry's own choice.
CHAIN_SMEM_BYTES = 227 * 1024
ACC_CHUNK = 256
# Stage A stamps the pre-mask of its four lattice rows in shared memory up
# to this many bytes (csrc/extract.cu PFT_LATTICE_SMEM: 40,960 columns),
# in device memory the wrapper passes beyond it.
LATTICE_SMEM_BYTES = 160 * 1024
A_WARPS = 4


class Candidates(NamedTuple):
    """Stage A's output. ``cells``: int32 [ny, stride], the lattice with
    columns >= nx zero (stride a multiple of ``seg``); ``seg_v``/``seg_c``:
    int32 [ny, stride // seg], each segment's maximum and the first column
    holding it; ``row_v``/``row_c``: int32 [ny], the same per row."""
    cells: torch.Tensor
    seg_v: torch.Tensor
    seg_c: torch.Tensor
    row_v: torch.Tensor
    row_c: torch.Tensor
    nx: int
    seg: int


def _chain_smem(ny: int, nseg: int) -> int:
    segs = 2 * ny * nseg if nseg > 1 else 0     # one segment: the row's
    return 4 * (segs + 2 * ny + 2 * (-(-ny // 32)) + 3 * ACC_CHUNK)


def segment_width(ny: int, nx: int) -> int:
    """The lattice segment width both stages use for a [ny, nx] lattice:
    the smallest power of two of at least 32 columns whose maxima fit
    stage B's shared memory (32 at 480x640, 64 at 768x1280, 128 at
    1080x1920, 256 at 1440x2560, 512 at 2160x3840), else one segment per
    row (whose row maxima stage B keeps in device memory when they do not
    fit either). A layout only: the plain versions never refuse a
    lattice."""
    seg = 32
    while seg < nx and _chain_smem(ny, -(-nx // seg)) > CHAIN_SMEM_BYTES:
        seg *= 2
    return seg


def _lattice_maxima(cells: torch.Tensor, nx: int, seg: int) -> Candidates:
    """Segment and row maxima of a padded lattice (first column on ties)."""
    ny, stride = cells.shape
    blocks = cells.view(ny, stride // seg, seg)
    sarg = torch.argmax(blocks, dim=2)
    seg_v = torch.gather(blocks, 2, sarg[..., None])[..., 0]
    seg_c = sarg + torch.arange(0, stride, seg, device=cells.device)
    rarg = torch.argmax(cells, dim=1)
    row_v = torch.gather(cells, 1, rarg[:, None])[:, 0]
    return Candidates(cells, seg_v.to(torch.int32).contiguous(),
                      seg_c.to(torch.int32).contiguous(),
                      row_v.to(torch.int32).contiguous(),
                      rarg.to(torch.int32).contiguous(), nx, seg)


def candidate_lattice_reference(eig, x, y, val, geom, *, min_eig: int,
                                radius: int) -> Candidates:
    """Plain version of stage A, in lattice space: each kept feature
    (``val >= 0``) at (int32(x), int32(y)) clamped into the frame blocks the
    lattice rows and columns whose pixel lies within ``radius`` of it; the
    boxes are stamped into a difference array whose 2-D prefix sums count
    the features covering each cell. ``geom``: (borderx, bordery, step, ny,
    nx) of ``select_device._candidate_grid``; ``radius < 0``: no pre-mask."""
    borderx, bordery, step, ny, nx = geom
    nrows, ncols = eig.shape
    cand = eig[bordery:bordery + (ny - 1) * step + 1:step,
               borderx:borderx + (nx - 1) * step + 1:step]
    cand = torch.where(cand < min_eig, 0, cand)
    if radius >= 0:
        xi = x.to(torch.int32).clamp(0, ncols - 1).to(torch.int64)
        yi = y.to(torch.int32).clamp(0, nrows - 1).to(torch.int64)

        def span(p, border, n):
            lo = -torch.div(border + radius - p, step, rounding_mode="floor")
            hi = torch.div(p + radius - border, step, rounding_mode="floor") + 1
            return lo.clamp(0, n), hi.clamp(0, n)

        r_lo, r_hi = span(yi, bordery, ny)
        c_lo, c_hi = span(xi, borderx, nx)
        w = ((val >= 0) & (r_lo < r_hi) & (c_lo < c_hi)).to(torch.int64)
        diff = torch.zeros((ny + 1) * (nx + 1), dtype=torch.int64,
                           device=eig.device)
        for rows, cols, sign in ((r_lo, c_lo, 1), (r_lo, c_hi, -1),
                                 (r_hi, c_lo, -1), (r_hi, c_hi, 1)):
            diff.index_put_((rows * (nx + 1) + cols,), sign * w,
                            accumulate=True)
        cover = diff.view(ny + 1, nx + 1).cumsum(0).cumsum(1)[:ny, :nx]
        cand = torch.where(cover > 0, 0, cand)
    seg = segment_width(ny, nx)
    stride = -(-nx // seg) * seg
    cells = F.pad(cand.to(torch.int32), (0, stride - nx)).contiguous()
    return _lattice_maxima(cells, nx, seg)


def _launch_lattice(eig, x, y, val, geom, min_eig, radius, out):
    global launches
    fn = cuda.function("pft_candidate_lattice",
                       [cuda.c_ptr, cuda.c_int, cuda.c_int] + [cuda.c_ptr] * 3
                       + [cuda.c_int] * 10 + [cuda.c_ptr] * 7)
    borderx, bordery, step, ny, nx = geom
    stride = out.cells.shape[1]
    mask = None
    if A_WARPS * stride > LATTICE_SMEM_BYTES:
        mask = torch.empty((-(-ny // A_WARPS) * A_WARPS * stride,),
                           dtype=torch.uint8, device=eig.device)
    rc = fn(eig.data_ptr(), eig.shape[0], eig.shape[1], x.data_ptr(),
            y.data_ptr(), val.data_ptr(), val.shape[0], radius, borderx,
            bordery, step, ny, nx, min_eig, out.seg, stride,
            None if mask is None else mask.data_ptr(),
            *(t.data_ptr() for t in out[:5]), cuda.stream_ptr(eig.device))
    cuda.check(rc, "pft_candidate_lattice")
    launches += 1


def candidate_lattice(eig: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      val: torch.Tensor, geom, *, min_eig: int,
                      radius: int) -> Candidates:
    """Stage A: the candidate lattice of the int32 eig map with its maxima.
    ``x``/``y``/``val``: the feature slots (kept: ``val >= 0``), read when
    ``radius >= 0``; ``geom``: (borderx, bordery, step, ny, nx), a
    non-empty lattice."""
    min_eig = max(int(min_eig), 1)
    radius = int(radius)
    if not cuda.use_kernel(eig, x, y, val):
        return candidate_lattice_reference(eig, x, y, val, geom,
                                           min_eig=min_eig, radius=radius)
    borderx, bordery, step, ny, nx = geom
    cuda.require(eig.dtype == torch.int32 and eig.dim() == 2
                 and eig.is_contiguous(),
                 "candidate_lattice takes a contiguous int32 [H, W] map")
    n = val.shape[0]
    cuda.require(x.dtype == y.dtype == torch.float32 and val.dtype == torch.int32
                 and x.shape == y.shape == (n,)
                 and all(t.is_contiguous() for t in (x, y, val)),
                 "candidate_lattice takes contiguous float32 x, y and int32 "
                 "val [N]")
    cuda.require(ny > 0 and nx > 0, "candidate_lattice: empty lattice")
    seg = segment_width(ny, nx)
    stride = -(-nx // seg) * seg
    dev = eig.device
    i32 = dict(dtype=torch.int32, device=dev)
    out = Candidates(torch.empty((ny, stride), **i32),
                     torch.empty((ny, stride // seg), **i32),
                     torch.empty((ny, stride // seg), **i32),
                     torch.empty((ny,), **i32), torch.empty((ny,), **i32),
                     nx, seg)
    _launch_lattice(eig, x, y, val, geom, min_eig, radius, out)
    return out


def greedy_extract_reference(cand: torch.Tensor, min_eig: int, dg: int,
                             budget: torch.Tensor, max_out: int):
    """Plain version of the chain: the obvious loop (``argmax`` returns the
    first maximum). Returns (rows, cols, vals) int32 [max_out] (lanes >=
    n_acc are zero) and n_acc int32 [1]."""
    m = cand.clone(memory_format=torch.contiguous_format)
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


def fill_slots(n_acc: torch.Tensor, cand_x: torch.Tensor,
               cand_y: torch.Tensor, cand_val: torch.Tensor,
               free: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               val: torch.Tensor):
    """Assign the r-th accepted candidate to the r-th free slot, in order
    (select_device.py:115-138 of the JAX package; here the accepted
    candidates are the first ``n_acc`` of the chain's output).
    Returns (x, y, val, filled)."""
    k = cand_x.shape[0]
    slot_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    ci = slot_rank.clamp(0, k - 1)
    filled = free & (slot_rank < n_acc)
    new_x = torch.where(free, torch.where(filled, cand_x[ci].to(x.dtype),
                                          -1.0), x)
    new_y = torch.where(free, torch.where(filled, cand_y[ci].to(y.dtype),
                                          -1.0), y)
    new_val = torch.where(free, torch.where(filled, cand_val[ci],
                                            KLT_NOT_FOUND), val)
    return new_x, new_y, new_val, filled


def kept_positions(free: torch.Tensor):
    """The part of a slot fill's plain version (``fill_slots``) that its
    position outputs' gradient depends on: they are ``where(free,
    candidate or -1, x)`` with integer candidates, so their vector-Jacobian
    product is that select's, which this reruns (x, y, val) -> (x, y) with
    the free lanes zero. K4's and K5's backward."""
    def plain(x, y, val):
        return torch.where(free, 0.0, x), torch.where(free, 0.0, y)
    return plain


def _launch_chain(cands, budget, min_eig, dg, max_out, lists, slots, geom,
                  replacing, slots_out):
    global launches
    fn = cuda.function("pft_greedy_chain",
                       [cuda.c_ptr] + [cuda.c_int] * 4 + [cuda.c_ptr] * 6
                       + [cuda.c_int] * 3 + [cuda.c_ptr] * 7
                       + [cuda.c_int] * 5 + [cuda.c_ptr] * 6)
    borderx, bordery, step = geom[:3]
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    x, y, val = slots if slots is not None else (None, None, None)
    cells = cands.cells
    ny, stride = cells.shape
    # device-memory scratch for the box bitmap and, after it, the row
    # maxima, used where they do not fit in shared memory (the C entry
    # decides)
    bits = torch.empty((ny, stride // 32 + 2), dtype=torch.int32,
                       device=cells.device)
    counts = profiling.device_counters(cells.device)
    rc = fn(cells.data_ptr(), ny, cands.nx, cands.seg, stride,
            *(t.data_ptr() for t in cands[1:5]), bits.data_ptr(), ptr(budget),
            min_eig, dg, max_out, *(t.data_ptr() for t in lists), ptr(x),
            ptr(y), ptr(val), 0 if val is None else val.shape[0],
            int(bool(replacing)), borderx, bordery, step,
            *(ptr(t) for t in slots_out), ptr(counts),
            cuda.stream_ptr(cells.device))
    cuda.check(rc, "pft_greedy_chain")
    launches += 1


def _chain_lists(max_out: int, dev):
    return tuple(torch.empty((max_out,), dtype=torch.int32, device=dev)
                 for _ in range(3)) + (
        torch.empty((1,), dtype=torch.int32, device=dev),)


def greedy_fill(cands: Candidates, x: torch.Tensor, y: torch.Tensor,
                val: torch.Tensor, geom, *, min_eig: int, dg: int,
                replacing: bool):
    """Stage B: the greedy chain over stage A's lattice (``dg``: box radius
    in lattice steps) into the feature slots. ``replacing=False``: every
    slot is free; ``replacing=True``: slots with ``val < 0`` are. The
    budget is the number of free slots. Returns (x, y, val, filled); on
    CUDA the kept lanes' positions carry gradients (``kept_positions``)."""
    min_eig = max(int(min_eig), 1)
    free = (val < 0) if replacing else torch.ones_like(val, dtype=torch.bool)
    n = int(val.shape[0])
    if not cuda.use_kernel(cands.cells, x, y, val):
        budget = free.sum().to(torch.int32).reshape(1)
        rr, cc, vv, n_acc = greedy_extract_reference(
            cands.cells[:, :cands.nx], min_eig, int(dg), budget, n)
        borderx, bordery, step = geom[:3]
        return fill_slots(n_acc, (borderx + cc * step).to(torch.int32),
                          (bordery + rr * step).to(torch.int32), vv, free, x,
                          y, val)
    cuda.require(x.dtype == y.dtype == torch.float32 and val.dtype == torch.int32
                 and x.shape == y.shape == (n,)
                 and all(t.is_contiguous() for t in (x, y, val)),
                 "greedy_fill takes contiguous float32 x, y and int32 val [N]")
    cuda.require(dg >= 0, "greedy_fill: dg >= 0")

    def launch(x, y, val):
        out = (torch.empty_like(x), torch.empty_like(y),
               torch.empty_like(val), torch.empty_like(free))
        if n:
            _launch_chain(cands, None, min_eig, int(dg), n,
                          _chain_lists(n, x.device), (x, y, val), geom,
                          replacing, out)
        return out

    return cuda.with_plain_vjp(launch, kept_positions(free), x, y, val)


def select_from_eig(eig: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    val: torch.Tensor, geom, *, min_eig: int, radius: int,
                    dg: int, replacing: bool):
    """The whole (re)selection from the int32 eig map: stage A, then stage
    B. Returns (x, y, val, filled)."""
    cands = candidate_lattice(eig, x, y, val, geom, min_eig=min_eig,
                              radius=radius)
    return greedy_fill(cands, x, y, val, geom, min_eig=min_eig, dg=dg,
                       replacing=replacing)


def greedy_extract(cand: torch.Tensor, *, min_eig: int, dg: int,
                   budget: torch.Tensor, max_out: int):
    """The chain alone on a candidate-lattice map ``cand`` (int32 [ny, nx],
    blocked cells already zeroed). ``dg``: box radius in lattice steps.
    ``budget``: int32 [1] on the map's device (at most ``max_out``
    acceptances are made). Returns (rows, cols, vals) int32 [max_out] in
    acceptance order (lanes >= n_acc zero) and n_acc int32 [1]. On CUDA:
    stage A over the map, then stage B without slots (the map is not
    modified)."""
    min_eig = max(int(min_eig), 1)
    if not cuda.use_kernel(cand, budget):
        return greedy_extract_reference(cand, min_eig, dg, budget, max_out)
    cuda.require(cand.dtype == torch.int32 and cand.dim() == 2
                 and cand.numel() > 0,
                 "greedy_extract takes a non-empty int32 [ny, nx] map")
    cuda.require(budget.dtype == torch.int32 and budget.numel() == 1,
                 "greedy_extract takes an int32 [1] budget")
    cuda.require(dg >= 0 and max_out >= 0, "greedy_extract: dg, max_out >= 0")
    ny, nx = cand.shape
    none = torch.empty((0,), dtype=torch.float32, device=cand.device)
    cands = candidate_lattice(cand.contiguous(), none, none,
                              none.to(torch.int32), (0, 0, 1, ny, nx),
                              min_eig=min_eig, radius=-1)
    lists = _chain_lists(max_out, cand.device)
    _launch_chain(cands, budget.contiguous(), min_eig, int(dg), max_out,
                  lists, None, (0, 0, 1), False, (None,) * 4)
    return lists
