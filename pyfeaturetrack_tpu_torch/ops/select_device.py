"""Device-resident feature selection / lost-feature replacement.

Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures +
_enforceMinimumDistance; port of ``pyfeaturetrack_tpu/ops/select_device.py``.

One route for both uses, K4 (``ops/cuda_select.select_from_eig``): stage A
builds the candidate lattice from the eig map (kept features pre-mask
their mindist boxes on a refill), stage B scans the FULL candidate pool in
the host greedy's order and writes the acceptances into the free slots,
so the result is the host greedy's exactly and never "exhausted"
(``select_features_device`` from an image, ``replace_lost_device`` the
same callable, ``select_features_from_eig_device`` from a map):

* initial selection: every slot free, no pre-mask, budget = n_features;
* refill: free slots are ``val < 0``, kept features pre-mask their
  mindist box, budget = number of free slots (counted on the device).

The JAX package's initial selection runs a top-K + maximal-independent-set
fixpoint instead; greedy is prefix-stable, so the two agree whenever that
pass is not exhausted. ``top_k`` stays in the signatures so callers match
and is not used. ``candidate_map`` is the pre-mask as the JAX package
builds it (stamp, dilate, sample the lattice), the reference the tests
hold stage A against.

``suppress_and_fill`` and ``fill_slots`` are the JAX module's op-level
pair over priority-ordered candidates: K5's scan (``cuda_suppress.
greedy_suppress``), which accepts the set of JAX's maximal-independent-set
fixpoint, then the slot fill.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..features import KLT_NOT_FOUND
from ..utils.profiling import host_sync
from . import cuda_select
from .cuda_select import select_from_eig
from .cuda_suppress import greedy_suppress

# Signature compatibility with the JAX package (unused: the extraction
# scans every candidate).
DEFAULT_TOP_K = 4096


def _dilate_chebyshev(occ: torch.Tensor, radius: int) -> torch.Tensor:
    """Box (Chebyshev-ball) dilation of a boolean occupancy map."""
    if radius <= 0:
        return occ
    w = 2 * radius + 1
    return F.max_pool2d(occ.to(torch.float32)[None, None], w, stride=1,
                        padding=radius)[0, 0] > 0


def _candidate_grid(cfg, shape):
    """Static candidate-lattice geometry (borders + nSkippedPixels)."""
    nrows, ncols = shape
    window_hw = max(cfg.window_width // 2, 1)
    window_hh = max(cfg.window_height // 2, 1)
    borderx = max(cfg.borderx, window_hw)
    bordery = max(cfg.bordery, window_hh)
    step = cfg.nSkippedPixels + 1
    ny = len(range(bordery, nrows - bordery, step))
    nx = len(range(borderx, ncols - borderx, step))
    return borderx, bordery, step, ny, nx


def select_features_from_eig_device(eig: torch.Tensor, x: torch.Tensor,
                                    y: torch.Tensor, val: torch.Tensor, cfg,
                                    *, replacing: bool,
                                    top_k: int = DEFAULT_TOP_K):
    """(Re)selection into the (x, y, val) feature arrays from an int32
    min-eig map. ``replacing=False``: overwrite every slot
    (KLTSelectGoodFeatures); ``replacing=True``: keep val >= 0 slots and
    refill the rest (KLTReplaceLostFeatures).

    Returns (x, y, val, filled, exhausted); ``exhausted`` is always False
    (the extraction scans every candidate)."""
    del top_k
    geom = _candidate_grid(cfg, eig.shape)
    not_exhausted = torch.zeros((), dtype=torch.bool, device=eig.device)
    if geom[3] == 0 or geom[4] == 0:
        # no room for features: every free slot comes back empty
        free = (val < 0) if replacing else torch.ones_like(val,
                                                           dtype=torch.bool)
        return (torch.where(free, -1.0, x), torch.where(free, -1.0, y),
                torch.where(free, KLT_NOT_FOUND, val),
                torch.zeros_like(free), not_exhausted)
    nxx, nyy, nval, filled = select_from_eig(
        eig, x, y, val, geom, min_eig=max(int(cfg.min_eigenvalue), 1),
        radius=premask_radius(cfg, replacing),
        dg=max(0, (int(cfg.mindist) - 1) // geom[2]), replacing=replacing)
    return nxx, nyy, nval, filled, not_exhausted


def premask_radius(cfg, replacing: bool) -> int:
    """Chebyshev radius of the kept features' pre-mask: mindist - 1 on a
    refill with mindist >= 1, else -1 (none). mindist == 0 suppresses
    nothing in the host greedy (the decremented radius makes its box
    empty), so no pre-mask there."""
    return int(cfg.mindist) - 1 if replacing and int(cfg.mindist) >= 1 else -1


def candidate_map(eig: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  val: torch.Tensor, cfg, *, replacing: bool):
    """The int32 candidate-lattice map as the JAX package builds it (None
    when the lattice is empty) and the free-slot mask: refills stamp the
    kept features into an occupancy map, dilate it by the mindist radius
    and zero the lattice cells inside; candidates below the bar are 0.
    Stage A of K4 (``cuda_select.candidate_lattice``) computes the same
    lattice without the full-frame dilation."""
    nrows, ncols = eig.shape
    borderx, bordery, step, ny, nx = _candidate_grid(cfg, eig.shape)
    min_eig = max(int(cfg.min_eigenvalue), 1)
    free = (val < 0) if replacing else torch.ones_like(val, dtype=torch.bool)
    if ny == 0 or nx == 0:
        return None, free

    cand = eig[bordery:nrows - bordery:step, borderx:ncols - borderx:step]
    cand = cand[:ny, :nx]
    if replacing and int(cfg.mindist) >= 1:
        # Stamp kept features into an occupancy map and dilate it by the
        # mindist radius: candidates inside can never be accepted.
        # mindist == 0 suppresses nothing in the host greedy (the
        # decremented radius makes its box empty), so no pre-mask there.
        keep = ~free
        xi = x.to(torch.int32).clamp(0, ncols - 1).to(torch.int64)
        yi = y.to(torch.int32).clamp(0, nrows - 1).to(torch.int64)
        occ = torch.zeros(nrows * ncols, dtype=torch.int32, device=eig.device)
        occ.index_put_((yi * ncols + xi,), keep.to(torch.int32),
                       accumulate=True)
        blocked = _dilate_chebyshev(occ.view(nrows, ncols) > 0,
                                    int(cfg.mindist) - 1)
        cand_blocked = blocked[bordery:nrows - bordery:step,
                               borderx:ncols - borderx:step][:ny, :nx]
        cand = torch.where(cand_blocked, 0, cand)
    # candidates below the bar count as 0 (< min_eig >= 1)
    return torch.where(cand < min_eig, 0, cand).contiguous(), free


def select_features_device(img, x: torch.Tensor, y: torch.Tensor,
                           val: torch.Tensor, cfg, *, replacing: bool,
                           top_k: int = DEFAULT_TOP_K):
    """(Re)selection from an image into the (x, y, val) feature arrays:
    the eig map of ``selection_eig_map_core`` (K1's eig-only level-0
    launch), then ``select_features_from_eig_device`` (K4, stages A and
    B). ``replacing=False``: overwrite every slot (KLTSelectGoodFeatures);
    ``replacing=True``: keep val >= 0 slots and refill the rest
    (KLTReplaceLostFeatures). The image goes to the feature arrays'
    device. Returns (x, y, val, filled, exhausted); ``exhausted`` is always
    False (the extraction scans every candidate)."""
    # ops/select.py imports this module
    from .select import selection_eig_map_core
    from .track import as_frame
    eig = selection_eig_map_core(
        as_frame(img, x.device), window_width=int(cfg.window_width),
        window_height=int(cfg.window_height),
        smooth_before=bool(cfg.smoothBeforeSelecting),
        smooth_sigma=float(cfg.smooth_sigma),
        grad_sigma=float(cfg.grad_sigma))
    return select_features_from_eig_device(eig, x, y, val, cfg,
                                           replacing=replacing, top_k=top_k)


# The JAX package's jitted form of the same function (the port has no jit).
replace_lost_device = select_features_device


def fill_slots(accepted: torch.Tensor, cand_x: torch.Tensor,
               cand_y: torch.Tensor, cand_val: torch.Tensor,
               free: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               val: torch.Tensor):
    """Assign the r-th accepted candidate (bool [K] ``accepted``, priority
    order) to the r-th free slot, in order; the other free slots become
    (-1, -1, KLT_NOT_FOUND). Returns (x, y, val, filled, exhausted):
    ``exhausted`` is True when free slots were left unfilled. The accepted
    lanes are ranked on the device (no host read), then
    ``cuda_select.fill_slots`` places them."""
    k = cand_x.shape[0]
    if k == 0:
        return _none_accepted(free, x, y, val)
    rank = torch.cumsum(accepted.to(torch.int64), 0) - 1
    # candidate index of each acceptance rank; ranks past the last are k
    # (dropped with the extra slot)
    first = torch.full((k + 1,), k, dtype=torch.int64, device=cand_x.device)
    first.scatter_(0, torch.where(accepted, rank, k),
                   torch.arange(k, dtype=torch.int64, device=cand_x.device))
    idx = first[:k].clamp(max=k - 1)
    n_acc = accepted.sum()
    nx, ny, nval, filled = cuda_select.fill_slots(
        n_acc, cand_x[idx], cand_y[idx], cand_val[idx], free, x, y, val)
    return nx, ny, nval, filled, (free & ~filled).any()


def _none_accepted(free, x, y, val):
    """``fill_slots`` with no candidate: every free slot comes back empty."""
    return (torch.where(free, -1.0, x), torch.where(free, -1.0, y),
            torch.where(free, KLT_NOT_FOUND, val), torch.zeros_like(free),
            free.any())


def _bounding_frame(cand_x, cand_y, valid):
    """(origin x, origin y, (rows, cols)) of the valid candidates' bounding
    box (two host reads: ``host_syncs``); a 1 x 1 frame when none is
    valid."""
    host_sync("sync.bounding_frame")
    if not bool(valid.any()):
        return 0, 0, (1, 1)
    big = torch.iinfo(torch.int32).max
    xs, ys = cand_x.to(torch.int64), cand_y.to(torch.int64)
    host_sync("sync.bounding_frame")
    box = torch.stack([torch.where(valid, xs, big).min(),
                       torch.where(valid, ys, big).min(),
                       torch.where(valid, xs, -big).max(),
                       torch.where(valid, ys, -big).max()]).tolist()
    x0, y0, x1, y1 = box
    return x0, y0, (y1 - y0 + 1, x1 - x0 + 1)


def suppress_and_fill(cand_x: torch.Tensor, cand_y: torch.Tensor,
                      cand_val: torch.Tensor, valid: torch.Tensor,
                      free: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      val: torch.Tensor, mindist: int):
    """Greedy mindist suppression over priority-ordered candidates, then
    the slot fill (select_device.py:81-112 of the JAX package).

    ``cand_*`` [K]: integer pixel coordinates and values in priority order
    (``valid[i]`` False lanes are pre-rejected); ``free`` bool [N]: the
    output slots to fill. A candidate is accepted when no accepted
    candidate of higher priority lies within ``mindist - 1`` pixels
    (Chebyshev): the set JAX's fixpoint accepts. K5's scan
    (``cuda_suppress.greedy_suppress``, one launch on CUDA tensors, its
    plain version on CPU tensors) runs over the valid candidates' bounding
    box as its frame (one host read) and stops once every free slot has a
    candidate, which leaves the fill unchanged. Returns (x, y, val,
    filled, exhausted) as ``fill_slots``."""
    if cand_x.shape[0] == 0:
        return _none_accepted(free, x, y, val)
    cx, cy = cand_x.to(torch.int32), cand_y.to(torch.int32)
    x0, y0, shape = _bounding_frame(cx, cy, valid)
    _, order, n_acc = greedy_suppress(
        (cx - x0).contiguous(), (cy - y0).contiguous(),
        valid.to(torch.bool).contiguous(), shape=shape, mindist=int(mindist),
        budget=free.sum().to(torch.int32).reshape(1),
        max_out=int(free.shape[0]))
    idx = order.to(torch.int64)
    nx, ny, nval, filled = cuda_select.fill_slots(
        n_acc, cand_x[idx], cand_y[idx], cand_val[idx], free, x, y, val)
    return nx, ny, nval, filled, (free & ~filled).any()
