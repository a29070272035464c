"""Device-resident feature selection / lost-feature replacement.

Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures +
_enforceMinimumDistance; port of ``pyfeaturetrack_tpu/ops/select_device.py``.

One route for both uses: K4 (ops/cuda_select.greedy_extract) scans the
FULL candidate pool in the host greedy's order, so its result is the host
greedy's exactly and never "exhausted":

* initial selection: every slot free, no pre-mask, budget = n_features;
* refill: free slots are ``val < 0``, kept features pre-mask their
  mindist box, budget = number of free slots (read on the device).

The JAX package's initial selection runs a top-K + maximal-independent-set
fixpoint instead; greedy is prefix-stable, so the two agree whenever that
pass is not exhausted. ``top_k`` stays in the signatures so callers match
and is not used.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..features import KLT_NOT_FOUND
from .cuda_select import greedy_extract

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


def fill_slots(n_acc: torch.Tensor, cand_x: torch.Tensor,
               cand_y: torch.Tensor, cand_val: torch.Tensor,
               free: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               val: torch.Tensor):
    """Assign the r-th accepted candidate to the r-th free slot, in order
    (select_device.py:115-138 of the JAX package; here the accepted
    candidates are the first ``n_acc`` of the extraction's output).
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
    borderx, bordery, step, ny, nx = _candidate_grid(cfg, eig.shape)
    not_exhausted = torch.zeros((), dtype=torch.bool, device=eig.device)
    cand, free = candidate_map(eig, x, y, val, cfg, replacing=replacing)
    if cand is None:
        # no room for features: every free slot comes back empty
        return (torch.where(free, -1.0, x), torch.where(free, -1.0, y),
                torch.where(free, KLT_NOT_FOUND, val),
                torch.zeros_like(free), not_exhausted)

    n_out = int(val.shape[0])
    rr, cc, vv, n_acc = greedy_extract(
        cand, min_eig=max(int(cfg.min_eigenvalue), 1),
        dg=max(0, (int(cfg.mindist) - 1) // step),
        budget=free.sum().to(torch.int32).reshape(1), max_out=n_out)
    cand_x = (borderx + cc * step).to(torch.int32)
    cand_y = (bordery + rr * step).to(torch.int32)
    nxx, nyy, nval, filled = fill_slots(n_acc, cand_x, cand_y, vv, free, x,
                                        y, val)
    return nxx, nyy, nval, filled, not_exhausted


def candidate_map(eig: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  val: torch.Tensor, cfg, *, replacing: bool):
    """K4's input: the int32 candidate-lattice map (None when the lattice
    is empty) and the free-slot mask. Refills zero the candidates inside
    the kept features' mindist boxes; candidates below the bar are 0."""
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
