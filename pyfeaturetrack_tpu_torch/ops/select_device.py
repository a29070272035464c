"""Device-resident feature selection / lost-feature replacement.

Reference parity: selectGoodFeatures.py -> _KLTSelectGoodFeatures +
_enforceMinimumDistance; port of ``pyfeaturetrack_tpu/ops/select_device.py``.

One route for both uses, K4 (``ops/cuda_select.select_from_eig``): stage A
builds the candidate lattice from the eig map (kept features pre-mask
their mindist boxes on a refill), stage B scans the FULL candidate pool in
the host greedy's order and writes the acceptances into the free slots,
so the result is the host greedy's exactly and never "exhausted":

* initial selection: every slot free, no pre-mask, budget = n_features;
* refill: free slots are ``val < 0``, kept features pre-mask their
  mindist box, budget = number of free slots (counted on the device).

The JAX package's initial selection runs a top-K + maximal-independent-set
fixpoint instead; greedy is prefix-stable, so the two agree whenever that
pass is not exhausted. ``top_k`` stays in the signatures so callers match
and is not used. ``candidate_map`` is the pre-mask as the JAX package
builds it (stamp, dilate, sample the lattice), the reference the tests
hold stage A against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..features import KLT_NOT_FOUND
from .cuda_select import fill_slots, select_from_eig  # noqa: F401

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
