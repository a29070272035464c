"""Track runs of a feature table (PyTorch port of the part of
``pyfeaturetrack_tpu/sfm/ba_windowed.py`` that the dense pipeline uses).

The windowed (banded) bundle adjustment itself, with
``pipeline.run_sfm_windowed``, is the next slice of the port (ROADMAP
Queue 1): its entry points exist under the JAX package's names and raise
NotImplementedError; only ``column_runs`` runs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .geometry import to_host


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


class WindowedBAProblem(NamedTuple):
    """K-windowed observation set (the JAX package's layout): K [3,3];
    c0 [L] first camera of each landmark's window; uv [L, Kw, 2] pixels
    at camera c0[l]+k; w [L, Kw] weights (0 pads)."""
    K: torch.Tensor
    c0: torch.Tensor
    uv: torch.Tensor
    w: torch.Tensor


def _next_slice(name: str):
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the windowed bundle adjustment is the next slice of "
            "the port (ROADMAP Queue 1); use sfm.bundle_adjust / run_sfm")
    missing.__name__ = name
    missing.__doc__ = (f"``{name}`` of the JAX package's windowed BA: not "
                       "in the port yet (raises NotImplementedError).")
    return missing


windowed_from_feature_table = _next_slice("windowed_from_feature_table")
triangulate_windowed = _next_slice("triangulate_windowed")
bundle_adjust_windowed = _next_slice("bundle_adjust_windowed")
pad_windowed_for_mesh = _next_slice("pad_windowed_for_mesh")
