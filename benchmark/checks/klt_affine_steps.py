"""Whether the KLT rows and the affine state that the timed path returned
with the affine-consistency check on are right: the comparison with the
plain references (``reference/klt.py`` and ``reference/klt_affine.py``).

The affine stage carries state that a row of (x, y, val) does not hold:
each feature's template and warp. So the mode (``modes/video_warp.py``)
holds the program's ``affine_state()`` at pairs of consecutive chain
boundaries of the window, rows r and r + k, and for each pair the
reference runs the k steps between them. Each step starts from the
program's row t - 1 and from the reference's own affine state, which
starts from the first held one: it tracks, runs the affine stage and
refills, and its row t is compared with the program's as
``checks/klt_steps.py`` compares rows. After the last step the
reference's state is compared with the second held one. The start (the
first frame's selection) is checked on its own.

The numbers compared, each against the limit that the cell's file under
``limits/`` sets:

* ``start_mismatch``, ``step_mismatch``, ``gap_p99_px``: as
  ``checks/klt_steps.py`` computes them, over the pairs' steps;
* ``warp_gap_p99``: the 99th percentile, over the lanes holding a
  template on both sides at a pair's end, of the largest entry of
  ``|A_program - A_reference|``;
* ``template_mismatch``: the share of the pairs' lanes whose template
  flag (``valid``) differs at the pair's end.
"""

from __future__ import annotations

import numpy as np
import torch

from checks.klt_steps import compare_picks, compare_rows
from reference.klt import F64
from reference.klt_affine import AffineReference, Templates

NUMBERS = ("start_mismatch", "step_mismatch", "gap_p99_px", "warp_gap_p99",
           "template_mismatch")


def _held_pairs(held: list) -> list:
    """((row, fields), (row, fields)) of each held pair."""
    return [(held[a], held[a + 1]) for a in range(0, len(held) - 1, 2)]


def check(session, cfg: dict, traffic: dict, seed: int, windows: list,
          device) -> dict:
    """The compared numbers for a session's rows and held states; the
    pairs are the mode's, fixed by the traffic, so ``seed`` and
    ``windows`` draw nothing."""
    del seed, windows
    ref = AffineReference(cfg["klt"], device)
    n = int(cfg["n_features"])
    replace_lost = bool(cfg["replace_lost"])
    frames = session.frames
    rows = session.rows

    def frame(r):
        j = session.frame_index(r)
        return j, frames[j]

    start_bad = compare_picks(ref.start(*frame(0), n), rows.row(0))
    lanes = bad = 0
    gaps, warps = [], []
    flags = flag_bad = 0
    pairs = _held_pairs(session.held)
    for (r0, first), (r1, last) in pairs:
        st = Templates(first["img"].to(device, F64),
                       first["A"].to(device, F64), first["valid"].to(device))
        for t in range(r0 + 1, r1 + 1):
            x, y, val = rows.row(t - 1)
            out, st = ref.affine_step(
                *frame(t - 1), *frame(t), np.asarray(x, np.float64),
                np.asarray(y, np.float64), np.asarray(val, np.int64), st,
                replace_lost=replace_lost)
            c = compare_rows(out, rows.row(t))
            lanes += c["lanes"]
            bad += c["bad"]
            gaps.append(c["gaps"])
        got_valid = last["valid"].cpu().numpy()
        ref_valid = st.valid.cpu().numpy()
        flags += got_valid.size
        flag_bad += int((got_valid != ref_valid).sum())
        both = got_valid & ref_valid
        diff = (last["A"].to(F64).cpu() - st.A.cpu()).abs().reshape(-1, 4)
        warps.append(diff.max(1).values.numpy()[both])
    gaps = np.concatenate(gaps) if gaps else np.zeros(0)
    warps = np.concatenate(warps) if warps else np.zeros(0)
    return {
        "start_mismatch": start_bad / max(n, 1),
        "step_mismatch": bad / max(lanes, 1) if pairs else 1.0,
        "gap_p99_px": float(np.quantile(gaps, 0.99)) if gaps.size else 0.0,
        "warp_gap_p99": float(np.quantile(warps, 0.99)) if warps.size else 0.0,
        "template_mismatch": flag_bad / max(flags, 1) if pairs else 1.0,
        "pairs": len(pairs), "lanes": lanes, "tracked_lanes": int(gaps.size),
        "template_lanes": int(warps.size),
    }
