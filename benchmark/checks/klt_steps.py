"""Whether the KLT rows the timed path returned are right: the comparison
with the plain reference (``reference/klt.py``). A traffic file names its
check (``"check": "klt_steps"``) and the run finds it as
``checks/<check>.py``; ``check`` returns the numbers that the cell's
``limits/<cell>.json`` bounds.

A frame's answer is the row of (x, y, val) that a drain returned for it.
Tracking is a recurrence, so the reference follows the program step by
step: for a sampled row t it takes the program's row t - 1 as the state,
rebuilds both frames' pyramids and the selection map from the frames
themselves, tracks and refills, and compares its row t with the
program's. The start (the first frame's selection, which no step covers)
is checked on its own, for every stream. Rows are sampled from the seed
once the window has closed.

Per lane: a lane the reference tracked matches when the program tracked
it within ``TRACK_TOL_PX``; a lost lane matches when the status code is
the same; fresh picks (the start, and each step's refills) match as sets
of pixels (``compare_picks``). The numbers compared, each against the limit
that the cell's file under ``limits/`` sets, are:

* ``start_mismatch``: share of the first frame's slots, over every
  stream, whose pick only one side made;
* ``step_mismatch``: share of the sampled steps' lanes that do not match;
* ``gap_p99_px``: the 99th percentile of the position gap over lanes both
  sides tracked.
"""

from __future__ import annotations

import numpy as np

from reference.klt import Reference

# px: two float32 solutions of one track lie about 1e-4 px apart; a
# track from levels stored in bfloat16 lands 1e-2 px or more away
TRACK_TOL_PX = 0.01
# rows whose step the reference repeats, drawn from the seed: each costs a
# float64 track and refill, well under a second at 4096 features
CHECK_STEPS = 16
NUMBERS = ("start_mismatch", "step_mismatch", "gap_p99_px")


def _picks(x, y, v) -> set:
    """Pixels of the slots holding a freshly selected feature (value > 0)."""
    keep = np.asarray(v) > 0
    return set(zip(np.asarray(x)[keep].tolist(), np.asarray(y)[keep].tolist()))


def compare_picks(ref, got) -> int:
    """Picks only one side made: a selection's r-th pick fills the r-th
    free slot, so one candidate taken or suppressed differently shifts
    every later pick to another slot, and slot by slot one rounding of the
    map would read as a mismatch of all the picks that follow it."""
    want, have = _picks(*ref), _picks(*got)
    return max(len(want), len(have)) - len(want & have)


def compare_rows(ref, got) -> dict:
    """Lane counts of one row: (lanes, mismatched, gaps of lanes both
    tracked). Tracked and lost lanes are compared slot by slot, refills
    as sets of picks (``compare_picks``)."""
    rx, ry, rv = ref
    gx, gy, gv = (np.asarray(c, np.float64) for c in got)
    gv = gv.astype(np.int64)
    tracked = rv == 0
    gap = np.hypot(gx - rx, gy - ry)
    both = tracked & (gv == 0)
    bad = int((tracked & ~(both & (gap <= TRACK_TOL_PX))).sum())
    bad += int(((rv < 0) & (gv != rv)).sum())
    bad += compare_picks(ref, (gx, gy, gv))
    return {"lanes": int(rv.size), "bad": bad, "gaps": gap[both]}


def check(session, cfg: dict, traffic: dict, seed: int, windows: list,
          device) -> dict:
    """The compared numbers for a session's rows: ``windows`` holds
    (first row, rows) of each measured stretch."""
    ref = Reference(cfg["klt"], device)
    streams = int(traffic.get("streams", 1))
    n = int(cfg["n_features"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11]))
    frames = session.frames

    def frame(r, s):
        j = session.frame_index(r)
        return (j, s), (frames[j] if streams == 1 else frames[j, s])

    def lane(row, s):
        return row if streams == 1 else tuple(c[s] for c in row)

    start_lanes = start_bad = 0
    for s in range(streams):
        key, f = frame(0, s)
        got = lane(session.rows.row(0), s)
        start_lanes += n
        start_bad += compare_picks(ref.start(key, f, n), got)

    pool = np.concatenate([np.arange(max(first, 1), first + rows)
                           for first, rows in windows])
    picks = sorted(rng.choice(pool, size=min(CHECK_STEPS, len(pool)),
                              replace=False).tolist())
    lanes = bad = 0
    gaps = []
    for r in picks:
        s = int(rng.integers(streams))
        kp, fp = frame(r - 1, s)
        kn, fn = frame(r, s)
        prev = lane(session.rows.row(r - 1), s)
        out = ref.step(kp, fp, kn, fn, np.asarray(prev[0], np.float64),
                       np.asarray(prev[1], np.float64),
                       np.asarray(prev[2], np.int64),
                       replace_lost=bool(cfg["replace_lost"]))
        c = compare_rows(out, lane(session.rows.row(r), s))
        lanes += c["lanes"]
        bad += c["bad"]
        gaps.append(c["gaps"])
    gaps = np.concatenate(gaps) if gaps else np.zeros(0)
    return {
        "start_mismatch": start_bad / max(start_lanes, 1),
        "step_mismatch": bad / max(lanes, 1),
        "gap_p99_px": float(np.quantile(gaps, 0.99)) if gaps.size else 0.0,
        "steps": len(picks), "lanes": lanes, "tracked_lanes": int(gaps.size),
    }
