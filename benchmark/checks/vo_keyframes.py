"""Whether the keyframes the visual odometry computed on the timed path are
right: the comparison with the plain references (``reference/klt.py`` for
the tracking, ``reference/vo.py`` for the geometry, both float64).

The mode (``modes/vo_drive.py``) holds the program's own
``keyframe_record()`` at keyframes spread over the window. Each held
keyframe gives:

* one frame step of its keyframe interval, drawn from the seed: the
  reference tracks and refills from the program's row t - 1 (the state
  before the interval, or the interval's row before) and its row t is
  compared with the program's, as ``checks/klt_steps.py`` compares rows;
* the motion-only refinement: the reference's Huber Gauss-Newton from the
  same start on the same landmarks and pixels;
* the batched DLT: the reference's points from the same pixels, masks and
  poses;
* the window BA: the reference's damped Gauss-Newton on the full normal
  equations from the same problem and start.

The numbers compared, each against the limit that the cell's file under
``limits/`` sets:

* ``step_mismatch``, ``gap_p99_px``: as ``checks/klt_steps.py`` computes
  them, over the sampled steps;
* ``pose_gap_p99``: over the held keyframes, the larger of the refined
  pose's rotation gap (radians) and its centre's gap over the window's
  baseline (the distance between the BA window's first and last centres
  at the start of its BA);
* ``tri_gap_p99``: the 99th percentile, over the DLT points that either
  side lets into the map, of the distance between the program's point
  and the reference's over the reference point's distance from the
  newest camera; a point only one side lets in (the program's ``kept``
  against the reference point's own test: in front of every observing
  camera by 1e-3, and reprojected within the record's ``gate_px`` of
  each of its pixels) counts as a gap of ``FLIPPED``;
* ``ba_gap_p99``: the largest, over the held keyframes, of each window
  BA's gap: the largest of its landmarks' 99th percentile (gaps measured
  as for ``tri_gap_p99``), its cameras' largest rotation gap and their
  largest centre gap over the baseline (the median over the windows is
  reported beside it, ``ba_gap_median``);
* ``ate_pct_travel``: the largest, over the completed drives, of the
  keyframe centres' error after a similarity alignment to the ground
  truth (``reference/vo.ate_aligned``) as a percentage of the drive's
  travel between its keyframes: a bound on the sanity of the whole loop,
  not a comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from checks.klt_steps import compare_rows
from reference import vo as rvo
from reference.klt import Reference

# the gap of a DLT point only one side lets into the map: as far off as
# the point is from the camera
FLIPPED = 1.0
NUMBERS = ("step_mismatch", "gap_p99_px", "pose_gap_p99", "tri_gap_p99",
           "ba_gap_p99", "ate_pct_travel")


def _finite(x: float) -> float:
    """``x``, or inf where it is not a number: a gap that NaN reaches is a
    failed comparison."""
    x = float(x)
    return x if np.isfinite(x) else float("inf")


def _p99(vals: list) -> float:
    v = np.concatenate([np.atleast_1d(a) for a in vals]) if vals else \
        np.zeros(0)
    if not v.size:
        return 0.0
    return float(np.quantile(v, 0.99)) if np.isfinite(v).all() else \
        float("inf")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _baseline(ba: dict, device) -> float:
    c = rvo.centres(rvo.t64(ba["R0"], device), rvo.t64(ba["t0"], device))
    return float(torch.linalg.vector_norm(c[-1] - c[0]))


def _point_gaps(got, want: torch.Tensor, centre: torch.Tensor):
    """|got - want| over want's distance from ``centre``, per point."""
    got = rvo.t64(got, want.device)
    dist = torch.linalg.vector_norm(want - centre, dim=-1)
    gap = torch.linalg.vector_norm(got - want, dim=-1)
    return (gap / torch.clamp(dist, min=1e-12)).cpu().numpy()


def _triangulation_gaps(tr: dict, device) -> np.ndarray:
    """Per DLT candidate that either side lets into the map: the point's
    gap (``_point_gaps``) where both do, ``FLIPPED`` where only one does
    (the reference's point in front of every observing camera by 1e-3
    and within the record's ``gate_px`` of each of its pixels, against
    the program's ``kept``)."""
    X = rvo.triangulate_dlt(tr["K"], tr["Rs"], tr["ts"], tr["uvs"],
                            tr["mask"], device=device)
    Rs, ts = rvo.t64(tr["Rs"], device), rvo.t64(tr["ts"], device)
    ref = rvo.consistent(tr["K"], Rs, ts, tr["uvs"], tr["mask"], X,
                         float(tr["gate_px"])).cpu().numpy()
    got = np.asarray(tr["kept"], bool)
    gaps = _point_gaps(tr["X"], X, rvo.centres(Rs[-1], ts[-1]))
    gaps[ref != got] = FLIPPED
    return gaps[ref | got]


def step_rows(rec: dict, j: int):
    """(row t - 1, row t) of step j of the keyframe's interval, host
    numpy."""
    hx, hy, hv = (_host(h) for h in rec["track"]["history"])
    if j == 0:
        prev = tuple(_host(c) for c in rec["track"]["start"])
    else:
        prev = (hx[j - 1], hy[j - 1], hv[j - 1])
    return prev, (hx[j], hy[j], hv[j])


def check(session, cfg: dict, traffic: dict, seed: int, windows: list,
          device) -> dict:
    """The compared numbers for a session's held keyframes and completed
    drives; ``windows`` draws nothing (the holds are the mode's)."""
    del windows
    rvo.fp64()
    klt = Reference(cfg["klt"], device)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 26]))
    frames = session.frames
    lanes = bad = 0
    gaps, poses, tri, bas = [], [], [], []
    for f, rec in session.held:
        k = rec["track"]["history"][0].shape[0]
        j = int(rng.integers(k))
        t = f - k + 1 + j
        (px, py, pv), got = step_rows(rec, j)
        out = klt.step(t - 1, frames[t - 1], t, frames[t],
                       np.asarray(px, np.float64), np.asarray(py, np.float64),
                       np.asarray(pv, np.int64), replace_lost=True)
        c = compare_rows(out, got)
        lanes += c["lanes"]
        bad += c["bad"]
        gaps.append(c["gaps"])

        base = _baseline(rec["ba"], device)
        loc = rec["localize"]
        R, tt = rvo.refine_pose(loc["K"], loc["R0"], loc["t0"], loc["X"],
                                loc["uv"], loc["w"], loc["n_iters"],
                                loc["huber_delta"], device=device)
        Rg, tg = rvo.t64(loc["R"], device), rvo.t64(loc["t"], device)
        poses.append(max(
            _finite(rvo.rotation_gap(Rg, R)),
            _finite(torch.linalg.vector_norm(rvo.centres(Rg, tg)
                                             - rvo.centres(R, tt)) / base)))

        if "triangulate" in rec:
            tri.append(_triangulation_gaps(rec["triangulate"], device))

        ba = rec["ba"]
        p = ba["problem"]
        R, tt, X = rvo.bundle_adjust(p.K, p.cam_idx, p.pt_idx, p.uv, p.w,
                                     ba["R0"], ba["t0"], ba["X0"],
                                     ba["n_iters"], ba["huber_delta"],
                                     device=device)
        Rg, tg = rvo.t64(ba["R"], device), rvo.t64(ba["t"], device)
        cg, cr = rvo.centres(Rg, tg), rvo.centres(R, tt)
        bas.append(max(
            _p99([_point_gaps(ba["X"], X, cr[-1])]),
            _finite(rvo.rotation_gap(Rg, R).max()),
            _finite(torch.linalg.vector_norm(cg - cr, dim=-1).max() / base)))

    ate = 0.0
    for fi, c in session.drives:
        if fi is None:
            ate = float("inf")
            continue
        gt = session.centres[fi]
        travel = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
        ate = max(ate, 100.0 * rvo.ate_aligned(c, gt) / max(travel, 1e-12))
    held = len(session.held)
    return {
        "step_mismatch": bad / max(lanes, 1) if held else 1.0,
        "gap_p99_px": _p99(gaps),
        "pose_gap_p99": _p99(poses) if held else float("inf"),
        "tri_gap_p99": _p99(tri),
        "ba_gap_p99": max(bas) if held else float("inf"),
        "ate_pct_travel": ate if session.drives else float("inf"),
        "keyframes_held": held, "lanes": lanes,
        "tracked_lanes": int(sum(g.size for g in gaps)),
        "tri_points": int(sum(a.size for a in tri)),
        "ba_gap_median": float(np.median(bas)) if held else 0.0,
        "drives": len(session.drives),
    }
