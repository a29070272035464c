"""Readings that set the visual odometry cell's correctness limits
(``limits/kitti_vo2000_drive.json``): the compared numbers of sound runs
and of controls, each the program with one lower-precision lane on, or
with one planted fault.

    python3 benchmark/control_vo.py --workload kitti_vo2000_drive \
        --seeds 11,12 --bf16-seeds 21 --tf32-seeds 31 \
        --unfiltered-seeds 41 --seconds 5

* ``bfloat16``: the configuration's levels stored as bfloat16
  (``image_dtype``), the control of the tracking numbers, as
  ``control.py`` has it for every cell;
* ``tf32``: the program's geometry (pose refinement, triangulation, the
  window BA) with CUDA float32 matrix products run as TF32
  (``torch.backends.cuda.matmul.allow_tf32``), the control of the
  geometry numbers. The program refuses TF32 (``sfm/geometry.
  require_fp32``), so this file switches that refusal off in the
  program's modules for the control's runs, and nowhere else;
* ``unfiltered``: not a precision but a planted fault at the cell's own
  size, the upper reading of ``tri_gap_p99``: every DLT point joins the
  map, whether behind its cameras or far off its own pixels (the
  program's ``VisualOdometry._consistent`` replaced for the run).

Each run is ``control.readings``: the cell's own traffic at its own size
with a short window; all share one process, so the kernel library loads
once. Prints a JSON line a run, then each number's largest sound reading
and smallest reading under each control. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import control
import run

LANES = ("float32", "bfloat16", "tf32", "unfiltered")


@contextlib.contextmanager
def tf32_geometry():
    """The program's SfM modules with TF32 matrix products allowed."""
    import torch
    from pyfeaturetrack_tpu_torch.sfm import ba, epipolar, homography, pnp
    # the modules of the VO's solves that refuse TF32
    mods = (ba, epipolar, homography, pnp)
    saved = [m.require_fp32 for m in mods]
    for m in mods:
        m.require_fp32 = lambda device: None
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        for m, f in zip(mods, saved):
            m.require_fp32 = f


@contextlib.contextmanager
def unfiltered_map():
    """The program's mapping with its filter skipped."""
    import numpy as np
    from pyfeaturetrack_tpu_torch.sfm.vo import VisualOdometry
    saved = VisualOdometry._consistent
    VisualOdometry._consistent = lambda self, X, *a: np.ones(len(X), bool)
    try:
        yield
    finally:
        VisualOdometry._consistent = saved


def readings(parts: dict, seed: int, seconds: float, lane: str) -> dict:
    """``control.readings`` of one run in ``lane``: the levels' dtype
    there, or float32 levels with TF32 geometry or the unfiltered map."""
    if lane in ("float32", "bfloat16"):
        return control.readings(parts, seed, seconds, lane)
    with (tf32_geometry() if lane == "tf32" else unfiltered_map()):
        return {**control.readings(parts, seed, seconds, "float32"),
                "lane": lane}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--bf16-seeds", default="")
    ap.add_argument("--tf32-seeds", default="")
    ap.add_argument("--unfiltered-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    run._paths()
    parts = run.load_cell(args.workload)
    rows = []
    for lane, seeds in zip(LANES, (args.seeds, args.bf16_seeds,
                                   args.tf32_seeds, args.unfiltered_seeds)):
        for s in (int(v) for v in seeds.split(",") if v):
            rows.append(readings(parts, s, args.seconds, lane))
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for k in parts["limits"]:
        got = {lane: [r[k] for r in rows if r["lane"] == lane]
               for lane in LANES}
        summary[k] = {"sound_max": max(got["float32"], default=None),
                      **{f"{lane}_min": min(got[lane], default=None)
                         for lane in LANES[1:]}}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
