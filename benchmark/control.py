"""Readings that set a cell's correctness limits (``limits/<cell>.json``):
the compared numbers of sound runs of the program and of the control.

    python3 benchmark/control.py --workload <cell> --seeds 11,12 \
        --control-seeds 21,22,23 --seconds 2

The control is the program with its own lower-precision lane switched
on: the configuration's levels stored as bfloat16 (``image_dtype``) where
it states float32. Each run is the cell's own traffic at its own size,
with a short window and as many checked steps as a benchmark run; all of
them share one process, so the kernel library loads once. Prints a JSON
line a run, then a summary line: each number's largest sound reading and
smallest control reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import run


def readings(parts: dict, seed: int, seconds: float, lane: str) -> dict:
    parts = copy.deepcopy(parts)
    parts["config"]["klt"]["image_dtype"] = lane
    parts["limits"] = {k: float("inf") for k in parts["limits"]}
    out = run.run(parts, seed, seconds, False, "cuda", time.perf_counter())
    return {"seed": seed, "lane": lane, "correct_path": out["correct"],
            **{k: v["value"] for k, v in out["checks"].items()},
            **out["checked"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    run._paths()
    parts = run.load_cell(args.workload)
    rows = []
    for lane, seeds in (("float32", args.seeds), ("bfloat16",
                                                   args.control_seeds)):
        for s in (int(v) for v in seeds.split(",") if v):
            rows.append(readings(parts, s, args.seconds, lane))
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for k in parts["limits"]:
        sound = [r[k] for r in rows if r["lane"] == "float32"]
        ctrl = [r[k] for r in rows if r["lane"] == "bfloat16"]
        summary[k] = {"sound_max": max(sound) if sound else None,
                      "control_min": min(ctrl) if ctrl else None}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
