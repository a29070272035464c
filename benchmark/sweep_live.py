"""The sweep that sets a lockstep cell's number of streams: the cell's
traffic at several stream counts B, one window each, in one process.

    python3 benchmark/sweep_live.py --workload vga1000_live30hz \
        --streams 26,28,30,32,34,36 --seed <n> --seconds 20

For each B it prints the p95 and p50 latency, the mean latency of the
window's first and last thirds (a backlog that grows shows as a last
third above the first) and how late the generator ran. The port sustains
B when p95 stays under one tick (1000 / rate_hz ms); the knee is the
largest B sustained on every seed swept (two or more). The knee moves
with the machine's host, so the cell takes about four fifths of the
lowest knee found. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    run._paths()
    import pyfeaturetrack_tpu_torch as pft
    import scene
    base = run.load_cell(args.workload)
    for b in (int(v) for v in args.streams.split(",")):
        parts = copy.deepcopy(base)
        traffic, config = parts["traffic"], parts["config"]
        traffic["streams"] = b
        h, w = config["frame"]["height"], config["frame"]["width"]
        frames = scene.render_streams(args.seed, b, traffic, h, w, "cuda")
        session = run.load("modes", traffic["mode"]).Session(
            pft, run.tracker_config(pft, config), config, frames, traffic,
            "cuda")
        session.setup()
        win = session.window(args.seconds)
        lat = np.asarray(win["latency_ms"])
        third = len(lat) // 3
        spans = session.spans
        out = {"streams": b, "ticks": len(lat),
               "p95_ms": float(np.percentile(lat, 95)),
               "p50_ms": float(np.percentile(lat, 50)),
               "first_third_ms": float(lat[:third].mean()),
               "last_third_ms": float(lat[-third:].mean()),
               "late_p95_ms": float(np.percentile(win["late_ms"], 95)),
               "feed_ms": spans.total_ns("feed") / spans.count("feed") / 1e6,
               "drain_ms": spans.total_ns("drain") / spans.count("drain") / 1e6,
               "tick_ms": 1e3 / float(traffic["rate_hz"])}
        out["sustained"] = out["p95_ms"] < out["tick_ms"]
        print(json.dumps(out), flush=True)
        session.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
