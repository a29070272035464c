"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root
of the checkout. Its parts are found by name:

* ``configs/<config>.json``: the deployment (frame size, features, the
  KLT context);
* ``traffic/<traffic>.json``: the traffic's parameters, read by the one
  generator (``scene.py``); its ``mode`` names the loop that drives the
  program (``modes/<mode>.py``) and its ``check`` the comparison with the
  plain reference (``checks/<check>.py``);
* ``limits/<workload>.json``: the limits of the numbers the check
  compares, with the readings they were set from;
* ``metrics/<metric>.py``: one reader a metric; ``--trace 0`` prints the
  cell's ``end_to_end`` metrics, ``--trace 1`` its ``per_layer`` ones.

A run renders the cell's clips on the card from ``--seed``, sets the
program up and warms it (``setup_s``), measures for ``--seconds``, and
with ``--trace 1`` then runs a fixed slice of the same traffic under
``torch.profiler``. Once the window has closed and the memory peak is read,
the check compares a sample of the answers with the plain reference. The
run fails, and prints no result, without a CUDA card, or if JAX or the
JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pyfeaturetrack_tpu")


def _paths() -> None:
    """The benchmark's modules and the program importable; every build
    and kernel cache at a fixed path inside the checkout."""
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The workload entry ``name`` with its configuration, traffic, limits
    and the BENCHMARK.json it came from."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    return {"bench": bench, "cell": cell,
            "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{name}.json")["limits"]}


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if name in m.get("workloads", [name])]
    own = {m["name"] for m in cell_metrics(bench, name, False)}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in own else [])]


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (a mode, a check or
    a metric's reader), found by name."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}", HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number
    the cell's limits bound is within its limit."""
    out = {name: {"value": numbers[name], "limit": limit}
           for name, limit in limits.items()}
    return all(v["value"] <= v["limit"] for v in out.values()), out


def tracker_config(pft, config: dict):
    """The program's TrackerConfig of a configuration file; its derived
    borders must be the file's."""
    klt = dict(config["klt"])
    cfg = pft.create_config(**klt)
    for key, want in klt.items():
        if getattr(cfg, key) != want:
            raise ValueError(f"configuration {key}={want} but the program "
                             f"derives {getattr(cfg, key)}")
    return cfg


class Context:
    """What a metric reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def roofline(self, names, count) -> float | None:
        """Percent of the least time the slice's frames need in a kernel
        over its kernels' (``names``) device time in the trace. ``count(klt,
        h, w, prev_val, val)`` gives one frame's (bytes, operations) from
        the configuration's ``klt`` and the slots' values before and after
        the frame's step; the least time is ``counts.bound_s`` of each,
        summed over the slice's frames and streams."""
        import counts
        if self.trace is None:
            return None
        a, b = self.slice_us
        dev_s = sum(self.trace.kernel_us(n, a, b) for n in names) * 1e-6
        if dev_s <= 0.0:
            return None
        h, w = self.config["frame"]["height"], self.config["frame"]["width"]
        first, n = self.slice_rows
        least = 0.0
        for r in range(first, first + n):
            prev = self.rows.row(r - 1)[2]
            cur = self.rows.row(r)[2]
            for pv, cv in zip(prev.reshape(-1, prev.shape[-1]),
                              cur.reshape(-1, cur.shape[-1])):
                least += counts.bound_s(*count(self.config["klt"], h, w,
                                               pv, cv))
        return 100.0 * least / dev_s


def traced_slice(session, on_card: bool):
    """The session's fixed slice under torch.profiler; (first row, rows,
    Trace). The Chrome trace goes to a temporary directory under TMPDIR,
    deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import devtrace
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        with profile(activities=acts) as prof:
            first, n, _ = session.traced_slice()
            if on_card:
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        trace = devtrace.Trace.load(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return first, n, trace


def run(parts: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float = T_START) -> dict:
    """One run of a cell (``load_cell``'s parts) on ``device``; returns the
    result line's dict, the compared numbers under ``checks`` last."""
    import numpy as np
    import torch

    import devtrace
    import drive
    import pyfeaturetrack_tpu_torch as pft
    import scene

    imports_s = time.perf_counter() - t_start
    cell, config, traffic = parts["cell"], parts["config"], parts["traffic"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
    context_s = time.perf_counter() - t_start
    cfg = tracker_config(pft, config)
    h, w = config["frame"]["height"], config["frame"]["width"]
    streams = int(traffic.get("streams", 1))
    frames = scene.render_streams(seed, streams, traffic, h, w, device)
    render_s = time.perf_counter() - t_start
    session = load("modes", traffic["mode"]).Session(
        pft, cfg, config, frames, traffic, device)
    session.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    window = session.window(seconds)
    if on_card:
        torch.cuda.synchronize()
    spans = session.spans
    windows = [(window["first_row"], window["rows"])]
    tr = slice_us = slice_rows = None
    if trace:
        first, n, tr = traced_slice(session, on_card)
        windows.append((first, n))
        slice_rows = (first, n)
        (slice_us,) = tr.named(drive.SPAN_SLICE)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    session.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = load("checks", traffic["check"]).check(
        session, config, traffic, seed, windows, device)
    check_s = time.perf_counter() - t_check
    correct, checks = verdict(numbers, parts["limits"])

    ctx = Context(mode=traffic["mode"], cell=cell, config=config,
                  traffic=traffic, streams=streams, setup_s=setup_s,
                  window=window, spans=spans, trace=tr, slice_us=slice_us,
                  slice_rows=slice_rows, rows=session.rows)
    metrics = {}
    for m in cell_metrics(parts["bench"], cell["name"], trace):
        value = load("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(window["rows"]) * streams, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        a, b = slice_us
        dev["busy_s"] = tr.busy_in(a, b) * 1e-6
        dev["window_s"] = (b - a) * 1e-6
        result["breakdown"] = {
            "device_ops": devtrace.top_device_ops(tr, a, b),
            "idle_gaps": devtrace.idle_by_host(tr, a, b)}
    if "late_ms" in window:
        late = np.asarray(window["late_ms"], np.float64)
        result["generator_late_ms"] = {
            "p50": float(np.percentile(late, 50)),
            "p95": float(np.percentile(late, 95)),
            "max": float(late.max())}
    result["timings_s"] = {
        "imports": imports_s, "context": context_s, "rendered": render_s,
        "setup": setup_s, "check": check_s,
        "feed_mean": spans.total_ns("feed") / max(spans.count("feed"), 1) * 1e-9,
        "drain_mean": spans.total_ns("drain") / max(spans.count("drain"), 1) * 1e-9}
    result["checked"] = {k: v for k, v in numbers.items()
                         if k not in checks}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    parts = load_cell(args.workload)
    import torch
    chips = int(parts["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(parts, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}; nothing it runs may "
              "load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
