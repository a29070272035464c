"""BENCHMARK.json against the contract's shape, every part a cell names
found by name, and a run's last line against the result schema."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest

import run
from conftest import BENCH, ROOT, bench_json, tiny_parts

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
              "end_to_end", "per_layer"}


def test_benchmark_json_shape():
    b = bench_json()
    assert set(b) == BENCH_KEYS
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in [e["name"] for e in b["end_to_end"]]
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench_json()["workloads"]])
def test_every_part_found_by_name(cell):
    parts = run.load_cell(cell)
    b = parts["bench"]
    tr = parts["traffic"]
    assert (BENCH / "modes" / f"{tr['mode']}.py").is_file()
    assert (BENCH / "checks" / f"{tr['check']}.py").is_file()
    assert set(parts["limits"]) <= set(run.load("checks", tr["check"])
                                       .NUMBERS)
    for trace in (False, True):
        got = run.cell_metrics(b, cell, trace)
        assert got, (cell, trace)
        for m in got:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    e2e = [m["name"] for m in run.cell_metrics(b, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in run.cell_metrics(b, cell, True):
        assert m["moves"] in e2e


def check_result(res: dict, trace: bool):
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert isinstance(res["correct"], bool)
    assert res["attempted"] > 0 and res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell,trace", [("vga1000_video_chain8", False),
                                        ("vga1000_video_chain8", True),
                                        ("vga1000_live30hz", False),
                                        ("vga1000_live30hz", True)])
def test_result_line_schema(cell, trace):
    res = run.run(tiny_parts(cell), 2 ** 31 + 11, 0.3, trace, "cpu",
                  time.perf_counter())
    check_result(res, trace)
    assert res["correct"] is True
    names = {m["name"] for m in run.cell_metrics(bench_json(), cell, trace)}
    assert set(res["metrics"]) <= names
    if cell == "vga1000_live30hz":
        want = ({"serving.frame_latency_p50_ms", "serving.frame_latency_p95_ms"}
                if trace else {"live_frames_per_s"})
        assert want <= set(res["metrics"])
    json.loads(json.dumps(res))


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "vga1000_video_chain8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "vga1000_video_chain8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
