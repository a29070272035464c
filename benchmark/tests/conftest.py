"""The benchmark's CPU tests: its modules and the program importable, and
a tiny cell (96x128 frames, 40 features) that runs through the whole
harness on the CPU, where the program takes its plain versions."""

import copy
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_parts(cell: str, **traffic) -> dict:
    """The parts of ``cell`` with the frame cut to 96x128, 40 features, a
    short clip."""
    import run
    parts = copy.deepcopy(run.load_cell(cell))
    parts["config"]["frame"] = {"height": 96, "width": 128, "dtype": "uint8"}
    parts["config"]["n_features"] = 40
    tr = parts["traffic"]
    tr["clip_frames"] = 8
    if tr["mode"] == "video":
        tr.update(drain_every=16, trace_periods=1)
    else:
        tr.update(streams=3, rate_hz=20, trace_ticks=3)
    tr.update(traffic)
    return parts


@pytest.fixture
def card():
    """Skip where torch sees no CUDA card (decided in the fixture, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
