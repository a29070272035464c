"""The port's tracing and timing helpers (``utils/profiling.py``) on the
CPU: named scopes land in the trace file, the host-clock timing of CPU
work, and no device time without a card. The card's side (a trace that
names the K1 and K2 kernels, device time per call) is checked by
chip_smoke.py's tools phase."""

import json

import numpy as np
import pytest
import torch

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _pyramid():
    img = torch.as_tensor(np.random.default_rng(0).uniform(
        0, 255, (48, 64)).astype(np.float32))
    return tpft.build_track_pyramids(img, tpft.create_config())


def test_trace_writes_named_scopes(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.named_scope("pft_pyramid_stage"):
            _pyramid()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in events.get("traceEvents", events)}
    assert "pft_pyramid_stage" in names


def test_time_jitted_on_the_cpu_is_a_host_clock():
    s = profiling.time_jitted(_pyramid, iters=3, warmup=1)
    assert 0.0 < s < 10.0


def test_device_time_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.device_time_per_call(_pyramid)
