"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault a cell can have. One chip, so no
exchange between chips to leave out."""

import time

import numpy as np
import pytest
import torch

import run
from conftest import tiny_parts
from pyfeaturetrack_tpu_torch import serving

CELLS = ["vga1000_video_chain8", "vga1000_live30hz"]
SEED = 2 ** 31 + 3


def unchanged(real):
    """A step that returns its state unchanged."""
    def chain(lanes, ticks, cfg, replace_lost=True):
        hist = tuple(torch.stack([torch.stack([lane[j]] * len(ticks))
                                  for lane in lanes]) for j in (1, 2, 3))
        return list(lanes), hist, torch.zeros(len(lanes), dtype=torch.bool)

    def step(pyr, f, x, y, val, cfg, replace_lost=True, top_k=0, aff=None,
             carry=None):
        return pyr, x, y, val, aff, torch.zeros((), dtype=torch.bool), carry
    return chain if real is serving.chain_lanes else step


def half_left_out(real):
    """Half of the batch left out: the second half of the features keep
    their state."""
    def chain(lanes, ticks, cfg, replace_lost=True):
        out, hist, ex = real(lanes, ticks, cfg, replace_lost)
        n = lanes[0][1].shape[0] // 2
        fixed = []
        for old, new in zip(lanes, out):
            fixed.append((new[0], *(torch.cat([new[j][:n], old[j][n:]])
                                    for j in (1, 2, 3)), new[4], new[5]))
        for h, j in zip(hist, (1, 2, 3)):
            for b, old in enumerate(lanes):
                h[b, :, n:] = old[j][n:]
        return fixed, hist, ex

    def step(pyr, f, x, y, val, *a, **kw):
        out = real(pyr, f, x, y, val, *a, **kw)
        n = x.shape[0] // 2
        return (out[0], *(torch.cat([o[:n], i[n:]])
                          for o, i in zip(out[1:4], (x, y, val))), *out[4:])
    return chain if real is serving.chain_lanes else step


@pytest.mark.parametrize("replace_lost", [True, False])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, replace_lost):
    """The configuration's ``replace_lost`` reaches both the program and
    the reference: were it to reach one side alone, the refills would
    differ."""
    parts = tiny_parts(cell)
    parts["config"]["replace_lost"] = replace_lost
    res = run.run(parts, SEED, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(monkeypatch, cell, fault):
    for name in ("chain_lanes", "sequence_step_device"):
        monkeypatch.setattr(serving, name, fault(getattr(serving, name)))
    res = run.run(tiny_parts(cell), SEED, 0.3, False, "cpu",
                  time.perf_counter())
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(monkeypatch, cell):
    """Every second answer altered where the program hands it out: the
    live lanes' x moved by half a pixel."""
    real = serving._StreamingBase.drain
    count = {"n": 0}

    def drain(self):
        x, y, val = real(self)
        x = x.copy()
        for r in range(x.shape[0]):
            if (count["n"] + r) % 2:
                x[r] = np.where(val[r] >= 0, x[r] + 0.5, x[r])
        count["n"] += x.shape[0]
        return x, y, val
    monkeypatch.setattr(serving._StreamingBase, "drain", drain)
    res = run.run(tiny_parts(cell), SEED, 0.3, False, "cpu",
                  time.perf_counter())
    assert res["correct"] is False, res["checks"]
