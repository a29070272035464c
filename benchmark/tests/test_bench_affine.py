"""The affine cell's harness on the CPU at a tiny size (128x160 frames, 48
features, the overlay moved into the frame): a sound run is correct, and
the check (``checks/klt_affine_steps.py``) catches three faults planted
in the program: the affine stage skipped, the warps handed on transposed,
and templates kept across a refill. Also the warp clip's geometry and
the holds of the mode (``modes/video_warp.py``), and the reference's
imports."""

import copy
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import run
from conftest import BENCH
from modes import video_warp
from pyfeaturetrack_tpu_torch.models import device_sequence

CELL = "vga1000_affine_chain8"
SEED = 2 ** 31 + 5


def tiny_parts() -> dict:
    parts = copy.deepcopy(run.load_cell(CELL))
    parts["config"]["frame"] = {"height": 128, "width": 160, "dtype": "uint8"}
    parts["config"]["n_features"] = 48
    parts["traffic"].update(clip_frames=8, drain_every=16, trace_periods=1,
                            overlay=[[52, 76], [60, 100]])
    return parts


def tiny_run():
    return run.run(tiny_parts(), SEED, 0.3, False, "cpu", time.perf_counter())


def test_sound_run_is_correct():
    res = tiny_run()
    assert res["correct"] is True, res["checks"]
    assert res["checked"]["pairs"] >= 1
    assert res["checked"]["template_lanes"] > 0


def _skipped(real):
    def stage(pyr1, pyr2, before, after, cfg):
        return after
    return stage


def _transposed(real):
    def stage(pyr1, pyr2, before, after, cfg):
        out = real(pyr1, pyr2, before, after, cfg)
        return out._replace(aff=out.aff._replace(
            A=out.aff.A.transpose(-1, -2).contiguous()))
    return stage


@pytest.mark.parametrize("fault", [_skipped, _transposed])
def test_broken_affine_stage_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(device_sequence, "affine_consistency_check",
                        fault(device_sequence.affine_consistency_check))
    res = tiny_run()
    assert res["correct"] is False, res["checks"]


def test_templates_kept_across_a_refill_are_not_correct(monkeypatch):
    """A lost feature's template and warp stay with its slot (neither the
    stage nor the refill drops them), so the slot's next feature is checked
    against the old one's template."""
    real = device_sequence.affine_consistency_check

    def stage(pyr1, pyr2, before, after, cfg):
        out = real(pyr1, pyr2, before, after, cfg)
        return out._replace(aff=out.aff._replace(
            valid=out.aff.valid | after.aff.valid))
    monkeypatch.setattr(device_sequence, "affine_consistency_check", stage)
    monkeypatch.setattr(device_sequence, "reset_affine",
                        lambda aff, lost: aff)
    res = tiny_run()
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["template_mismatch"]["value"] > 0


@pytest.mark.parametrize("n,roll,zoom", [(32, 0.05, 0.001), (8, 2.0, 0.0)])
def test_least_zoom_keeps_every_sample_inside(n, roll, zoom):
    h, w = 480, 640
    z0 = video_warp.least_zoom(n, h, w, roll, zoom)
    assert z0 >= 1.0
    for i in range(n):
        th, z = math.radians(i * roll), z0 * (1 + zoom) ** i
        for cx in (-1, 1):
            for cy in (-1, 1):
                px, py = cx * (w - 1) / 2, cy * (h - 1) / 2
                qx = (math.cos(th) * px + math.sin(th) * py) / z + (w - 1) / 2
                qy = (-math.sin(th) * px + math.cos(th) * py) / z + (h - 1) / 2
                assert 0 <= qx <= w - 1.001 and 0 <= qy <= h - 1.001


def test_warp_clip_pastes_a_static_overlay():
    traffic = {"roll_deg": 0.05, "zoom": 0.001, "overlay": [[10, 20], [5, 25]]}
    rng = np.random.default_rng(1)
    pan = rng.integers(0, 256, (4, 40, 48), dtype=np.uint8)
    out = video_warp.warp_clip(pan, traffic, "cpu")
    assert out.shape == pan.shape and out.dtype == np.uint8
    box = np.flip(pan[-1, :10, :20], (0, 1))
    for f in out:
        np.testing.assert_array_equal(f[10:20, 5:25], box)
    assert not np.array_equal(out[0], out[1])


def test_holds_pairs_of_chain_boundaries(monkeypatch):
    """The mode holds the first and the next chain boundary of the window,
    and a pair every HOLD_STRIDE boundaries after, up to MAX_PAIRS."""
    monkeypatch.setattr(video_warp, "HOLD_STRIDE", 3)
    monkeypatch.setattr(video_warp, "MAX_PAIRS", 2)
    import pyfeaturetrack_tpu_torch as pft
    parts = tiny_parts()
    parts["traffic"]["drain_every"] = 48            # six chains a period
    cfg = run.tracker_config(pft, parts["config"])
    frames = np.zeros((8, 128, 160), np.uint8)
    s = video_warp.Session(pft, cfg, parts["config"], frames,
                           parts["traffic"], "cpu")
    s.setup()
    first = s.fed
    s.window(0.0)
    rows = [r for r, _ in s.held]
    chain = parts["traffic"]["chain"]
    assert rows == [first + chain - 1 + chain * k for k in (0, 1, 3, 4)]
    assert [sorted(f) for _, f in s.held] == [
        ["A", "img", "valid"], ["A", "valid"]] * 2
    assert all(isinstance(t, torch.Tensor) for _, f in s.held
               for t in f.values())


def test_affine_reference_imports_nothing_of_the_program():
    """The reference loads neither the program nor JAX, and switches TF32
    off."""
    code = ("import sys; sys.path.insert(0, %r); from reference import "
            "klt_affine; import torch; "
            "assert not torch.backends.cuda.matmul.allow_tf32; "
            "assert not torch.backends.cudnn.allow_tf32; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'pyfeaturetrack_tpu', "
            "'pyfeaturetrack_tpu_torch')))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
