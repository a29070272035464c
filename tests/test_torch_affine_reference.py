"""BASELINE config 3 (KLT's affine-consistency check, a 6-parameter warp,
3 levels at subsampling 2) through ``StreamingTracker(chain=2)`` on the
CPU, against the benchmark's plain float64 reference
(``benchmark/reference/klt_affine.py``) on a seeded small clip that pans,
rolls and zooms under a static textured overlay
(``benchmark/modes/video_warp.py``'s warp).

The reference follows the port step by step: each step starts from the
port's row t - 1 and from the reference's own affine state (empty at the
first frame, like the port's). Every row matches lane for lane (positions
within 1e-3 px, statuses, refills as sets); at every chain boundary the
port's ``affine_state()`` holds the reference's template flags, and its
warps lie within 1e-4 of the reference's. The port's K6 device counters,
which its plain stage adds on the CPU, equal the reference's counts of
lanes checked and rejected, and its Gauss-Newton updates."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import scene  # noqa: E402
from checks.klt_steps import compare_rows  # noqa: E402
from modes.video_warp import warp_clip  # noqa: E402
from reference.klt_affine import AffineReference, empty  # noqa: E402

import pyfeaturetrack_tpu_torch as tpft  # noqa: E402
from pyfeaturetrack_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

# 128x160: inside config 3's borders of 32 px, room for the 48 features
H, W, N, CHAIN, FRAMES = 128, 160, 48, 2, 13
# the cell's motion, the roll and zoom ten times the cell's so that the
# warps move well off the identity within the clip, the overlay moved into
# the small frame
TRAFFIC = {"motion_px": [1, 3], "roll_deg": 0.5, "zoom": 0.01,
           "overlay": [[52, 76], [60, 100]], "clip_frames": FRAMES}


def _klt() -> dict:
    path = BENCH / "configs" / "klt_vga_affine_1000.json"
    return json.loads(path.read_text())["klt"]


def _clip(seed: int) -> np.ndarray:
    pan = scene.render_clip(seed, 0, FRAMES, H, W, TRAFFIC, "cpu").numpy()
    return warp_clip(pan, TRAFFIC, "cpu")


def _device_counts() -> dict:
    got = profiling.counters()
    return {k: got[k] for k in ("k6.checked_lanes", "k6.gn_steps",
                                "k6.rejections")}


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_chained_affine_stream_matches_the_float64_reference(seed):
    klt = _klt()
    frames = _clip(seed)
    tracker = tpft.StreamingTracker(tpft.create_config(**klt), n_features=N,
                                    replace_lost=True, chain=CHAIN,
                                    device="cpu")
    before = _device_counts()
    held = {}
    for i, f in enumerate(frames):
        tracker.feed(f)
        if i and i % CHAIN == 0:
            held[i] = tracker.affine_state()
    x, y, val = tracker.table()
    grew = {k: v - before[k] for k, v in _device_counts().items()}

    ref = AffineReference(klt, "cpu")
    st = empty(N, klt, "cpu")
    gaps = []
    for t in range(1, FRAMES):
        out, st = ref.affine_step(
            t - 1, frames[t - 1], t, frames[t],
            x[t - 1].astype(np.float64), y[t - 1].astype(np.float64),
            val[t - 1].astype(np.int64), st)
        c = compare_rows(out, (x[t], y[t], val[t]))
        assert c["bad"] == 0, (t, c)
        gaps.append(c["gaps"])
        if t in held:
            got = held[t]
            assert torch.equal(got.valid, st.valid), t
            both = got.valid & st.valid
            dA = (got.A.double() - st.A)[both].abs()
            assert dA.numel() and float(dA.max()) < 1e-4, t
    assert float(np.concatenate(gaps).max()) < 1e-3
    # what the clip exercises: templates held, warps well off the identity,
    # lanes rejected by the stage (the overlay) and refilled
    last = held[max(held)]
    assert int(last.valid.sum()) >= N // 2
    off = (last.A - torch.eye(2))[last.valid].abs().amax()
    assert float(off) > 0.02
    checked, updates, rejected = ref.counts
    assert rejected > 0 and checked > 5 * N
    assert grew == {"k6.checked_lanes": checked, "k6.gn_steps": updates,
                    "k6.rejections": rejected}
