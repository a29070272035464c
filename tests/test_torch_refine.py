"""Port sub-pixel corner refinement (ops/refine.py) vs the JAX package's,
and SequenceTracker(subpixel_refine=True) vs JAX's.

Bars: refine_corners within 1e-3 px of JAX's on tests/test_refine.py's
inputs, with every lane over 1e-4 px listed and classified; the known
corners within 0.03 px; out-of-bounds and degenerate lanes keep their
input exactly. The refined sequence: vals exact, positions within 1e-3 px,
every entry over 1e-4 px carried from a refined selection (the class of
ROADMAP.md Queue 3). Refinement solves q from sums of the form
sum(gxx x + gxy y) with coordinates of tens to hundreds of pixels, so its
float32 result carries a cancellation error of up to about 1e-3 px; XLA on
the CPU contracts those multiply-adds into FMAs, the port rounds each
product and sum on its own."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image
from test_refine import _corner_image, _mirror_refine

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.features import create_feature_list
from pyfeaturetrack_tpu.models.sequence import track_sequence as jax_sequence
from pyfeaturetrack_tpu.ops.convolve import compute_gradients
from pyfeaturetrack_tpu.ops.refine import (refine_corners as jax_refine,
                                           refine_features_subpixel as
                                           jax_refine_features)
from pyfeaturetrack_tpu.utils.io import pgm_read

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.features import FeatureState
from pyfeaturetrack_tpu_torch.ops.convolve import compute_gradients as \
    port_gradients
from pyfeaturetrack_tpu_torch.ops.refine import (refine_corners,
                                                 refine_features_subpixel)
from pyfeaturetrack_tpu_torch.utils.convert import config_from_jax

torch.set_num_threads(2)

REFINE_TOL = 1e-3
# Lanes of test_refine_matches_float64_mirror's inputs over 1e-4 px, class
# "cancellation" (see the module docstring): lane -> |port - JAX| bound.
# Lane 2 exceeds 1e-3: there JAX is 9.5e-4 px from the float64 mirror and
# the port 2.1e-4, so most of the gap is JAX's own float32 error.
LISTED_LANES = {2: 1.2e-3, 15: REFINE_TOL, 22: REFINE_TOL, 24: REFINE_TOL}


def _mirror_inputs():
    img = make_textured_image(96, 128, seed=11)
    gx, gy = compute_gradients(jnp.asarray(img, jnp.float32), 1.0)
    rng = np.random.default_rng(3)
    x = rng.uniform(8, 119, 40).astype(np.float32)
    y = rng.uniform(8, 87, 40).astype(np.float32)
    return gx, gy, x, y


def test_refine_corners_matches_jax():
    gx, gy, x, y = _mirror_inputs()
    jx, jy = jax_refine(gx, gy, jnp.asarray(x), jnp.asarray(y))
    tx, ty = refine_corners(torch.tensor(np.asarray(gx)),
                            torch.tensor(np.asarray(gy)), torch.tensor(x),
                            torch.tensor(y))
    d = np.maximum(np.abs(tx.numpy() - np.asarray(jx)),
                   np.abs(ty.numpy() - np.asarray(jy)))
    over = {int(i) for i in np.flatnonzero(d > 1e-4)}
    assert over <= set(LISTED_LANES), sorted((i, d[i]) for i in over)
    for lane, bound in LISTED_LANES.items():
        assert d[lane] <= bound, (lane, d[lane])
    mirror = _mirror_refine(gx, gy, x, y)
    assert abs(tx[2].item() - mirror[2, 0]) < 3e-4
    assert abs(ty[2].item() - mirror[2, 1]) < 3e-4
    np.testing.assert_allclose(tx.numpy(), mirror[:, 0], atol=2e-2)
    np.testing.assert_allclose(ty.numpy(), mirror[:, 1], atol=2e-2)


@pytest.mark.parametrize("corner", [(20.3, 15.7), (40.62, 31.18),
                                    (55.0, 44.5)])
def test_refine_recovers_known_subpixel_corner(corner):
    """tests/test_refine.py's rendered corners, through the port's own
    gradients, from the integer start: within 0.03 px."""
    cx, cy = corner
    gx, gy = port_gradients(torch.tensor(_corner_image(cx, cy)), 1.0)
    rx, ry = refine_corners(gx, gy, torch.tensor([float(round(cx))]),
                            torch.tensor([float(round(cy))]))
    assert abs(rx.item() - cx) < 0.03
    assert abs(ry.item() - cy) < 0.03


def test_refine_oob_and_degenerate_lanes_keep_input():
    gx, gy = port_gradients(torch.full((48, 64), 100.0), 1.0)  # flat: det 0
    x = torch.tensor([2.0, 30.0, 61.5])     # lanes 0 and 2: window OOB
    y = torch.tensor([2.0, 20.0, 20.0])
    rx, ry = refine_corners(gx, gy, x, y)
    assert torch.equal(rx, x) and torch.equal(ry, y)


def test_refine_features_subpixel_matches_jax():
    """The wrapper on a rendered corner with the default config (gradients
    from K1 level 0, smoothed as the selection smooths): live lanes within
    1e-3 px of JAX's and of the corner within 0.1 px, the dead lane
    untouched."""
    cfg = create_config()
    cx, cy = 33.4, 27.8
    img = _corner_image(cx, cy, h=64, w=80)
    x, y, val = ([33.0, 28.0, -1.0], [28.0, 22.0, -1.0], [0, 0, -1])
    jfl = create_feature_list(3)._replace(
        x=jnp.asarray(x, jnp.float32), y=jnp.asarray(y, jnp.float32),
        val=jnp.asarray(val, jnp.int32))
    want = jax_refine_features(img, jfl, cfg)
    fl = FeatureState(torch.tensor(x), torch.tensor(y),
                      torch.tensor(val, dtype=torch.int32), None)
    got = refine_features_subpixel(img, fl, config_from_jax(cfg))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               atol=REFINE_TOL)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y),
                               atol=REFINE_TOL)
    assert abs(got.x[0].item() - cx) < 0.1 and abs(got.y[0].item() - cy) < 0.1
    assert got.x[2].item() == -1.0 and got.y[2].item() == -1.0
    assert torch.equal(got.val, fl.val)


def test_track_sequence_subpixel_matches_jax():
    """track_sequence(subpixel_refine=True) on the 10 bundled frames, 100
    features: vals exact, positions within 1e-3 px, and every entry over
    1e-4 px belongs to a lane whose position at its last (re)selection
    already differed by over 5e-5 px, i.e. carried from the refinement
    (without refinement the same run stays within 1e-4 px,
    tests/test_torch_tracker.py)."""
    data = Path(__file__).resolve().parent.parent / "examples" / "data"
    frames = [pgm_read(data / f"img{i}.pgm") for i in range(10)]
    jcfg = create_config()
    jft, _ = jax_sequence(frames, cfg=jcfg, n_features=100,
                          subpixel_refine=True)
    tft, metrics = tpft.track_sequence(frames, cfg=config_from_jax(jcfg),
                                       n_features=100, subpixel_refine=True,
                                       device="cpu")
    jx, jy, jv = (np.asarray(a) for a in jft)
    tx, ty, tv = (a.numpy() for a in tft)
    np.testing.assert_array_equal(tv, jv)
    d = np.maximum(np.abs(tx - jx), np.abs(ty - jy))
    assert d.max() <= REFINE_TOL
    selected = jv > 0
    selected[0] = jv[0] >= 0
    for f, i in np.argwhere(d > 1e-4):
        s = max(k for k in range(f + 1) if selected[k, i])
        assert d[s, i] > 5e-5, (f, i, s, d[s, i], d[f, i])
    # the refined first frame is off the integer lattice
    assert (tx[0][tv[0] >= 0] != np.round(tx[0][tv[0] >= 0])).mean() > 0.5
    assert len(metrics) == 10
