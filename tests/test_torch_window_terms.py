"""K9's plain version (ops/cuda_window_terms.py) vs the TPU kernel it
replaces, binned_window_terms (interpret mode, both slab heights), and vs
the XLA terms, at tests/test_pallas_lk.py:34's bars (rtol 1e-4, atol 0.05).
Edge lanes beyond every side pin the position clamp
(pallas_lk.py:166-167), which the XLA terms do not apply: they get the
clamped positions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyfeaturetrack_tpu.ops.interp import gather_window
from pyfeaturetrack_tpu.ops.pallas_lk import (binned_window_terms,
                                              xla_window_terms)

from pyfeaturetrack_tpu_torch.ops.cuda_window_terms import (
    window_terms, window_terms_reference)

torch.set_num_threads(2)


def _inputs(hw=3, hh=3):
    """tests/test_pallas_lk.py's inputs (templates from offset positions)
    plus six lanes beyond the edges."""
    rng = np.random.default_rng(0)
    h, w, n = 200, 256, 77
    img2 = jnp.asarray(rng.uniform(0, 255, (h, w)), jnp.float32)
    gx2 = jnp.asarray(rng.uniform(-20, 20, (h, w)), jnp.float32)
    gy2 = jnp.asarray(rng.uniform(-20, 20, (h, w)), jnp.float32)
    x2 = rng.uniform(8, w - 9, n).astype(np.float32)
    y2 = rng.uniform(8, h - 9, n).astype(np.float32)
    x2[:6] = [-5.0, 0.5, 2.9, w - 3.5, w + 4.0, 100.0]
    y2[:6] = [100.0, 1.0, h - 2.0, 50.0, -3.0, h + 9.0]
    x2, y2 = jnp.asarray(x2), jnp.asarray(y2)
    w1, g1x, g1y = (gather_window(im, x2 + 1.3, y2 - 0.8, hw, hh)
                    for im in (img2, gx2, gy2))
    return (img2, gx2, gy2, w1, g1x, g1y, x2, y2)


def _torch(args):
    return tuple(torch.tensor(np.asarray(a)) for a in args)


@pytest.mark.parametrize("slab_h", [64, 128])
def test_window_terms_match_binned_kernel(slab_h):
    args = _inputs()
    kw = dict(hw=3, hh=3, step_factor=1.0)
    want = np.asarray(binned_window_terms(*args, slab_h=slab_h,
                                          interpret=True, **kw))
    got = window_terms(*_torch(args), **kw).numpy()
    assert got.shape == (77, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)


@pytest.mark.parametrize("step_factor,win", [(1.0, (3, 3)), (0.5, (3, 3)),
                                             (1.0, (2, 4))])
def test_window_terms_match_xla_terms(step_factor, win):
    hw, hh = win
    args = _inputs(hw, hh)
    img2 = args[0]
    h, w = img2.shape
    xs = jnp.clip(args[6], hw, w - hw - 1.001)
    ys = jnp.clip(args[7], hh, h - hh - 1.001)
    kw = dict(hw=hw, hh=hh, step_factor=step_factor)
    want = np.asarray(xla_window_terms(*args[:6], xs, ys, **kw))
    got = window_terms(*_torch(args), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)


def test_window_terms_clamp_edges():
    """A lane beyond an edge gives the terms of the clamped position: x to
    [hw, W - hw - 1.001], y to [hh, H - hh - 1.001] in float32."""
    args = _torch(_inputs())
    img2 = args[0]
    h, w = img2.shape
    kw = dict(hw=3, hh=3, step_factor=1.0)
    got = window_terms_reference(*args, **kw)
    x_hi = float(np.float32(w - 3 - 1.001))
    y_hi = float(np.float32(h - 3 - 1.001))
    clamped = window_terms_reference(*args[:6], args[6].clamp(3.0, x_hi),
                                     args[7].clamp(3.0, y_hi), **kw)
    assert torch.equal(got, clamped)
    moved = (args[6] != args[6].clamp(3.0, x_hi)) | \
        (args[7] != args[7].clamp(3.0, y_hi))
    assert moved[:6].all() and not moved[6:].any()
