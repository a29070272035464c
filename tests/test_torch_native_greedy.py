"""The port's native greedy (utils/native.enforce_min_distance, built with
g++ from native/min_distance.cpp into build/torch_native/) against the JAX
package's native entry and its NumPy path
(ops/select._enforce_minimum_distance), on random candidate sets, for both
``overwrite_all`` values: float64 copies equal; and against K5's plain
version on the same sorted candidates."""

import numpy as np
import pytest
import torch

from pyfeaturetrack_tpu.ops.select import _enforce_minimum_distance
from pyfeaturetrack_tpu.utils import native as jnative

from pyfeaturetrack_tpu_torch.ops import select_device as tsd
from pyfeaturetrack_tpu_torch.utils import native

SHAPE = (90, 120)


def _case(seed, n_cand, n_feat, kept_frac):
    rng = np.random.default_rng(seed)
    h, w = SHAPE
    xs = rng.integers(0, w, n_cand)
    ys = rng.integers(0, h, n_cand)
    vals = rng.integers(0, 5000, n_cand)
    order = np.argsort(-vals, kind="stable")
    feats = np.column_stack([rng.uniform(0, w - 1, n_feat),
                             rng.uniform(0, h - 1, n_feat),
                             rng.integers(0, 900, n_feat).astype(float)])
    lost = rng.uniform(size=n_feat) >= kept_frac
    feats[lost] = (-1.0, -1.0, -1.0)
    return xs, ys, vals, order, feats


CASES = [(0, 400, 60, 0.5, 10, 1), (1, 300, 120, 0.0, 4, 100),
         (2, 50, 80, 0.3, 6, 1), (3, 500, 40, 0.9, 0, 1),
         (4, 500, 40, 0.2, 1, 2500), (5, 0, 10, 0.5, 10, 1),
         (6, 200, 30, 1.0, 25, 1)]


@pytest.mark.parametrize("seed,n_cand,n_feat,kept,mindist,min_eig", CASES)
@pytest.mark.parametrize("overwrite_all", [True, False])
def test_matches_jax_native_and_numpy(seed, n_cand, n_feat, kept, mindist,
                                      min_eig, overwrite_all):
    xs, ys, vals, order, feats = _case(seed, n_cand, n_feat, kept)
    args = (xs, ys, vals, order, feats, SHAPE, mindist, min_eig,
            overwrite_all)
    before = feats.copy()
    got = native.enforce_min_distance(*args)
    np.testing.assert_array_equal(feats, before)       # a copy is filled
    assert got.dtype == np.float64 and got.shape == feats.shape
    np.testing.assert_array_equal(got, _enforce_minimum_distance(*args))
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.enforce_min_distance(
            *args))


@pytest.mark.parametrize("seed,mindist", [(0, 10), (1, 0), (2, 3)])
def test_equals_k5_on_the_same_sorted_candidates(seed, mindist):
    """overwrite_all: the greedy's slots == K5's scan (plain version) and
    the slot fill over the same candidates in the same order."""
    xs, ys, vals, order, feats = _case(seed, 300, 50, 0.0)
    got = native.enforce_min_distance(xs, ys, vals, order, feats, SHAPE,
                                      mindist, 1, True)
    c = [torch.tensor(a[order], dtype=torch.int32) for a in (xs, ys, vals)]
    n = feats.shape[0]
    x, y, v, _, _ = tsd.suppress_and_fill(
        c[0], c[1], c[2], c[2] >= 1, torch.ones(n, dtype=torch.bool),
        torch.zeros(n), torch.zeros(n), torch.zeros(n, dtype=torch.int32),
        mindist)
    np.testing.assert_array_equal(
        got, np.column_stack([x.numpy(), y.numpy(), v.numpy()]))


def test_refuses_pixels_outside_the_image():
    xs, ys, vals, order, feats = _case(0, 20, 5, 0.0)
    xs[order[0]] = SHAPE[1]
    with pytest.raises(ValueError, match="outside"):
        native.enforce_min_distance(xs, ys, vals, order, feats, SHAPE, 5, 1,
                                    True)
    with pytest.raises(ValueError, match="order"):
        native.enforce_min_distance(xs, ys, vals, order + 100, feats, SHAPE,
                                    5, 1, True)


def test_raises_where_it_cannot_be_built(monkeypatch):
    monkeypatch.setattr(native, "_greedy", None)
    monkeypatch.setattr(native, "_greedy_tried", False)
    monkeypatch.setattr(native, "_compile", lambda *a: None)
    xs, ys, vals, order, feats = _case(0, 20, 5, 0.0)
    with pytest.raises(RuntimeError, match="could not be built"):
        native.enforce_min_distance(xs, ys, vals, order, feats, SHAPE, 5, 1,
                                    True)
