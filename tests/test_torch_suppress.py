"""K5's plain versions (ops/cuda_suppress.py) against the JAX package's
greedy suppression kernel (greedy_suppress_pallas, interpret mode) and the
numpy host greedy; K5's fused entry (suppress_and_fill: decode, budget,
scan, slot fill) against the composition it replaces (decode,
greedy_suppress, fill_slots) and JAX's host greedy with its slot walk
(_enforce_minimum_distance); and the port's host-API selection
(ops/select.py: stage A, sort, K5) against JAX's _enforce_minimum_distance
fed the port's own int32 eig map, lattice and order. Bars: acceptance
flags, slot fills and (x, y, val) arrays equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops.pallas_select import greedy_suppress_pallas
from pyfeaturetrack_tpu.ops.select import _enforce_minimum_distance
from pyfeaturetrack_tpu.ops.select_device import suppress_and_fill

from pyfeaturetrack_tpu_torch.errors import KLTWarningCategory
from pyfeaturetrack_tpu_torch.features import (FeatureState,
                                               feature_state_from_numpy,
                                               feature_state_to_numpy)
from pyfeaturetrack_tpu_torch.ops import cuda_suppress
from pyfeaturetrack_tpu_torch.ops.cuda_suppress import greedy_suppress
from pyfeaturetrack_tpu_torch.ops.select import (replace_lost_features,
                                                 select_good_features,
                                                 select_good_features_arrays,
                                                 selection_eig_map)
from pyfeaturetrack_tpu_torch.ops.cuda_select import fill_slots
from pyfeaturetrack_tpu_torch.utils.convert import config_from_jax

torch.set_num_threads(2)


def _numpy_greedy(cx, cy, valid, d, h, w, budget=None):
    """tests/test_pallas_select.py's host greedy, with a budget."""
    occ = np.zeros((h, w), bool)
    acc = np.zeros(len(cx), bool)
    budget = len(cx) if budget is None else budget
    for j in range(len(cx)):
        if acc.sum() >= budget:
            break
        if valid[j] and not occ[cy[j], cx[j]]:
            acc[j] = True
            if d >= 0:
                occ[max(cy[j] - d, 0):cy[j] + d + 1,
                    max(cx[j] - d, 0):cx[j] + d + 1] = True
    return acc


def _port(cx, cy, valid, shape, mindist, budget=None, max_out=None):
    k = len(cx)
    budget = k if budget is None else budget
    acc, order, n = greedy_suppress(
        torch.tensor(cx, dtype=torch.int32), torch.tensor(cy, dtype=torch.int32),
        torch.tensor(valid), shape=shape, mindist=mindist,
        budget=torch.tensor([budget], dtype=torch.int32),
        max_out=k if max_out is None else max_out)
    acc = acc.numpy()
    n = int(n[0])
    # the index list is the accepted lanes in acceptance order, then zeros
    np.testing.assert_array_equal(order[:n].numpy(), np.flatnonzero(acc))
    assert not order[n:].any()
    return acc


def _edge_candidates(rng, h, w, d, k):
    """Candidates within d of every edge and corner, then the interior."""
    e = max(d, 1)
    xs = np.concatenate([rng.integers(0, e + 1, k // 4),
                         rng.integers(w - 1 - e, w, k // 4),
                         rng.integers(0, w, k // 4),
                         rng.integers(0, w, k - 3 * (k // 4))])
    ys = np.concatenate([rng.integers(0, h, k // 4),
                         rng.integers(0, h, k // 4),
                         rng.integers(0, e + 1, k // 8),
                         rng.integers(h - 1 - e, h, k // 4 - k // 8),
                         rng.integers(0, h, k - 3 * (k // 4))])
    perm = rng.permutation(k)
    return xs[perm], ys[perm]


@pytest.mark.parametrize("mindist,seed", [(10, 0), (5, 1), (25, 2),
                                          (1, 3), (0, 4)])
def test_plain_matches_pallas_and_host_greedy(mindist, seed):
    """tests/test_pallas_select.py's scenarios: flags bit-equal to the TPU
    kernel (interpret mode) and to the numpy greedy."""
    h, w, k = 200, 256, 400
    rng = np.random.default_rng(seed)
    cx = rng.integers(8, w - 8, k)
    cy = rng.integers(8, h - 8, k)
    valid = rng.uniform(size=k) > 0.1
    got = _port(cx, cy, valid, (h, w), mindist)
    want = _numpy_greedy(cx, cy, valid, mindist - 1, h, w)
    np.testing.assert_array_equal(got, want)
    jax_acc = np.asarray(greedy_suppress_pallas(
        jnp.asarray(cx, jnp.int32), jnp.asarray(cy, jnp.int32),
        jnp.asarray(valid), shape=(h, w), mindist=mindist, interpret=True))
    np.testing.assert_array_equal(got, jax_acc)


@pytest.mark.parametrize("mindist,seed", [(10, 5), (3, 6), (60, 7)])
def test_edges_and_large_radius_match_host_greedy(mindist, seed):
    """Boxes clipped at every image edge; mindist 60 (a radius the TPU
    kernel refuses) against the numpy greedy, the others against the TPU
    kernel too."""
    h, w, k = 150, 200, 500
    rng = np.random.default_rng(seed)
    cx, cy = _edge_candidates(rng, h, w, mindist - 1, k)
    valid = rng.uniform(size=k) > 0.1
    got = _port(cx, cy, valid, (h, w), mindist)
    np.testing.assert_array_equal(
        got, _numpy_greedy(cx, cy, valid, mindist - 1, h, w))
    assert got.sum() > 1
    if mindist <= 49:
        jax_acc = np.asarray(greedy_suppress_pallas(
            jnp.asarray(cx, jnp.int32), jnp.asarray(cy, jnp.int32),
            jnp.asarray(valid), shape=(h, w), mindist=mindist,
            interpret=True))
        np.testing.assert_array_equal(got, jax_acc)


@pytest.mark.parametrize("budget", [0, 7, 25])
def test_budget_early_exit(budget):
    """A budget stops the scan: the flags are the first ``budget``
    acceptances of the unbudgeted scan (also in the TPU kernel), budget 0
    writes all-zero flags, and max_out caps the acceptances like a
    budget."""
    h, w, k = 160, 256, 400
    rng = np.random.default_rng(11)
    cx = rng.integers(8, w - 8, k)
    cy = rng.integers(8, h - 8, k)
    valid = rng.uniform(size=k) > 0.1
    full = _port(cx, cy, valid, (h, w), 10)
    got = _port(cx, cy, valid, (h, w), 10, budget=budget)
    assert got.sum() == min(budget, full.sum())
    np.testing.assert_array_equal(np.flatnonzero(got),
                                  np.flatnonzero(full)[:budget])
    jax_acc = np.asarray(greedy_suppress_pallas(
        jnp.asarray(cx, jnp.int32), jnp.asarray(cy, jnp.int32),
        jnp.asarray(valid), shape=(h, w), mindist=10, interpret=True,
        budget=jnp.int32(budget)))
    np.testing.assert_array_equal(got, jax_acc)
    np.testing.assert_array_equal(
        _port(cx, cy, valid, (h, w), 10, max_out=budget), got)


def test_outside_and_invalid_lanes_never_accepted():
    cx = np.array([-1, 5, 5, 300, 5, 6])
    cy = np.array([3, -2, 5, 3, 5, 400])
    valid = np.array([True, True, False, True, True, True])
    got = _port(cx, cy, valid, (100, 200), 0)
    np.testing.assert_array_equal(got, [False, False, False, False, True,
                                        False])


def test_kernel_route_plus_fill_matches_suppress_and_fill():
    """K5's flags and index list + the port's fill_slots == JAX's MIS
    fixpoint + fill (select_device.suppress_and_fill), with a budget of
    the free-slot count."""
    h, w, k, n = 160, 256, 300, 80
    rng = np.random.default_rng(7)
    cx = rng.integers(8, w - 8, k).astype(np.int32)
    cy = rng.integers(8, h - 8, k).astype(np.int32)
    cval = np.sort(rng.integers(1, 1 << 20, k))[::-1].astype(np.int32)
    valid = rng.uniform(size=k) > 0.1
    x = rng.uniform(8, w - 8, n).astype(np.float32)
    y = rng.uniform(8, h - 8, n).astype(np.float32)
    val = rng.integers(-2, 1, n).astype(np.int32)
    free = val < 0
    want = suppress_and_fill(*(jnp.asarray(a) for a in (
        cx, cy, cval, valid, free, x, y, val)), 10)
    t = [torch.tensor(a) for a in (cx, cy, cval, valid, free, x, y, val)]
    _, idx, n_acc = greedy_suppress(
        t[0], t[1], t[3], shape=(h, w), mindist=10, max_out=n,
        budget=t[4].sum().to(torch.int32).reshape(1))
    idx = idx.long()
    got = fill_slots(n_acc, t[0][idx], t[1][idx], t[2][idx], *t[4:])
    for g, wv in zip(got, want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def test_cpu_tensors_take_the_plain_version():
    before = cuda_suppress.launches
    _port(np.array([3]), np.array([4]), np.array([True]), (10, 10), 10)
    assert cuda_suppress.launches == before
    assert cuda_suppress.grid_bytes((480, 640)) == 38400
    assert cuda_suppress.grid_bytes((1080, 1920)) > \
        cuda_suppress.SMEM_GRID_BYTES


# ---- K5's fused entry: decode, budget, scan and slot fill ---------------

def _composition(neg, order, geom, min_eig, shape, mindist, x, y, val,
                 replacing):
    """The host API's selection after the sort as it was composed before
    the fused entry: decode, greedy_suppress under the free-slot budget,
    fill_slots."""
    borderx, bordery, step, _, nx = geom
    vals = -neg
    cand_x = (borderx + (order % nx) * step).to(torch.int32)
    cand_y = (bordery + (order // nx) * step).to(torch.int32)
    valid = vals >= min_eig
    free = (val < 0) if replacing else torch.ones_like(val, dtype=torch.bool)
    _, idx, n_acc = greedy_suppress(
        cand_x, cand_y, valid, shape=shape, mindist=mindist,
        max_out=int(val.shape[0]),
        budget=free.sum().to(torch.int32).reshape(1))
    idx = idx.to(torch.int64)
    return fill_slots(n_acc, cand_x[idx], cand_y[idx], vals[idx], free, x, y,
                      val)[:3]


_GEOMS = {"edges": (0, 0, 1, 60, 80),          # candidates on every edge
          "strided": (4, 3, 2, 27, 36)}
_SLOTS = ["initial", "refill", "budget 0", "budget 1", "all lost",
          "all invalid"]


@pytest.mark.parametrize("geometry", list(_GEOMS))
@pytest.mark.parametrize("slots", _SLOTS)
@pytest.mark.parametrize("mindist", [0, 1, 10, 25])
def test_suppress_and_fill_matches_composition_and_jax(mindist, slots,
                                                       geometry):
    """Random lattices with ties (values 0..49, bar 10): initial selection,
    a refill (kept features pre-mask their boxes, as stage A does), no free
    slot (budget 0), one free slot, every slot lost, and an all-invalid
    list; boxes clipped at every edge. The fused entry's plain version ==
    the earlier composition == JAX's _enforce_minimum_distance on the
    unmasked lattice."""
    h, w = 60, 80
    geom = _GEOMS[geometry]
    bx, by, step, ny, nx = geom
    rng = np.random.default_rng(mindist * 31 + _SLOTS.index(slots))
    min_eig = 10
    vals = rng.integers(0, 50, (ny, nx)).astype(np.int32)
    if slots == "all invalid":
        vals = np.minimum(vals, min_eig - 1)
    n = 30
    replacing = slots != "initial"
    feats = np.tile([-1.0, -1.0, -1.0], (n, 1))
    if replacing:
        feats[:, 0] = rng.uniform(0, w, n)
        feats[:, 1] = rng.uniform(0, h, n)
        feats[:, 2] = rng.integers(0, 5000, n)
        lost = {"refill": rng.uniform(size=n) < 0.4,
                "budget 0": np.zeros(n, bool),
                "budget 1": np.arange(n) == 17}.get(slots, np.ones(n, bool))
        feats[lost, 2] = rng.integers(-5, 0, int(lost.sum()))
    gy, gx = np.meshgrid(by + step * np.arange(ny), bx + step * np.arange(nx),
                         indexing="ij")
    cand = vals.copy()
    if replacing and mindist >= 1:
        # stage A's pre-mask: cells within the kept features' boxes
        for fx, fy, fv in feats:
            if fv >= 0:
                near = ((np.abs(gx - int(fx)) <= mindist - 1)
                        & (np.abs(gy - int(fy)) <= mindist - 1))
                cand[near] = 0
    neg, order = torch.sort(-torch.tensor(cand.ravel()), stable=True)
    x, y = (torch.tensor(feats[:, i], dtype=torch.float32) for i in (0, 1))
    val = torch.tensor(feats[:, 2], dtype=torch.int32)
    args = (neg, order, geom, min_eig, (h, w), mindist, x, y, val, replacing)
    before = cuda_suppress.launches
    got = cuda_suppress.suppress_and_fill(
        neg, order, geom=geom, min_eig=min_eig, shape=(h, w),
        mindist=mindist, x=x, y=y, val=val, replacing=replacing)
    assert cuda_suppress.launches == before
    for a, b in zip(got, _composition(*args)):
        assert torch.equal(a, b)
    want = _enforce_minimum_distance(
        gx.ravel(), gy.ravel(), vals.ravel().astype(np.int64),
        np.argsort(-vals.ravel().astype(np.int64), kind="stable"),
        np.column_stack([feats[:, :2].astype(np.float32), feats[:, 2]]),
        (h, w), mindist, min_eig, not replacing)
    np.testing.assert_array_equal(feature_state_to_numpy(FeatureState(*got)),
                                  want)
    if slots == "budget 0":
        np.testing.assert_array_equal(got[2].numpy(), val.numpy())
    if slots == "all invalid":
        assert (got[2][val < 0] == -1).all()


# ---- the host-API selection given the same eig map --------------------

def _host_greedy(eig, cfg, feats, overwrite_all):
    """JAX's lattice, order and _enforce_minimum_distance on ``eig``."""
    nrows, ncols = eig.shape
    bx = max(cfg.borderx, max(cfg.window_width // 2, 1))
    by = max(cfg.bordery, max(cfg.window_height // 2, 1))
    step = cfg.nSkippedPixels + 1
    ys_r = np.arange(by, nrows - by, step)
    xs_r = np.arange(bx, ncols - bx, step)
    gy, gx = np.meshgrid(ys_r, xs_r, indexing="ij")
    vals = eig[gy, gx].astype(np.int64).ravel()
    order = np.argsort(-vals, kind="stable")
    return _enforce_minimum_distance(
        gx.ravel(), gy.ravel(), vals, order, feats, (nrows, ncols),
        int(cfg.mindist), max(int(cfg.min_eigenvalue), 1), overwrite_all)


_HOST_CASES = {
    "select": ({}, None),
    "select mindist 0": ({"mindist": 0}, None),
    "select skipped pixels": ({"mindist": 5, "nSkippedPixels": 2}, None),
    "replace with kept": ({}, "lose"),
    "replace mindist 0": ({"mindist": 0}, "lose"),
    "nothing lost": ({}, "none"),
    "dry pool": ({"min_eigenvalue": 2_000_000}, "lose"),
}


@pytest.mark.parametrize("case", list(_HOST_CASES))
def test_host_selection_matches_jax_host_greedy(case):
    overrides, mode = _HOST_CASES[case]
    jcfg = create_config(**overrides)
    cfg = config_from_jax(jcfg)
    img = make_textured_image(120, 160, seed=40 + len(case))
    n = 40
    eig = selection_eig_map(torch.tensor(img, dtype=torch.float32),
                            cfg).numpy()
    if mode is None:
        want = _host_greedy(eig, jcfg, np.tile([-1.0, -1.0, -1.0], (n, 1)),
                            True)
        got = feature_state_to_numpy(
            select_good_features(img, n, cfg, device="cpu"))
        np.testing.assert_array_equal(
            select_good_features_arrays(img, n, cfg, device="cpu"), got)
    else:
        kept = _host_greedy(eig, create_config(), np.tile(
            [-1.0, -1.0, -1.0], (n, 1)), True)
        assert (kept[:, 2] >= 0).all()
        if mode == "lose":
            for i, code in [(0, -1), (3, -2), (7, -4), (12, -5), (21, -3),
                            (33, -1), (39, -4)]:
                kept[i] = (kept[i, 0], kept[i, 1], code)
        want = (_host_greedy(eig, jcfg, kept, False) if mode == "lose"
                else kept)
        fl = feature_state_from_numpy(kept, device="cpu")
        got = feature_state_to_numpy(replace_lost_features(img, fl, cfg))
    np.testing.assert_array_equal(got, want)
    if case == "dry pool":
        assert (got[:, 2] == -1).sum() > 0     # slots left empty
    if case == "nothing lost":
        np.testing.assert_array_equal(got, kept)


def test_empty_lattice_and_few_candidates_warn():
    cfg = config_from_jax(create_config())
    img = make_textured_image(40, 40, seed=1)
    with pytest.warns(KLTWarningCategory, match="no room for features"):
        fl = select_good_features(img, 5, cfg, device="cpu")
    assert (fl.val == -1).all() and (fl.x == -1).all()
    img = make_textured_image(52, 54, seed=2)          # 4 x 6 lattice
    with pytest.warns(KLTWarningCategory, match="fewer candidate pixels"):
        fl = select_good_features(img, 30, cfg, device="cpu")
    eig = selection_eig_map(torch.tensor(img, dtype=torch.float32),
                            cfg).numpy()
    want = _host_greedy(eig, cfg, np.tile([-1.0, -1.0, -1.0], (30, 1)),
                        True)
    np.testing.assert_array_equal(feature_state_to_numpy(fl), want)
