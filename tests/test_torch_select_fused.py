"""K4's two stages (ops/cuda_select.py) on the CPU, where they run their
plain versions, against the JAX package.

Stage A (``candidate_lattice``: the candidate lattice and its maxima,
built in lattice space) is held exactly to the dilation route it replaces
(``select_device.candidate_map``: stamp, max_pool2d, sample) and to the
JAX package's candidate map (``pyfeaturetrack_tpu/ops/select_device.py:
188-214``, built here with that module's own helpers), over mindist 0, 1,
2 and 10, nSkippedPixels 0 and 1, borders larger than the window, kept
features on and near the frame's edges, initial selection and refill.
Stage B (``greedy_fill``: the chain and the slot fill) is held exactly to
the JAX refill route (``PFT_PALLAS_SELECT=1``: the TPU extraction kernel
in interpret mode, then ``fill_slots``) and to the JAX MIS route with
top_k = every candidate: x, y, val and filled. Frames up to 2160x3840
(segment widths 64, 256 and 512) go through both stages against JAX too.
All inputs are made with numpy from a seed; both sides read the same
int32 eig map."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops import select_device as jsd
from pyfeaturetrack_tpu.ops.select import selection_eig_map_core

from pyfeaturetrack_tpu_torch.ops import cuda_select
from pyfeaturetrack_tpu_torch.ops.select_device import (
    _candidate_grid, candidate_map, premask_radius,
    select_features_from_eig_device)
from pyfeaturetrack_tpu_torch.utils.convert import (config_from_jax,
                                                    features_from_numpy)

torch.set_num_threads(2)

H, W, N = 96, 128, 60


def _eig(jcfg, seed, shape=(H, W)):
    img = make_textured_image(*shape, seed=seed)
    return np.asarray(selection_eig_map_core(
        jnp.asarray(img, jnp.float32), window_width=jcfg.window_width,
        window_height=jcfg.window_height,
        smooth_before=jcfg.smoothBeforeSelecting,
        smooth_sigma=jcfg.smooth_sigma, grad_sigma=jcfg.grad_sigma))


def _slots(replacing, seed, shape=(H, W)):
    """N feature slots: on a refill about a third lost, the kept ones
    spread over the frame with some on each edge, next to it (within
    mindist) and just outside it (truncated and clamped back in)."""
    if not replacing:
        return np.full(N, -1.0), np.full(N, -1.0), np.full(N, -1)
    h, w = shape
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, w - 1, N)
    y = rng.uniform(0, h - 1, N)
    x[:8] = [0.0, w - 1.0, 0.7, w - 1.6, 4.2, -0.6, 60.5, w + 2.0]
    y[:8] = [3.0, h - 1.0, 0.0, h - 0.2, h - 6.5, 50.0, -0.9, 20.0]
    val = np.where(rng.uniform(size=N) < 0.35, -1, 900)
    val[:8] = 900
    return x, y, val


def _jax_candidate_map(eig, x, y, val, jcfg, replacing):
    """The candidate lattice as the JAX package's
    select_features_from_eig_device builds it, with its own helpers."""
    nrows, ncols = eig.shape
    borderx, bordery, step, ny, nx = jsd._candidate_grid(jcfg, eig.shape)
    eig = jnp.asarray(eig)
    cand = eig[bordery:nrows - bordery:step, borderx:ncols - borderx:step]
    cand = cand[:ny, :nx]
    if replacing and int(jcfg.mindist) >= 1:
        keep = jnp.asarray(val) >= 0
        xi = jnp.clip(jnp.asarray(x, jnp.float32).astype(jnp.int32), 0,
                      ncols - 1)
        yi = jnp.clip(jnp.asarray(y, jnp.float32).astype(jnp.int32), 0,
                      nrows - 1)
        occ = jnp.zeros((nrows, ncols), bool).at[yi, xi].max(keep)
        blocked = jsd._dilate_chebyshev(occ, int(jcfg.mindist) - 1)
        cand = jnp.where(blocked[bordery:nrows - bordery:step,
                                 borderx:ncols - borderx:step][:ny, :nx],
                         0, cand)
    return np.asarray(jnp.where(cand < max(int(jcfg.min_eigenvalue), 1), 0,
                                cand))


def _config(mindist, skip, border):
    jcfg = create_config(mindist=mindist, nSkippedPixels=skip)
    if border is not None:
        jcfg = jcfg.replace(borderx=border[0], bordery=border[1])
    return jcfg


@pytest.mark.parametrize("mindist", [0, 1, 2, 10])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("border", [None, (30, 17)])
@pytest.mark.parametrize("replacing", [False, True])
def test_stage_a_matches_dilation_route_and_jax(mindist, skip, border,
                                                replacing):
    jcfg = _config(mindist, skip, border)
    cfg = config_from_jax(jcfg)
    eig = _eig(jcfg, seed=mindist + 3 * skip)
    x, y, val = _slots(replacing, seed=mindist)
    tx, ty, tv = features_from_numpy(x, y, val, device="cpu")
    geom = _candidate_grid(cfg, eig.shape)
    assert geom[3] > 0 and geom[4] > 0
    got = cuda_select.candidate_lattice(
        torch.tensor(eig), tx, ty, tv, geom,
        min_eig=int(cfg.min_eigenvalue),
        radius=premask_radius(cfg, replacing))
    nx = geom[4]
    lattice = got.cells[:, :nx].numpy()
    old, _ = candidate_map(torch.tensor(eig), tx, ty, tv, cfg,
                           replacing=replacing)
    np.testing.assert_array_equal(lattice, old.numpy())
    np.testing.assert_array_equal(
        lattice, _jax_candidate_map(eig, x, y, val, jcfg, replacing))
    assert not got.cells[:, nx:].any()
    if replacing and mindist >= 1:
        # the pre-mask took effect: some cells above the bar were zeroed
        bar = max(int(cfg.min_eigenvalue), 1)
        base = eig[geom[1]::geom[2], geom[0]::geom[2]][:geom[3], :nx]
        assert ((base >= bar) & (lattice == 0)).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_a_maxima_first_occurrence(seed):
    """Segment and row maxima are each block's largest value and the first
    column holding it, on a lattice full of ties."""
    rng = np.random.default_rng(seed)
    eig = rng.integers(0, 6, (40, 150)).astype(np.int32)
    x = torch.zeros(0)
    got = cuda_select.candidate_lattice(
        torch.tensor(eig), x, x, x.to(torch.int32), (0, 0, 1, 40, 150),
        min_eig=2, radius=-1)
    cells = got.cells.numpy()
    assert got.seg == 32 and cells.shape == (40, 160)
    np.testing.assert_array_equal(cells[:, :150], np.where(eig < 2, 0, eig))
    blocks = cells.reshape(40, 5, 32)
    np.testing.assert_array_equal(got.seg_v.numpy(), blocks.max(axis=2))
    np.testing.assert_array_equal(
        got.seg_c.numpy(), blocks.argmax(axis=2) + np.arange(0, 160, 32))
    np.testing.assert_array_equal(got.row_v.numpy(), cells.max(axis=1))
    np.testing.assert_array_equal(got.row_c.numpy(), cells.argmax(axis=1))


def test_segment_width_keeps_1080p_in_shared_memory():
    """K4's shared-memory ceiling: the segment width grows with the frame
    (480x640: 32 columns, 768x1280: 64, 1080x1920: 128, 1440x2560: 256,
    2160x3840: 512, 4320x7680: 2048) and never refuses a lattice: past
    every split a row is one segment."""
    for lattice, seg in (((432, 592), 32), ((720, 1232), 64),
                         ((1032, 1872), 128), ((1392, 2512), 256),
                         ((2112, 3792), 512), ((4272, 7632), 2048)):
        assert cuda_select.segment_width(*lattice) == seg
    assert cuda_select.segment_width(40000, 40000) == 65536


def _jax_select(eig, x, y, val, jcfg, replacing, pallas, top_k=None):
    fn = jax.jit(jsd.select_features_from_eig_device,
                 static_argnames=("cfg", "replacing", "top_k"))
    if top_k is None:
        top_k = int(eig.size) if not pallas else 512
    return fn(jnp.asarray(eig), jnp.asarray(x, jnp.float32),
              jnp.asarray(y, jnp.float32), jnp.asarray(val, jnp.int32), jcfg,
              replacing=replacing, top_k=top_k)


@pytest.mark.parametrize("mindist,skip", [(1, 0), (2, 0), (10, 0), (10, 1),
                                          (2, 1), (0, 0)])
def test_stage_b_matches_jax_refill(mindist, skip, monkeypatch):
    """The refill through stage A and stage B equals the JAX package's
    refill through its extraction kernel (interpret mode): x, y, val and
    filled exact."""
    monkeypatch.setenv("PFT_PALLAS_SELECT", "1")
    jcfg = _config(mindist, skip, None)
    cfg = config_from_jax(jcfg)
    eig = _eig(jcfg, seed=20 + mindist)
    x, y, val = _slots(True, seed=5 + mindist)
    jx, jy, jv, jf, jex = _jax_select(eig, x, y, val, jcfg, True, True)
    assert not bool(jex)
    tx, ty, tv, tf, tex = select_features_from_eig_device(
        torch.tensor(eig), *features_from_numpy(x, y, val, device="cpu"), cfg,
        replacing=True)
    assert not bool(tex)
    for got, want in ((tx, jx), (ty, jy), (tv, jv), (tf, jf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tf.any()


@pytest.mark.parametrize("mindist,replacing", [(0, False), (10, False),
                                               (10, True), (1, True)])
def test_stage_b_matches_jax_mis(mindist, replacing, monkeypatch):
    """Initial selection and refill against the JAX MIS route over every
    candidate (never exhausted, so the full greedy)."""
    monkeypatch.delenv("PFT_PALLAS_SELECT", raising=False)
    jcfg = _config(mindist, 0, (30, 17))
    cfg = config_from_jax(jcfg)
    eig = _eig(jcfg, seed=40 + mindist)
    x, y, val = _slots(replacing, seed=9)
    jx, jy, jv, jf, jex = _jax_select(eig, x, y, val, jcfg, replacing, False)
    assert not bool(jex)
    geom = _candidate_grid(cfg, eig.shape)
    tx, ty, tv = features_from_numpy(x, y, val, device="cpu")
    cands = cuda_select.candidate_lattice(
        torch.tensor(eig), tx, ty, tv, geom,
        min_eig=int(cfg.min_eigenvalue),
        radius=premask_radius(cfg, replacing))
    got = cuda_select.greedy_fill(
        cands, tx, ty, tv, geom, min_eig=int(cfg.min_eigenvalue),
        dg=max(0, (mindist - 1) // geom[2]), replacing=replacing)
    for g, want in zip(got, (jx, jy, jv, jf)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,seg", [((768, 1280), 64), ((1440, 2560), 256),
                                       ((2160, 3840), 512)])
@pytest.mark.parametrize("replacing", [False, True])
def test_large_frames_match_jax(shape, seg, replacing, monkeypatch):
    """Frames whose lattices take 64-, 256- and 512-column segments
    (2160x3840: 2112 x 3792 cells, whose box bitmap lies in device memory
    on the card), initial selection and refill with the pre-mask: stage A
    equals the dilation route and JAX's candidate map, and the selection
    equals JAX's: the refill's through its extraction kernel (interpret
    mode), the initial one's through its default top-k route, which does
    not run dry here."""
    if replacing:
        monkeypatch.setenv("PFT_PALLAS_SELECT", "1")
    else:
        monkeypatch.delenv("PFT_PALLAS_SELECT", raising=False)
    jcfg = create_config()
    cfg = config_from_jax(jcfg)
    eig = _eig(jcfg, seed=shape[0], shape=shape)
    x, y, val = _slots(replacing, seed=shape[1], shape=shape)
    tx, ty, tv = features_from_numpy(x, y, val, device="cpu")
    geom = _candidate_grid(cfg, eig.shape)
    cands = cuda_select.candidate_lattice(
        torch.tensor(eig), tx, ty, tv, geom,
        min_eig=int(cfg.min_eigenvalue),
        radius=premask_radius(cfg, replacing))
    assert cands.seg == seg
    lattice = cands.cells[:, :geom[4]].numpy()
    old, _ = candidate_map(torch.tensor(eig), tx, ty, tv, cfg,
                           replacing=replacing)
    np.testing.assert_array_equal(lattice, old.numpy())
    np.testing.assert_array_equal(
        lattice, _jax_candidate_map(eig, x, y, val, jcfg, replacing))
    jx, jy, jv, jf, jex = _jax_select(eig, x, y, val, jcfg, replacing,
                                      replacing, top_k=jsd.DEFAULT_TOP_K)
    assert not bool(jex)
    got = select_features_from_eig_device(torch.tensor(eig), tx, ty, tv,
                                          cfg, replacing=replacing)
    for g, want in zip(got[:4], (jx, jy, jv, jf)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert bool(got[3].any())


def test_empty_lattice_fills_nothing():
    """Borders that leave no lattice: both packages return every free slot
    empty and fill nothing."""
    jcfg = create_config().replace(borderx=70, bordery=50)
    cfg = config_from_jax(jcfg)
    eig = _eig(jcfg, seed=1)
    assert 0 in _candidate_grid(cfg, eig.shape)[3:]
    x, y, val = _slots(True, seed=2)
    jx, jy, jv, jf, _ = _jax_select(eig, x, y, val, jcfg, True, False)
    got = select_features_from_eig_device(
        torch.tensor(eig), *features_from_numpy(x, y, val, device="cpu"), cfg,
        replacing=True)
    for g, want in zip(got[:4], (jx, jy, jv, jf)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert not got[3].any() and (got[2].numpy()[val < 0] == -1).all()
