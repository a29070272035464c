"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test is marked ``gpu`` and skips where torch sees no CUDA
device; on a GPU machine run them (no JAX needed) with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bars: K1, K3 and K4 bit-equal; K2 and K6 statuses and iterations equal
and positions (K6: and warps) bit-equal (the kernels round and sum in
their plain versions' order). Inputs are small seeded numpy images."""

import numpy as np
import pytest
import torch

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.ops import (cuda_affine, cuda_eig, cuda_lk,
                                          cuda_pyramid, cuda_select)
from pyfeaturetrack_tpu_torch.ops.interp import gather_window
from pyfeaturetrack_tpu_torch.utils import cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _texture(h, w, seed):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, (h + 4, w + 4))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for axis in (0, 1):
        img = sum(c * np.roll(img, s - 2, axis=axis) for s, c in enumerate(k))
    return np.floor(img[2:-2, 2:-2]).astype(np.float32)


def _plain(fn, *args, **kw):
    with cuda.reference_path():
        return fn(*args, **kw)


@pytest.mark.parametrize("shape", [(120, 160), (97, 130), (480, 640)])
@pytest.mark.parametrize("search_range", [15, 60])
def test_pyramid_level_bit_equal(dev, shape, search_range):
    cfg = tpft.create_config(search_range=search_range)
    taps = cuda_pyramid.level_taps(cfg)
    cur = torch.tensor(_texture(*shape, seed=shape[0]), device=dev)
    for level in range(cfg.nPyramidLevels):
        args = (cur, taps, level == 0, level < cfg.nPyramidLevels - 1)
        got = cuda_pyramid.pyramid_level(*args)
        want = _plain(cuda_pyramid.pyramid_level, *args)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
        if got[3] is None:
            break
        cur = got[3]


@pytest.mark.parametrize("win", [(7, 7), (5, 9), (3, 3)])
def test_min_eig_bit_equal(dev, win):
    cfg = tpft.create_config()
    pyr = tpft.build_track_pyramids(
        torch.tensor(_texture(120, 160, seed=3), device=dev), cfg)
    got = cuda_eig.min_eig_map(pyr.gradx[0], pyr.grady[0], *win)
    assert got.dtype == torch.int32
    assert torch.equal(got, _plain(cuda_eig.min_eig_map, pyr.gradx[0],
                                   pyr.grady[0], *win))


@pytest.mark.parametrize("dg,budget,min_eig,seed", [
    (3, 10, 30, 0), (0, 5, 30, 1), (9, 200, 900, 2), (1, 64, 1, 3),
    (2, 0, 1, 4), (9, 1000, 1, 5),
])
def test_extract_exact(dev, dg, budget, min_eig, seed):
    rng = np.random.default_rng(seed)
    cand = torch.tensor(rng.integers(0, 1000, (50, 700)).astype(np.int32),
                        device=dev)
    b = torch.tensor([budget], dtype=torch.int32, device=dev)
    before = cand.clone()
    got = cuda_select.greedy_extract(cand, min_eig=min_eig, dg=dg, budget=b,
                                     max_out=1000)
    want = _plain(cuda_select.greedy_extract, cand, min_eig=min_eig, dg=dg,
                  budget=b, max_out=1000)
    assert torch.equal(cand, before)          # the kernel works on a copy
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("overrides", [
    {}, {"lighting_insensitive": True}, {"min_displacement": 0.0},
    {"step_factor": 0.0}, {"window_width": 3, "window_height": 5},
    {"window_width": 11, "window_height": 11},
])
def test_lk_level_bit_equal(dev, overrides):
    cfg = tpft.create_config(**overrides)
    h, w = 120, 160
    base = _texture(h + 8, w + 8, seed=9)
    p1 = tpft.build_track_pyramids(torch.tensor(base[:h, :w], device=dev),
                                   cfg)
    p2 = tpft.build_track_pyramids(
        torch.tensor(np.ascontiguousarray(base[1:h + 1, 2:w + 2]) * 0.8 + 20,
                     device=dev), cfg)
    rng = np.random.default_rng(1)
    n = 300
    x = torch.tensor(rng.uniform(-3, w + 3, n), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.uniform(-3, h + 3, n), dtype=torch.float32,
                     device=dev)
    act = torch.tensor(rng.uniform(size=n) > 0.1, device=dev)
    args = (x, y, x, y, p1.img[0], p1.gradx[0], p1.grady[0], p2.img[0],
            p2.gradx[0], p2.grady[0], cfg, act)
    got = cuda_lk.lk_level(*args)
    want = _plain(cuda_lk.lk_level, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_lk_level_rejects_windows_beyond_the_warp_layout(dev):
    cfg = tpft.create_config(window_width=13, window_height=13)
    img = torch.zeros((64, 64), device=dev)
    x = torch.full((4,), 30.0, device=dev)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        cuda_lk.lk_level(x, x, x, x, img, img, img, img, img, img, cfg, act)


def test_sequence_on_card_equals_plain_on_cpu(dev):
    base = _texture(120, 160, seed=13)
    frames = [np.roll(base, 4 * i, axis=1) for i in range(8)]
    cfg = tpft.create_config(mindist=8)
    counts = {m: m.launches for m in (cuda_pyramid, cuda_lk, cuda_eig,
                                       cuda_select)}
    g = tpft.track_sequence_device(frames, cfg=cfg, n_features=40,
                                   device="cuda")
    c = tpft.track_sequence_device(frames, cfg=cfg, n_features=40,
                                   device="cpu")
    for m, before in counts.items():
        assert m.launches > before
    for a, b in zip(g, c):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("win", [(15, 15), (11, 17), (3, 3)])
def test_affine_track_bit_equal(dev, mode, win):
    """K6 against its plain version: lanes near and across the edges
    (warp OOB), a flat block (SMALL_DET), fresh noise (LARGE_RESIDUE),
    starts off the optimum (drift), scaled warps and unchecked lanes."""
    ww, wh = win
    cfg = tpft.create_config(affineConsistencyCheck=mode,
                             affine_window_width=ww, affine_window_height=wh)
    h, w = 120, 160
    base = _texture(h + 8, w + 8, seed=21)
    a = base[:h, :w].copy()
    b = np.ascontiguousarray(base[1:h + 1, 2:w + 2])
    a[70:110, 10:60] = b[70:110, 10:60] = 90.0
    b[10:50, 100:150] = np.random.default_rng(2).uniform(0, 255, (40, 50))
    p1 = tpft.build_track_pyramids(torch.tensor(a, device=dev), cfg)
    p2 = tpft.build_track_pyramids(torch.tensor(b, device=dev), cfg)
    rng = np.random.default_rng(mode)
    n = 300
    x = torch.tensor(rng.uniform(-2, w + 2, n), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.uniform(-2, h + 2, n), dtype=torch.float32,
                     device=dev)
    tmpl = gather_window(p1.img[0], x, y, ww // 2, wh // 2).contiguous()
    off = torch.tensor(rng.uniform(-2.5, 0.5, (2, n)), dtype=torch.float32,
                       device=dev)
    A0 = torch.eye(2, device=dev).repeat(n, 1, 1) * torch.tensor(
        rng.choice([1.0, 1.0, 1.05, 2.5], n), dtype=torch.float32,
        device=dev)[:, None, None]
    check = torch.tensor(rng.uniform(size=n) > 0.1, device=dev)
    args = (tmpl, p2.img[0], p2.gradx[0], p2.grady[0], x - 2.0 + off[0],
            y - 1.0 + off[1], A0.contiguous(), check, cfg)
    got = cuda_affine.affine_track_batch(*args)
    want = _plain(cuda_affine.affine_track_batch, *args)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    codes = set(got[3][check].tolist())
    assert {0, -4}.issubset(codes), codes


@pytest.mark.parametrize("mode", [0, 2])
def test_affine_sequence_on_card_equals_plain_on_cpu(dev, mode):
    base = _texture(120, 160, seed=17)
    frames = [np.roll(base, 3 * i, axis=1) for i in range(6)]
    cfg = tpft.create_config(mindist=8, affineConsistencyCheck=mode)
    before = cuda_affine.launches
    g = tpft.track_sequence_device(frames, cfg=cfg, n_features=30,
                                   device="cuda")
    c = tpft.track_sequence_device(frames, cfg=cfg, n_features=30,
                                   device="cpu")
    assert cuda_affine.launches > before
    for a, b in zip(g, c):
        np.testing.assert_array_equal(a, b)
