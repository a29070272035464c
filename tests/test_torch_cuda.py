"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test is marked ``gpu`` and skips where torch sees no CUDA
device; on a GPU machine run them (no JAX needed) with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bars: K1, K3 (standalone, inside K1's level-0 launch, and K1's eig-only
launch), K4 (both stages), K5 (both entries) and K9 (N up
to 65,536) bit-equal; K2
(per level and per pyramidal track call), K6 and K8 (every start mode)
statuses and iterations equal and positions (K6: and warps; K8: the flow
and disparity maps, whole levels and row bands) bit-equal (the kernels round and sum in their plain
versions' order); the affine stage (K6's stage kernel) bit-equal in the
feature list and all eight AffineState fields. Inputs are small seeded
numpy images, but for the wide and tall K4 lattices, the deep K2
pyramids, K5 on 480x640 and 1080x1920 lattices and K8 at 480x640."""

import numpy as np
import pytest
import torch

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.ops import (cuda_affine, cuda_eig, cuda_lk,
                                          cuda_lk_dense, cuda_pyramid,
                                          cuda_select, cuda_suppress,
                                          cuda_window_terms)
from pyfeaturetrack_tpu_torch.ops.interp import gather_window
from pyfeaturetrack_tpu_torch.ops.select_device import (_candidate_grid,
                                                        premask_radius)
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


@pytest.mark.parametrize("shape", [(481, 643), (120, 160), (60, 700)])
@pytest.mark.parametrize("levels,sub", [(1, 4), (2, 4), (3, 2), (4, 2),
                                        (4, 4)])
@pytest.mark.parametrize("overrides", [
    {}, {"window_width": 13, "window_height": 13},
    {"affineConsistencyCheck": 2}])
def test_pyramid_build_bit_equal(dev, shape, levels, sub, overrides):
    """K1's whole-pyramid entry against the plain level composition: an odd
    frame size, a frame whose coarse levels are narrower than a tile, the
    default, 13x13-window (pre-smooth radius 3) and config-3 sigmas; at
    most two launches per build."""
    cfg = tpft.create_config(nPyramidLevels=levels, subsampling=sub,
                             **overrides)
    img = torch.tensor(_texture(*shape, seed=shape[1]), device=dev)
    before = cuda_pyramid.launches
    got = tpft.build_track_pyramids(img, cfg)
    assert cuda_pyramid.launches - before == min(levels, 2)
    want = _plain(tpft.build_track_pyramids, img, cfg)
    for a, b in zip(got, want):
        assert len(a) == len(b) == levels
        for x, y in zip(a, b):
            assert x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("win", [(7, 7), (5, 9), (3, 3)])
def test_min_eig_bit_equal(dev, win):
    cfg = tpft.create_config()
    pyr = tpft.build_track_pyramids(
        torch.tensor(_texture(120, 160, seed=3), device=dev), cfg)
    got = cuda_eig.min_eig_map(pyr.gradx[0], pyr.grady[0], *win)
    assert got.dtype == torch.int32
    assert torch.equal(got, _plain(cuda_eig.min_eig_map, pyr.gradx[0],
                                   pyr.grady[0], *win))


# Frames for K3 inside K1's level-0 launch: the headline frame, an odd
# size, one narrower than two tiles, and one smaller than a 51x51 window
# plus the border (its map is all zero).
EIG_SHAPES = [(480, 640), (481, 643), (480, 70), (40, 45)]
EIG_WINDOWS = [(3, 3), (7, 7), (13, 13), (15, 15), (51, 51), (5, 9),
               (71, 71), (9, 97), (97, 97)]


@pytest.mark.parametrize("shape", EIG_SHAPES)
@pytest.mark.parametrize("win", EIG_WINDOWS)
@pytest.mark.parametrize("levels,sub", [(1, 4), (2, 4), (3, 2), (4, 2)])
def test_fused_eig_bit_equal(dev, shape, win, levels, sub):
    """The build's level-0 launch with K3's map: the map bit-equal to K3's
    standalone entry on the gradients the build stored and to the plain
    version; every level bit-equal to the build without the map; the same
    launches, one of them counted as carrying the map, and no K3 launch.
    Every window at its own sigmas: 3x3's one-tap pre-smooth, and 71x71,
    9x97 and 97x97 (the widest the taps allow), whose margins take a
    smaller tile than the full one."""
    cfg = tpft.create_config(nPyramidLevels=levels, subsampling=sub,
                             window_width=win[0], window_height=win[1])
    taps = cuda_pyramid.level_taps(cfg)
    img = torch.tensor(_texture(*shape, seed=shape[1] + win[0]), device=dev)
    k1, k1_eig, k3 = (cuda_pyramid.launches, cuda_pyramid.eig_launches,
                      cuda_eig.launches)
    *got, eig = cuda_pyramid.pyramid_build(img, taps, levels, eig_window=win)
    assert cuda_pyramid.launches - k1 == min(levels, 2)
    assert cuda_pyramid.eig_launches - k1_eig == 1
    assert cuda_eig.launches == k3
    assert eig.dtype == torch.int32 and eig.shape == img.shape
    plain = cuda_pyramid.pyramid_build(img, taps, levels)
    for a, b in zip(got, plain):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(eig, cuda_eig.min_eig_map(got[1][0], got[2][0], *win))
    *pgot, peig = _plain(cuda_pyramid.pyramid_build, img, taps, levels,
                         eig_window=win)
    assert torch.equal(eig, peig)
    assert torch.equal(peig, cuda_eig.min_eig_reference(pgot[1][0],
                                                        pgot[2][0], *win))
    if shape[0] < win[1] or shape[1] < win[0]:
        assert not eig.any()


@pytest.mark.parametrize("shape", EIG_SHAPES)
@pytest.mark.parametrize("win", EIG_WINDOWS)
@pytest.mark.parametrize("smooth", [True, False])
def test_eig_only_entry_bit_equal(dev, shape, win, smooth):
    """The eig-only level-0 launch: bit-equal to the plain version and to
    K3's standalone entry on the level's gradients; it writes nothing but
    the map (a guarded output buffer and the frame stay as they were)."""
    cfg = tpft.create_config(window_width=win[0], window_height=win[1])
    taps = cuda_pyramid.level_taps(cfg)
    img = torch.tensor(_texture(*shape, seed=shape[0] + win[1]), device=dev)
    before = img.clone()
    k1, k3 = cuda_pyramid.launches, cuda_eig.launches
    got = cuda_pyramid.level0_eig(img, taps, smooth, *win)
    assert cuda_pyramid.launches - k1 == 1
    assert cuda_eig.launches == k3
    assert torch.equal(got, _plain(cuda_pyramid.level0_eig, img, taps,
                                   smooth, *win))
    _, gx, gy, _ = cuda_pyramid.pyramid_level(img, taps, smooth, False)
    assert torch.equal(got, cuda_eig.min_eig_map(gx, gy, *win))
    # the C entry into the middle of a guarded buffer
    h, w = shape
    guard = torch.full((h * w + 2048,), -7, dtype=torch.int32, device=dev)
    out = guard[1024:1024 + h * w]
    fn = cuda.function("pft_pyramid_eig",
                       [cuda.c_ptr] * 2 + [cuda.c_int] * 3
                       + [cuda.c_ptr, cuda.c_int] * 3 + [cuda.c_int] * 2
                       + [cuda.c_ptr])
    taps_c = []
    for k, used in zip(taps.rev[:3], (smooth, True, True)):
        taps_c += [k.ctypes.data, k.shape[0]] if used else [None, 0]
    cuda.check(fn(img.data_ptr(), out.data_ptr(), h, w, int(smooth), *taps_c,
                  *win, cuda.stream_ptr(dev)), "pft_pyramid_eig")
    torch.cuda.synchronize()
    assert torch.equal(out.view(h, w), got)
    assert (guard[:1024] == -7).all() and (guard[1024 + h * w:] == -7).all()
    assert torch.equal(img, before)


def test_eig_tile_refuses_what_it_cannot_hold(dev):
    """Wide gradient taps and a 97x97 window (the pre-smooth's halo, the
    window's margin and the gradient radius together) do not fit even a
    one-pixel tile: the build raises, with no other route behind it."""
    cfg = tpft.create_config(grad_sigma=8.0, window_width=97,
                             window_height=97)
    taps = cuda_pyramid.level_taps(cfg)
    img = torch.tensor(_texture(120, 160, seed=5), device=dev)
    k3 = cuda_eig.launches
    with pytest.raises(RuntimeError, match="pft_pyramid_build"):
        cuda_pyramid.pyramid_build(img, taps, 2, eig_window=(97, 97))
    with pytest.raises(RuntimeError, match="pft_pyramid_eig"):
        cuda_pyramid.level0_eig(img, taps, True, 97, 97)
    assert cuda_eig.launches == k3


@pytest.mark.parametrize("smooth", [True, False])
def test_device_route_takes_the_map_from_k1(dev, smooth):
    """track_sequence_device launches no standalone K3: one level-0 launch
    per frame carries the map (the build's with smoothBeforeSelecting, an
    eig-only one without), and the table equals the plain run's."""
    cfg = tpft.create_config(smoothBeforeSelecting=smooth)
    base = _texture(140, 190, seed=41)
    frames = [np.ascontiguousarray(base[i:i + 120, 2 * i:2 * i + 160])
              for i in range(4)]
    k1, k1_eig, k3 = (cuda_pyramid.launches, cuda_pyramid.eig_launches,
                      cuda_eig.launches)
    got = tpft.track_sequence_device(frames, cfg=cfg, n_features=60)
    assert cuda_eig.launches == k3
    assert cuda_pyramid.eig_launches - k1_eig == len(frames)
    assert cuda_pyramid.launches - k1 == len(frames) * (
        2 if smooth else 3)
    want = _plain(tpft.track_sequence_device, frames, cfg=cfg, n_features=60)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


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


def _selection_inputs(dev, cfg, h, w, n, seed):
    """An int32 eig map of a seeded texture and n feature slots: about
    three quarters kept (val >= 0), among them slots on and next to every
    edge of the frame, the rest lost."""
    pyr = tpft.build_track_pyramids(
        torch.tensor(_texture(h, w, seed=seed), device=dev), cfg)
    eig = cuda_eig.min_eig_map(pyr.gradx[0], pyr.grady[0], cfg.window_width,
                               cfg.window_height)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, w - 1, n)
    y = rng.uniform(0, h - 1, n)
    x[:6] = [0.0, w - 1.0, 0.4, w - 1.3, 3.0, -0.6]
    y[:6] = [2.0, h - 1.0, 0.0, h - 2.5, h - 4.0, 40.0]
    val = np.where(rng.uniform(size=n) < 0.25, -1, 500)
    val[:6] = 500
    x, y, v = (torch.tensor(a, dtype=t, device=dev) for a, t in
               ((x, torch.float32), (y, torch.float32), (val, torch.int32)))
    return eig, x, y, v


@pytest.mark.parametrize("mindist", [0, 1, 2, 10])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("replacing", [False, True])
def test_candidate_lattice_bit_equal(dev, mindist, skip, replacing):
    """K4 stage A against its plain version: the lattice and its segment
    and row maxima, with kept features on and near the frame's edges and
    borders larger than the window."""
    cfg = tpft.create_config(mindist=mindist, nSkippedPixels=skip).replace(
        borderx=30, bordery=17)
    eig, x, y, v = _selection_inputs(dev, cfg, 120, 160, 200, seed=mindist)
    geom = _candidate_grid(cfg, eig.shape)
    kw = dict(min_eig=int(cfg.min_eigenvalue),
              radius=premask_radius(cfg, replacing))
    before = cuda_select.launches
    got = cuda_select.candidate_lattice(eig, x, y, v, geom, **kw)
    assert cuda_select.launches == before + 1
    want = _plain(cuda_select.candidate_lattice, eig, x, y, v, geom, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("mindist", [0, 1, 10, 25])
@pytest.mark.parametrize("replacing", [False, True])
def test_select_from_eig_bit_equal(dev, mindist, replacing):
    """K4 stage B (with stage A before it) against greedy_extract_reference
    + fill_slots: x, y, val and filled; two launches per selection."""
    cfg = tpft.create_config(mindist=mindist)
    eig, x, y, v = _selection_inputs(dev, cfg, 120, 160, 150, seed=7)
    geom = _candidate_grid(cfg, eig.shape)
    kw = dict(min_eig=int(cfg.min_eigenvalue),
              radius=premask_radius(cfg, replacing),
              dg=max(0, (mindist - 1) // geom[2]), replacing=replacing)
    before = cuda_select.launches
    got = cuda_select.select_from_eig(eig, x, y, v, geom, **kw)
    assert cuda_select.launches == before + 2
    want = _plain(cuda_select.select_from_eig, eig, x, y, v, geom, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert replacing or bool(got[3].any())


@pytest.mark.parametrize("shape", [(64, 41100), (27900, 64)])
@pytest.mark.parametrize("replacing", [False, True])
def test_select_from_eig_wide_and_tall_lattices(dev, shape, replacing):
    """K4 beyond its earlier caps: a lattice wider than 40,960 columns
    (stage A's pre-mask in device memory) and one of more than 27,803 rows
    (stage B's row maxima in device memory), initial selection and refill,
    both stages equal to the plain versions."""
    cfg = tpft.create_config()
    eig, x, y, v = _selection_inputs(dev, cfg, *shape, 400, seed=shape[0])
    geom = _candidate_grid(cfg, eig.shape)
    min_eig = int(cfg.min_eigenvalue)
    radius = premask_radius(cfg, replacing)
    got = cuda_select.candidate_lattice(eig, x, y, v, geom, min_eig=min_eig,
                                        radius=radius)
    want = _plain(cuda_select.candidate_lattice, eig, x, y, v, geom,
                  min_eig=min_eig, radius=radius)
    for a, b in zip(got, want):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    kw = dict(min_eig=min_eig, dg=(cfg.mindist - 1) // geom[2],
              replacing=replacing)
    filled = cuda_select.greedy_fill(got, x, y, v, geom, **kw)
    for a, b in zip(filled, _plain(cuda_select.greedy_fill, got, x, y, v,
                                   geom, **kw)):
        assert torch.equal(a, b)
    assert bool(filled[3].any())


def test_select_from_eig_1080p(dev):
    """A 1080x1920 initial selection (a 1032 x 1872 lattice: stage B's
    segment maxima at 128 columns) equals the plain version's."""
    cfg = tpft.create_config()
    eig, x, y, v = _selection_inputs(dev, cfg, 1080, 1920, 400, seed=11)
    geom = _candidate_grid(cfg, eig.shape)
    assert cuda_select.segment_width(geom[3], geom[4]) == 128
    kw = dict(min_eig=int(cfg.min_eigenvalue), radius=-1,
              dg=(cfg.mindist - 1) // geom[2], replacing=False)
    got = cuda_select.select_from_eig(eig, x, y, v, geom, **kw)
    want = _plain(cuda_select.select_from_eig, eig, x, y, v, geom, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[3].all())


@pytest.mark.parametrize("shape,seg", [((768, 1280), 64), ((1440, 2560), 256),
                                       ((2160, 3840), 512), ((2880, 5120), 1024),
                                       ((4320, 7680), 2048)])
@pytest.mark.parametrize("replacing", [False, True])
def test_select_from_eig_large_frames(dev, shape, seg, replacing):
    """Both stages at the 64- to 2048-column segment widths (2048: the
    width read at run time), initial selection and refill with the
    pre-mask (from 1080x1920 up the box bitmap lies in device memory):
    lattice, maxima and slots equal the plain versions'."""
    cfg = tpft.create_config()
    eig, x, y, v = _selection_inputs(dev, cfg, *shape, 400, seed=shape[0])
    geom = _candidate_grid(cfg, eig.shape)
    min_eig = int(cfg.min_eigenvalue)
    radius = premask_radius(cfg, replacing)
    got = cuda_select.candidate_lattice(eig, x, y, v, geom, min_eig=min_eig,
                                        radius=radius)
    assert got.seg == seg
    want = _plain(cuda_select.candidate_lattice, eig, x, y, v, geom,
                  min_eig=min_eig, radius=radius)
    for a, b in zip(got, want):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    kw = dict(min_eig=min_eig, dg=(cfg.mindist - 1) // geom[2],
              replacing=replacing)
    filled = cuda_select.greedy_fill(got, x, y, v, geom, **kw)
    for a, b in zip(filled, _plain(cuda_select.greedy_fill, got, x, y, v,
                                   geom, **kw)):
        assert torch.equal(a, b)
    assert bool(filled[3].any())


@pytest.mark.parametrize("levels,sub", [(1, 4), (3, 2), (4, 2)])
@pytest.mark.parametrize("li", [False, True])
def test_track_pyramid_guided_bit_equal(dev, levels, sub, li):
    """K2 with guided starts (x_init/y_init 20-40 px from the anchors)
    against the plain level loop with the same starts, one launch per
    call, counted as guided; starts at the anchors give the start-free
    call's bits."""
    cfg = tpft.create_config(nPyramidLevels=levels, subsampling=sub,
                             lighting_insensitive=li)
    h, w = 192, 256
    base = _texture(h + 40, w + 40, seed=23)
    a = base[:h, :w].copy()
    b = np.ascontiguousarray(base[4:h + 4, 30:w + 30])
    p1, p2 = (tpft.build_track_pyramids(torch.tensor(
        f.astype(np.float32), device=dev), cfg) for f in (a, b))
    rng = np.random.default_rng(levels + sub)
    n = 300
    x = rng.uniform(-3, w + 3, n)
    y = rng.uniform(-3, h + 3, n)
    xi = x - 30.0 + rng.uniform(-2, 2, n)
    yi = y - 4.0 + rng.uniform(-2, 2, n)
    val = np.where(rng.uniform(size=n) < 0.15, -1, 0)
    x, y, xi, yi = (torch.tensor(t, dtype=torch.float32, device=dev)
                    for t in (x, y, xi, yi))
    val = torch.tensor(val, dtype=torch.int32, device=dev)
    before, guided = cuda_lk.launches, cuda_lk.guided_launches
    got = cuda_lk.track_pyramid(p1, p2, x, y, val, cfg, xi, yi)
    assert cuda_lk.launches == before + 1
    assert cuda_lk.guided_launches == guided + 1
    want = _plain(cuda_lk.track_pyramid, p1, p2, x, y, val, cfg, xi, yi)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    assert int((got[2] == 0).sum()) > 20
    same = cuda_lk.track_pyramid(p1, p2, x, y, val, cfg, x.clone(), y.clone())
    free = cuda_lk.track_pyramid(p1, p2, x, y, val, cfg)
    for a_, b_ in zip(same, free):
        assert torch.equal(a_, b_)


def test_bundle_adjust_deterministic_on_card(dev):
    """The BA's segmented sums give the same bits on every run on the card
    (index_add_'s atomics would not), and agree with the CPU run."""
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.sfm.ba import make_problem
    rng = np.random.default_rng(0)
    C, L = 6, 300
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Rs = sfm.so3_exp(torch.tensor(0.02 * rng.standard_normal((C, 3)),
                                  dtype=torch.float32))
    ts = torch.tensor([[-0.2 * i, 0.0, 0.0] for i in range(C)])
    X = torch.tensor(np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                               rng.uniform(5, 10, L)], -1), dtype=torch.float32)
    uv, _ = sfm.project(K, Rs[:, None], ts[:, None], X[None])
    cam = np.repeat(np.arange(C), L)
    pt = np.tile(np.arange(L), C)
    X0 = X + 0.05 * torch.tensor(rng.standard_normal((L, 3)),
                                 dtype=torch.float32)
    out = []
    for d in (dev, dev, torch.device("cpu")):
        prob = make_problem(K, cam, pt, uv.reshape(-1, 2), np.ones(C * L),
                            device=d)
        out.append([o.cpu() for o in sfm.bundle_adjust(prob, Rs, ts, X0,
                                                        n_iters=4)])
    for a_, b_ in zip(out[0], out[1]):
        assert torch.equal(a_, b_)
    np.testing.assert_allclose(out[0][1].numpy(), out[2][1].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("levels,sub", [(1, 4), (2, 4), (3, 2), (4, 2)])
@pytest.mark.parametrize("overrides", [
    {}, {"lighting_insensitive": True},
    {"window_width": 13, "window_height": 13}, {"max_iterations": 3},
    {"window_width": 17, "window_height": 17},
    {"window_width": 21, "window_height": 21, "lighting_insensitive": True}])
def test_track_pyramid_bit_equal(dev, levels, sub, overrides):
    """K2's pyramidal entry against the plain level loop: lanes tracked,
    broken at a coarse level (flat block, edges), out of view, and dead
    (val < 0, passed through); one launch per call."""
    cfg = tpft.create_config(nPyramidLevels=levels, subsampling=sub,
                             **overrides)
    # windows above 15x15 need a larger frame for their coarsest level
    h, w = (192, 256) if cfg.window_width <= 15 else (384, 512)
    li = cfg.lighting_insensitive
    base = _texture(h + 8, w + 8, seed=19)
    a = base[:h, :w].copy()
    b = np.ascontiguousarray(base[1:h + 1, 2:w + 2]) * (0.8 if li else 1.0) \
        + (20.0 if li else 0.0)
    a[60:110, 20:90] = b[60:110, 20:90] = 90.0
    p1, p2 = (tpft.build_track_pyramids(torch.tensor(
        f.astype(np.float32), device=dev), cfg) for f in (a, b))
    rng = np.random.default_rng(levels * 10 + sub)
    n = 400
    x = rng.uniform(-3, w + 3, n)
    y = rng.uniform(-3, h + 3, n)
    val = np.where(rng.uniform(size=n) < 0.15, -1, 0)
    x, y = (torch.tensor(t, dtype=torch.float32, device=dev) for t in (x, y))
    val = torch.tensor(val, dtype=torch.int32, device=dev)
    before = cuda_lk.launches
    got = cuda_lk.track_pyramid(p1, p2, x, y, val, cfg)
    assert cuda_lk.launches == before + 1
    want = _plain(cuda_lk.track_pyramid, p1, p2, x, y, val, cfg)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    dead = val < 0
    assert torch.equal(got[0][dead], x[dead]) and bool((got[2][dead] < 0).all())
    codes = set(got[2][~dead].tolist())
    assert -4 in codes and codes & {0, -3, -5}


@pytest.mark.parametrize("overrides", [
    {}, {"lighting_insensitive": True}, {"min_displacement": 0.0},
    {"step_factor": 0.0}, {"window_width": 3, "window_height": 5},
    {"window_width": 11, "window_height": 11},
    {"window_width": 13, "window_height": 13},
    {"window_width": 15, "window_height": 15},
    {"window_width": 17, "window_height": 17},
    {"window_width": 25, "window_height": 25},
    {"window_width": 31, "window_height": 31, "lighting_insensitive": True},
    {"window_width": 51, "window_height": 51},
    {"window_width": 15, "window_height": 19},
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


@pytest.mark.parametrize("levels,sub,shape", [(9, 2, (1024, 1536)),
                                              (12, 2, (4096, 4096)),
                                              (40, 1, (64, 80))])
def test_track_pyramid_deep_pyramids(dev, levels, sub, shape):
    """K2 at 9 and 12 levels (subsampling 2) and at 40 (subsampling 1: the
    level table in device memory) against its plain level loop."""
    cfg = tpft.create_config(nPyramidLevels=levels, subsampling=sub)
    h, w = shape
    base = _texture(h + 4, w + 4, seed=levels)
    p1, p2 = (tpft.build_track_pyramids(torch.tensor(
        np.ascontiguousarray(f), device=dev), cfg)
        for f in (base[:h, :w], base[1:h + 1, 2:w + 2]))
    rng = np.random.default_rng(levels)
    n = 300
    x, y = (torch.tensor(rng.uniform(0, e, n), dtype=torch.float32,
                         device=dev) for e in (w, h))
    val = torch.tensor(np.where(rng.uniform(size=n) < 0.1, -1, 0),
                       dtype=torch.int32, device=dev)
    before = cuda_lk.launches
    got = cuda_lk.track_pyramid(p1, p2, x, y, val, cfg)
    assert cuda_lk.launches == before + 1
    want = _plain(cuda_lk.track_pyramid, p1, p2, x, y, val, cfg)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)


def test_kitti_frame_with_2000_lanes_bit_equal(dev):
    """The visual odometry cell's shapes: K1 with K3's map, K2 and K4's
    refill on 376x1241 frames (levels of 1241, 620, 310 and 155 columns)
    with 2000 lanes, through the first selection, an eager step and a
    2-frame chain of frames on the card (the captured graph): pyramids,
    gradients and every row equal the plain versions' bit for bit."""
    from pyfeaturetrack_tpu_torch.models.device_sequence import (
        select_step_device, sequence_chain_device, sequence_step_device)
    cfg = tpft.create_config(nPyramidLevels=4, subsampling=2).replace(
        sequentialMode=True)
    base = _texture(420, 1300, seed=26)
    frames = [torch.as_tensor(np.ascontiguousarray(
        base[4 * i:4 * i + 376, 9 * i:9 * i + 1241]), device=dev)
        for i in range(6)]

    def run():
        pyr, x, y, val, _, _ = select_step_device(frames[0], cfg, 2000)
        rows = [(x, y, val)]
        pyr, x, y, val, _, _, _ = sequence_step_device(
            pyr, frames[1], x, y, val, cfg, True)
        rows.append((x, y, val))
        for i in (2, 4):
            pyr, hist, (x, y, val), _, _, _ = sequence_chain_device(
                pyr, (frames[i], frames[i + 1]), x, y, val, cfg, True)
            rows += [tuple(h[j] for h in hist) for j in range(2)]
        return pyr, rows

    counts = {m: m.launches for m in (cuda_pyramid, cuda_lk, cuda_select)}
    got = run()
    for m, before in counts.items():
        assert m.launches > before
    want = _plain(run)
    for a, b in zip(got[0], want[0]):
        assert len(a) == 4 and [t.shape[-1] for t in a] == [1241, 620, 310,
                                                            155]
        for la, lb in zip(a, b):
            assert torch.equal(la, lb)
    for ra, rb in zip(got[1], want[1]):
        for a, b in zip(ra, rb):
            assert a.shape == (2000,) and torch.equal(a, b)
    first, last = got[1][0][2], got[1][-1][2]
    assert int((first >= 0).sum()) > 1000
    assert bool((last == 0).any()) and bool((last > 0).any())


def test_sequence_on_card_equals_plain_on_cpu(dev):
    base = _texture(120, 160, seed=13)
    frames = [np.roll(base, 4 * i, axis=1) for i in range(8)]
    cfg = tpft.create_config(mindist=8)
    counts = {m: m.launches for m in (cuda_pyramid, cuda_lk, cuda_select)}
    k3_in_k1, k3 = cuda_pyramid.eig_launches, cuda_eig.launches
    g = tpft.track_sequence_device(frames, cfg=cfg, n_features=40,
                                   device="cuda")
    c = tpft.track_sequence_device(frames, cfg=cfg, n_features=40,
                                   device="cpu")
    for m, before in counts.items():
        assert m.launches > before
    # K3's map comes from K1's level-0 launch, never its standalone entry
    assert cuda_pyramid.eig_launches > k3_in_k1 and cuda_eig.launches == k3
    for a, b in zip(g, c):
        np.testing.assert_array_equal(a, b)


def _level_pair(dev, cfg, h=97, w=130, seed=9, gain=1.0, bias=0.0):
    """Level-0 images of a pair whose content moves by (+2, +1) px, with a
    flat block (SMALL_DET) and fresh noise in frame 2 (LARGE_RESIDUE)."""
    base = _texture(h + 8, w + 8, seed=seed)
    a = base[:h, :w].copy()
    b = np.ascontiguousarray(base[1:h + 1, 2:w + 2]) * gain + bias
    a[40:70, 10:50] = b[40:70, 10:50] = 90.0
    b[10:40, 80:120] = np.random.default_rng(seed).uniform(0, 255, (30, 40))
    p1 = tpft.build_track_pyramids(torch.tensor(a, device=dev), cfg)
    p2 = tpft.build_track_pyramids(torch.tensor(b.astype(np.float32),
                                                device=dev), cfg)
    return (p1.img[0], p1.gradx[0], p1.grady[0], p2.img[0], p2.gradx[0],
            p2.grady[0])


@pytest.mark.parametrize("overrides", [
    {}, {"lighting_insensitive": True}, {"max_iterations": 3},
    {"window_width": 3, "window_height": 5},
    {"window_width": 17, "window_height": 17},
])
@pytest.mark.parametrize("one_d", [False, True])
def test_dense_level_bit_equal(dev, overrides, one_d):
    """K8 in both modes against its plain version: every pixel of a small
    level (rim lanes OOB, a flat block, fresh noise), starts off the true
    motion by up to half a pixel; one launch per call."""
    cfg = tpft.create_config(**overrides)
    li = cfg.lighting_insensitive
    lvl = _level_pair(dev, cfg, gain=0.8 if li else 1.0,
                      bias=20.0 if li else 0.0)
    rng = np.random.default_rng(5)
    h, w = lvl[0].shape
    u = torch.tensor(rng.uniform(-2.5, -1.5, (h, w)), dtype=torch.float32,
                     device=dev)
    v = torch.tensor(rng.uniform(-1.5, -0.5, (h, w)), dtype=torch.float32,
                     device=dev)
    before = cuda_lk_dense.launches
    if one_d:
        got = cuda_lk_dense.dense_level_1d(*lvl, u.neg(), cfg)
        want = _plain(cuda_lk_dense.dense_level_1d, *lvl, u.neg(), cfg)
    else:
        got = cuda_lk_dense.dense_level(*lvl, u, v, cfg)
        want = _plain(cuda_lk_dense.dense_level, *lvl, u, v, cfg)
    assert cuda_lk_dense.launches == before + 1
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert {0, -4}.issubset(set(got[-2].flatten().tolist()))


def _start_case(dev, cfg, h, w, seed=9):
    """Level-0 images of a textured pair whose content moves by (+2, +1) px
    (frame 2 at gain 0.8 and bias 20 under lighting) and coarser maps of
    (h // 4, w // 4): a smooth field near the motion with a block of flows
    of +-20 px that leave the staged frame-2 region."""
    li = cfg.lighting_insensitive
    base = _texture(h + 8, w + 8, seed=seed)
    a = base[:h, :w].copy()
    b = np.ascontiguousarray(base[1:h + 1, 2:w + 2])
    if li:
        b = b * 0.8 + 20.0
    p1, p2 = (tpft.build_track_pyramids(
        torch.tensor(f.astype(np.float32), device=dev), cfg) for f in (a, b))
    lvl = (p1.img[0], p1.gradx[0], p1.grady[0], p2.img[0], p2.gradx[0],
           p2.grady[0])
    rng = np.random.default_rng(seed)
    hc, wc = max(h // 4, 1), max(w // 4, 1)
    uc = -0.5 + 0.1 * rng.standard_normal((hc, wc))
    vc = -0.25 + 0.1 * rng.standard_normal((hc, wc))
    uc[:hc // 3, :wc // 3] = rng.uniform(-5.0, 5.0, (hc // 3, wc // 3))
    vc[:hc // 3, :wc // 3] = rng.uniform(-5.0, 5.0, (hc // 3, wc // 3))
    uc, vc = (torch.tensor(t, dtype=torch.float32, device=dev)
              for t in (uc, vc))
    return lvl, uc, vc


def _dense_equal(got, want, before):
    assert cuda_lk_dense.launches == before + 1
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape,win,overrides", [
    ((480, 640), (7, 7), {}),
    ((480, 640), (7, 7), {"lighting_insensitive": True}),
    ((481, 643), (7, 7), {}),
    ((480, 70), (7, 7), {}),
    ((37, 53), (7, 7), {}),
    ((6, 64), (7, 7), {}),
    ((64, 6), (7, 7), {}),
    ((120, 160), (3, 5), {}),
    ((120, 160), (17, 17), {"lighting_insensitive": True}),
    ((120, 160), (51, 51), {}),
])
@pytest.mark.parametrize("one_d", [False, True])
def test_dense_level_start_modes_bit_equal(dev, shape, win, overrides, one_d):
    """K8 in both modes and every start against its plain version: from
    the coarser maps upsampled x4 (the kernel computes upsample_flow), from
    those maps upsampled by the plain upsample_flow and passed as level
    maps, and (2-D) from zero. Flows of +-20 px in a block of the maps send
    pixels out of the staged frame-2 region. At 6x64 and 64x6 the coarser
    maps are one row or one column high (interp.bilinear's flat indices
    wrap) and every pixel is out of bounds, so the outputs are the starts."""
    h, w = shape
    cfg = tpft.create_config(window_width=win[0], window_height=win[1],
                             **overrides)
    lvl, uc, vc = _start_case(dev, cfg, h, w)
    from pyfeaturetrack_tpu_torch.ops.interp import upsample_flow
    if one_d:
        dc = -uc
        before = cuda_lk_dense.launches
        got = cuda_lk_dense.dense_level_1d_up(*lvl, dc, 4.0, cfg)
        _dense_equal(got, _plain(cuda_lk_dense.dense_level_1d_up, *lvl, dc,
                                 4.0, cfg), before)
        d = upsample_flow(dc, (h, w), 4.0)
        before = cuda_lk_dense.launches
        _dense_equal(cuda_lk_dense.dense_level_1d(*lvl, d, cfg),
                     _plain(cuda_lk_dense.dense_level_1d, *lvl, d, cfg),
                     before)
        assert torch.equal(got[0], cuda_lk_dense.dense_level_1d(*lvl, d,
                                                                cfg)[0])
        return
    before = cuda_lk_dense.launches
    got = cuda_lk_dense.dense_level_up(*lvl, uc, vc, 4.0, cfg)
    _dense_equal(got, _plain(cuda_lk_dense.dense_level_up, *lvl, uc, vc, 4.0,
                             cfg), before)
    u, v = (upsample_flow(t, (h, w), 4.0) for t in (uc, vc))
    before = cuda_lk_dense.launches
    maps = cuda_lk_dense.dense_level(*lvl, u, v, cfg)
    _dense_equal(maps, _plain(cuda_lk_dense.dense_level, *lvl, u, v, cfg),
                 before)
    assert all(torch.equal(a, b) for a, b in zip(got, maps))
    before = cuda_lk_dense.launches
    _dense_equal(cuda_lk_dense.dense_level_up(*lvl, None, None, 4.0, cfg),
                 _plain(cuda_lk_dense.dense_level_up, *lvl, None, None, 4.0,
                        cfg), before)
    if h >= 100:
        assert {0, -4}.issubset(set(got[2].flatten().tolist()))


@pytest.mark.parametrize("win", [(7, 7), (3, 5), (15, 15), (17, 17),
                                 (25, 25), (31, 31), (51, 51)])
def test_window_terms_bit_equal(dev, win):
    """K9 against its plain version, with lanes beyond every edge (the
    clamp moves them in)."""
    ww, wh = win
    lvl = _level_pair(dev, tpft.create_config())
    img2, gx2, gy2 = lvl[3:]
    h, w = img2.shape
    rng = np.random.default_rng(7)
    n = 200
    x = rng.uniform(-4, w + 4, n)
    y = rng.uniform(-4, h + 4, n)
    x[:4], y[:4] = [-3.0, w + 2.0, 20.0, 40.0], [30.0, 30.0, -3.0, h + 2.0]
    x, y = (torch.tensor(t, dtype=torch.float32, device=dev) for t in (x, y))
    w1, g1x, g1y = (gather_window(im, x + 1.3, y - 0.8, ww // 2,
                                  wh // 2).contiguous() for im in lvl[:3])
    args = (img2, gx2, gy2, w1, g1x, g1y, x, y)
    kw = dict(hw=ww // 2, hh=wh // 2, step_factor=1.0)
    before = cuda_window_terms.launches
    got = cuda_window_terms.window_terms(*args, **kw)
    assert cuda_window_terms.launches == before + 1
    assert torch.equal(got, _plain(cuda_window_terms.window_terms, *args,
                                   **kw))


K9_WINDOWS = [(3, 3), (7, 7), (3, 5), (15, 15), (17, 17), (51, 51)]
# windows up to 15x15 at the largest batch
K9_CASES = ([(n, win) for n in (1, 5, 1000) for win in K9_WINDOWS]
            + [(65536, win) for win in K9_WINDOWS if win[0] * win[1] <= 225])


@pytest.mark.parametrize("n,win", K9_CASES)
@pytest.mark.parametrize("step_factor", [1.0, 2.0])
def test_window_terms_batches(dev, n, win, step_factor):
    """K9 at N = 1 to 65,536, with lanes clamped in from beyond every edge
    and step factors 1 and 2: bit-equal to its plain version."""
    ww, wh = win
    lvl = _level_pair(dev, tpft.create_config())
    img2, gx2, gy2 = lvl[3:]
    h, w = img2.shape
    rng = np.random.default_rng(n + ww)
    x = rng.uniform(-4, w + 4, n)
    y = rng.uniform(-4, h + 4, n)
    k = min(n, 4)
    x[:k], y[:k] = ([-3.0, w + 2.0, 20.0, 40.0][:k],
                    [30.0, 30.0, -3.0, h + 2.0][:k])
    x, y = (torch.tensor(t, dtype=torch.float32, device=dev) for t in (x, y))
    w1, g1x, g1y = (gather_window(im, x + 1.3, y - 0.8, ww // 2,
                                  wh // 2).contiguous() for im in lvl[:3])
    args = (img2, gx2, gy2, w1, g1x, g1y, x, y)
    kw = dict(hw=ww // 2, hh=wh // 2, step_factor=step_factor)
    got = cuda_window_terms.window_terms(*args, **kw)
    assert torch.equal(got, _plain(cuda_window_terms.window_terms, *args,
                                   **kw))


def test_dense_paths_on_card_equal_plain_versions(dev, monkeypatch):
    """compute_dense_flow, dense_flow_fb's gate and dense_depth through the
    kernels equal the same calls through the plain versions on the card;
    K8 launches twice per flow and four times per depth map, and no call
    upsamples a map outside it. (On the card, not against the CPU: the SSD
    sweep's cumsum and hypot round by device.)"""
    from pyfeaturetrack_tpu_torch.ops import flow, interp
    from pyfeaturetrack_tpu_torch.ops.flow import dense_flow_fb
    base = _texture(110, 150, seed=31)
    a, b = base[:96, :128], base[1:97, 2:130]
    calls = []
    for mod in (interp, flow, cuda_lk_dense):
        monkeypatch.setattr(mod, "upsample_flow",
                            lambda *x, f=mod.upsample_flow: calls.append(x)
                            or f(*x))
    before = cuda_lk_dense.launches
    g = tpft.compute_dense_flow(a, b)
    assert cuda_lk_dense.launches == before + 2
    tpft.dense_depth(a, base[:96, 8:136], np.eye(3), 0.5, max_disparity=16.0)
    assert not calls
    monkeypatch.undo()
    for x, y in zip(g, _plain(tpft.compute_dense_flow, a, b)):
        assert x.device.type == "cuda"
        assert torch.equal(x, y)
    cfg = tpft.create_config()
    pyrs = [tpft.build_track_pyramids(torch.tensor(f, device=dev), cfg)
            for f in (a, b)]
    fwd, err, valid = dense_flow_fb(*pyrs, cfg)
    pfwd, perr, pvalid = _plain(dense_flow_fb, *pyrs, cfg)
    for x, y in zip((*fwd, err, valid), (*pfwd, perr, pvalid)):
        assert torch.equal(x, y)
    left, right = base[:96, :128], base[:96, 8:136]     # disparity 8 px
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    before = cuda_lk_dense.launches
    dg = tpft.dense_depth(left, right, K, 0.5, max_disparity=16.0)
    assert cuda_lk_dense.launches == before + 4
    for x, y in zip(dg, _plain(tpft.dense_depth, left, right, K, 0.5,
                                max_disparity=16.0)):
        np.testing.assert_array_equal(x, y)
    assert dg[2].mean() > 0.3 and abs(np.median(dg[1][dg[2]]) - 8.0) < 0.1


def test_refine_sequence_kernels_equal_plain_versions(dev):
    base = _texture(120, 160, seed=13)
    frames = [np.roll(base, 4 * i, axis=1) for i in range(6)]
    cfg = tpft.create_config(mindist=8)
    g, _ = tpft.track_sequence(frames, cfg=cfg, n_features=40,
                               subpixel_refine=True)
    p, _ = _plain(tpft.track_sequence, frames, cfg=cfg, n_features=40,
                  subpixel_refine=True)
    for a, b in zip(g, p):
        assert a.device.type == "cuda"
        assert torch.equal(a, b)
    assert (g.x[0] != torch.round(g.x[0])).any()


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


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("win", [(17, 17), (25, 25), (31, 31), (51, 51)])
def test_affine_track_large_windows_bit_equal(dev, mode, win):
    """K6 at windows above 256 samples (the window walked sample by
    sample) against its plain version, on a frame large enough that most
    lanes' windows fit."""
    ww, wh = win
    cfg = tpft.create_config(affineConsistencyCheck=mode,
                             affine_window_width=ww, affine_window_height=wh)
    h, w = 240, 320
    base = _texture(h + 8, w + 8, seed=25)
    a, b = base[:h, :w].copy(), np.ascontiguousarray(base[1:h + 1, 2:w + 2])
    b[20:80, 200:280] = np.random.default_rng(3).uniform(0, 255, (60, 80))
    p1, p2 = (tpft.build_track_pyramids(torch.tensor(f, device=dev), cfg)
              for f in (a, b))
    rng = np.random.default_rng(ww + mode)
    n = 200
    x = torch.tensor(rng.uniform(0, w, n), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.uniform(0, h, n), dtype=torch.float32, device=dev)
    tmpl = gather_window(p1.img[0], x, y, ww // 2, wh // 2).contiguous()
    off = torch.tensor(rng.uniform(-0.5, 0.5, (2, n)), dtype=torch.float32,
                       device=dev)
    A0 = torch.eye(2, device=dev).repeat(n, 1, 1).contiguous()
    check = torch.tensor(rng.uniform(size=n) > 0.1, device=dev)
    args = (tmpl, p2.img[0], p2.gradx[0], p2.grady[0], x - 2.0 + off[0],
            y - 1.0 + off[1], A0, check, cfg)
    got = cuda_affine.affine_track_batch(*args)
    want = _plain(cuda_affine.affine_track_batch, *args)
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    assert {0, -4}.issubset(set(got[3][check].tolist()))


AFFINE_GROUPS = ("tracked", "flat", "noise", "edge", "drift", "wander",
                 "capture", "lost", "dead")


def _affine_stage_mix(dev, n, cfg):
    """The affine stage's inputs on a lane mix of n lanes, lane i in group
    AFFINE_GROUPS[i % 9]: frame 2 shows frame 1's content moved by (+3, +2)
    px, with a flat block (SMALL_DET) and a patch of fresh noise
    (LARGE_RESIDUE); lanes across the left edge (OOB), started 2.5 px off
    the optimum (drift: OOB), with a noise template (wander: runs to
    affine_max_iterations), first tracks (captured), lost and dead lanes.
    Returns (pyr1, pyr2, fl_before, fl_after) and the groups."""
    from pyfeaturetrack_tpu_torch.features import FeatureState
    h, w = 240, 320
    base = _texture(h + 8, w + 8, seed=30 + cfg.affine_window_width)
    a = base[4:4 + h, 4:4 + w].copy()
    b = base[2:2 + h, 1:1 + w].copy()            # content at (x + 3, y + 2)
    a[60:120, 40:140] = b[62:122, 43:143] = 128.0
    rng = np.random.default_rng(n)
    b[150:230, 200:310] = rng.uniform(0, 255, (80, 110))
    p1, p2 = (tpft.build_track_pyramids(torch.tensor(f, device=dev), cfg)
              for f in (a, b))
    groups = np.array([AFFINE_GROUPS[i % 9] for i in range(n)])
    box = {"flat": (60, 120, 75, 105), "noise": (212, 292, 163, 213),
           "edge": (0.5, 5.0, 30, h - 30)}
    x = np.empty(n)
    y = np.empty(n)
    for g in AFFINE_GROUPS:
        m = groups == g
        x0, x1, y0, y1 = box.get(g, (20, 190, 130, 220))
        x[m] = rng.uniform(x0, x1, m.sum())
        y[m] = rng.uniform(y0, y1, m.sum())
    off = np.where(groups == "drift", 2.5, 0.3)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    xb, yb = f32(x), f32(y)
    xa, ya = f32(x + 3.0 + off), f32(y + 2.0 - 0.2)
    g = {k: torch.tensor(groups == k, device=dev) for k in AFFINE_GROUPS}
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    tmpl = gather_window(p1.img[0], xb, yb, hw, hh)
    noise = f32(rng.uniform(0, 255, tmpl.shape))
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    aff = tpft.AffineState(
        img=torch.where(g["wander"][:, None, None], noise, tmpl).contiguous(),
        gradx=gather_window(p1.gradx[0], xb, yb, hw, hh).contiguous(),
        grady=gather_window(p1.grady[0], xb, yb, hw, hh).contiguous(),
        x=xb, y=yb, A=torch.eye(2, device=dev).repeat(n, 1, 1).contiguous(),
        valid=~(g["capture"] | g["dead"]),
        nit=(torch.arange(n, device=dev) % 7).to(torch.int32))
    val_before = torch.where(g["dead"], -1, zero)
    val_after = torch.where(g["lost"], -4, val_before)
    before = FeatureState(xb, yb, val_before, aff)
    after = FeatureState(torch.where(g["dead"] | g["lost"], -1.0, xa),
                         torch.where(g["dead"] | g["lost"], -1.0, ya),
                         val_after, aff)
    return (p1, p2, before, after), groups


@pytest.mark.parametrize("n", [1, 33, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("win", [7, 15, 17, 21, 25])
def test_affine_stage_bit_equal(dev, mode, win, dtype, n):
    """K6's stage kernel (one launch per stage) against the eager stage on
    the card, over a lane mix (_affine_stage_mix) and the step after it,
    which checks the captured templates and refills the lanes the first
    dropped: the feature list and all eight AffineState fields, bit for
    bit. At 1000 lanes the first step ends lanes TRACKED, SMALL_DET, OOB
    and LARGE_RESIDUE, runs some to affine_max_iterations (read from the
    batch entry on the checked lanes, itself == its plain version) and
    captures and drops templates."""
    from pyfeaturetrack_tpu_torch.features import FeatureState, reset_affine
    from pyfeaturetrack_tpu_torch.ops.affine import affine_consistency_check
    cfg = tpft.create_config(affineConsistencyCheck=mode,
                             affine_window_width=win,
                             affine_window_height=win, image_dtype=dtype)
    (p1, p2, before, after), groups = _affine_stage_mix(dev, n, cfg)
    for step in range(2):
        args = (p1, p2, before, after, cfg)
        launched = cuda_affine.launches
        got = affine_consistency_check(*args)
        assert cuda_affine.launches == launched + 1
        want = _plain(affine_consistency_check, *args)
        for a_, b_ in zip(got[:3], want[:3]):
            assert torch.equal(a_, b_)
        for name in got.aff._fields:
            assert torch.equal(getattr(got.aff, name),
                               getattr(want.aff, name)), name
        if step == 0 and n == 1000:
            aff = after.aff
            check = (after.val == 0) & aff.valid
            batch = (aff.img, p2.img[0], p2.gradx[0], p2.grady[0], after.x,
                     after.y, aff.A, check, cfg)
            status = cuda_affine.affine_track_batch(*batch)
            for a_, b_ in zip(status, _plain(cuda_affine.affine_track_batch,
                                             *batch)):
                assert torch.equal(a_, b_)
            assert set(got.val[check].tolist()) == {0, -2, -4, -5}
            assert bool((status[4] == cfg.affine_max_iterations).any())
            cap = torch.tensor(groups == "capture", device=dev)
            lost = torch.tensor(groups == "lost", device=dev)
            assert bool(got.aff.valid[cap].all())
            assert not bool(got.aff.valid[lost].any())
        # the next step: the same pair from this step's AffineState, every
        # lane tracked to its start near the optimum, the lanes this step
        # dropped refilled (their templates captured)
        drop = got.val < 0
        before = FeatureState(before.x, before.y, torch.where(drop, 500,
                                                             got.val),
                              reset_affine(got.aff, drop))
        after = FeatureState(before.x + 3.3, before.y + 1.8,
                             torch.zeros_like(got.val), before.aff)
    assert bool(got.aff.valid.any())


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


@pytest.mark.parametrize("grid", ["shared", "global"])
@pytest.mark.parametrize("mindist,budget", [
    (0, None), (1, 7), (10, None), (10, 0), (25, 7), (60, None)])
def test_suppress_exact(dev, grid, mindist, budget, monkeypatch):
    """K5 against its plain version: flags, index list and count, with
    candidates within the radius of every edge and about 10 % invalid
    lanes, the coverage grid in shared and (with the shared-memory limit
    set to 0) in global memory."""
    if grid == "global":
        monkeypatch.setattr(cuda_suppress, "SMEM_GRID_BYTES", 0)
    h, w, k = 150, 200, 3000
    rng = np.random.default_rng(mindist)
    d = max(mindist - 1, 1)
    cx = np.where(rng.uniform(size=k) < 0.3,
                  rng.choice([0, d, w - 1 - d, w - 1], k), rng.integers(0, w, k))
    cy = np.where(rng.uniform(size=k) < 0.3,
                  rng.choice([0, d, h - 1 - d, h - 1], k), rng.integers(0, h, k))
    args = (torch.tensor(cx, dtype=torch.int32, device=dev),
            torch.tensor(cy, dtype=torch.int32, device=dev),
            torch.tensor(rng.uniform(size=k) > 0.1, device=dev))
    kw = dict(shape=(h, w), mindist=mindist, max_out=k,
              budget=torch.tensor([k if budget is None else budget],
                                  dtype=torch.int32, device=dev))
    before = cuda_suppress.launches
    got = cuda_suppress.greedy_suppress(*args, **kw)
    assert cuda_suppress.launches == before + 1
    want = _plain(cuda_suppress.greedy_suppress, *args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2]) == (0 if budget == 0 else int(got[0].sum()))


def test_suppress_large_frame_uses_global_grid(dev):
    """1080x1920: the grid (259 KB) exceeds shared memory and lives in
    global memory."""
    h, w, k = 1080, 1920, 20000
    rng = np.random.default_rng(3)
    args = (torch.tensor(rng.integers(0, w, k), dtype=torch.int32, device=dev),
            torch.tensor(rng.integers(0, h, k), dtype=torch.int32, device=dev),
            torch.ones(k, dtype=torch.bool, device=dev))
    kw = dict(shape=(h, w), mindist=10, max_out=500,
              budget=torch.tensor([500], dtype=torch.int32, device=dev))
    assert cuda_suppress.grid_bytes((h, w)) > cuda_suppress.SMEM_GRID_BYTES
    got = cuda_suppress.greedy_suppress(*args, **kw)
    want = _plain(cuda_suppress.greedy_suppress, *args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _sorted_lattice(dev, cfg, h, w, seed, n, replacing):
    """The host API's sorted candidate list of a textured frame (stage A,
    then the sort) and feature slots: all free, or (replacing) the frame's
    n selected features with every 25th lost."""
    img = torch.tensor(_texture(h, w, seed), device=dev)
    pyr = tpft.build_track_pyramids(img, cfg)
    eig = cuda_eig.min_eig_map(pyr.gradx[0], pyr.grady[0], cfg.window_width,
                               cfg.window_height)
    geom = _candidate_grid(cfg, (h, w))
    x = torch.full((n,), -1.0, device=dev)
    val = torch.full((n,), -1, dtype=torch.int32, device=dev)
    y = x
    if replacing:
        _, x, y, val, _ = tpft.select_step_device(img, cfg, n)[:5]
        val = val.clone()
        val[::25] = -4
    cand = cuda_select.candidate_lattice(
        eig, x, y, val, geom, min_eig=max(int(cfg.min_eigenvalue), 1),
        radius=premask_radius(cfg, replacing)).cells[:, :geom[4]]
    neg, order = torch.sort(-cand.reshape(-1), stable=True)
    return neg, order, geom, x, y, val


@pytest.mark.parametrize("shape", [(480, 640), (1080, 1920)])
@pytest.mark.parametrize("mindist", [0, 10, 60])
@pytest.mark.parametrize("replacing", [False, True])
def test_suppress_and_fill_bit_equal(dev, shape, mindist, replacing):
    """K5's fused entry (decode, budget, scan, slot fill) against its plain
    version (the decode, greedy_suppress_reference, fill_slots) on the host
    API's sorted lattice: initial selection and refill, the coverage grid in
    shared memory (480x640) and global memory (1080x1920); then K5's list
    entry on the decoded list under the same budget. One launch each."""
    h, w = shape
    cfg = tpft.create_config(mindist=mindist)
    neg, order, geom, x, y, val = _sorted_lattice(dev, cfg, h, w, 21, 1000,
                                                  replacing)
    min_eig = max(int(cfg.min_eigenvalue), 1)
    kw = dict(geom=geom, min_eig=min_eig, shape=shape, mindist=mindist, x=x,
              y=y, val=val, replacing=replacing)
    before = cuda_suppress.launches
    got = cuda_suppress.suppress_and_fill(neg, order, **kw)
    assert cuda_suppress.launches == before + 1
    want = _plain(cuda_suppress.suppress_and_fill, neg, order, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    free = (val < 0) if replacing else torch.ones_like(val, dtype=torch.bool)
    assert bool((got[2][free] >= 0).any())
    cx, cy, _, valid = cuda_suppress.decode_candidates(neg, order, geom,
                                                       min_eig)
    lkw = dict(shape=shape, mindist=mindist, max_out=val.shape[0],
               budget=free.sum().to(torch.int32).reshape(1))
    got = cuda_suppress.greedy_suppress(cx, cy, valid, **lkw)
    want = _plain(cuda_suppress.greedy_suppress, cx, cy, valid, **lkw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grid", ["shared", "global"])
def test_suppress_and_fill_budget_zero_and_dry_pool(dev, grid, monkeypatch):
    """A refill with no free slot (budget 0: the slots come back as they
    were) and one whose pool runs dry (every candidate below the bar: the
    free slots come back empty)."""
    if grid == "global":
        monkeypatch.setattr(cuda_suppress, "SMEM_GRID_BYTES", 0)
    cfg = tpft.create_config()
    neg, order, geom, x, y, val = _sorted_lattice(dev, cfg, 120, 160, 22, 60,
                                                  True)
    kept = torch.where(val < 0, 7, val)
    for v, bar in ((kept, 1), (val, 1 << 30)):
        kw = dict(geom=geom, min_eig=bar, shape=(120, 160), mindist=10, x=x,
                  y=y, val=v, replacing=True)
        got = cuda_suppress.suppress_and_fill(neg, order, **kw)
        want = _plain(cuda_suppress.suppress_and_fill, neg, order, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert torch.equal(got[2][val < 0], torch.full_like(got[2][val < 0], -1))


def test_facade_two_frames_on_card_equals_plain_on_cpu(dev):
    """Example 1's flow (select, track) through the facade on the card
    equals the same calls on the CPU; K1 (with K3's map in the selection's
    level-0 launch), K2 and K5 launch, K3's standalone entry does not."""
    base = _texture(140, 180, seed=23)
    img0, img1 = base[:120, :160], base[1:121, 2:162]
    cfg = tpft.create_config()
    mods = (cuda_pyramid, cuda_lk, cuda_suppress)
    counts = {m: m.launches for m in mods}
    k3_in_k1, k3 = cuda_pyramid.eig_launches, cuda_eig.launches
    g = tpft.KLTSelectGoodFeatures(cfg, img0, 60)
    g2, _ = tpft.KLTTrackFeatures(cfg, img0, img1, g)
    c = tpft.KLTSelectGoodFeatures(cfg, img0, 60, device="cpu")
    c2, _ = tpft.KLTTrackFeatures(cfg, img0, img1, c)
    for m, before in counts.items():
        assert m.launches > before, m.__name__
    assert cuda_pyramid.eig_launches > k3_in_k1 and cuda_eig.launches == k3
    for a, b in zip(g[:3] + g2[:3], c[:3] + c2[:3]):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("mode", [-1, 2])
def test_host_loop_on_card_equals_device_route(dev, mode):
    base = _texture(120, 160, seed=13)
    frames = [np.roll(base, 4 * i, axis=1) for i in range(8)]
    cfg = tpft.create_config(mindist=8, affineConsistencyCheck=mode)
    ft, _ = tpft.track_sequence(frames, cfg=cfg, n_features=40)
    d = tpft.track_sequence_device(frames, cfg=cfg, n_features=40)
    c, _ = tpft.track_sequence(frames, cfg=cfg, n_features=40, device="cpu")
    for a, b, e in zip(ft, d, c):
        np.testing.assert_array_equal(a.cpu().numpy(), b)
        assert torch.equal(a.cpu(), e)


def test_stable_sort_ties_match_numpy(dev):
    """The host API's priority order on the card: torch.sort(-vals,
    stable=True) over a quantized map full of ties equals
    np.argsort(-vals, kind="stable") (descending, ties in scan order)."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 50, 255744).astype(np.int32)
    _, order = torch.sort(-torch.tensor(vals, device=dev), stable=True)
    np.testing.assert_array_equal(order.cpu().numpy(),
                                  np.argsort(-vals, kind="stable"))


# ---------------------------------------------------------------------------
# The captured k-frame chain and the serving path on the card
# ---------------------------------------------------------------------------

def _scroll(n, seed=13, shift=4, shape=(120, 160)):
    base = _texture(*shape, seed=seed)
    return [np.roll(base, shift * i, axis=1) for i in range(n)]


@pytest.mark.parametrize("affine,replace_lost,uint8", [
    (-1, True, False), (2, True, True), (-1, False, True)])
def test_captured_chain_equals_eager_steps(dev, affine, replace_lost, uint8):
    """track_sequence_device(chain=4): two replays of the captured graph
    and a tail step == the eager steps, bit for bit (default, config-3
    style affine mode 2, and without refills); uint8 frames are cast
    inside the graph."""
    frames = _scroll(10)
    if uint8:
        frames = [f.astype(np.uint8) for f in frames]
    cfg = tpft.create_config(mindist=8, affineConsistencyCheck=affine)
    steps = tpft.track_sequence_device(frames, cfg=cfg, n_features=40,
                                       replace_lost=replace_lost)
    from pyfeaturetrack_tpu_torch.models import device_sequence as ds
    ds._GRAPHS.clear()
    for warm_up in (1, 0):
        lk = cuda_lk.launches
        chained = tpft.track_sequence_device(
            frames, cfg=cfg, n_features=40, replace_lost=replace_lost,
            chain=4)
        # K2 once per step (a replay adds the launches its capture
        # recorded), and once in the capture's warm-up step
        assert cuda_lk.launches - lk == 9 + warm_up
        for a, b in zip(chained, steps):
            np.testing.assert_array_equal(a, b)


def test_chain_outputs_survive_the_next_replay(dev):
    """Returned tensors are the caller's: a second replay leaves the first
    call's hist, final state, AffineState and pyramid as they were."""
    from pyfeaturetrack_tpu_torch.models.device_sequence import (
        sequence_chain_device)
    frames = _scroll(9)
    cfg = tpft.create_config(mindist=8, affineConsistencyCheck=2).replace(
        sequentialMode=True)
    pyr, x, y, v, aff, _ = tpft.select_step_device(frames[0], cfg, 40,
                                                   device="cuda")
    first = sequence_chain_device(pyr, frames[1:5], x, y, v, cfg, aff=aff)
    held = [*first[1], *first[2], *first[3], *first[0].img,
            *first[0].gradx]
    kept = [t.clone() for t in held]
    second = sequence_chain_device(first[0], frames[5:9], *first[2], cfg,
                                   aff=first[3])
    torch.cuda.synchronize()
    for a, b in zip(held, kept):
        assert torch.equal(a, b)
    assert not torch.equal(second[1][0], first[1][0])
    # and the state the second call started from came from the graph's
    # own buffers: the same as starting eagerly from the first outputs
    p, sx, sy, sv, sa = first[0], *first[2], first[3]
    for f in frames[5:9]:
        p, sx, sy, sv, sa, _, _ = tpft.sequence_step_device(p, f, sx, sy, sv,
                                                            cfg, aff=sa)
    for a, b in zip(second[2], (sx, sy, sv)):
        assert torch.equal(a, b)


def test_graph_cache_reused_and_keyed_by_shape(dev):
    from pyfeaturetrack_tpu_torch.models import device_sequence as ds
    cfg = tpft.create_config(mindist=8).replace(sequentialMode=True)
    ds._GRAPHS.clear()

    def run(frames):
        pyr, x, y, v, aff, _ = tpft.select_step_device(frames[0], cfg, 30,
                                                       device="cuda")
        return ds.sequence_chain_device(pyr, frames[1:], x, y, v, cfg)

    a = _scroll(4)
    run(a)
    assert len(ds._GRAPHS) == 1
    graph = next(iter(ds._GRAPHS.values()))
    run(_scroll(4, seed=5))
    assert len(ds._GRAPHS) == 1 and next(iter(ds._GRAPHS.values())) is graph
    run(_scroll(4, shape=(96, 128)))                  # another frame size
    run(_scroll(5))                                    # another chain length
    run([f.astype(np.uint8) for f in a])               # another frame dtype
    assert len(ds._GRAPHS) == 4
    for i in range(ds.GRAPH_CACHE_SIZE + 2):
        run(_scroll(3, shape=(64 + 8 * i, 96)))
    assert len(ds._GRAPHS) == ds.GRAPH_CACHE_SIZE


def test_prefetch_to_device_order_and_residency_on_card(dev):
    """Frames in order on the card in the staged dtype; the ring of two
    one-frame blocks waits for a block's last copy before each of the
    seven rewrites, and counts each wait (``sync.stage_block``)."""
    from pyfeaturetrack_tpu_torch.serving import prefetch_to_device
    from pyfeaturetrack_tpu_torch.utils.profiling import counters
    frames = [np.full((48, 64), i, np.float32) for i in range(9)]
    for dtype in (np.float32, np.uint8):
        waits = counters().get("sync.stage_block", 0)
        out = list(prefetch_to_device(iter(frames), depth=2, device=dev,
                                      stage_dtype=dtype))
        assert counters().get("sync.stage_block", 0) - waits == 7
        assert len(out) == 9
        for i, a in enumerate(out):
            assert a.is_cuda and a.dtype == (torch.uint8 if dtype is np.uint8
                                             else torch.float32)
            np.testing.assert_array_equal(a.cpu().numpy(), frames[i])


def test_block_ring_waits_for_a_blocks_last_copy(dev):
    """A block handed out again after a copy is handed out once that copy
    has run, and the wait counts once under ``sync.stage_block``; a block
    never copied is handed out without one."""
    from pyfeaturetrack_tpu_torch.utils.profiling import counters
    from pyfeaturetrack_tpu_torch.utils.staging import BlockRing
    shape = (2, 1, 480, 640)
    ring = BlockRing(2, dev)
    a, b = ring.next(shape, torch.uint8), ring.next(shape, torch.uint8)
    a.array[...] = 7
    out = a.copy_to(torch.empty(shape, dtype=torch.uint8, device=dev))
    waits = counters().get("sync.stage_block", 0)
    assert ring.next(shape, torch.uint8) is a
    assert a.copied.query()
    assert ring.next(shape, torch.uint8) is b
    assert counters().get("sync.stage_block", 0) - waits == 1
    assert bool((out == 7).all())


@pytest.mark.parametrize("chain", [1, 3])
def test_streaming_on_card_equals_device_loop(dev, chain):
    from pyfeaturetrack_tpu_torch.serving import (BatchedStreamingTracker,
                                                  serve_stream)
    cfg = tpft.create_config(mindist=8, affineConsistencyCheck=2)
    streams = [[f.astype(np.uint8) for f in _scroll(8, seed=20 + b,
                                                    shift=3 + b)]
               for b in range(3)]
    singles = [serve_stream(s, cfg=cfg, n_features=25, chain=chain,
                            prefetch=2, stage_uint8=True) for s in streams]
    for s, got in zip(streams, singles):
        want = tpft.track_sequence_device(s, cfg=cfg, n_features=25)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    bt = BatchedStreamingTracker(cfg, n_streams=3, n_features=25,
                                 chain=chain)
    for i in range(8):
        bt.feed(np.stack([s[i] for s in streams]))
    table = bt.table()
    for b, want in enumerate(singles):
        for a, w in zip(table, want):
            np.testing.assert_array_equal(a[:, b], w)


def _counted(fn):
    """fn()'s result and how much it grew the chain's counters."""
    from pyfeaturetrack_tpu_torch.utils.profiling import counters
    names = ("chain.replays", "chain.block_stages", "sync.stage_block",
             "chain.captures")
    before = counters()
    out = fn()
    after = counters()
    return out, {n: after.get(n, 0) - before.get(n, 0) for n in names}


def _streamed(tracker, frames, flush_at=(), drain_at=()):
    """Feed ``frames`` one by one (a flush or a drain after the listed
    indices); the drained parts stacked as one table."""
    parts = []
    for i, f in enumerate(frames):
        tracker.feed(f)
        if i in flush_at:
            tracker.flush()
        if i in drain_at:
            parts.append(tracker.drain())
    parts.append(tracker.drain())
    return tuple(np.concatenate([p[j] for p in parts]) for j in range(3))


def _assert_same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _warped(n, h=480, w=640, seed=31):
    """uint8 frames that pan (2, 1) px, roll 0.05 deg and zoom 0.1 % a frame
    about the centre under a static textured box (rows 300-400, columns
    240-400), by bilinear sampling of one texture."""
    tex = _texture(h + 160, w + 160, seed)
    box = _texture(100, 160, seed + 1)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xx, yy = xx - (w - 1) / 2.0, yy - (h - 1) / 2.0
    out = []
    for i in range(n):
        th, z = np.radians(0.05 * i), 1.05 * 1.001 ** i
        qx = (np.cos(th) * xx + np.sin(th) * yy) / z + (w - 1) / 2.0 + 80 + 2 * i
        qy = (-np.sin(th) * xx + np.cos(th) * yy) / z + (h - 1) / 2.0 + 80 + i
        x0, y0 = np.floor(qx).astype(np.int64), np.floor(qy).astype(np.int64)
        ax, ay = qx - x0, qy - y0
        v = ((1 - ax) * (1 - ay) * tex[y0, x0] + ax * (1 - ay) * tex[y0, x0 + 1]
             + (1 - ax) * ay * tex[y0 + 1, x0] + ax * ay * tex[y0 + 1, x0 + 1])
        v[300:400, 240:400] = box
        out.append(np.floor(v).astype(np.uint8))
    return out


def test_config3_chain8_at_vga_equals_eager_steps(dev):
    """BASELINE config 3 (the affine check, 3 levels at subsampling 2) at
    480x640 and 1000 features through StreamingTracker(chain=8), fed host
    uint8 frames that pan, roll and zoom under a static overlay: every
    chain is one replay whose frames cross as one block; the table and the
    final AffineState == eager sequence_step_device's, bit for bit;
    affine_state() is the chain's copy (none of the graph's buffers), which
    later feeds leave unchanged, and the stage checked and rejected
    lanes."""
    from pyfeaturetrack_tpu_torch.models import device_sequence as ds
    from pyfeaturetrack_tpu_torch.serving import StreamingTracker
    from pyfeaturetrack_tpu_torch.utils.profiling import counters
    cfg = tpft.create_config(affineConsistencyCheck=2, nPyramidLevels=3,
                             subsampling=2).replace(sequentialMode=True)
    frames = _warped(33)
    tr = StreamingTracker(cfg, n_features=1000, chain=8)
    tr.feed(frames[0])
    assert tr.affine_state() is not None and not bool(
        tr.affine_state().valid.any())
    before = counters()
    held = None
    for i, f in enumerate(frames[1:], 1):
        tr.feed(f)
        if i == 16:
            held = tr.affine_state()
            kept = [t.clone() for t in held]
    grew = {k: counters()[k] - before.get(k, 0)
            for k in ("chain.replays", "chain.block_stages",
                      "k6.checked_lanes", "k6.rejections")}
    got = tr.table()
    last = tr.affine_state()
    torch.cuda.synchronize()
    assert grew["chain.replays"] == grew["chain.block_stages"] == 4
    assert grew["k6.checked_lanes"] > 1000 and grew["k6.rejections"] > 0
    for a, b in zip(held, kept):
        assert torch.equal(a, b)
    graph = next(reversed(ds._GRAPHS.values()))      # the tracker's, last used
    bufs = {t.untyped_storage().data_ptr() for t in graph.state}
    assert not bufs & {t.untyped_storage().data_ptr() for t in last}

    pyr, x, y, v, aff, _ = tpft.select_step_device(
        torch.tensor(frames[0], device=dev), cfg, 1000)
    rows = [(x, y, v)]
    carry = None
    for f in frames[1:]:
        pyr, x, y, v, aff, _, carry = tpft.sequence_step_device(
            pyr, torch.tensor(f, device=dev), x, y, v, cfg, aff=aff,
            carry=carry)
        rows.append((x, y, v))
    want = tuple(torch.stack([r[j] for r in rows]).cpu().numpy()
                 for j in range(3))
    _assert_same(got, want)
    for a, b in zip(last, aff):
        assert torch.equal(a, b)
    assert int(last.valid.sum()) > 500


@pytest.mark.parametrize("chain", [8, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("how", ["flush", "emit_every", "drain"])
def test_streaming_host_blocks_equal_device_loop(dev, chain, dtype, how):
    """A chained stream's host frames cross as one block a chain: with a
    flush in the middle of a chain, ``emit_every`` 5, or drains off a chain
    boundary, the table == track_sequence_device's, bit for bit; every
    replay took its frames as a block, and from the third chain on each
    chain's first write waited for its block's last copy."""
    from pyfeaturetrack_tpu_torch.serving import StreamingTracker
    frames = [f.astype(dtype) for f in _scroll(30, seed=61, shift=3)]
    cfg = tpft.create_config(mindist=8)
    want = tpft.track_sequence_device(frames, cfg=cfg, n_features=30)
    tr = StreamingTracker(cfg, n_features=30, chain=chain,
                          emit_every=5 if how == "emit_every" else 0)
    got, grew = _counted(lambda: _streamed(
        tr, frames, flush_at=(chain + 2,) if how == "flush" else (),
        drain_at=(chain + 2, 2 * chain + 3) if how == "drain" else ()))
    _assert_same(got, want)
    # emit_every 5 flushes every chain of 8 before it fills
    assert (grew["chain.replays"] > 0) == (how != "emit_every" or chain < 5)
    assert grew["chain.block_stages"] == grew["chain.replays"]
    assert grew["sync.stage_block"] > 0


def test_batched_host_blocks_equal_single_streams(dev):
    """BatchedStreamingTracker(n_streams=3, chain=4) fed host uint8
    batches: one block of [4, 3, H, W] a chain; each stream == its own
    track_sequence_device."""
    from pyfeaturetrack_tpu_torch.serving import BatchedStreamingTracker
    cfg = tpft.create_config(mindist=8)
    streams = [[f.astype(np.uint8) for f in _scroll(18, seed=70 + b,
                                                    shift=2 + b)]
               for b in range(3)]
    bt = BatchedStreamingTracker(cfg, n_streams=3, n_features=25, chain=4)
    table, grew = _counted(lambda: _streamed(
        bt, [np.stack([s[i] for s in streams]) for i in range(18)],
        drain_at=(6,)))
    assert grew["chain.block_stages"] == grew["chain.replays"] == 3
    for b, s in enumerate(streams):
        want = tpft.track_sequence_device(s, cfg=cfg, n_features=25)
        _assert_same([t[:, b] for t in table], want)


def test_reused_host_buffer_equals_distinct_frames(dev):
    """One numpy buffer, rewritten after every feed as a decoder does,
    tracks like distinct frames: the block write at feed is the frame's own
    copy."""
    from pyfeaturetrack_tpu_torch.serving import StreamingTracker
    frames = [f.astype(np.uint8) for f in _scroll(26, seed=62, shift=3)]
    cfg = tpft.create_config(mindist=8)
    want = _streamed(StreamingTracker(cfg, n_features=30, chain=8), frames)
    tr = StreamingTracker(cfg, n_features=30, chain=8)
    buf = np.empty_like(frames[0])
    for f in frames:
        buf[...] = f
        tr.feed(buf)
        buf[...] = 255 - f
    _assert_same(tr.table(), want)


def test_two_trackers_share_a_graph_not_their_frames(dev):
    """Two trackers of the same shapes, fed in turn, share one captured
    graph and each equals its solo run: each writes its own blocks, and
    its block crosses into the graph's frame buffer just before its
    replay."""
    from pyfeaturetrack_tpu_torch.serving import StreamingTracker
    cfg = tpft.create_config(mindist=8)
    clips = [[f.astype(np.uint8) for f in _scroll(25, seed=63 + c,
                                                  shift=2 + c)]
             for c in range(2)]
    solo = [_streamed(StreamingTracker(cfg, n_features=30, chain=8), c)
            for c in clips]

    def in_turn():
        trackers = [StreamingTracker(cfg, n_features=30, chain=8)
                    for _ in clips]
        for i in range(25):
            for tr, c in zip(trackers, clips):
                tr.feed(c[i])
        return [tr.table() for tr in trackers]

    tables, grew = _counted(in_turn)
    assert grew["chain.captures"] == 0
    assert grew["chain.block_stages"] == grew["chain.replays"] == 6
    for got, want in zip(tables, solo):
        _assert_same(got, want)


def test_device_tensor_mid_chain_takes_the_per_frame_path(dev):
    """A frame already on the card, fed in the middle of a chain of host
    frames, is staged on its own; that chain's slots cross in one copy and
    the chain replays from frames on the card: the table == the per-frame
    path's (every frame on the card) and track_sequence_device's."""
    from pyfeaturetrack_tpu_torch.serving import StreamingTracker
    frames = [f.astype(np.uint8) for f in _scroll(17, seed=64, shift=3)]
    cfg = tpft.create_config(mindist=8)
    per_frame, grew_all = _counted(lambda: _streamed(
        StreamingTracker(cfg, n_features=30, chain=8),
        [torch.tensor(f, device=dev) for f in frames]))
    assert grew_all["chain.block_stages"] == 0
    mixed = [torch.tensor(f, device=dev) if i == 4 else f
             for i, f in enumerate(frames)]
    got, grew = _counted(lambda: _streamed(
        StreamingTracker(cfg, n_features=30, chain=8), mixed))
    assert grew["chain.replays"] == 2 and grew["chain.block_stages"] == 1
    _assert_same(got, per_frame)
    _assert_same(got, tpft.track_sequence_device(frames, cfg=cfg,
                                                 n_features=30))


@pytest.mark.parametrize("chain,prefetch", [(1, 0), (8, 2)])
def test_no_block_stages_off_the_chained_host_path(dev, chain, prefetch):
    """``chain`` 1 (no replay) and ``prefetch`` 2 (frames on the card)
    stage frame by frame: no chain crosses as a block."""
    from pyfeaturetrack_tpu_torch.serving import serve_stream
    frames = [f.astype(np.uint8) for f in _scroll(18, seed=65, shift=3)]
    cfg = tpft.create_config(mindist=8)
    got, grew = _counted(lambda: serve_stream(
        frames, cfg=cfg, n_features=30, chain=chain, prefetch=prefetch,
        stage_uint8=True))
    assert grew["chain.block_stages"] == 0
    assert grew["chain.replays"] == (0 if chain == 1 else 2)
    _assert_same(got, tpft.track_sequence_device(frames, cfg=cfg,
                                                 n_features=30))


def test_chunked_lockstep_on_card_equals_serial(dev):
    frames = _scroll(10, seed=53, shift=3)
    kw = dict(n_features=20, n_chunks=2, replace_lost=True)
    serial, _, _ = tpft.track_sequence_chunked(frames, **kw)
    batch, _, _ = tpft.track_sequence_chunked(frames, **kw, batched=True,
                                              chain=3)
    for k in ("x", "y", "val"):
        np.testing.assert_array_equal(batch[k], serial[k])


def _grad_of(loss, img):
    leaf = img.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(leaf), leaf)
    return g


@pytest.mark.parametrize("what", ["track", "flow"])
def test_gradients_through_kernels_equal_plain_route(dev, what):
    """A loss over tracked positions (K1, K2) or dense flow (K1, K8): the
    gradient with respect to frame 2 through the kernels' autograd
    Functions equals the plain route's, bit for bit (the backward is the
    plain version's VJP); the forward launched the kernels."""
    cfg = tpft.create_config()
    img1 = torch.tensor(_texture(96, 128, 7), device=dev)
    img2 = torch.roll(img1, (1, 2), (0, 1)).contiguous()
    _, x, y, val, _, _ = tpft.select_step_device(img1, cfg, 40)

    def loss(i2):
        p1 = tpft.build_track_pyramids(img1, cfg)
        p2 = tpft.build_track_pyramids(i2, cfg)
        if what == "track":
            nx, ny, nv = tpft.track_features_pyramids(p1, p2, x, y, val, cfg)
            return torch.where(nv == 0, nx + ny, 0.0).sum()
        from pyfeaturetrack_tpu_torch.ops.flow import dense_flow_pyramids
        fl = dense_flow_pyramids(p1, p2, cfg)
        return torch.where(fl.status == 0, fl.u ** 2 + fl.v ** 2, 0.0).sum()

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mod = cuda_lk if what == "track" else cuda_lk_dense
        before = mod.launches
        g = _grad_of(loss, img2)
        assert mod.launches > before
        want = _plain(_grad_of, loss, img2)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    assert torch.equal(g, want), (g - want).abs().max()


def test_captured_chain_refuses_inputs_that_require_grad(dev):
    cfg = tpft.create_config().replace(sequentialMode=True)
    img = torch.tensor(_texture(96, 128, 8), device=dev)
    pyr, x, y, v, _, _ = tpft.select_step_device(img, cfg, 20)
    with pytest.raises(ValueError, match="records no gradients"):
        tpft.sequence_chain_device(pyr, [img.clone().requires_grad_(True),
                                         img], x, y, v, cfg)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_windowed_ba_rerun_bit_equal_on_card(dev, solver):
    """The windowed BA's sums are segmented, not atomic: runs on the card
    give the same bits, with the CG blocks replayed from a captured graph
    or run eagerly (reference_path), and they converge."""
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.sfm.ba_windowed import (
        make_windowed_problem)
    rng = np.random.default_rng(0)
    C, L, kw = 24, 400, 6
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Rs = sfm.so3_exp(torch.tensor(0.01 * rng.standard_normal((C, 3)),
                                  dtype=torch.float32, device=dev))
    ts = torch.tensor([[-0.15 * i, 0.0, 0.0] for i in range(C)],
                      dtype=torch.float32, device=dev)
    X = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                  rng.uniform(5, 12, L)], -1).astype(np.float32)
    c0 = rng.integers(0, C - kw + 1, L)
    cidx = torch.tensor(c0[:, None] + np.arange(kw), device=dev)
    uv, _ = sfm.project(K, Rs[cidx], ts[cidx],
                        torch.tensor(X, device=dev)[:, None])
    problem = make_windowed_problem(K, c0, uv, np.ones((L, kw)), device=dev)
    X0 = torch.tensor(X + 0.05 * rng.standard_normal(X.shape)
                      .astype(np.float32), device=dev)
    def run():
        return sfm.bundle_adjust_windowed(problem, Rs, ts, X0, n_iters=4,
                                          point_only_iters=1, solver=solver,
                                          precond_block=4, return_info=True)

    runs = [run(), run(), _plain(run)]
    # the second run replays the CG graph the first captured; the third
    # runs the CG iterations eagerly
    for other in runs[1:]:
        for a, b in zip(runs[0][:4], other[:4]):
            assert torch.equal(a, b)
        assert torch.equal(runs[0][4]["cg_iters"], other[4]["cg_iters"])
    costs = runs[0][3].cpu().numpy()
    assert costs[-1] < 1e-2 * costs[0]
    pp, Xp, n_pad = sfm.pad_windowed_for_mesh(problem, X0, 7)
    assert n_pad == 6 and Xp.shape == (L + 6, 3)
    assert bool((pp.w[L:] == 0).all()) and torch.equal(Xp[:L], X0)


@pytest.mark.parametrize("shape,bands", [((480, 640), (0, 120, 240, 360, 480)),
                                         ((120, 160), (0, 7, 64, 120)),
                                         ((37, 53), (0, 1, 36, 37))])
@pytest.mark.parametrize("overrides", [{}, {"lighting_insensitive": True}])
@pytest.mark.parametrize("one_d", [False, True])
def test_dense_level_band_bit_equal(dev, shape, bands, overrides, one_d):
    """K8's row band: each band launch (every start mode) equals those rows
    of the whole-level launch and the plain version of the band, bit for
    bit; one launch each, counted as a band launch."""
    h, w = shape
    cfg = tpft.create_config(**overrides)
    lvl, uc, vc = _start_case(dev, cfg, h, w)
    from pyfeaturetrack_tpu_torch.ops.interp import upsample_flow
    u, v = (upsample_flow(t, (h, w), 4.0) for t in (uc, vc))
    if one_d:
        calls = [lambda band: cuda_lk_dense.dense_level_1d_up(
                     *lvl, -uc, 4.0, cfg, band=band),
                 lambda band: cuda_lk_dense.dense_level_1d(*lvl, -u, cfg,
                                                           band=band)]
    else:
        calls = [lambda band: cuda_lk_dense.dense_level_up(
                     *lvl, uc, vc, 4.0, cfg, band=band),
                 lambda band: cuda_lk_dense.dense_level(*lvl, u, v, cfg,
                                                        band=band),
                 lambda band: cuda_lk_dense.dense_level_up(
                     *lvl, None, None, 4.0, cfg, band=band)]
    for call in calls:
        whole = call(None)
        for r0, r1 in zip(bands[:-1], bands[1:]):
            before = cuda_lk_dense.launches
            bands_before = cuda_lk_dense.band_launches
            got = call((r0, r1 - r0))
            _dense_equal(got, _plain(call, (r0, r1 - r0)), before)
            assert cuda_lk_dense.band_launches == (bands_before
                                                   + (r1 - r0 < h))
            for a, b in zip(got, whole):
                if a is not None:
                    assert torch.equal(a, b[r0:r1])


def test_sharded_paths_split_on_card_equal_unsharded(dev):
    """A 4-way split on the card (the ranks' bodies in turn): tracking,
    the full step and dense flow equal the unsharded route bit for bit;
    the dense BA reruns bit-equal."""
    from pyfeaturetrack_tpu_torch.parallel import sharding, split_mesh
    cfg = tpft.create_config()
    a = _texture(96, 128, seed=3)
    b = np.ascontiguousarray(np.roll(a, (1, 2), axis=(0, 1)))
    imgs1, imgs2 = np.stack([a, b]), np.stack([b, a])
    rng = np.random.default_rng(2)
    xs = rng.uniform(10, 118, (2, 64)).astype(np.float32)
    ys = rng.uniform(10, 86, (2, 64)).astype(np.float32)
    vals = np.ones((2, 64), np.int32)
    grid = split_mesh((2, 2), ("frame", "feature"), dev)
    got = sharding.track_batch_sharded(imgs1, imgs2, xs, ys, vals, cfg, grid)
    want = [tpft.track_features_pyramids(
        tpft.build_track_pyramids(torch.tensor(imgs1[i], device=dev), cfg),
        tpft.build_track_pyramids(torch.tensor(imgs2[i], device=dev), cfg),
        *(torch.tensor(t[i], device=dev) for t in (xs, ys, vals)), cfg)
        for i in range(2)]
    for g, w in zip(got, (torch.stack(c) for c in zip(*want))):
        assert torch.equal(g, w)
    full_cfg = tpft.create_config(affineConsistencyCheck=2,
                                  lighting_insensitive=True).validated_window()
    got = sharding.full_pair_batch_sharded(imgs1, imgs2, xs, ys, vals,
                                           full_cfg, grid)
    # the device sequence's step (track, affine check, refill)
    want = [tpft.sequence_step_device(
        tpft.build_track_pyramids(torch.tensor(imgs1[i], device=dev),
                                  full_cfg),
        torch.tensor(imgs2[i], device=dev),
        *(torch.tensor(t[i], device=dev) for t in (xs, ys, vals)), full_cfg,
        replace_lost=True,
        aff=tpft.make_affine_state(xs.shape[1], full_cfg, dev))[1:4]
        for i in range(2)]
    for g, w in zip(got, (torch.stack(c) for c in zip(*want))):
        assert torch.equal(g, w)
    before = cuda_lk_dense.band_launches
    got = sharding.dense_flow_sharded(a, b, cfg,
                                      split_mesh((4,), ("pixrow",), dev))
    want = tpft.compute_dense_flow(a, b, cfg)
    assert cuda_lk_dense.band_launches == before + 4 * cfg.nPyramidLevels
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    return a == b


@pytest.mark.parametrize("shape", [(120, 160), (97, 130)])
def test_ops_surface_bit_equal(dev, shape):
    """The JAX package's op-level names on the card: each launches the
    kernel named in its docstring and equals its plain version bit for
    bit (compute_pyramid / compute_gradient_pyramids: K1 level launches;
    quantized_min_eig_map: K3; selection_eig_map_core: K1 eig-only;
    select_features_device: that and K4; track_feature_level: K2's level
    launch; suppress_and_fill: K5)."""
    from pyfeaturetrack_tpu_torch.ops import select as sel
    from pyfeaturetrack_tpu_torch.ops import select_device as sd
    from pyfeaturetrack_tpu_torch.ops.pyramid import (
        compute_gradient_pyramids, compute_pyramid)
    from pyfeaturetrack_tpu_torch.ops.track import track_feature_level
    cfg = tpft.create_config(mindist=5)
    img = torch.tensor(_texture(*shape, seed=shape[1]), device=dev)
    img2 = torch.roll(img, 1, 1)
    n = 40
    empty = (torch.full((n,), -1.0, device=dev),
             torch.full((n,), -1.0, device=dev),
             torch.full((n,), -1, dtype=torch.int32, device=dev))
    pa, pb = (tpft.build_track_pyramids(t, cfg) for t in (img, img2))
    core = dict(window_width=7, window_height=7, smooth_before=True,
                smooth_sigma=cfg.smooth_sigma, grad_sigma=cfg.grad_sigma)
    sel_out = sd.select_features_device(img, *empty, cfg, replacing=False)
    x, y, v = sel_out[:3]
    cx = torch.arange(60, dtype=torch.int32, device=dev) * 3 % shape[1]
    cy = torch.arange(60, dtype=torch.int32, device=dev) * 7 % shape[0]
    calls = {
        "pyramid": (lambda: compute_pyramid(img, 2, 3, 0.9), cuda_pyramid, 2),
        "gradients": (lambda: compute_gradient_pyramids(
            compute_pyramid(img, 2, 3, 0.9), 1.0), cuda_pyramid, 5),
        "quantized": (lambda: sel.quantized_min_eig_map(
            pa.gradx[0], pa.grady[0], 7, 7), cuda_eig, 1),
        "core": (lambda: sel.selection_eig_map_core(img, **core),
                 cuda_pyramid, 1),
        "select": (lambda: sd.select_features_device(
            img, *empty, cfg, replacing=False), cuda_select, 2),
        "level": (lambda: track_feature_level(
            x, y, x, y, pa.img[0], pa.gradx[0], pa.grady[0], pb.img[0],
            pb.gradx[0], pb.grady[0], cfg, v >= 0), cuda_lk, 1),
        "suppress": (lambda: sd.suppress_and_fill(
            cx, cy, cx + cy, cx > 0, torch.ones(n, dtype=torch.bool,
                                                device=dev), *empty, 4),
                     cuda_suppress, 1),
    }
    for name, (fn, mod, want) in calls.items():
        before = mod.launches
        got = fn()
        assert mod.launches - before == want, name
        assert _same(got, _plain(fn)), name
