"""K3 inside K1's level-0 launch, through the plain versions on the CPU:
the build's map (``pyramid_build(..., eig_window=...)``,
``build_track_pyramids(..., with_eig=True)``) and the eig-only entry
(``level0_eig``) equal ``min_eig_reference`` of the gradients the build
stores, bit for bit; ``selection_eig_map`` gives the same map with and
without a pyramid, with smoothing on and off; the device route's tables
are those of the route that read the map from the pyramid's gradients."""

import numpy as np
import pytest
import torch

from pyfeaturetrack_tpu.ops.track import TrackPyramids as JaxTrackPyramids

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.ops import cuda_eig, cuda_pyramid
from pyfeaturetrack_tpu_torch.ops.select import selection_eig_map
from pyfeaturetrack_tpu_torch.ops.select_device import \
    select_features_from_eig_device
from pyfeaturetrack_tpu_torch.ops.track import TrackPyramids

torch.set_num_threads(2)


def _frame(h, w, seed):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, (h + 4, w + 4))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for axis in (0, 1):
        img = sum(c * np.roll(img, s - 2, axis=axis) for s, c in enumerate(k))
    return torch.tensor(np.floor(img[2:-2, 2:-2]), dtype=torch.float32)


@pytest.mark.parametrize("shape", [(61, 83), (40, 50), (9, 12)])
@pytest.mark.parametrize("win", [(3, 3), (7, 7), (13, 13), (5, 9)])
@pytest.mark.parametrize("levels,sub", [(1, 4), (2, 4), (3, 2)])
def test_build_map_is_k3_of_the_stored_gradients(shape, win, levels, sub):
    cfg = tpft.create_config(nPyramidLevels=levels, subsampling=sub)
    taps = cuda_pyramid.level_taps(cfg)
    img = _frame(*shape, seed=shape[0] + win[0])
    *pyr, eig = cuda_pyramid.pyramid_build(img, taps, levels, eig_window=win)
    assert eig.dtype == torch.int32 and eig.shape == img.shape
    assert torch.equal(eig, cuda_eig.min_eig_reference(pyr[1][0], pyr[2][0],
                                                       *win))
    for a, b in zip(pyr, cuda_pyramid.pyramid_build(img, taps, levels)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    if shape[0] < win[1] or shape[1] < win[0]:    # no interior window
        assert not eig.any()


def test_build_track_pyramids_returns_the_map_beside_the_pyramid():
    cfg = tpft.create_config(window_width=9, window_height=5)
    img = _frame(64, 96, seed=5)
    pyr, eig = tpft.build_track_pyramids(img, cfg, with_eig=True)
    assert TrackPyramids._fields == JaxTrackPyramids._fields
    plain = tpft.build_track_pyramids(img, cfg)
    assert isinstance(plain, TrackPyramids)
    assert all(torch.equal(x, y) for a, b in zip(pyr, plain)
               for x, y in zip(a, b))
    assert torch.equal(eig, cuda_eig.min_eig_reference(pyr.gradx[0],
                                                       pyr.grady[0], 9, 5))


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("win", [(7, 7), (5, 9)])
def test_selection_map_with_and_without_pyramid(smooth, win):
    cfg = tpft.create_config(smoothBeforeSelecting=smooth,
                             window_width=win[0], window_height=win[1])
    img = _frame(70, 90, seed=11)
    pyr, built = tpft.build_track_pyramids(img, cfg, with_eig=True)
    alone = selection_eig_map(img, cfg)
    assert torch.equal(alone, selection_eig_map(img, cfg, pyr))
    taps = cuda_pyramid.level_taps(cfg)
    assert torch.equal(alone, cuda_pyramid.level0_eig(img, taps, smooth,
                                                      *win))
    _, gx, gy, _ = cuda_pyramid.pyramid_level_reference(img, taps, smooth,
                                                        False)
    assert torch.equal(alone, cuda_eig.min_eig_reference(gx, gy, *win))
    if smooth:
        # selection smooths exactly like the pyramid base
        assert torch.equal(alone, built)


def _map_through_pyramid(img, pyr, cfg):
    """The selection map as the device route read it before: K3 over the
    pyramid's level-0 gradients with smoothBeforeSelecting, else over the
    raw frame's."""
    if cfg.smoothBeforeSelecting:
        return cuda_eig.min_eig_reference(pyr.gradx[0], pyr.grady[0],
                                          cfg.window_width, cfg.window_height)
    return selection_eig_map(img, cfg)


@pytest.mark.parametrize("smooth", [True, False])
def test_device_route_equals_the_route_through_the_pyramid(smooth):
    """select_step_device and sequence_step_device take the map from the
    build (or an eig-only launch without smoothing); the same steps
    composed from a build without the map, K3 over the pyramid's gradients,
    the track and the selection give the same features."""
    cfg = tpft.create_config(smoothBeforeSelecting=smooth, mindist=6)
    base = _frame(90, 120, seed=23)
    frames = [base[i:i + 80, 2 * i:2 * i + 100].contiguous()
              for i in range(3)]
    n = 40
    pyr, x, y, val, _, _ = tpft.select_step_device(frames[0], cfg, n)
    pyr_w = tpft.build_track_pyramids(frames[0], cfg)
    empty = (torch.full((n,), -1.0), torch.full((n,), -1.0),
             torch.full((n,), -1, dtype=torch.int32))
    want = select_features_from_eig_device(
        _map_through_pyramid(frames[0], pyr_w, cfg), *empty, cfg,
        replacing=False)[:3]
    for a, b in zip((x, y, val), want):
        assert torch.equal(a, b)
    for img in frames[1:]:
        val = val.clone()
        val[::5] = -4
        pyr_n, x2, y2, v2, _, _, _ = tpft.sequence_step_device(
            pyr, img, x, y, val, cfg)
        pyr_w = tpft.build_track_pyramids(img, cfg)
        tx, ty, tv = tpft.track_features_pyramids(pyr, pyr_w, x, y, val, cfg)
        want = select_features_from_eig_device(
            _map_through_pyramid(img, pyr_w, cfg), tx, ty, tv, cfg,
            replacing=True)[:3]
        for a, b in zip((x2, y2, v2), want):
            assert torch.equal(a, b)
        assert int((v2 >= 0).sum()) > 0
        pyr, x, y, val = pyr_n, x2, y2, v2
