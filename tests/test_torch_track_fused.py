"""K2's pyramidal entry (ops/cuda_lk.track_pyramid, the whole
coarse-to-fine track call) on the CPU, where it runs its plain version,
against the JAX package's track_features_pyramids_carry.

Both sides track on the SAME pyramids (the JAX XLA build, carried over
with utils/convert.pyramids_from_numpy), over 1-4 levels at subsampling 2
and 4, with lanes tracked, broken at a coarse level (a flat block gives
SMALL_DET, windows across the frame's edge OOB), out of view after the
track (the final border test), and dead (val < 0, passed through); also
the lighting-insensitive variant, 13x13, 17x17 and 25x25 windows and
nine levels. Bars: statuses
exact, positions within 1e-4 px (tests/test_track.py:53)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.oracle import klt_oracle as oracle
from pyfeaturetrack_tpu.ops.track import build_track_pyramids as jax_build
from pyfeaturetrack_tpu.ops.track import (
    track_features_pyramids_carry as jax_track_carry)

from pyfeaturetrack_tpu_torch.ops.cuda_lk import (track_pyramid,
                                                  track_pyramid_reference)
from pyfeaturetrack_tpu_torch.ops.track import track_features_pyramids_carry
from pyfeaturetrack_tpu_torch.utils.convert import (config_from_jax,
                                                    features_from_numpy,
                                                    pyramids_from_numpy)

torch.set_num_threads(2)

POS_TOL = 1e-4
SHAPE = (192, 256)
FLAT = (slice(60, 130), slice(80, 190))      # rows, cols of the flat block


def _pair(li, shape=SHAPE):
    img1 = make_textured_image(*shape, seed=31)
    img1[FLAT] = 120.0
    img2 = shift_image_bilinear(img1, 1.6, -1.1)
    if li:
        img2 = np.clip(img2 * 0.7 + 30.0, 0, 255)
    return img1, img2


def _features(jcfg, img1, seed):
    """Good features of frame 1 (tracked lanes), lanes in the flat block
    (SMALL_DET), lanes on and across the frame's edges (OOB at a coarse
    level or out of view after the track) and dead lanes."""
    H, W = img1.shape
    good = oracle.select_good_features(img1, 40, jcfg)[:, :2]
    rng = np.random.default_rng(seed)
    flat = np.stack([rng.uniform(110, 160, 8), rng.uniform(80, 110, 8)], 1)
    edge = np.array([[1.0, 50.0], [W - 2.0, 90.0], [60.0, 0.5],
                     [130.0, H - 1.5], [-2.0, 70.0], [W + 1.0, 20.0],
                     [jcfg.borderx + 0.5, 100.0], [W - 1.0 - jcfg.borderx, 60.0],
                     [150.0, jcfg.bordery + 0.4], [90.0, H - jcfg.bordery - 0.8]])
    xy = np.concatenate([good, flat, edge])
    val = np.zeros(len(xy))
    val[rng.choice(len(xy), 8, replace=False)] = rng.choice([-1, -2, -4], 8)
    return xy[:, 0], xy[:, 1], val


def _run(jcfg, li, seed, shape=SHAPE):
    jcfg = jcfg.validated_window()
    cfg = config_from_jax(jcfg)
    img1, img2 = _pair(li, shape)
    jp1, jp2 = (jax_build(jnp.asarray(im, jnp.float32), jcfg)
                for im in (img1, img2))
    tp1, tp2 = (pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                      for lv in p), device="cpu") for p in (jp1, jp2))
    x, y, val = _features(jcfg, img1, seed)
    jx, jy, jv, _ = jax.jit(jax_track_carry, static_argnames=("cfg",))(
        jp1, jp2, jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(val.astype(np.int32)), jcfg)
    tx, ty, tv = track_pyramid(tp1, tp2, *features_from_numpy(x, y, val, device="cpu"),
                               cfg)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=POS_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=POS_TOL)
    dead = val < 0
    np.testing.assert_array_equal(tv.numpy()[dead], val[dead])
    np.testing.assert_array_equal(tx.numpy()[dead], x[dead].astype(np.float32))
    return tv.numpy()[~dead]


@pytest.mark.parametrize("levels,sub", [(1, 2), (2, 2), (3, 2), (4, 2),
                                        (1, 4), (2, 4), (3, 4)])
def test_pyramid_walk_matches_jax(levels, sub):
    # three levels at subsampling 4 set a 112 px border: a larger frame
    shape = (320, 384) if (levels, sub) == (3, 4) else SHAPE
    codes = _run(create_config(nPyramidLevels=levels, subsampling=sub),
                 False, seed=levels + sub, shape=shape)
    assert (codes == 0).sum() >= 10
    assert (codes == -4).any()
    if levels == 1:
        assert (codes == -2).any()       # flat lanes keep SMALL_DET


@pytest.mark.parametrize("levels,sub", [(2, 4), (3, 2)])
def test_lighting_insensitive_matches_jax(levels, sub):
    jcfg = create_config(nPyramidLevels=levels, subsampling=sub).replace(
        lighting_insensitive=True)
    codes = _run(jcfg, True, seed=7)
    assert (codes == 0).sum() >= 10


def test_13x13_window_matches_jax():
    codes = _run(create_config(window_width=13, window_height=13), False,
                 seed=3)
    assert (codes == 0).sum() >= 10


@pytest.mark.parametrize("win", [17, 25])
def test_large_windows_match_jax(win):
    """Windows above 256 pixels, which K2 walks pixel by pixel on the card
    (its plain version has no such limit)."""
    codes = _run(create_config(window_width=win, window_height=win), False,
                 seed=win, shape=(320, 384))
    assert (codes == 0).sum() >= 10


def test_nine_levels_match_jax():
    """Nine levels at subsampling 2 (the coarsest 1x1): every lane breaks
    at a coarse level or leaves the view, as in JAX."""
    codes = _run(create_config(nPyramidLevels=9, subsampling=2), False,
                 seed=9, shape=(320, 384))
    assert (codes == -4).all()


def test_coarse_break_freezes_the_break_level_position():
    """A lane of the flat block breaks (SMALL_DET) at the coarsest level:
    its position stays there (28.75, 23.75 at level 2 of three), so the
    final border test (border 32) finds it out of view and it ends OOB;
    with one level it stays SMALL_DET."""
    for levels, want in ((3, -4), (1, -2)):
        jcfg = create_config(nPyramidLevels=levels, subsampling=2)
        cfg = config_from_jax(jcfg.validated_window())
        img1, img2 = _pair(False)
        tp1, tp2 = (pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                          for lv in jax_build(
                                              jnp.asarray(im, jnp.float32),
                                              jcfg)), device="cpu")
                    for im in (img1, img2))
        x, y, v = features_from_numpy([115.0], [95.0], [0], device="cpu")
        nx, ny, nv = track_pyramid_reference(tp1, tp2, x, y, v, cfg)
        assert int(nv[0]) == want and float(nx[0]) == -1.0


def test_track_call_goes_through_track_pyramid(monkeypatch):
    """ops/track.track_features_pyramids_carry is one track_pyramid call."""
    from pyfeaturetrack_tpu_torch.ops import track as track_mod
    calls = []
    monkeypatch.setattr(track_mod, "track_pyramid",
                        lambda *a: calls.append(a) or track_pyramid(*a))
    jcfg = create_config().validated_window()
    img1, img2 = _pair(False)
    tp1, tp2 = (pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                      for lv in jax_build(
                                          jnp.asarray(im, jnp.float32),
                                          jcfg)), device="cpu")
                for im in (img1, img2))
    x, y, v = features_from_numpy(*_features(jcfg, img1, 1), device="cpu")
    out = track_features_pyramids_carry(tp1, tp2, x, y, v,
                                        config_from_jax(jcfg))
    assert len(calls) == 1 and out[3] is None
