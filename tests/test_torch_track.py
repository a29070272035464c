"""Port LK (ops/track.py around K2's plain version, ops/cuda_lk.py) vs the
JAX package on the trigger scenarios of tests/test_track.py.

Both sides track on the SAME pyramids (the JAX XLA build, carried over with
utils/convert.pyramids_from_numpy), so only the LK code differs. Bars:
statuses and iteration counts exactly equal, positions within 1e-4 px (the
bar of tests/test_track.py:53). One single-level case runs against the
Pallas K2 kernel, vec_track_level, in interpret mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.oracle import klt_oracle as oracle
from pyfeaturetrack_tpu.ops.pallas_lk_vec import vec_track_level
from pyfeaturetrack_tpu.ops.track import build_track_pyramids as jax_build
from pyfeaturetrack_tpu.ops.track import track_feature_level
from pyfeaturetrack_tpu.ops.track import (
    track_features_pyramids as jax_track)

from pyfeaturetrack_tpu_torch.ops.cuda_lk import lk_level
from pyfeaturetrack_tpu_torch.ops.track import (track_features_pyramids,
                                                track_features_pyramids_carry)
from pyfeaturetrack_tpu_torch.ops.cuda_lk import empty_track_carry
from pyfeaturetrack_tpu_torch.utils.convert import (config_from_jax,
                                                    features_from_numpy,
                                                    pyramids_from_numpy)

torch.set_num_threads(2)

POS_TOL = 1e-4


def _scenario(name):
    """(jax cfg, img1, img2, features [N, 3]) as in tests/test_track.py."""
    cfg = create_config()
    pair1 = make_textured_image(96, 128, seed=11)
    pair2 = shift_image_bilinear(pair1, 1.6, -1.1)
    one = lambda x, y: np.array([[x, y, 100.0]])  # noqa: E731
    if name == "shift":
        return cfg, pair1, pair2, oracle.select_good_features(pair1, 40, cfg)
    if name == "oob":
        return cfg, pair1, pair2, one(cfg.borderx + 1.0, cfg.bordery + 1.0)
    if name == "small_det":
        flat = np.full((96, 128), 100.0)
        return create_config(search_range=2), flat, flat, one(60.0, 48.0)
    if name == "coarse_break":
        flat = np.full((96, 128), 100.0)
        return cfg, flat, flat, one(60.0, 48.0)
    if name == "residue":
        return (create_config(step_factor=0.0),
                make_textured_image(96, 128, seed=1),
                make_textured_image(96, 128, seed=2), one(60.0, 48.0))
    if name == "max_iterations":
        img = make_textured_image(96, 128, seed=1)
        return create_config(min_displacement=0.0), img, img, one(60.0, 48.0)
    if name == "identity":
        img = make_textured_image(96, 128, seed=1)
        return cfg, img, img, one(60.0, 48.0)
    if name == "gain_bias_li":
        img1 = make_textured_image(96, 128, seed=5)
        img2 = np.clip(shift_image_bilinear(img1, 0.8, 0.5) * 0.6 + 40.0,
                       0, 255)
        return (cfg.replace(lighting_insensitive=True), img1, img2,
                oracle.select_good_features(img1, 20, cfg))
    if name == "noisy_shift":
        img1 = make_textured_image(128, 160, seed=91)
        r = np.random.default_rng(0)
        img2 = np.clip(shift_image_bilinear(img1, 3.7, -2.9)
                       + r.normal(0, 6, img1.shape), 0, 255)
        return cfg, img1, img2, oracle.select_good_features(img1, 100, cfg)
    raise KeyError(name)


SCENARIOS = ["shift", "oob", "small_det", "coarse_break", "residue",
             "max_iterations", "identity", "gain_bias_li", "noisy_shift"]


def _setup(name):
    jcfg, img1, img2, feats = _scenario(name)
    jcfg = jcfg.validated_window()
    jp1 = jax_build(jnp.asarray(img1, jnp.float32), jcfg)
    jp2 = jax_build(jnp.asarray(img2, jnp.float32), jcfg)
    tp1, tp2 = (pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                      for lv in p), device="cpu") for p in (jp1, jp2))
    return jcfg, config_from_jax(jcfg), jp1, jp2, tp1, tp2, feats


@pytest.mark.parametrize("name", SCENARIOS)
def test_pyramidal_tracking_matches_jax(name):
    jcfg, cfg, jp1, jp2, tp1, tp2, feats = _setup(name)
    jx, jy, jv = jax.jit(jax_track, static_argnames=("cfg",))(
        jp1, jp2, jnp.asarray(feats[:, 0], jnp.float32),
        jnp.asarray(feats[:, 1], jnp.float32),
        jnp.asarray(feats[:, 2].astype(np.int32)), jcfg)
    tx, ty, tv = track_features_pyramids(tp1, tp2, *features_from_numpy(
        feats[:, 0], feats[:, 1], feats[:, 2], device="cpu"), cfg)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=POS_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=POS_TOL)
    expect = {"small_det": -2, "coarse_break": -4, "residue": -5,
              "max_iterations": -3, "identity": 0}
    if name in expect:
        assert int(tv[0]) == expect[name]
    if name in ("shift", "gain_bias_li", "noisy_shift"):
        assert (tv.numpy() == 0).sum() >= 10


@pytest.mark.parametrize("name", SCENARIOS)
def test_levels_match_track_feature_level(name):
    """Each level of the coarse-to-fine loop, from the same inputs:
    statuses AND iteration counts exactly equal."""
    jcfg, cfg, jp1, jp2, tp1, tp2, feats = _setup(name)
    s = float(jcfg.subsampling)
    x = np.asarray(feats[:, 0], np.float32)
    y = np.asarray(feats[:, 1], np.float32)
    active = feats[:, 2] >= 0
    scale = s ** jcfg.nPyramidLevels
    xloc, yloc = x / np.float32(scale), y / np.float32(scale)
    xout, yout = xloc.copy(), yloc.copy()
    for r in range(jcfg.nPyramidLevels - 1, -1, -1):
        xloc, yloc = xloc * np.float32(s), yloc * np.float32(s)
        xout, yout = xout * np.float32(s), yout * np.float32(s)
        jx, jy, js, ji = jax.jit(track_feature_level,
                                 static_argnames=("cfg",))(
            *(jnp.asarray(a) for a in (xloc, yloc, xout, yout)),
            jp1.img[r], jp1.gradx[r], jp1.grady[r],
            jp2.img[r], jp2.gradx[r], jp2.grady[r], jcfg,
            jnp.asarray(active))
        tx, ty, ts, ti = lk_level(
            *(torch.tensor(a) for a in (xloc, yloc, xout, yout)),
            tp1.img[r], tp1.gradx[r], tp1.grady[r],
            tp2.img[r], tp2.gradx[r], tp2.grady[r], cfg,
            torch.tensor(active))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=POS_TOL)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=POS_TOL)
        xout, yout = np.asarray(jx), np.asarray(jy)


@pytest.mark.parametrize("win", [13, 15])
def test_large_windows_match_jax(win):
    """Windows past K2's former 128-pixel warp layout (13x13 = 169 and
    15x15 = 225 pixels, 6 and 8 per lane on the card) through the sparse
    tracker: statuses exact, positions within 1e-4 px of JAX's."""
    jcfg = create_config(window_width=win, window_height=win
                         ).validated_window()
    img1 = make_textured_image(128, 160, seed=11)
    img2 = shift_image_bilinear(img1, 1.6, -1.1)
    feats = oracle.select_good_features(img1, 40, jcfg)
    jp1 = jax_build(jnp.asarray(img1, jnp.float32), jcfg)
    jp2 = jax_build(jnp.asarray(img2, jnp.float32), jcfg)
    tp1, tp2 = (pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                      for lv in p), device="cpu") for p in (jp1, jp2))
    jx, jy, jv = jax.jit(jax_track, static_argnames=("cfg",))(
        jp1, jp2, jnp.asarray(feats[:, 0], jnp.float32),
        jnp.asarray(feats[:, 1], jnp.float32),
        jnp.asarray(feats[:, 2].astype(np.int32)), jcfg)
    tx, ty, tv = track_features_pyramids(tp1, tp2, *features_from_numpy(
        feats[:, 0], feats[:, 1], feats[:, 2], device="cpu"), config_from_jax(jcfg))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=POS_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=POS_TOL)
    assert (tv.numpy() == 0).sum() >= 20


def test_single_level_matches_pallas_vec_kernel():
    """Level solve against the TPU K2 kernel (interpret mode)."""
    jcfg = create_config()
    cfg = config_from_jax(jcfg)
    rng = np.random.default_rng(0)
    h, w = 120, 160
    base = make_textured_image(h + 8, w + 8, seed=21)
    img1 = base[:h, :w]
    img2 = base[1:h + 1, 2:w + 2]
    jp1 = jax_build(jnp.asarray(img1, jnp.float32), jcfg)
    jp2 = jax_build(jnp.asarray(img2, jnp.float32), jcfg)
    lvl = (jp1.img[0], jp1.gradx[0], jp1.grady[0],
           jp2.img[0], jp2.gradx[0], jp2.grady[0])
    n = 32
    # interior lanes: the Pallas kernel's block corridor holds them (its
    # stale-lane fallback is a TPU workaround the port does not have)
    x = rng.uniform(12, w - 13, n).astype(np.float32)
    y = rng.uniform(12, h - 13, n).astype(np.float32)
    act = rng.uniform(size=n) > 0.1
    vx, vy, vs, vi, stale = vec_track_level(
        *(jnp.asarray(a) for a in (x, y, x, y)), *lvl, jcfg,
        jnp.asarray(act), interpret=True)
    assert not np.asarray(stale)[act].any()
    tx, ty, ts, ti = lk_level(
        *(torch.tensor(a) for a in (x, y, x, y)),
        *(torch.tensor(np.asarray(a)) for a in lvl), cfg, torch.tensor(act))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(vs))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(vi))
    np.testing.assert_allclose(tx.numpy(), np.asarray(vx), atol=POS_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(vy), atol=POS_TOL)
    assert (ts.numpy()[act] == 0).sum() >= n // 2


def test_carry_signature_same_results():
    """A passed TrackCarry comes back with ok cleared; results identical."""
    jcfg, cfg, _, _, tp1, tp2, feats = _setup("shift")
    x, y, v = features_from_numpy(feats[:, 0], feats[:, 1], feats[:, 2], device="cpu")
    a = track_features_pyramids_carry(tp1, tp2, x, y, v, cfg)
    carry = empty_track_carry(x.shape[0], cfg, device="cpu")._replace(
        ok=torch.ones(x.shape[0], dtype=torch.bool))
    b = track_features_pyramids_carry(tp1, tp2, x, y, v, cfg, carry=carry)
    assert a[3] is None
    assert not b[3].ok.any()
    for p, q in zip(a[:3], b[:3]):
        assert torch.equal(p, q)


def test_inactive_lanes_pass_through():
    jcfg, cfg, _, _, tp1, tp2, feats = _setup("shift")
    vals = feats[:, 2].copy()
    vals[::3] = -1
    x, y, v = features_from_numpy(feats[:, 0], feats[:, 1], vals, device="cpu")
    nx, ny, nv = track_features_pyramids(tp1, tp2, x, y, v, cfg)
    dead = vals < 0
    np.testing.assert_array_equal(nv.numpy()[dead], vals[dead])
    np.testing.assert_array_equal(nx.numpy()[dead], feats[dead, 0]
                                  .astype(np.float32))
