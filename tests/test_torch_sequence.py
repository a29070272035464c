"""The slice end to end: the port's track_sequence_device (plain versions
on the CPU) vs the JAX package's, feature table for feature table.

Bars: val tables equal, positions within 1e-4 px. A lane that differs is
allowed only when it traces back to a +-1 eig-quantization difference
between the two selection maps, and then it is listed by (frame, lane) in
the test, never covered by a percentage (CLAUDE.md, "Parity discipline")."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.models.device_sequence import (
    track_sequence_device as jax_track_sequence_device)
from pyfeaturetrack_tpu.ops.select import selection_eig_map_core

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.ops.cuda_eig import min_eig_map
from pyfeaturetrack_tpu_torch.utils.convert import config_from_jax

torch.set_num_threads(2)

POS_TOL = 1e-4


def _rolling_frames(n_frames=8, shift=4, seed=13, shape=(120, 160)):
    """Texture scrolls right: features drift toward the border and are
    lost at a steady rate, exercising per-frame replacement."""
    base = make_textured_image(*shape, seed=seed)
    return [np.roll(base, shift * i, axis=1) for i in range(n_frames)]


def _eig_diff_pixels(frame, jcfg):
    """Pixels where the JAX and port selection eig maps differ."""
    j = np.asarray(selection_eig_map_core(
        jnp.asarray(frame, jnp.float32), window_width=jcfg.window_width,
        window_height=jcfg.window_height, smooth_before=True,
        smooth_sigma=jcfg.smooth_sigma, grad_sigma=jcfg.grad_sigma))
    pyr = tpft.build_track_pyramids(torch.tensor(frame, dtype=torch.float32),
                                    config_from_jax(jcfg))
    t = min_eig_map(pyr.gradx[0], pyr.grady[0], jcfg.window_width,
                    jcfg.window_height).numpy()
    return np.argwhere(j != t)


def _compare(frames, jcfg, n_features, replace_lost, listed):
    jx, jy, jv = jax_track_sequence_device(frames, cfg=jcfg,
                                           n_features=n_features,
                                           replace_lost=replace_lost)
    tx, ty, tv = tpft.track_sequence_device(
        frames, cfg=config_from_jax(jcfg), n_features=n_features,
        replace_lost=replace_lost, device="cpu")
    assert tv.shape == (len(frames), n_features)
    assert tx.dtype == np.float32 and tv.dtype == np.int32
    differ = [tuple(int(v) for v in fl) for fl in np.argwhere(tv != jv)]
    if differ != listed:
        frames_off = sorted({f for f, _ in differ})
        eig = {f: len(_eig_diff_pixels(frames[f], jcfg)) for f in frames_off}
        raise AssertionError(
            f"unlisted differing (frame, lane) entries {differ}; eig maps "
            f"differ at {eig} pixels in those frames")
    same = tv == jv
    np.testing.assert_allclose(tx[same], jx[same], atol=POS_TOL)
    np.testing.assert_allclose(ty[same], jy[same], atol=POS_TOL)
    return tx, ty, tv


# Listed lanes per case: none differ. Measured: the two selection eig
# maps of these frames differ (by one int step) at 0 to 9 of 12k-19k
# pixels, and none of those decides a selection.
@pytest.mark.parametrize("replace_lost", [True, False])
def test_sequence_matches_jax(replace_lost):
    frames = _rolling_frames()
    _, _, tv = _compare(frames, create_config(mindist=8), 40, replace_lost,
                        listed=[])
    if replace_lost:
        assert (tv[1:] > 0).any()          # refills happened
        assert (tv[-1] >= 0).all()         # and the last frame is full
    else:
        assert (tv[-1] < 0).any()          # lost features stay lost


@pytest.mark.parametrize("shift,seed,shape,mindist", [
    (6, 29, (120, 160), 8), (3, 17, (97, 130), 10), (5, 31, (96, 128), 6),
])
def test_sequence_matches_jax_more_scenes(shift, seed, shape, mindist):
    frames = _rolling_frames(n_frames=7, shift=shift, seed=seed, shape=shape)
    _compare(frames, create_config(mindist=mindist), 30, True, listed=[])


def test_uint8_frames_and_step_api():
    """uint8 frames track like float frames; the step functions thread the
    pyramid cache and the TrackCarry like the JAX signatures."""
    frames = _rolling_frames(n_frames=4)
    cfg = tpft.create_config(mindist=8).replace(sequentialMode=True)
    a = tpft.track_sequence_device([f.astype(np.uint8) for f in frames],
                                   cfg=cfg, n_features=20, device="cpu")
    b = tpft.track_sequence_device([f.astype(np.float32) for f in frames],
                                   cfg=cfg, n_features=20, device="cpu")
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)

    pyr, x, y, val, aff, ex = tpft.select_step_device(
        torch.tensor(frames[0], dtype=torch.float32), cfg, 20)
    assert aff is None and not bool(ex) and x.device.type == "cpu"
    from pyfeaturetrack_tpu_torch.ops.cuda_lk import empty_track_carry
    carry = empty_track_carry(20, cfg)
    for i, f in enumerate(frames[1:], start=1):
        pyr, x, y, val, aff, ex, carry = tpft.sequence_step_device(
            pyr, torch.tensor(f, dtype=torch.float32), x, y, val, cfg,
            carry=carry)
        assert not carry.ok.any()
        np.testing.assert_array_equal(val.numpy(), a[2][i])
        np.testing.assert_array_equal(x.numpy(), a[0][i])
