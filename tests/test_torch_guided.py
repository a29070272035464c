"""Guided starts in K2 (``x_init``/``y_init``: the frame-2 search starts
at an external motion prior) on the CPU, where K2 runs its plain version,
against the JAX package's guided track_features_pyramids, and the loop
closure's guided round trip (``sfm/loop.guided_retrack``) against JAX's.

Both sides track on the SAME pyramids (the JAX XLA build, carried over
with utils/convert.pyramids_from_numpy): tests/test_loop.py's 25 px
large-displacement scene (beyond the default 15 px search range) with
lanes tracked, broken at a coarse level (a flat block: SMALL_DET),
starting across the frame's edge (OOB), out of view after the track and
dead (val < 0, passed through whatever their start). Bars: statuses
exact, positions within 1e-4 px (tests/test_track.py:53); guided
round-trip acceptance equal, its error within 1e-4 px."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops.track import build_track_pyramids as jax_build
from pyfeaturetrack_tpu.ops.track import \
    track_features_pyramids as jax_track
from pyfeaturetrack_tpu.sfm.loop import guided_retrack as jax_retrack

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.ops.cuda_lk import (track_pyramid,
                                                  track_pyramid_reference)
from pyfeaturetrack_tpu_torch.sfm.loop import guided_retrack
from pyfeaturetrack_tpu_torch.utils.convert import (config_from_jax,
                                                    features_from_numpy,
                                                    pyramids_from_numpy)

torch.set_num_threads(2)

POS_TOL = 1e-4
DX = 25.0


def _pyramids(jcfg, img1, img2):
    jp = [jax_build(jnp.asarray(im, jnp.float32), jcfg) for im in (img1, img2)]
    tp = [pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv) for lv in p),
                              device="cpu") for p in jp]
    return jp, tp


def _scene(shape=(96, 160), flat=True):
    img1 = make_textured_image(*shape, seed=40)
    if flat:
        img1[40:80, 100:150] = 120.0
    return img1, shift_image_bilinear(img1, DX, 0.0)


def _lanes(shape, seed=41):
    """Lanes with a prior ~2 px off the 25 px truth, lanes in the flat
    block, starts across the edge, starts that end out of view, and dead
    lanes; returns x, y, val, x_init, y_init."""
    h, w = shape
    rng = np.random.default_rng(seed)
    n = 30
    x = rng.uniform(20, w - 50, n)
    y = rng.uniform(20, h - 21, n)
    xi = x + DX + rng.uniform(-2.5, 2.5, n)
    yi = y + rng.uniform(-2.0, 2.0, n)
    fx = rng.uniform(75, 95, 6)                 # flat block after the shift
    fy = rng.uniform(45, 75, 6)
    ex = np.array([30.0, 60.0, 90.0, 120.0, 40.0])
    ey = np.array([50.0, 30.0, 60.0, 40.0, 70.0])
    exi = np.array([-3.0, w + 2.0, w - 1.0, 2.0, 50.0])
    eyi = np.array([50.0, 30.0, 60.0, 40.0, h + 4.0])
    x = np.concatenate([x, fx - DX, ex])
    y = np.concatenate([y, fy, ey])
    x_init = np.concatenate([xi, fx, exi])
    y_init = np.concatenate([yi, fy, eyi])
    val = np.zeros(len(x))
    val[rng.choice(len(x), 6, replace=False)] = rng.choice([-1, -4], 6)
    return x, y, val, x_init, y_init


@pytest.mark.parametrize("levels,sub,li", [(2, 4, False), (3, 2, False),
                                           (1, 2, False), (2, 4, True)])
def test_guided_track_matches_jax(levels, sub, li):
    jcfg = create_config(nPyramidLevels=levels, subsampling=sub)
    if li:
        jcfg = jcfg.replace(lighting_insensitive=True)
    jcfg = jcfg.validated_window()
    cfg = config_from_jax(jcfg)
    img1, img2 = _scene()
    if li:
        img2 = np.clip(img2 * 0.8 + 20.0, 0, 255)
    (jp1, jp2), (tp1, tp2) = _pyramids(jcfg, img1, img2)
    x, y, val, xi, yi = _lanes(img1.shape)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    jx, jy, jv = jax.jit(jax_track, static_argnames=("cfg",))(
        jp1, jp2, f32(x), f32(y), jnp.asarray(val.astype(np.int32)), jcfg,
        x_init=f32(xi), y_init=f32(yi))
    tx, ty, tv = tpft.track_features_pyramids(
        tp1, tp2, *features_from_numpy(x, y, val, device="cpu"), cfg,
        x_init=torch.as_tensor(xi, dtype=torch.float32),
        y_init=torch.as_tensor(yi, dtype=torch.float32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=POS_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=POS_TOL)
    dead = val < 0
    np.testing.assert_array_equal(tv.numpy()[dead], val[dead])
    np.testing.assert_array_equal(tx.numpy()[dead], x[dead].astype(np.float32))
    codes = tv.numpy()[~dead]
    assert (codes == 0).sum() >= 12          # the prior recovers the shift
    assert (codes == -4).any()               # starts across / out of view
    if levels >= 2 and not li:
        good = (tv.numpy() == 0) & (np.arange(len(x)) < 30)
        assert np.median(np.abs(tx.numpy()[good] - x[good] - DX)) < 0.1


def test_guided_start_at_x_is_the_start_free_call():
    """x_init = x, y_init = y: the plain version returns the start-free
    call's bits (the start is the same IEEE division by s^L)."""
    cfg = tpft.create_config(nPyramidLevels=3).validated_window()
    img1, img2 = _scene()
    p1, p2 = (tpft.build_track_pyramids(torch.as_tensor(im, dtype=torch.float32),
                                        cfg) for im in (img1, img2))
    x, y, val, _, _ = _lanes(img1.shape)
    x, y, val = features_from_numpy(x, y, val, device="cpu")
    plain = track_pyramid_reference(p1, p2, x, y, val, cfg)
    guided = track_pyramid_reference(p1, p2, x, y, val, cfg, x, y)
    through_wrapper = track_pyramid(p1, p2, x, y, val, cfg, x.clone(),
                                    y.clone())
    for a, b, c in zip(plain, guided, through_wrapper):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError):
        track_pyramid(p1, p2, x, y, val, cfg, x, None)


@pytest.mark.parametrize("occlude", [False, True])
def test_guided_retrack_matches_jax(occlude):
    """tests/test_loop.py's round trip: an 18 px shift, a prior ~2 px off,
    and (second case) an occluded block whose lanes must fail the gate."""
    jcfg = create_config().validated_window()
    cfg = config_from_jax(jcfg)
    base = make_textured_image(96, 160, seed=42)
    img2 = shift_image_bilinear(base, 18.0, 0.0).copy()
    if occlude:
        img2[30:70, 90:130] = make_textured_image(40, 40, seed=43)
    (jp1, jp2), (tp1, tp2) = _pyramids(jcfg, base, img2)
    rng = np.random.default_rng(44)
    n = 40
    x = rng.uniform(15, 120, n).astype(np.float32)
    y = rng.uniform(15, 80, n).astype(np.float32)
    xi = (x + 18.0 + rng.uniform(-2, 2, n)).astype(np.float32)
    yi = (y + rng.uniform(-2, 2, n)).astype(np.float32)
    got = guided_retrack(tp1, tp2, x, y, xi, yi, cfg)
    want = jax_retrack(jp1, jp2, x, y, xi, yi, jcfg)
    np.testing.assert_array_equal(got[2], want[2])
    fin = np.isfinite(want[3])
    np.testing.assert_array_equal(np.isfinite(got[3]), fin)
    np.testing.assert_allclose(got[3][fin], want[3][fin], atol=POS_TOL)
    np.testing.assert_allclose(got[0], want[0], atol=POS_TOL)
    np.testing.assert_allclose(got[1], want[1], atol=POS_TOL)
    assert got[2].sum() >= 10
    if occlude:
        inside = (xi > 88) & (xi < 132) & (yi > 28) & (yi < 72)
        assert not got[2][inside].any()
