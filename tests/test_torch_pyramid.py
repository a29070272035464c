"""Port pyramid (K1's plain version, ops/cuda_pyramid.py + ops/convolve.py)
vs the JAX package: the XLA path (ops/track.build_track_pyramids) and the
Pallas K1 kernel (ops/pallas_pyramid.fused_level_build, interpret mode on
the CPU). Bar: max abs <= 1e-3 on the 0..255 scale."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops.convolve import compute_gradients as jax_gradients
from pyfeaturetrack_tpu.ops.convolve import (
    compute_smoothed_image as jax_smoothed)
from pyfeaturetrack_tpu.ops.kernels import compute_kernels
from pyfeaturetrack_tpu.ops.pallas_pyramid import fused_level_build
from pyfeaturetrack_tpu.ops.track import (
    build_track_pyramids as jax_build_track_pyramids)

from pyfeaturetrack_tpu_torch.ops import cuda_pyramid
from pyfeaturetrack_tpu_torch.ops.convolve import (compute_gradients,
                                                   compute_smoothed_image)
from pyfeaturetrack_tpu_torch.ops.track import build_track_pyramids
from pyfeaturetrack_tpu_torch.utils.convert import config_from_jax

torch.set_num_threads(2)

# Measured at 120x160 and 97x130: max abs 4.6e-5 (0..255 scale) against
# the XLA convolutions and 4.6e-5 against the Pallas kernel in interpret
# mode (the same tap order, rounded differently by XLA's CPU backend). On
# the card, K1 and this plain version agree bit for bit (chip_smoke.py).
TOL = 1e-3


def _pair(jax_arr, t):
    return np.asarray(jax_arr, np.float32), t.cpu().numpy()


@pytest.mark.parametrize("shape", [(120, 160), (97, 130)])
def test_pyramids_match_jax_xla(shape):
    jcfg = create_config()
    img = make_textured_image(*shape, seed=shape[0])
    jp = jax_build_track_pyramids(jnp.asarray(img, jnp.float32), jcfg)
    tp = build_track_pyramids(torch.tensor(img, dtype=torch.float32),
                              config_from_jax(jcfg))
    assert len(tp.img) == jcfg.nPyramidLevels
    for field in ("img", "gradx", "grady"):
        for lv, (a, b) in enumerate(zip(getattr(jp, field),
                                        getattr(tp, field))):
            a, b = _pair(a, b)
            assert a.shape == b.shape, (field, lv)
            assert np.abs(a - b).max() <= TOL, (field, lv,
                                                np.abs(a - b).max())


@pytest.mark.parametrize("shape", [(120, 160), (97, 130)])
def test_levels_match_pallas_fused_level_build(shape):
    """Each level against the TPU K1 kernel (interpret mode)."""
    jcfg = create_config()
    cfg = config_from_jax(jcfg)
    taps = cuda_pyramid.level_taps(cfg)
    sg, _ = compute_kernels(float(jcfg.smooth_sigma))
    gg, gd = compute_kernels(float(jcfg.grad_sigma))
    pg, _ = compute_kernels(float(jcfg.pyramid_sigma_fact * jcfg.subsampling))
    tup = lambda k: tuple(float(v) for v in k)  # noqa: E731
    sub = jcfg.subsampling
    cur = make_textured_image(*shape, seed=7).astype(np.float32)
    for level in range(jcfg.nPyramidLevels):
        smooth, with_pyr = level == 0, level < jcfg.nPyramidLevels - 1
        h, w = cur.shape
        dec = (sub, sub // 2, h // sub, w // sub) if with_pyr else None
        jb, jgx, jgy, _, jdec = fused_level_build(
            jnp.asarray(cur), tup(sg) if smooth else None, (tup(gg), tup(gd)),
            tup(pg) if with_pyr else None, dec=dec)
        tb, tgx, tgy, tdec = cuda_pyramid.pyramid_level_reference(
            torch.tensor(cur), taps, smooth, with_pyr)
        pairs = [(jb, tb), (jgx, tgx), (jgy, tgy)]
        if with_pyr:
            pairs.append((jdec, tdec))
        for a, b in pairs:
            a, b = _pair(a, b)
            assert np.abs(a - b).max() <= TOL
        if with_pyr:
            cur = tdec.numpy()


def _assert_builds_match(jp, tp):
    """Every level within TOL; a level the JAX reference's fused gradient
    pair leaves at (6, 6) (the listed fault below: levels narrower than its
    kernel) must be all zero in the port at the level's own shape."""
    for field in ("img", "gradx", "grady"):
        for lv, (a, b) in enumerate(zip(getattr(jp, field),
                                        getattr(tp, field))):
            a, b = _pair(a, b)
            if a.shape != b.shape:
                assert field != "img" and a.shape == (6, 6), (field, lv)
                assert b.shape == tp.img[lv].shape and not b.any()
                continue
            assert np.abs(a - b).max() <= TOL, (field, lv,
                                                np.abs(a - b).max())


@pytest.mark.parametrize("levels,sub", [(1, 4), (2, 4), (3, 4), (4, 4),
                                        (1, 2), (2, 2), (3, 2), (4, 2),
                                        (9, 2)])
def test_multi_level_builds_match_jax_xla(levels, sub):
    """The plain whole-pyramid build (cuda_pyramid.pyramid_build on CPU
    tensors: pyramid_level_reference composed over the levels) against
    JAX's build_track_pyramids, 1-4 levels at subsampling 2 and 4 and nine
    levels at subsampling 2 (down to 1x1)."""
    jcfg = create_config(nPyramidLevels=levels, subsampling=sub)
    shape = (480, 640) if sub == 4 else (300, 400)
    img = make_textured_image(*shape, seed=10 * levels + sub)
    jp = jax_build_track_pyramids(jnp.asarray(img, jnp.float32), jcfg)
    cfg = config_from_jax(jcfg)
    tp = cuda_pyramid.pyramid_build(torch.tensor(img, dtype=torch.float32),
                                    cuda_pyramid.level_taps(cfg), levels)
    assert len(tp[0]) == levels
    _assert_builds_match(jp, build_track_pyramids(
        torch.tensor(img, dtype=torch.float32), cfg))
    for a, b in zip(tp, build_track_pyramids(
            torch.tensor(img, dtype=torch.float32), cfg)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_narrow_levels_are_all_zero():
    """search_range=60 -> 3 levels, subsampling 8: a 64x80 frame gives
    8x10 and 1x1 levels; passes over an extent narrower than their kernel
    zero everything (convolve.py:78 of the JAX package)."""
    jcfg = create_config(search_range=60)
    assert (jcfg.nPyramidLevels, jcfg.subsampling) == (3, 8)
    img = make_textured_image(64, 80, seed=2)
    jp = jax_build_track_pyramids(jnp.asarray(img, jnp.float32), jcfg)
    tp = build_track_pyramids(torch.tensor(img, dtype=torch.float32),
                              config_from_jax(jcfg))
    assert tuple(tp.img[2].shape) == (1, 1)
    mismatched = []
    for field in ("img", "gradx", "grady"):
        for lv, (a, b) in enumerate(zip(getattr(jp, field),
                                        getattr(tp, field))):
            a, b = _pair(a, b)
            if a.shape != b.shape:
                mismatched.append((field, lv, a.shape))
                continue
            assert np.abs(a - b).max() <= TOL
    # Listed fault of the JAX reference: its fused gradient pair
    # (convolve.py:148-175) lacks the 2r >= extent guard, so a 1x1 level
    # yields (6, 6) gradients; the port keeps the level's shape, all zero.
    assert mismatched == [("gradx", 2, (6, 6)), ("grady", 2, (6, 6))]
    # level 2 = the 8x10 level smoothed by a 43-tap kernel: all zero
    assert not tp.img[2].any()
    assert tp.gradx[2].shape == tp.img[2].shape
    assert not tp.gradx[2].any() and not tp.grady[2].any()


@pytest.mark.parametrize("sigma", [0.7, 1.0, 1.5, 3.6])
def test_convolve_matches_jax(sigma):
    """Smoothing and gradients, including unequal gauss/deriv widths
    (sigma 3.6: 21 vs 25 taps; the derivative's sign depends on the flip)."""
    img = make_textured_image(64, 96, seed=int(sigma * 10)).astype(np.float32)
    t = torch.tensor(img)
    a, b = _pair(jax_smoothed(jnp.asarray(img), sigma),
                 compute_smoothed_image(t, sigma))
    assert np.abs(a - b).max() <= TOL
    for ja, tb in zip(jax_gradients(jnp.asarray(img), sigma),
                      compute_gradients(t, sigma)):
        a, b = _pair(ja, tb)
        assert np.abs(a - b).max() <= TOL
        assert np.abs(a).max() > 1.0   # non-trivial gradients


def test_uint8_frame_builds_like_float():
    cfg = config_from_jax(create_config())
    img = make_textured_image(64, 80, seed=4)
    a = build_track_pyramids(torch.tensor(img.astype(np.uint8)), cfg)
    b = build_track_pyramids(torch.tensor(img, dtype=torch.float32), cfg)
    for x, y in zip(a.gradx + a.img, b.gradx + b.img):
        assert torch.equal(x, y)
