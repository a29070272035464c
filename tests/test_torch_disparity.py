"""Port dense disparity and depth (ops/disparity.py around K8's 1-D plain
version) vs the JAX package's ops/disparity.py, on tests/test_disparity.py's
scenes.

Both sides work on the same pyramids (the JAX build, carried over) for the
level and pyramid comparisons; the entry points (dense_disparity_lr,
dense_depth) build their own from the same frames. Bars: statuses and valid
masks exact; d within 1e-4 px per level and 2e-3 px end to end on TRACKED
pixels; depth to the relative bar 2e-3 / d. The SSD seed map is held equal
to JAX's but for the listed flipped pixel (a float32 integral-image tie)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops import disparity as jdisp
from pyfeaturetrack_tpu.ops.convolve import (compute_gradients,
                                             compute_smoothed_image)
from pyfeaturetrack_tpu.ops.pallas_lk_fused import fused_track_level
from pyfeaturetrack_tpu.ops.track import build_track_pyramids as jax_build

from pyfeaturetrack_tpu_torch.ops import disparity as tdisp
from pyfeaturetrack_tpu_torch.ops.cuda_lk_dense import (_reference,
                                                        dense_level_1d,
                                                        dense_level_1d_up)
from pyfeaturetrack_tpu_torch.ops.interp import upsample_flow
from pyfeaturetrack_tpu_torch.utils.convert import (config_from_jax,
                                                    pyramids_from_numpy)

torch.set_num_threads(2)

POS_TOL = 1e-4
DISP_TOL = 2e-3

# Seed-map pixels where the port's argmin differs from JAX's, per scene:
# (row, col) of the coarse level -> (JAX's pick, the port's pick). Class:
# a float32 tie. The box sums are differences of a float32 integral image
# whose cumulative sums round in each implementation's order (torch.cumsum
# on the CPU is sequential, XLA's is not); at (23, 34) of the 40 px scene
# JAX's SSDs for shifts 8 and 16 are 198.0 and 198.0 (first wins: 8), the
# port's 198.25 and 197.5 (16). The pixel sits on the coarse level's last
# row, whose level-0 pixels are out of bounds in both.
LISTED_SEED_FLIPS = {"sweep40": {(23, 34): (8.0, 16.0)}}


def _pyramids(left, right, jcfg):
    build = jax.jit(jax_build, static_argnames=("cfg",))
    jp = (build(jnp.asarray(left, jnp.float32), jcfg),
          build(jnp.asarray(right, jnp.float32), jcfg))
    tp = [pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                for lv in p), device="cpu") for p in jp]
    return jp, tp


def _scene(name):
    """(left, right, max_disparity) of tests/test_disparity.py."""
    if name == "subpixel":
        right = make_textured_image(96, 128, seed=11)
        return shift_image_bilinear(right, 1.5, 0.0), right, 3.0
    if name == "sweep40":
        tex = make_textured_image(96, 260, seed=5)
        return tex[:, :200], tex[:, 40:240], 64.0
    raise KeyError(name)


def _planes():
    """tests/test_disparity.py's two planes: background d = 2, box d = 10,
    composited with real visibility (occluded band left of the box)."""
    h, w = 120, 200
    bg = make_textured_image(h, w + 16, seed=7)
    fg = make_textured_image(h, w + 16, seed=8)
    b0, b1, y0, y1 = 60, 140, 30, 90
    xs = np.arange(w)[None, :]
    ys = np.arange(h)[:, None]
    in_box_r = (xs >= b0) & (xs < b1) & (ys >= y0) & (ys < y1)
    right = np.where(in_box_r, fg[:, 10:w + 10], bg[:, 2:w + 2])
    in_box_l = (xs >= b0 + 10) & (xs < b1 + 10) & (ys >= y0) & (ys < y1)
    left = np.where(in_box_l, fg[:, :w], bg[:, :w])
    return left, right


def _level(p1, p2, r=0):
    return tuple(p[r] for p in (p1.img, p1.gradx, p1.grady,
                                p2.img, p2.gradx, p2.grady))


def test_box_sum_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 10, (17, 23)).astype(np.float32)
    want = np.asarray(jdisp._box_sum(jnp.asarray(a), 3, 2))
    got = tdisp._box_sum(torch.tensor(a), 3, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["sweep40", "planes"])
def test_hypothesis_init_matches_jax(name):
    """The coarse-level SSD seed map equals JAX's but for the listed flips,
    each a tie of its two SSDs within 1 (on values of about 200)."""
    jcfg = create_config().validated_window()
    if name == "planes":
        left, right = _planes()
        max_d = 16.0
    else:
        left, right, max_d = _scene(name)
    jp, tp = _pyramids(left, right, jcfg)
    s = float(jcfg.subsampling)
    hw = jcfg.window_width // 2
    hyp = tuple(range(0, int(max_d / s) + 1, hw + 1))
    assert len(hyp) > 1
    want = np.asarray(jdisp._hypothesis_init(jp[0].img[1], jp[1].img[1], hyp,
                                             hw, hw))
    got = tdisp._hypothesis_init(tp[0].img[1], tp[1].img[1], hyp, hw,
                                 hw).numpy()
    flips = {(int(r), int(c)): (float(want[r, c]), float(got[r, c]))
             for r, c in np.argwhere(got != want)}
    listed = LISTED_SEED_FLIPS.get(name, {})
    assert flips.items() <= listed.items(), flips
    for (r, c), picks in flips.items():
        w_img = tp[0].img[1].shape[1]
        ssd = {}
        for h in picks:
            shifted = torch.nn.functional.pad(tp[1].img[1], (int(h), 0))
            ssd[h] = tdisp._box_sum((tp[0].img[1] - shifted[:, :w_img]) ** 2,
                                    hw, hw)[r, c].item()
        assert abs(ssd[picks[0]] - ssd[picks[1]]) <= 1.0, ssd


@pytest.mark.parametrize("lighting", [False, True])
def test_disparity_level_matches_xla(lighting):
    """One level of the subpixel scene from a start within half a pixel:
    statuses exact, d within 1e-4 px. With lighting_insensitive=True the
    port, like JAX's XLA route (disparity.py:144, :168), ignores the flag:
    the result equals the flag-off result bit for bit."""
    jcfg = create_config(lighting_insensitive=lighting).validated_window()
    left, right, _ = _scene("subpixel")
    jp, tp = _pyramids(left, right, jcfg)
    rng = np.random.default_rng(6)
    d0 = (1.5 + rng.uniform(-0.5, 0.5, (96, 128))).astype(np.float32)
    jd, js = jax.jit(jdisp.disparity_level, static_argnames=("cfg",))(
        *_level(*jp), jnp.asarray(d0), jcfg)
    tcfg = config_from_jax(jcfg)
    td, ts, ti = dense_level_1d(*_level(*tp), torch.tensor(d0), tcfg)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=POS_TOL)
    assert (ts.numpy() == 0).mean() > 0.5
    off = dense_level_1d(*_level(*tp), torch.tensor(d0),
                         tcfg.replace(lighting_insensitive=False))
    for a, b in zip((td, ts, ti), off):
        assert torch.equal(a, b)


def test_disparity_level_matches_fused_kernel():
    """K8's 1-D plain version against the TPU kernel's one_d mode
    (fused_track_level, interpret mode, lighting off) over every pixel of a
    40x56 level: statuses and iterations exact, d within 1e-3 px. The 1-D
    step reads only gx; bounds are checked at (x2, y1)."""
    jcfg = create_config()
    h, w = 40, 56
    right = make_textured_image(h, w + 8, seed=21)
    left = shift_image_bilinear(right, 2.5, 0.0)
    lvl = []
    for img in (left[:, :w], right[:, :w]):
        s = compute_smoothed_image(jnp.asarray(img, jnp.float32),
                                   jcfg.smooth_sigma)
        lvl += [s, *compute_gradients(s, jcfg.grad_sigma)]
    rng = np.random.default_rng(8)
    d0 = (2.5 + rng.uniform(-0.5, 0.5, (h, w))).astype(np.float32)
    x1 = jnp.tile(jnp.arange(w, dtype=jnp.float32), h)
    y1 = jnp.repeat(jnp.arange(h, dtype=jnp.float32), w)
    fx, _, fs, fi = fused_track_level(
        x1, y1, x1 - jnp.asarray(d0).ravel(), y1, *lvl, jcfg,
        jnp.ones(x1.shape, bool), interpret=True, one_d=True)
    td, ts, ti = dense_level_1d(*(torch.tensor(np.asarray(t)) for t in lvl),
                                torch.tensor(d0), config_from_jax(jcfg))
    np.testing.assert_array_equal(ts.numpy().ravel(), np.asarray(fs))
    np.testing.assert_array_equal(ti.numpy().ravel(), np.asarray(fi))
    np.testing.assert_allclose(td.numpy().ravel(), np.asarray(x1 - fx),
                               rtol=0, atol=1e-3)
    assert (ts.numpy() == 0).mean() > 0.4


@pytest.mark.parametrize("name", ["subpixel", "sweep40"])
def test_dense_disparity_pyramids_matches_jax(name):
    jcfg = create_config().validated_window()
    left, right, max_d = _scene(name)
    jp, tp = _pyramids(left, right, jcfg)
    want = jdisp.dense_disparity_pyramids(*jp, jcfg, max_disparity=max_d)
    got = tdisp.dense_disparity_pyramids(*tp, config_from_jax(jcfg),
                                         max_disparity=max_d)
    st = got.status.numpy()
    np.testing.assert_array_equal(st, np.asarray(want.status))
    ok = st == 0
    assert ok.mean() > 0.3
    np.testing.assert_allclose(got.d.numpy()[ok], np.asarray(want.d)[ok],
                               rtol=0, atol=DISP_TOL)
    true_d = {"subpixel": 1.5, "sweep40": 40.0}[name]
    inner = np.zeros_like(ok)
    inner[10:-10, 50 if name == "sweep40" else 10:-10] = True
    assert abs(np.median(got.d.numpy()[ok & inner]) - true_d) < 0.2


def test_dense_level_1d_up_plain_is_upsample_then_level():
    """K8's 1-D upsampled start, plain version: upsample_flow of the coarser
    disparity map then the 1-D level solve from the map, bit for bit."""
    jcfg = create_config().validated_window()
    left, right, _ = _scene("subpixel")
    _, tp = _pyramids(left, right, jcfg)
    lvl = _level(*tp)
    h, w = lvl[0].shape
    d = torch.tensor(np.random.default_rng(2).uniform(0.0, 1.0,
                                                      (h // 4, w // 4)),
                     dtype=torch.float32)
    got = dense_level_1d_up(*lvl, d, 4.0, config_from_jax(jcfg))
    want = _reference(lvl, upsample_flow(d, (h, w), 4.0), None,
                      config_from_jax(jcfg), True)
    for a, b in zip(got, (want[0], want[2], want[3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["subpixel", "sweep40"])
def test_dense_disparity_pyramids_equals_upsampling_outside_k8(name):
    """Coarse to fine through K8's upsampled start equals the loop that
    upsampled each level's start with upsample_flow, bit for bit."""
    jcfg = create_config().validated_window()
    cfg = config_from_jax(jcfg)
    left, right, max_d = _scene(name)
    _, (pl, pr) = _pyramids(left, right, jcfg)
    got = tdisp.dense_disparity_pyramids(pl, pr, cfg, max_disparity=max_d)
    s = float(cfg.subsampling)
    n_levels = cfg.nPyramidLevels
    hw, hh = cfg.window_width // 2, cfg.window_height // 2
    hyp = tuple(range(0, int(max_d / s ** (n_levels - 1)) + 1, hw + 1))
    d = tdisp._hypothesis_init(pl.img[-1], pr.img[-1], hyp, hw, hh)
    for r in range(n_levels - 1, -1, -1):
        shape = tuple(pl.img[r].shape)
        if shape != tuple(d.shape):
            d = upsample_flow(d, shape, s)
        d, status, _ = dense_level_1d(*_level(pl, pr, r), d, cfg)
    assert torch.equal(got.d, d) and torch.equal(got.status, status)


def test_dense_disparity_lr_matches_jax_on_planes():
    """tests/test_disparity.py's two planes through the entry point (each
    side builds its own pyramids from the same frames): statuses and the
    LR valid mask exact, d and the LR error within 2e-3 px; the box, the
    background and the occluded band as that test requires."""
    jcfg = create_config()
    left, right = _planes()
    jdl, jerr, jvalid = jdisp.dense_disparity_lr(left, right, jcfg,
                                                 max_disparity=16.0)
    tdl, terr, tvalid = tdisp.dense_disparity_lr(
        left, right, config_from_jax(jcfg), max_disparity=16.0, device="cpu")
    st = tdl.status.numpy()
    v = tvalid.numpy()
    np.testing.assert_array_equal(st, np.asarray(jdl.status))
    np.testing.assert_array_equal(v, np.asarray(jvalid))
    ok = st == 0
    np.testing.assert_allclose(tdl.d.numpy()[ok], np.asarray(jdl.d)[ok],
                               rtol=0, atol=DISP_TOL)
    np.testing.assert_allclose(terr.numpy()[v], np.asarray(jerr)[v], rtol=0,
                               atol=DISP_TOL)
    d = tdl.d.numpy()
    assert abs(np.median(d[30 + 8:90 - 8, 60 + 18:140 + 2][
        v[30 + 8:90 - 8, 60 + 18:140 + 2]]) - 10.0) < 0.3
    assert v[30 + 8:90 - 8, 60 + 3:60 + 9].mean() < 0.4


def test_dense_depth_matches_jax():
    """tests/test_disparity.py's metric scene (d = 8, fx 100, baseline 0.5):
    valid mask exact, depth within the relative bar 2e-3 / d, invalid
    pixels 0; numpy out, as JAX's."""
    jcfg = create_config()
    tex = make_textured_image(96, 180, seed=9)
    left, right = tex[:, :160], tex[:, 8:168]
    K = np.array([[100.0, 0, 80], [0, 100.0, 48], [0, 0, 1]])
    jdep, jd, jv = jdisp.dense_depth(left, right, K, baseline=0.5, cfg=jcfg,
                                     max_disparity=16.0)
    tdep, td, tv = tdisp.dense_depth(left, right, K, baseline=0.5,
                                     cfg=config_from_jax(jcfg),
                                     max_disparity=16.0, device="cpu")
    assert isinstance(tdep, np.ndarray) and tdep.dtype == np.float32
    np.testing.assert_array_equal(tv, np.asarray(jv))
    rel = np.abs(tdep - jdep)[tv] / jdep[tv]
    assert (rel <= DISP_TOL / td[tv]).all()
    assert (tdep[~tv] == 0).all()
    inner = np.zeros_like(tv)
    inner[10:-10, 20:-10] = True
    assert abs(np.median(tdep[tv & inner]) - 100.0 * 0.5 / 8.0) < 0.1


def test_dense_disparity_uint8_entry():
    """dense_disparity takes uint8 frames (cast on the device) and returns
    a DenseDisparity with finite maps (tests/test_disparity.py's entry
    scene, d = 4)."""
    tex = make_textured_image(64, 120, seed=3)
    left = tex[:, :100].astype(np.uint8)
    right = tex[:, 4:104].astype(np.uint8)
    out = tdisp.dense_disparity(left, right, max_disparity=8.0, device="cpu")
    assert isinstance(out, tdisp.DenseDisparity)
    ok = out.status.numpy() == 0
    assert ok.mean() > 0.4
    assert np.isfinite(out.d.numpy()).all()
    assert abs(np.median(out.d.numpy()[ok]) - 4.0) < 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tdisp.dense_disparity(left, right, max_disparity=8.0)
