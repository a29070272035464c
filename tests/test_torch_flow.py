"""Port dense flow (ops/flow.py around K8's plain version,
ops/cuda_lk_dense.py) vs the JAX package's ops/flow.py.

Both sides work on the SAME pyramids (the JAX XLA build, carried over with
utils/convert.pyramids_from_numpy), so only the dense LK code differs. Bars:
per level, statuses and iteration counts exact and positions within 1e-4 px
(the bar of tests/test_track.py:53); end to end, statuses exact and u, v
within 2e-3 px (tests/test_pallas_flow_fused.py:117-120). Every pixel over
1e-4 px is listed below with its class (ROADMAP.md Queue 3): the port sums
each window in row-major order with every product and sum rounded on its
own, while XLA on the CPU contracts multiply-adds into FMAs, so lanes that
never converge (ten updates, or driven out of the image) drift apart in the
last bits over their iterations."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops import flow as jflow
from pyfeaturetrack_tpu.ops.convolve import (compute_gradients,
                                             compute_smoothed_image)
from pyfeaturetrack_tpu.ops.pallas_lk_fused import fused_track_level
from pyfeaturetrack_tpu.ops.track import build_track_pyramids as jax_build
from pyfeaturetrack_tpu.ops.track import track_feature_level

from pyfeaturetrack_tpu_torch.ops import flow as tflow
from pyfeaturetrack_tpu_torch.ops.cuda_lk_dense import (_reference,
                                                        dense_level,
                                                        dense_level_up)
from pyfeaturetrack_tpu_torch.utils.convert import (config_from_jax,
                                                    pyramids_from_numpy)

torch.set_num_threads(2)

POS_TOL = 1e-4     # per level (tests/test_track.py:53)
FLOW_TOL = 2e-3    # end to end (tests/test_pallas_flow_fused.py:117-120)

# Pixels over POS_TOL, (row, col): class. "drift": a lane that never
# converges (status LARGE_RESIDUE / OOB / MAX_ITERATIONS after its last
# allowed updates), float-order drift over its iterations, within FLOW_TOL.
# "lost": the same in the lighting-insensitive mode, where the gain
# alpha = sqrt(s11 / s22) of a window at the rim amplifies the drift; the
# tracker reports these lanes lost; they read at most 7.2e-3 px, held
# within 1e-2 px. "straddle": a TRACKED pixel whose third update
# is |dx| = 0.0999985 px in JAX and 0.1000061 px in the port against
# min_displacement 0.1, so the port takes one more update (4 against 3);
# bound by min_displacement.
LISTED_LEVEL = {
    False: {(4, 114): "drift", (9, 3): "drift", (38, 4): "drift"},
    True: dict.fromkeys([
        (3, 33), (3, 35), (3, 37), (3, 59), (4, 32), (4, 36), (4, 40),
        (4, 44), (4, 55), (4, 59), (6, 57), (11, 4), (14, 4), (17, 59),
        (20, 59), (26, 34), (34, 59), (43, 9), (43, 10), (43, 14), (43, 15),
        (43, 35), (43, 38)], "lost"),
}
BOUNDS = {"drift": 2e-3, "lost": 1e-2}
LISTED_PYRAMIDS = {
    ((48, 64), "default"): {(3, 58): "drift", (6, 57): "drift",
                            (7, 57): "drift", (41, 59): "drift"},
    ((48, 64), "3 levels"): {(3, 58): "drift", (6, 57): "drift",
                             (7, 57): "drift", (41, 59): "drift"},
    ((48, 64), "9x9"): {},
    ((48, 64), "4 iterations"): {},
    ((96, 128), "default"): {(3, 5): "drift", (3, 114): "drift",
                             (8, 3): "drift", (39, 104): "straddle",
                             (89, 28): "drift", (90, 29): "drift"},
    ((96, 128), "3 levels"): {(3, 5): "drift", (3, 114): "drift",
                              (8, 3): "drift", (89, 28): "drift",
                              (90, 29): "drift"},
    ((96, 128), "9x9"): {(36, 4): "drift"},
    ((96, 128), "4 iterations"): {},
}
CONFIGS = {"default": {},
           "3 levels": dict(nPyramidLevels=3, subsampling=2),
           "9x9": dict(window_width=9, window_height=9),
           "4 iterations": dict(max_iterations=4, min_displacement=0.05)}


def _textured(h, w, seed=0, passes=2):
    """tests/test_flow.py's texture."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h + 16, w + 16))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for _ in range(passes):
        for axis in (0, 1):
            img = np.apply_along_axis(
                lambda m: np.convolve(m, k, mode="same"), axis, img)
    return img


def _pair(h, w, seed=14):
    """Content moves by (-2, -1) px (true flow u = -2, v = -1)."""
    base = _textured(h, w, seed)
    return (np.asarray(base[4:4 + h, 4:4 + w], np.float32),
            np.asarray(base[5:5 + h, 6:6 + w], np.float32))


def _pyramids(img1, img2, jcfg):
    build = jax.jit(jax_build, static_argnames=("cfg",))
    jp = (build(jnp.asarray(img1), jcfg), build(jnp.asarray(img2), jcfg))
    tp = [pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                for lv in p), device="cpu") for p in jp]
    return jp, tp


def _level(p1, p2, r=0):
    return tuple(p[r] for p in (p1.img, p1.gradx, p1.grady,
                                p2.img, p2.gradx, p2.grady))


def _deviators(du, dv, tol=POS_TOL):
    return {(int(r), int(c)) for r, c in np.argwhere((du > tol) | (dv > tol))}


def _check_listed(du, dv, status, listed, cfg):
    """Every pixel over POS_TOL is listed; listed pixels stay within their
    class's bound."""
    dev = _deviators(du, dv)
    assert dev <= set(listed), sorted(
        (p, int(status[p]), float(du[p]), float(dv[p]))
        for p in dev - set(listed))
    for p, cls in listed.items():
        bound = (cfg.min_displacement if cls == "straddle"
                 else BOUNDS[cls])
        assert max(du[p], dv[p]) <= bound, (p, cls, du[p], dv[p])
        assert (status[p] == 0) == (cls == "straddle"), (p, cls)


@pytest.mark.parametrize("lighting,shape", [(False, (96, 128)),
                                            (True, (48, 64))])
def test_flow_level_matches_xla(lighting, shape):
    """One level from the same start (random within half a pixel): u, v and
    status against flow_level, iterations against track_feature_level over
    the same grid (flow_level returns none). The lighting-insensitive case
    sees frame 2 at gain 0.8 and bias 20."""
    jcfg = create_config(lighting_insensitive=lighting).validated_window()
    h, w = shape
    img1, img2 = _pair(h, w)
    if lighting:
        img2 = img2 * np.float32(0.8) + np.float32(20.0)
    jp, tp = _pyramids(img1, img2, jcfg)
    rng = np.random.default_rng(4)
    u0 = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    v0 = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    ju, jv, js = jax.jit(jflow.flow_level, static_argnames=("cfg",))(
        *_level(*jp), jnp.asarray(u0), jnp.asarray(v0), jcfg)
    x1 = jnp.tile(jnp.arange(w, dtype=jnp.float32), h)
    y1 = jnp.repeat(jnp.arange(h, dtype=jnp.float32), w)
    ji = np.asarray(jax.jit(track_feature_level, static_argnames=("cfg",))(
        x1, y1, x1 + jnp.asarray(u0).ravel(), y1 + jnp.asarray(v0).ravel(),
        *_level(*jp), jcfg, jnp.ones(x1.shape, bool))[3]).reshape(h, w)
    tu, tv, ts, ti = dense_level(*_level(*tp), torch.tensor(u0),
                                 torch.tensor(v0), config_from_jax(jcfg))
    st = ts.numpy()
    np.testing.assert_array_equal(st, np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), ji)
    du = np.abs(tu.numpy() - np.asarray(ju))
    dv = np.abs(tv.numpy() - np.asarray(jv))
    _check_listed(du, dv, st, LISTED_LEVEL[lighting], jcfg)
    assert (st == 0).mean() > 0.5


def test_flow_level_matches_fused_kernel():
    """K8's plain version against the TPU kernel it replaces
    (fused_track_level, interpret mode) over every pixel of a 40x56 level:
    statuses and iterations exact, positions within 1e-3 px
    (tests/test_pallas_flow_fused.py:73-74)."""
    jcfg = create_config()
    h, w = 40, 56
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (h + 8, w + 8))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for axis in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, base)
    a = jnp.asarray(base[:h, :w], jnp.float32)
    b = jnp.asarray(base[1:h + 1, 1:w + 1], jnp.float32)
    s1 = compute_smoothed_image(a, jcfg.smooth_sigma)
    s2 = compute_smoothed_image(b, jcfg.smooth_sigma)
    lvl = (s1, *compute_gradients(s1, jcfg.grad_sigma),
           s2, *compute_gradients(s2, jcfg.grad_sigma))
    r = np.random.default_rng(4)
    u0 = r.uniform(-0.5, 0.5, (h, w)).astype(np.float32)
    v0 = r.uniform(-0.5, 0.5, (h, w)).astype(np.float32)
    x1 = jnp.tile(jnp.arange(w, dtype=jnp.float32), h)
    y1 = jnp.repeat(jnp.arange(h, dtype=jnp.float32), w)
    fx, fy, fs, fi = fused_track_level(
        x1, y1, x1 + jnp.asarray(u0).ravel(), y1 + jnp.asarray(v0).ravel(),
        *lvl, jcfg, jnp.ones(x1.shape, bool), interpret=True)
    tu, tv, ts, ti = dense_level(*(torch.tensor(np.asarray(t)) for t in lvl),
                                 torch.tensor(u0), torch.tensor(v0),
                                 config_from_jax(jcfg))
    np.testing.assert_array_equal(ts.numpy().ravel(), np.asarray(fs))
    np.testing.assert_array_equal(ti.numpy().ravel(), np.asarray(fi))
    np.testing.assert_allclose(tu.numpy().ravel(),
                               np.asarray(fx - x1), atol=1e-3)
    np.testing.assert_allclose(tv.numpy().ravel(),
                               np.asarray(fy - y1), atol=1e-3)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("shape", [(48, 64), (96, 128)])
def test_dense_flow_pyramids_matches_jax(shape, config):
    """Coarse to fine over the config matrix of tests/test_flow.py:66-70:
    statuses exact, u and v within 1e-4 px but the listed pixels."""
    jcfg = create_config().replace(**CONFIGS[config]).validated_window()
    jp, tp = _pyramids(*_pair(*shape), jcfg)
    jf = jax.jit(jflow.dense_flow_pyramids, static_argnames=("cfg",))(
        *jp, jcfg)
    tf = tflow.dense_flow_pyramids(*tp, config_from_jax(jcfg))
    st = tf.status.numpy()
    np.testing.assert_array_equal(st, np.asarray(jf.status))
    du = np.abs(tf.u.numpy() - np.asarray(jf.u))
    dv = np.abs(tf.v.numpy() - np.asarray(jf.v))
    _check_listed(du, dv, st, LISTED_PYRAMIDS[(shape, config)], jcfg)
    if config == "default":
        inner = np.zeros(shape, bool)
        inner[12:-12, 12:-12] = True
        ok = (st == 0) & inner
        assert abs(np.median(tf.u.numpy()[ok]) + 2.0) < 0.05
        assert abs(np.median(tf.v.numpy()[ok]) + 1.0) < 0.05


@pytest.mark.parametrize("coarse", [(12, 16), (1, 16), (12, 1)])
def test_dense_level_up_plain_is_upsample_then_level(coarse):
    """K8's upsampled start, plain version: upsample_flow of the coarser
    maps then the level solve from maps (_reference), bit for bit, also
    from a map one row or one column high (flat indices wrap); the zero
    start is the solve from zero maps."""
    cfg = config_from_jax(create_config())
    _, tp = _pyramids(*_pair(48, 64), create_config().validated_window())
    lvl = _level(*tp)
    rng = np.random.default_rng(8)
    uc, vc = (torch.tensor(rng.uniform(-1.0, 1.0, coarse), dtype=torch.float32)
              for _ in range(2))
    got = dense_level_up(*lvl, uc, vc, 4.0, cfg)
    want = _reference(lvl, tflow.upsample_flow(uc, (48, 64), 4.0),
                      tflow.upsample_flow(vc, (48, 64), 4.0), cfg, False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    zero = torch.zeros((48, 64))
    for a, b in zip(dense_level_up(*lvl, None, None, 4.0, cfg),
                    _reference(lvl, zero, zero, cfg, False)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config", ["default", "3 levels"])
def test_dense_flow_pyramids_equals_upsampling_outside_k8(config):
    """Coarse to fine through K8's start modes equals the loop that
    upsampled each level's start with upsample_flow and solved from maps,
    bit for bit."""
    jcfg = create_config().replace(**CONFIGS[config]).validated_window()
    cfg = config_from_jax(jcfg)
    _, (p1, p2) = _pyramids(*_pair(48, 64), jcfg)
    u = torch.zeros(p1.img[-1].shape)
    v = torch.zeros_like(u)
    for r in range(cfg.nPyramidLevels - 1, -1, -1):
        shape = tuple(p1.img[r].shape)
        if shape != tuple(u.shape):
            u = tflow.upsample_flow(u, shape, float(cfg.subsampling))
            v = tflow.upsample_flow(v, shape, float(cfg.subsampling))
        u, v, status, _ = dense_level(*_level(p1, p2, r), u, v, cfg)
    got = tflow.dense_flow_pyramids(p1, p2, cfg)
    for a, b in zip(got, (u, v, status)):
        assert torch.equal(a, b)


def test_upsample_flow_and_warp_image_match_jax():
    rng = np.random.default_rng(0)
    u = rng.uniform(-3, 3, (24, 32)).astype(np.float32)
    want = np.asarray(jflow.upsample_flow(jnp.asarray(u), (96, 128), 4.0))
    got = tflow.upsample_flow(torch.tensor(u), (96, 128), 4.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    fu = rng.uniform(-3, 3, (40, 56)).astype(np.float32)
    fv = rng.uniform(-3, 3, (40, 56)).astype(np.float32)
    want = np.asarray(jflow.warp_image(*(jnp.asarray(a) for a in
                                         (img, fu, fv))))
    got = tflow.warp_image(*(torch.tensor(a) for a in (img, fu, fv))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_dense_flow_fb_matches_jax_on_occlusion_scene():
    """tests/test_fb_check.py:112's scene (a block of fresh texture in frame
    2): valid mask equal, round-trip error within 2e-3 where valid, and the
    gate's physics (occluded block mostly invalid, clean area valid)."""
    jcfg = create_config().validated_window()
    h, w = 96, 128
    base = make_textured_image(h, w, seed=23)
    img2 = shift_image_bilinear(base, 1.0, -0.5).copy()
    img2[30:70, 40:90] = make_textured_image(40, 50, seed=98)
    jp, tp = _pyramids(np.asarray(base, np.float32),
                       np.asarray(img2, np.float32), jcfg)
    jfwd, jerr, jvalid = jflow.dense_flow_fb(*jp, jcfg)
    tfwd, terr, tvalid = tflow.dense_flow_fb(*tp, config_from_jax(jcfg))
    valid = tvalid.numpy()
    np.testing.assert_array_equal(tfwd.status.numpy(), np.asarray(jfwd.status))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    np.testing.assert_allclose(terr.numpy()[valid], np.asarray(jerr)[valid],
                               rtol=0, atol=FLOW_TOL)
    assert valid[38:62, 48:82].mean() < 0.35
    assert valid[16:80, 12:28].mean() > 0.6


def test_flow_consistency_rounds_half_to_even():
    """The landing pixel of flow_consistency is torch.round's, half to even
    like jnp.round: with a flow of +0.5 column 2 lands on column 2 and
    column 3 on column 4, so no pixel lands on column 3, whose backward
    status is not TRACKED (rounding half up would send column 2 there)."""
    z = torch.zeros((1, 6))
    u = torch.full((1, 6), 0.5)
    bad = torch.zeros((1, 6), dtype=torch.int32)
    bad[0, 3] = -4                     # column 3 is not TRACKED backward
    fwd = tflow.DenseFlow(u, z, torch.zeros((1, 6), dtype=torch.int32))
    bwd = tflow.DenseFlow(-u, z, bad)
    _, valid = tflow.flow_consistency(fwd, bwd)
    _, jvalid = jflow.flow_consistency(
        jflow.DenseFlow(*(jnp.asarray(t.numpy()) for t in fwd)),
        jflow.DenseFlow(*(jnp.asarray(t.numpy()) for t in bwd)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.numpy()[0].all()


def test_dense_flow_batched_equals_per_pair():
    cfg = config_from_jax(create_config())
    pairs = [_pair(48, 64, seed=s) for s in (3, 4)]
    got = tflow.dense_flow_batched(np.stack([p[0] for p in pairs]),
                                   np.stack([p[1] for p in pairs]), cfg,
                                   device="cpu")
    assert got.u.shape == (2, 48, 64)
    for b, (a, c) in enumerate(pairs):
        want = tflow.compute_dense_flow(a, c, cfg, device="cpu")
        for x, y in zip(got, want):
            assert torch.equal(x[b], y)


def test_flow_to_rgb_matches_jax():
    rng = np.random.default_rng(0)
    u = rng.uniform(-2, 2, (32, 48)).astype(np.float32)
    v = rng.uniform(-2, 2, (32, 48)).astype(np.float32)
    for mag in (None, 1.5):
        want = jflow.flow_to_rgb(u, v, max_mag=mag)
        got = tflow.flow_to_rgb(torch.tensor(u), torch.tensor(v), max_mag=mag)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_compute_dense_flow_devices():
    """Arrays go to "cuda" unless device="cpu" (with no CUDA device that
    raises); tensors stay on their own device."""
    a, b = _pair(48, 64)
    fl = tflow.compute_dense_flow(a, b, device="cpu")
    assert fl.u.device.type == "cpu" and fl.status.dtype == torch.int32
    assert tflow.compute_dense_flow(torch.tensor(a), torch.tensor(b)
                                    ).u.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tflow.compute_dense_flow(a, b)
