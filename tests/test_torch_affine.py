"""The affine-consistency slice of the port vs the JAX package.

* ``ops/linalg`` (``gauss_solve_det``, ``inv3x3``) and ``ops/interp``
  (``bilinear``, ``gather_window``) against the JAX functions: bit-equal.
* K6's plain version (``ops/affine._affine_track_batch``) against JAX's
  XLA batch on the scenarios of tests/test_pallas_affine_vec.py and
  tests/test_pallas_affine_fused.py: statuses exact, positions and warp
  entries within 1e-4; against the K6 (vec) and K7 (fused) Pallas kernels
  in interpret mode at their own bar: statuses exact, 1e-3.
* ``affine_consistency_check`` against JAX's on capture, loss and a
  template kept through a replace: features and the whole AffineState.
* ``affine_state_from_numpy`` round trip; K6's launch shape by window.
  The slice end to end
  (``track_sequence_device`` in modes 0, 1, 2) is in
  test_torch_sequence.py.

Inputs are made with numpy from seeds and handed to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image
from test_pallas_affine_fused import _inputs as fused_inputs
from test_pallas_affine_vec import _scene as vec_scene

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.features import FeatureState as JFeatureState
from pyfeaturetrack_tpu.features import reset_affine as jax_reset_affine
from pyfeaturetrack_tpu.ops.affine import (
    _affine_track_batch as jax_affine_batch,
    affine_consistency_check as jax_affine_check,
    make_affine_state as jax_make_affine_state)
from pyfeaturetrack_tpu.ops.convolve import compute_gradients
from pyfeaturetrack_tpu.ops.interp import bilinear as jax_bilinear
from pyfeaturetrack_tpu.ops.interp import gather_window as jax_gather_window
from pyfeaturetrack_tpu.ops.linalg import gauss_solve_det as jax_gauss
from pyfeaturetrack_tpu.ops.linalg import inv3x3 as jax_inv3x3
from pyfeaturetrack_tpu.ops.pallas_affine_fused import (
    fused_affine_track_batch)
from pyfeaturetrack_tpu.ops.pallas_affine_vec import vec_affine_with_fallback
from pyfeaturetrack_tpu.ops.track import build_track_pyramids as jax_pyramids
from pyfeaturetrack_tpu.ops.track import (
    track_features_pyramids as jax_track)

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.features import FeatureState, reset_affine
from pyfeaturetrack_tpu_torch.ops.affine import (affine_consistency_check,
                                                 make_affine_state)
from pyfeaturetrack_tpu_torch.ops.cuda_affine import (affine_track_batch,
                                                      launch_shape)
from pyfeaturetrack_tpu_torch.ops.interp import bilinear, gather_window
from pyfeaturetrack_tpu_torch.ops.linalg import gauss_solve_det, inv3x3
from pyfeaturetrack_tpu_torch.utils.convert import (affine_state_from_numpy,
                                                    config_from_jax,
                                                    features_from_numpy,
                                                    pyramids_from_numpy)

torch.set_num_threads(2)

POS_TOL = 1e-4       # the port's bar against JAX's XLA path
KERNEL_TOL = 1e-3    # the Pallas kernels' own bar (test_pallas_affine_vec)
AFF_FIELDS = ("img", "gradx", "grady", "x", "y", "A", "valid", "nit")


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------- linalg

def _spd(p, n, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, p, p + 3)).astype(np.float32)
    return (m @ m.transpose(0, 2, 1)).astype(np.float32), \
        rng.standard_normal((n, p)).astype(np.float32)


@pytest.mark.parametrize("p", [2, 4, 6])
def test_gauss_solve_det_matches_jax(p):
    A, b = _spd(p, 40, seed=p)
    A[0] = 0.0                        # singular lane: every pivot guarded
    A[1, 0, :] = A[1, 1, :]           # rank-deficient lane
    A[1, :, 0] = A[1, :, 1]
    jx, jd = jax_gauss(jnp.asarray(A), jnp.asarray(b))
    tx, td = gauss_solve_det(_t(A), _t(b))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    ok = np.abs(np.asarray(jd)) > 1e-3
    np.testing.assert_allclose(tx.numpy()[ok],
                               np.linalg.solve(A[ok], b[ok][..., None])[..., 0],
                               rtol=2e-2, atol=1e-3)


def test_inv3x3_matches_jax():
    M, _ = _spd(3, 30, seed=9)
    M[0] = 0.0
    ji, jd = jax_inv3x3(jnp.asarray(M))
    ti, td = inv3x3(_t(M))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------- interp

def test_bilinear_and_gather_window_match_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    xs = rng.uniform(-5, 60, (7, 9, 11)).astype(np.float32)
    ys = rng.uniform(-5, 44, (7, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        bilinear(_t(img), _t(xs), _t(ys)).numpy(),
        np.asarray(jax_bilinear(jnp.asarray(img), jnp.asarray(xs),
                                jnp.asarray(ys))))
    x = rng.uniform(-3, 58, 25).astype(np.float32)
    y = rng.uniform(-3, 42, 25).astype(np.float32)
    for hw, hh in ((7, 7), (5, 8), (1, 3)):
        np.testing.assert_array_equal(
            gather_window(_t(img), _t(x), _t(y), hw, hh).numpy(),
            np.asarray(jax_gather_window(jnp.asarray(img), jnp.asarray(x),
                                         jnp.asarray(y), hw, hh)))


# ----------------------------------------------------- the GN batch (K6)

def _small_det_inputs():
    """A flat frame 2: zero gradients, singular normal matrices."""
    cfg = create_config(affineConsistencyCheck=2)
    args = fused_inputs(cfg, n=20, seed=5)
    flat = jnp.full_like(args[1], 100.0)
    zero = jnp.zeros_like(args[2])
    return cfg, (args[0], flat, zero, zero) + args[4:]


def _vec_small_det_inputs():
    cfg = create_config(affineConsistencyCheck=2)
    h, w, n = 120, 160, 12
    img = jnp.full((h, w), 80.0, jnp.float32)
    gx, gy = compute_gradients(img, cfg.grad_sigma)
    hw = cfg.affine_window_width // 2
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(hw + 3, w - hw - 4, n), jnp.float32)
    y = jnp.asarray(rng.uniform(hw + 3, h - hw - 4, n), jnp.float32)
    tmpl = jax_gather_window(img, x, y, hw, hw)
    A0 = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (n, 2, 2))
    return cfg, (tmpl, img, gx, gy, x, y, A0, jnp.ones((n,), bool))


def _scenario(name):
    """(cfg, args, statuses the scenario must produce) for one scenario of
    the Pallas affine test files."""
    c2 = create_config(affineConsistencyCheck=2)
    if name.startswith("modes"):
        cfg = create_config(affineConsistencyCheck=int(name[-1]))
        return cfg, fused_inputs(cfg), {0}
    if name == "unchecked":
        cfg, args = vec_scene(n=30)
        check = jnp.asarray(np.arange(30) % 3 == 0)
        return cfg, args[:7] + (check,), {0}
    if name == "oob":
        return c2, fused_inputs(c2, margin=7, seed=4), {-4}
    if name == "small_det":
        cfg, args = _small_det_inputs()
        return cfg, args, {-2}
    if name == "small_det_flat_frames":
        cfg, args = _vec_small_det_inputs()
        return cfg, args, {-2}
    if name == "large_residue":
        return c2, fused_inputs(c2, tmpl_seed=99, seed=6), {-5}
    if name == "drift":
        cfg = create_config(affineConsistencyCheck=2,
                            affine_max_displacement_differ=0.05)
        return cfg, fused_inputs(cfg, start_err=(0.4, -0.3), seed=7), {-4}
    if name == "drift_far_start":
        cfg, args = vec_scene(seed=5)
        return cfg, args[:4] + (args[4] + 3.0, args[5] + 2.0) + args[6:], {-4}
    if name == "residue_tight":
        cfg, args = vec_scene(seed=5)
        return cfg.replace(affine_max_residue=0.5), args, {-5}
    if name == "stale_warp_2.4":
        cfg, args = vec_scene(seed=7, n=16)
        A0 = jnp.broadcast_to(2.4 * jnp.eye(2, dtype=jnp.float32),
                              (16, 2, 2))
        return cfg, args[:6] + (A0,) + args[7:], set()
    if name.startswith("extreme_warp"):
        scale = float(name.split("_")[-1])
        return c2, fused_inputs(c2, n=24, seed=8, margin=30,
                                scale_A=scale), set()
    if name == "ragged":
        return c2, fused_inputs(c2, n=13, seed=9), {0}
    if name == "rect_13x11":
        cfg = create_config(affineConsistencyCheck=2, affine_window_width=13,
                            affine_window_height=11)
        return cfg, fused_inputs(cfg, seed=10), {0}
    if name == "rect_11x17":
        cfg = create_config(affineConsistencyCheck=2, affine_window_width=11,
                            affine_window_height=17)
        return vec_scene(cfg=cfg) + ({0},)
    raise KeyError(name)


SCENARIOS = ["modes_0", "modes_1", "modes_2", "unchecked", "oob",
             "small_det", "small_det_flat_frames", "large_residue",
             "residue_tight", "drift", "drift_far_start", "extreme_warp_3.0",
             "extreme_warp_4.0", "stale_warp_2.4", "ragged", "rect_13x11",
             "rect_11x17"]


def _port_batch(cfg, args):
    return affine_track_batch(*(_t(a) for a in args), config_from_jax(cfg))


def _assert_batch(got, want, check, tol):
    """Statuses exact on every lane; x, y, A within ``tol`` on the checked
    lanes the reference keeps TRACKED; unchecked lanes pass through."""
    gx, gy, gA, gs = (np.asarray(a) for a in got[:4])
    wx, wy, wA, ws = (np.asarray(a) for a in want[:4])
    np.testing.assert_array_equal(gs, ws)
    ok = check & (ws == 0)
    for g, w in ((gx, wx), (gy, wy), (gA, wA)):
        np.testing.assert_allclose(g[ok], w[ok], atol=tol, rtol=0)


@pytest.mark.parametrize("name", SCENARIOS)
def test_affine_batch_matches_jax_xla(name):
    cfg, args, must = _scenario(name)
    got = _port_batch(cfg, args)
    want = jax_affine_batch(*args, cfg)
    check = np.asarray(args[7])
    _assert_batch(got, want, check, POS_TOL)
    st = got[3].numpy()
    assert must <= set(st[check].tolist()), (name, np.unique(st[check]))
    # unchecked lanes pass through untouched with 0 iterations
    un = ~check
    np.testing.assert_array_equal(st[un], 0)
    np.testing.assert_array_equal(got[0].numpy()[un], np.asarray(args[4])[un])
    np.testing.assert_array_equal(got[2].numpy()[un], np.asarray(args[6])[un])
    np.testing.assert_array_equal(got[4].numpy()[un], 0)
    assert (got[4].numpy()[check & (st == 0)] >= 1).all()


# Each kind of scenario against both kernels (interpret mode, as the JAX
# package's CPU suite runs them); the rest of each kernel's own test file
# against it.
_VEC = ["modes_0", "modes_1", "modes_2", "unchecked", "oob",
        "small_det_flat_frames", "large_residue", "residue_tight",
        "drift_far_start", "extreme_warp_3.0", "stale_warp_2.4", "ragged",
        "rect_11x17"]
_FUSED = ["modes_0", "modes_2", "unchecked", "oob", "small_det",
          "large_residue", "drift", "extreme_warp_3.0", "extreme_warp_4.0",
          "ragged", "rect_13x11"]


@pytest.mark.parametrize("kernel,name", [("vec", n) for n in _VEC]
                         + [("fused", n) for n in _FUSED])
def test_affine_batch_matches_pallas_kernels(kernel, name):
    cfg, args, _ = _scenario(name)
    if kernel == "vec":
        want = vec_affine_with_fallback(*args, cfg, interpret=True)
    else:
        want = fused_affine_track_batch(*args, cfg, interpret=True)
    check = np.asarray(args[7])
    got = _port_batch(cfg, args)
    if kernel == "fused":
        # the fused kernel's contract covers checked lanes only
        got = tuple(np.asarray(a)[check] for a in got[:4])
        want = tuple(np.asarray(a)[check] for a in want)
        check = check[check]
    _assert_batch(got, want, check, KERNEL_TOL)


# ------------------------------------------------- affine_consistency_check

def _frames_pair(seed, shift):
    base = make_textured_image(132, 172, seed=seed)
    a = base[6:126, 6:166]
    b = base[6 + shift[0]:126 + shift[0], 6 + shift[1]:166 + shift[1]]
    return a, b


def _port_pyr(jpyr):
    return pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                 for lv in jpyr), device="cpu")


def _assert_features(port: FeatureState, jfl, tol=POS_TOL):
    np.testing.assert_array_equal(port.val.numpy(), np.asarray(jfl.val))
    np.testing.assert_allclose(port.x.numpy(), np.asarray(jfl.x), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(port.y.numpy(), np.asarray(jfl.y), atol=tol,
                               rtol=0)


def _assert_affine_state(port, jaff, tol=POS_TOL):
    """Anchors, valid and nit equal; warps and templates within ``tol``.

    Templates are not bit-equal to JAX's: its capture runs inside a
    compiled ``lax.cond``, where XLA contracts the bilinear blend (measured
    up to 4.6e-5 abs, 2.5e-7 rel, on 0..255 values), while the port's
    ``gather_window`` rounds every product, as JAX's eager
    ``gather_window`` does (bit-equal in the interp test above)."""
    for name in AFF_FIELDS:
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(jaff, name))
        if name in ("A", "img", "gradx", "grady"):
            np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_affine_check_capture_loss_and_replace(mode):
    """Frame A->B captures templates (two lanes arrive lost, one starts
    empty); B->C verifies them; a replace drops the lost lanes' templates,
    and C->D recaptures those lanes while the kept templates persist."""
    _capture_loss_and_replace(mode, 15)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_affine_check_21x21_window(mode):
    """The same sequence at a 21x21 affine window (441 samples: above what
    K6 holds in registers on the card; the plain stage has no limit)."""
    _capture_loss_and_replace(mode, 21)


def _capture_loss_and_replace(mode, win):
    jcfg = create_config(affineConsistencyCheck=mode, affine_window_width=win,
                         affine_window_height=win)
    cfg = config_from_jax(jcfg)
    base = make_textured_image(140, 180, seed=21 + mode)
    frames = [base[i:i + 120, 2 * i:2 * i + 160] for i in range(4)]
    jpyrs = [jax_pyramids(jnp.asarray(f, jnp.float32), jcfg) for f in frames]
    tpyrs = [_port_pyr(p) for p in jpyrs]
    rng = np.random.default_rng(mode)
    n = 24
    x = rng.uniform(20, 140, n).astype(np.float32)
    y = rng.uniform(20, 100, n).astype(np.float32)
    val = np.zeros(n, np.int32)
    val[3], val[9] = -1, -4                         # not live
    x[5], y[5] = 3.0, 60.0                          # tracked out of the frame
    jfl = JFeatureState(jnp.asarray(x), jnp.asarray(y), jnp.asarray(val))
    tfl = FeatureState(*features_from_numpy(x, y, val, device="cpu"))

    def step(i, jfl, tfl):
        jx, jy, jv = jax_track(jpyrs[i], jpyrs[i + 1], jfl.x, jfl.y, jfl.val,
                               jcfg)
        jout = jax_affine_check(jpyrs[i], jpyrs[i + 1], jfl,
                                jfl._replace(x=jx, y=jy, val=jv), jcfg)
        tx, ty, tv = tpft.track_features_pyramids(
            tpyrs[i], tpyrs[i + 1], tfl.x, tfl.y, tfl.val, cfg)
        tout = affine_consistency_check(tpyrs[i], tpyrs[i + 1], tfl,
                                        tfl._replace(x=tx, y=ty, val=tv), cfg)
        _assert_features(tout, jout)
        _assert_affine_state(tout.aff, jout.aff)
        return jout, tout

    jfl, tfl = step(0, jfl, tfl)                     # capture
    assert tfl.aff.valid.sum() > n // 2
    assert not tfl.aff.valid[[3, 9]].any()
    jfl, tfl = step(1, jfl, tfl)                     # verify
    lost = tfl.val < 0
    assert lost.any()
    # a replace: lost slots are refilled with fresh positions and drop
    # their templates, kept ones persist
    rx = torch.where(lost, 80.0, tfl.x)
    ry = torch.where(lost, 60.0, tfl.y)
    rv = torch.where(lost, 500, tfl.val)
    tfl = FeatureState(rx, ry, rv, reset_affine(tfl.aff, lost))
    jlost = jnp.asarray(lost.numpy())
    jfl = JFeatureState(jnp.asarray(rx.numpy()), jnp.asarray(ry.numpy()),
                        jnp.asarray(rv.numpy()),
                        jax_reset_affine(jfl.aff, jlost))
    _assert_affine_state(tfl.aff, jfl.aff)
    assert not tfl.aff.valid[lost].any()
    kept, kept_img = tfl.aff.valid.clone(), tfl.aff.img.clone()
    jfl, tfl = step(2, jfl, tfl)                     # recapture + persist
    tracked = tfl.val == 0
    assert tfl.aff.valid[lost & tracked].all()
    assert (tfl.aff.nit[lost & tracked] == 5).all()
    assert (kept & tracked).any()
    assert torch.equal(tfl.aff.img[kept & tracked],
                       kept_img[kept & tracked])


def test_affine_state_round_trip():
    jcfg = create_config(affineConsistencyCheck=2)
    jaff = jax_make_affine_state(7, jcfg)
    rng = np.random.default_rng(3)
    jaff = jaff._replace(
        img=jnp.asarray(rng.uniform(0, 255, (7, 15, 15)), jnp.float32),
        A=jnp.asarray(rng.standard_normal((7, 2, 2)), jnp.float32),
        valid=jnp.asarray(rng.uniform(size=7) > 0.5),
        nit=jnp.asarray(rng.integers(0, 10, 7), jnp.int32))
    taff = affine_state_from_numpy(*(np.asarray(a) for a in jaff), device="cpu")
    _assert_affine_state(taff, jaff, tol=0.0)
    assert taff.valid.dtype == torch.bool and taff.nit.dtype == torch.int32
    back = affine_state_from_numpy(*(a.numpy() for a in taff), device="cpu")
    for name in AFF_FIELDS:
        assert torch.equal(getattr(back, name), getattr(taff, name))
    fresh = make_affine_state(7, config_from_jax(jcfg), device="cpu")
    _assert_affine_state(fresh, jax_make_affine_state(7, jcfg), tol=0.0)
    assert affine_state_from_numpy(*(a.numpy() for a in fresh[:7]), device="cpu").nit \
        is None


@pytest.mark.parametrize("win,shape", [
    ((3, 3), (1, 8)), ((7, 7), (2, 4)), ((9, 11), (4, 2)),
    ((11, 17), (6, 1)), ((15, 15), (8, 1)), ((17, 17), (8, 1)),
    ((21, 21), (8, 1)), ((25, 25), (8, 1)), ((51, 51), (8, 1))])
def test_affine_launch_shape(win, shape):
    """K6's launch shape from the window: a warp for each row of 32
    samples, 8 at most (windows above 256 samples walk their rows 8 at a
    time), and as many features as fill a block of 8 warps."""
    warps, per_block = launch_shape(*win)
    assert (warps, per_block) == shape
    assert warps <= -(-win[0] * win[1] // 32)
    assert 32 * warps * per_block <= 256
