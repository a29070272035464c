"""The port's VO and ``run_sfm`` under tests/test_sfm_stress.py's
photometric nuisances and on tests/test_sfm_kitti.py's forward-motion
scene, held to the JAX package on the CPU: the same frames through both,
the JAX run's decisions (events, keyframes, landmarks; keyframe centres
within 1e-3 units, tests/test_torch_vo.py's bar) and the JAX tests' own
ATE bars on the port's runs. The KITTI-like scene: the tracked table
(statuses exact, positions 1e-4 px) and run_sfm (costs as
tests/test_torch_sfm.py holds them, poses 1e-4) against JAX."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfeaturetrack_tpu.config import create_config as jax_create_config
from pyfeaturetrack_tpu.models.sequence import track_sequence as jax_track
from pyfeaturetrack_tpu.sfm import run_sfm as jax_run_sfm
from pyfeaturetrack_tpu.sfm.geometry import so3_exp as jax_so3_exp
from pyfeaturetrack_tpu.sfm.pipeline import ate_rmse_aligned as jax_ate
from pyfeaturetrack_tpu.sfm.vo import VisualOdometry as JaxVO

from pyfeaturetrack_tpu_torch.config import create_config
from pyfeaturetrack_tpu_torch.models.sequence import track_sequence
from pyfeaturetrack_tpu_torch.sfm import run_sfm
from pyfeaturetrack_tpu_torch.sfm.pipeline import ate_rmse_aligned
from pyfeaturetrack_tpu_torch.sfm.vo import VisualOdometry

import test_loop
import test_sfm_kitti
import test_stereo
import test_vo
from test_sfm_stress import DIST, distorted, gain_bias, noisy, occluded
from test_torch_sfm import costs_close
from test_torch_vo import assert_same_run, run

torch.set_num_threads(2)

KW = dict(n_features=120, kf_every=2, window=6, min_parallax_px=10.0)


@pytest.fixture(scope="module")
def mono_scene():
    Rs, ts, cs, pts = test_vo._gt_scene()
    frames = test_vo._render(Rs, ts, pts)
    travel = float(np.linalg.norm(np.diff(cs, axis=0), axis=1).sum())
    return ts, frames, travel


def mono_pair(frames, ts, jax_cfg=None, **kw):
    """The port's and JAX's VO over ``frames``: the port's ATE after
    asserting that it took JAX's decisions."""
    cfg = {} if jax_cfg is None else {"cfg": create_config(**jax_cfg)}
    jcfg = {} if jax_cfg is None else {"cfg": jax_create_config(**jax_cfg)}
    got = run(VisualOdometry(test_vo.K, **KW, **kw, **cfg, device="cpu"),
              frames)
    want = run(JaxVO(test_vo.K, **KW, **kw, **jcfg), frames)
    assert got.initialized and want.initialized
    assert_same_run(got, want)
    idx, _, t, _ = got.trajectory()
    ate = float(ate_rmse_aligned(t, ts[idx]))
    assert abs(ate - float(jax_ate(jnp.asarray(want.trajectory()[2],
                                               jnp.float32),
                                   jnp.asarray(ts[idx], jnp.float32)))) < 1e-3
    return ate


def test_mono_gain_bias_drift_needs_lighting_insensitive(mono_scene):
    ts, frames, travel = mono_scene
    stressed = gain_bias(frames)
    plain = mono_pair(stressed, ts)
    li = mono_pair(stressed, ts, jax_cfg={"lighting_insensitive": True})
    assert plain > 0.05 * travel
    assert li < 0.005 * travel
    assert li < plain / 10


def test_mono_sensor_noise(mono_scene):
    ts, frames, travel = mono_scene
    assert mono_pair(noisy(frames), ts) < 0.005 * travel


def test_mono_occluder_fb_gate_wins(mono_scene):
    ts, frames, travel = mono_scene
    stressed = occluded(frames)
    plain = mono_pair(stressed, ts)
    fb = mono_pair(stressed, ts, fb_max_displacement=0.5)
    assert plain < 0.01 * travel
    assert fb < 0.006 * travel
    assert fb < plain


def test_mono_distortion_corrected(mono_scene):
    ts, frames, travel = mono_scene
    stressed = distorted(frames, test_vo.K)
    corrected = mono_pair(stressed, ts, dist=DIST)
    ignored = mono_pair(stressed, ts)
    assert corrected < 0.006 * travel
    assert corrected < ignored


def test_mono_combined_robust_preset(mono_scene):
    ts, frames, travel = mono_scene
    stressed = noisy(gain_bias(frames))
    assert mono_pair(stressed, ts, robust=True) < 0.005 * travel


def test_stereo_gain_noise_stress():
    """tests/test_sfm_stress.py's stereo scene (per-eye gain mismatch,
    drift and noise, robust=True): JAX's decisions, and the raw metric
    error under that test's bar."""
    rng = np.random.default_rng(80)
    n_pts = 300
    pts = np.stack([rng.uniform(-9.0, 9.0, n_pts),
                    rng.uniform(-6.0, 6.0, n_pts),
                    rng.uniform(6.0, 20.0, n_pts)], -1).astype(np.float32)
    amp = rng.uniform(120, 255, n_pts)
    cs = [np.array([0.2 * i, 0.03 * i, 0.08 * i]) for i in range(12)]
    R = np.eye(3, dtype=np.float32)
    lefts, rights = [], []
    for c in cs:
        lefts.append(test_stereo._render(R, (-R @ c).astype(np.float32),
                                         pts, amp))
        c_r = c + np.array([test_stereo.BASELINE, 0, 0])
        rights.append(test_stereo._render(R, (-R @ c_r).astype(np.float32),
                                          pts, amp))
    lefts = noisy(gain_bias(lefts), seed=3)
    rights = [np.clip(1.06 * f + 5.0, 0, 255)
              for f in noisy(gain_bias(rights), seed=4)]
    kw = dict(n_features=120, kf_every=2, window=6,
              stereo_baseline=test_stereo.BASELINE, max_disparity=40.0,
              robust=True)
    got = run(VisualOdometry(test_vo.K, **kw, device="cpu"), lefts, rights)
    want = run(JaxVO(test_vo.K, **kw), lefts, rights)
    assert got.initialized
    assert_same_run(got, want)
    fi, _, _, c = got.trajectory()
    err = np.linalg.norm(c - np.stack(cs)[fi], axis=-1)
    travel = float(np.linalg.norm(np.diff(np.stack(cs), axis=0),
                                  axis=-1).sum())
    assert err.max() < 0.06 * travel, (err.max(), travel, got.events)


def test_loop_closure_under_gain_noise():
    _, ts, cs, frames = test_loop._loop_scene()
    stressed = noisy(gain_bias(frames), seed=11)
    kw = dict(n_features=140, kf_every=2, window=6, min_parallax_px=8.0,
              loop_closure=True, robust=True)
    got = run(VisualOdometry(test_vo.K, **kw, device="cpu"), stressed)
    want = run(JaxVO(test_vo.K, **kw), stressed)
    assert got.initialized
    assert any("loop" in e for e in got.events), got.events
    assert_same_run(got, want)
    idx, _, t, _ = got.trajectory()
    ate = float(ate_rmse_aligned(t, ts[idx]))
    travel = float(np.linalg.norm(np.diff(cs, axis=0), axis=-1).sum())
    assert ate < 0.04 * travel, (ate, travel, got.events)


@pytest.fixture(scope="module")
def kitti():
    Rs, ts, pts = test_sfm_kitti._gt_scene()
    frames = test_sfm_kitti._render(Rs, ts, pts)
    got, _ = track_sequence(frames, n_features=80, replace_lost=False,
                            device="cpu")
    want, _ = jax_track(frames, n_features=80, replace_lost=False)
    return Rs, ts, got, want


def test_forward_motion_tracking(kitti):
    _, _, got, want = kitti
    v = got.val.numpy().astype(np.int64)
    np.testing.assert_array_equal(v, np.asarray(want.val))
    for a, b in ((got.x, want.x), (got.y, want.y)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert (v[0] >= 0).sum() >= 40
    assert (v >= 0).all(axis=0).sum() >= 25


def test_forward_motion_sfm_ate(kitti):
    Rs, ts, ft, jft = kitti
    n = test_sfm_kitti.N_FRAMES
    rng = np.random.default_rng(9)
    dw = 0.003 * rng.standard_normal((n, 3)).astype(np.float32)
    dw[0] = 0
    R0 = (np.asarray(jax_so3_exp(jnp.asarray(dw))) @ Rs.astype(np.float32)
          ).astype(np.float32)
    t0 = ts.astype(np.float32) + \
        0.02 * rng.standard_normal(ts.shape).astype(np.float32)
    t0[0] = ts[0]
    K = test_sfm_kitti.K.astype(np.float32)
    kw = dict(n_iters=20, min_track_len=3, huber_delta=2.0,
              max_init_reproj_error=8.0)
    got = run_sfm(ft, K, R0, t0, **kw, device="cpu")
    want = jax_run_sfm(jft, K, R0, t0, **kw)
    assert got["n_observations"] == want["n_observations"]
    costs_close(got["costs"], want["costs"], 2 * got["n_observations"])
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(want["R"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]),
                               atol=1e-4)
    costs = got["costs"].numpy()
    assert costs[-1] < 0.7 * costs[0]
    ate0 = ate_rmse_aligned(t0, ts)
    ate1 = ate_rmse_aligned(got["t"], ts)
    assert ate1 < ate0
    assert ate1 < 0.03
