"""The slice end to end: the port's track_sequence_device (plain versions
on the CPU) vs the JAX package's, feature table for feature table, with
and without the affine-consistency stage (modes 0, 1, 2).

Bars: val tables equal, positions within 1e-4 px. A lane that differs is
allowed only when it traces back to a threshold the two packages' float
orders can straddle, and then it is listed by (frame, lane) in the test,
never covered by a percentage (the repository's parity discipline): a +-1
eig-quantization difference between the two selection maps, or, in the
affine stage, det against min_determinant, residue against
affine_max_residue, drift against affine_max_displacement_differ or the
last step against affine_min_displacement. An unlisted difference fails
with each lane's margin to those thresholds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.models.device_sequence import (
    select_step_device as jax_select_step,
    sequence_step_device as jax_sequence_step,
    track_sequence_device as jax_track_sequence_device)
from pyfeaturetrack_tpu.ops.select import selection_eig_map_core
from pyfeaturetrack_tpu.ops.track import build_track_pyramids as jax_pyramids
from pyfeaturetrack_tpu.ops.track import (
    track_features_pyramids as jax_track)

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.ops.affine import (_jacobian, _normal_equations,
                                                 _step, _warp_coords,
                                                 _warp_oob)
from pyfeaturetrack_tpu_torch.ops.cuda_affine import affine_track_batch
from pyfeaturetrack_tpu_torch.ops.cuda_eig import min_eig_map
from pyfeaturetrack_tpu_torch.ops.interp import bilinear
from pyfeaturetrack_tpu_torch.ops.linalg import gauss_solve_det
from pyfeaturetrack_tpu_torch.utils.convert import (affine_state_from_numpy,
                                                    config_from_jax,
                                                    features_from_numpy,
                                                    pyramids_from_numpy)
from test_torch_affine import _assert_affine_state

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


def _affine_margins(frames, jcfg, n_features, frame, lanes):
    """Each lane's margin to the affine thresholds at ``frame``, on the
    JAX package's own state before that step: (det - min_determinant,
    residue - affine_max_residue, drift - affine_max_displacement_differ,
    max(|dx|, |dy|) - affine_min_displacement) of the port's batch, with
    det and the step of one more Gauss-Newton iteration at its result."""
    seq = jcfg.replace(sequentialMode=True)
    cfg = config_from_jax(seq)
    pyr, x, y, v, aff, _ = jax_select_step(jnp.asarray(frames[0]), seq,
                                           n_features)
    for f in frames[1:frame]:
        pyr, x, y, v, aff, _, _ = jax_sequence_step(
            pyr, jnp.asarray(f), x, y, v, seq, True, aff=aff)
    jnew = jax_pyramids(jnp.asarray(frames[frame]), seq)
    nx, ny, _ = jax_track(pyr, jnew, x, y, v, seq)
    new = pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                for lv in jnew), device="cpu")
    taff = affine_state_from_numpy(*(np.asarray(a) for a in aff), device="cpu")
    x0, y0, _ = features_from_numpy(nx, ny, np.zeros(len(nx)), device="cpu")
    img2, gx2, gy2 = new.img[0], new.gradx[0], new.grady[0]
    check = torch.ones(len(nx), dtype=torch.bool)
    bx, by, bA, _, _ = affine_track_batch(taff.img, img2, gx2, gy2, x0, y0,
                                          taff.A, check, cfg)
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    xs, ys = _warp_coords(bx, by, bA, hw, hh)
    n = len(nx)
    diff = taff.img.reshape(n, -1) - bilinear(img2, xs, ys).reshape(n, -1)
    J = _jacobian(bilinear(gx2, xs, ys), bilinear(gy2, xs, ys), hw, hh,
                  int(cfg.affineConsistencyCheck))
    d, det = gauss_solve_det(*_normal_equations(J, diff))
    _, dx, dy = _step(d, int(cfg.affineConsistencyCheck))
    out = {}
    for i in lanes:
        out[i] = dict(
            det=float(det[i].abs()) - cfg.min_determinant,
            residue=float(diff[i].abs().mean()) - cfg.affine_max_residue,
            drift=max(abs(float(bx[i] - x0[i])), abs(float(by[i] - y0[i])))
            - cfg.affine_max_displacement_differ,
            step=max(abs(float(dx[i])), abs(float(dy[i])))
            - cfg.affine_min_displacement,
            warp_oob=bool(_warp_oob(xs[i:i + 1], ys[i:i + 1],
                                    img2.shape[1], img2.shape[0])))
    return out


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
        margins = {}
        if jcfg.affineConsistencyCheck >= 0:
            for f in frames_off:
                if f:
                    margins[f] = _affine_margins(
                        frames, jcfg, n_features, f,
                        [i for g, i in differ if g == f])
        raise AssertionError(
            f"unlisted differing (frame, lane) entries {differ}; eig maps "
            f"differ at {eig} pixels in those frames; affine threshold "
            f"margins {margins}")
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
    carry = empty_track_carry(20, cfg, device="cpu")
    for i, f in enumerate(frames[1:], start=1):
        pyr, x, y, val, aff, ex, carry = tpft.sequence_step_device(
            pyr, torch.tensor(f, dtype=torch.float32), x, y, val, cfg,
            carry=carry)
        assert not carry.ok.any()
        np.testing.assert_array_equal(val.numpy(), a[2][i])
        np.testing.assert_array_equal(x.numpy(), a[0][i])


def _similarity_frames(n_frames=6, shape=(120, 160), seed=13,
                       shift=(1.5, 0.75), rot_deg=0.4, scale=1.004):
    """A textured scene under a slow similarity motion about the frame
    centre: a point at p in frame i sits at c + s R (p - c) + t in frame
    i + 1 (bilinear rendering of one larger numpy texture)."""
    h, w = shape
    pad = 40
    tex = make_textured_image(h + 2 * pad, w + 2 * pad, seed=seed)
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0])[:, None]
    th = np.deg2rad(rot_deg)
    S = scale * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    Sinv = np.linalg.inv(S)
    t = np.array(shift)[:, None]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.stack([xx.ravel(), yy.ravel()])    # frame-0 coords of each pixel
    frames = []
    for _ in range(n_frames):
        qx = np.clip(p[0] + pad, 0, tex.shape[1] - 1.001)
        qy = np.clip(p[1] + pad, 0, tex.shape[0] - 1.001)
        x0, y0 = np.floor(qx).astype(int), np.floor(qy).astype(int)
        ax, ay = qx - x0, qy - y0
        v = ((1 - ax) * (1 - ay) * tex[y0, x0] + ax * (1 - ay) * tex[y0, x0 + 1]
             + (1 - ax) * ay * tex[y0 + 1, x0] + ax * ay * tex[y0 + 1, x0 + 1])
        frames.append(np.floor(v.reshape(h, w)).astype(np.float32))
        # frame i+1 pixel p shows what frame i showed at S^-1 (p - c - t) + c
        p = Sinv @ (p - c - t) + c
    return frames


# Listed (frame, lane) entries per mode: none differ.
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_sequence_affine_matches_jax(mode):
    """Config-3-style runs (the affine stage in every step) at a small
    size; then a step-by-step run of both packages ends in the same
    AffineState (templates and warps within 1e-4, anchors, valid flags
    and nit hints equal)."""
    frames = _similarity_frames()
    jcfg = create_config(mindist=8, affineConsistencyCheck=mode)
    n = 30
    _, _, tv = _compare(frames, jcfg, n, True, listed=[])
    assert (tv[1:] > 0).any()                          # lost slots refilled
    seq = jcfg.replace(sequentialMode=True)
    cfg = config_from_jax(seq)
    jpyr, jx, jy, jv, jaff, _ = jax_select_step(jnp.asarray(frames[0]), seq, n)
    tpyr, x, y, v, taff, _ = tpft.select_step_device(torch.tensor(frames[0]),
                                                     cfg, n)
    for f in frames[1:]:
        jpyr, jx, jy, jv, jaff, _, _ = jax_sequence_step(
            jpyr, jnp.asarray(f), jx, jy, jv, seq, True, aff=jaff)
        tpyr, x, y, v, taff, _, _ = tpft.sequence_step_device(
            tpyr, torch.tensor(f), x, y, v, cfg, True, aff=taff)
        _assert_affine_state(taff, jaff, tol=POS_TOL)
    assert taff.valid.sum() > n // 2                   # templates held


def test_affine_stage_rejects_on_a_changed_scene():
    """A scene change under the trackers: whatever translational LK still
    calls TRACKED, the affine stage re-checks against the first-frame
    templates and rejects, exactly as JAX's stage does."""
    frames = _similarity_frames(n_frames=3)
    alien = make_textured_image(120, 160, seed=99).astype(np.float32)
    frames = frames[:2] + [0.7 * frames[2] + 0.3 * alien]
    jcfg = create_config(mindist=8, affineConsistencyCheck=2)
    _, _, tv = _compare(frames, jcfg, 30, False, listed=[])
    assert (tv[2] == -5).any() or (tv[2] == -4).any()
