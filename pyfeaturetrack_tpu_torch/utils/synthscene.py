"""Long synthetic KITTI-style sequences for end-to-end benchmarks (the
port's own copy of ``pyfeaturetrack_tpu/utils/synthscene.py``: the scenes
are numpy; the VO drives run the port's ``VisualOdometry`` on ``device``,
"cuda" unless the caller passes "cpu").

BASELINE.md config 5 names a KITTI-style forward-motion sequence; this
module renders a stand-in that is checked against exact ground truth
with no footage to ship: a CORRIDOR
of true-3D blob landmarks streaming past a forward-translating,
gently curving camera. Unlike the short scenes in tests/test_sfm_kitti
(fixed point cloud, 10 frames) the corridor extends with the path, so
features continuously enter/leave the FOV and the front-end must keep
re-selecting, re-triangulating, and re-anchoring scale — the failure
modes that only show up at 100+ frames.

Shared by chip_smoke.py's sfm phase and the port's tests.
"""

from __future__ import annotations

import numpy as np


def corridor_scene(n_frames: int = 120, h: int = 240, w: int = 320,
                   step: float = 0.35, curve: float = 2.5,
                   n_points_per_20u: int = 260, seed: int = 5):
    """Ground-truth corridor scene.

    Returns (K, Rs, ts, cs, pts): world->cam rotations/translations,
    camera centers, and the 3D landmark field. The camera advances
    ``step`` units/frame along +z on a sinusoidal lateral curve with a
    matching yaw (tangent-following, like a road vehicle).
    """
    rng = np.random.default_rng(seed)
    K = np.array([[260.0, 0, w / 2], [0, 260.0, h / 2], [0, 0, 1]],
                 np.float64)

    length = step * n_frames + 30.0
    n_pts = int(n_points_per_20u * length / 20.0)
    # corridor walls/floor/scatter: denser near the path edges so the
    # FOV always sees parallax at several depths
    z = rng.uniform(3.0, length, n_pts)
    x = rng.uniform(-9.0, 9.0, n_pts)
    y = rng.uniform(-5.0, 5.0, n_pts)
    pts = np.stack([x, y, z], -1).astype(np.float32)

    om = 2 * np.pi / max(n_frames, 1)
    Rs, ts, cs = [], [], []
    for i in range(n_frames):
        cx = curve * np.sin(om * i)
        cz = step * i
        c = np.array([cx, 0.15 * np.sin(3 * om * i), cz], np.float64)
        # yaw follows the path tangent: dx/dz = curve*om*cos(om i)/step
        yaw = np.arctan2(curve * om * np.cos(om * i), 1.0) * \
            (step / (step + 1e-9)) * 0.5
        cy_, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy_, 0, -sy], [0, 1, 0], [sy, 0, cy_]],
                     np.float64)
        Rs.append(R.astype(np.float32))
        cs.append(c.astype(np.float32))
        ts.append((-R @ c).astype(np.float32))
    return (K, np.stack(Rs), np.stack(ts), np.stack(cs), pts)


def render_blobs(K, Rs, ts, pts, h: int, w: int, seed: int = 1,
                 rad: int = 6, sigma: float = 1.8, bg: float = 20.0):
    """Render each frame by splatting every visible landmark as a
    Gaussian blob at its EXACT pinhole projection (sub-pixel center),
    so the tracker's output can be checked against analytic geometry.
    Pure NumPy: float64 projection, float32 frames."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(120, 255, pts.shape[0])
    K = np.asarray(K, np.float64)
    frames = []
    yy0, xx0 = np.mgrid[-rad:rad + 1, -rad:rad + 1]
    for Rk, tk in zip(np.asarray(Rs, np.float64),
                      np.asarray(ts, np.float64)):
        pc = pts.astype(np.float64) @ Rk.T + tk
        depth = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = K[0, 0] * pc[:, 0] / depth + K[0, 2]
            v = K[1, 1] * pc[:, 1] / depth + K[1, 2]
        img = np.full((h, w), bg)
        ok = ((depth > 1.0) & (u > rad) & (u < w - rad - 1) &
              (v > rad) & (v < h - rad - 1))
        for j in np.flatnonzero(ok):
            cu, cv = int(u[j]), int(v[j])
            du, dv = u[j] - cu, v[j] - cv
            img[cv - rad:cv + rad + 1, cu - rad:cu + rad + 1] += (
                amp[j] * np.exp(-((xx0 - du) ** 2 + (yy0 - dv) ** 2) /
                                (2 * sigma ** 2)))
        frames.append(np.clip(img, 0, 255).astype(np.float32))
    return frames


def circuit_scene(n_frames: int = 520, h: int = 240, w: int = 320,
                  ax_a: float = 14.0, ax_b: float = 9.0,
                  n_points_per_20u: int = 300, seed: int = 7,
                  laps: float = 1.08):
    """Closed-circuit ground truth for LONG runs with a genuine
    revisit: the camera drives ``laps`` laps of an ellipse (tangent
    yaw), so past ~1 lap it re-enters previously mapped territory —
    the loop-closure shape — while the landmark band streams past for
    hundreds of keyframes before that.

    Returns (K, Rs, ts, cs, pts) like corridor_scene."""
    rng = np.random.default_rng(seed)
    K = np.array([[260.0, 0, w / 2], [0, 260.0, h / 2], [0, 0, 1]],
                 np.float64)
    # landmark band around the ellipse: points at radial offsets from
    # the path so the forward FOV always sees parallax at mixed depths
    n_pts = int(n_points_per_20u * (np.pi * (ax_a + ax_b)) / 20.0)
    th = rng.uniform(0, 2 * np.pi, n_pts)
    rad_off = rng.uniform(1.5, 8.0, n_pts)
    side = rng.choice([-1.0, 1.0], n_pts)
    px = (ax_a + side * rad_off) * np.cos(th)
    pz = (ax_b + side * rad_off) * np.sin(th)
    py = rng.uniform(-4.0, 4.0, n_pts)
    pts = np.stack([px, py, pz], -1).astype(np.float32)

    om = 2 * np.pi * laps / max(n_frames, 1)
    Rs, ts, cs = [], [], []
    for i in range(n_frames):
        a = om * i
        c = np.array([ax_a * np.cos(a), 0.1 * np.sin(5 * a),
                      ax_b * np.sin(a)], np.float64)
        # forward = path tangent: d/da (a_x cos, ., b sin) ∝
        # (-a_x sin a, 0, b cos a); yaw about +y with +z forward
        tx, tz = -ax_a * np.sin(a), ax_b * np.cos(a)
        yaw = np.arctan2(tx, tz)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy_, 0, -sy], [0, 1, 0], [sy, 0, cy_]],
                     np.float64)
        Rs.append(R.astype(np.float32))
        cs.append(c.astype(np.float32))
        ts.append((-R @ c).astype(np.float32))
    return (K, np.stack(Rs), np.stack(ts), np.stack(cs), pts)


def apply_photometric_drift(frames, gain_amp: float = 0.25,
                            bias_amp: float = 12.0,
                            gain_period: float = 90.0,
                            bias_period: float = 137.0):
    """Slowly varying exposure gain/bias over a frame list (the
    tests/test_sfm_stress nuisance, extended to long sequences): frame
    i -> clip(gain_i * frame + bias_i). Defeats plain LK over long
    horizons; the lighting-insensitive residuals recover it."""
    out = []
    for i, f in enumerate(frames):
        g = 1.0 + gain_amp * np.sin(2 * np.pi * i / gain_period)
        b = bias_amp * np.sin(2 * np.pi * i / bias_period)
        out.append(np.clip(g * np.asarray(f, np.float32) + b, 0,
                           255).astype(np.float32))
    return out


def run_vo_on_circuit(n_frames: int = 520, h: int = 240, w: int = 320,
                      n_features: int = 120, kf_every: int = 4,
                      window: int = 6, seed: int = 7,
                      photometric: bool = True,
                      loop_closure: bool = True, laps: float = 1.08,
                      finalize: bool = True, *, device="cuda"):
    """Config-5 long-horizon stress: 500+ frame
    closed circuit with a genuine revisit, photometric gain/bias
    drift, loop closure, and KITTI-format ATE/RPE gates. Returns the
    run_vo_on_corridor metric dict (with its "vo" entry) plus
    loop/photometric flags."""
    import time

    from ..sfm import VisualOdometry
    from ..sfm.pipeline import ate_rmse_aligned
    from .trajectory import rpe

    K, Rs, ts, cs, pts = circuit_scene(n_frames, h, w, seed=seed,
                                       laps=laps)
    frames = render_blobs(K, Rs, ts, pts, h, w)
    if photometric:
        frames = apply_photometric_drift(frames)
    # loop_radius is in the ESTIMATED gauge and must exceed the
    # accumulated drift at the revisit (vo._try_close_loop docstring):
    # ~4.7% of 77 units of pre-closure travel measured ≈ 5-6 estimated
    # units at 520 frames; wrong candidates die at the PnP inlier gate
    # so a generous radius costs only rejected attempts.
    vo = VisualOdometry(K, n_features=n_features, kf_every=kf_every,
                        window=window, min_parallax_px=10.0,
                        robust=photometric,
                        loop_closure=loop_closure, loop_min_gap=25,
                        loop_radius=8.0, device=device)
    t0 = time.perf_counter()
    for f in frames:
        vo.feed(f)
    if finalize:
        vo.finalize(n_iters=12)   # end-of-sequence global BA polish
    dt = time.perf_counter() - t0
    fi, R, t, c = vo.trajectory()
    gt_c = cs[fi]
    travel = float(np.linalg.norm(np.diff(gt_c, axis=0), axis=1).sum())
    ate = float(ate_rmse_aligned(c, gt_c))
    est_len = float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
    s = travel / max(est_len, 1e-9)
    te, re = rpe(np.asarray(R, np.float64),
                 np.asarray(t, np.float64) * s,
                 np.asarray(Rs, np.float64)[fi],
                 np.asarray(ts, np.float64)[fi], delta=1)
    return {
        "n_frames": n_frames,
        "keyframes": len(fi),
        "landmarks": int(len(vo.map_points())),
        "loop_closures": len(getattr(vo, "loops_closed", [])),
        "photometric_drift": bool(photometric),
        "travel_units": round(travel, 3),
        "ate_units": round(ate, 4),
        "ate_pct_travel": round(100.0 * ate / max(travel, 1e-9), 3),
        "rpe_trans_median_units": round(float(np.median(te)), 4),
        "rpe_trans_p90_units": round(float(np.percentile(te, 90)), 4),
        "rpe_rot_median_deg": round(float(np.degrees(np.median(re))),
                                    4),
        "wall_fps": round(n_frames / dt, 2),
        "vo": vo,
    }


def run_vo_on_corridor(n_frames: int = 120, h: int = 240, w: int = 320,
                       n_features: int = 120, kf_every: int = 2,
                       window: int = 6, seed: int = 5, *, device="cuda",
                       device_loop: bool = False):
    """Full config-5 front-end drive: render -> VisualOdometry (track ->
    bootstrap -> localize -> triangulate -> windowed BA) -> trajectory
    metrics. Returns a dict with ate (similarity-aligned RMSE), travel,
    rpe translation stats, keyframe/landmark counts, wall fps, and the
    VisualOdometry itself under "vo" (its trajectory and events)."""
    import time

    from ..sfm import VisualOdometry
    from ..sfm.pipeline import ate_rmse_aligned
    from .trajectory import rpe

    K, Rs, ts, cs, pts = corridor_scene(n_frames, h, w, seed=seed)
    frames = render_blobs(K, Rs, ts, pts, h, w)
    vo = VisualOdometry(K, n_features=n_features, kf_every=kf_every,
                        window=window, min_parallax_px=10.0,
                        device_loop=device_loop, device=device)
    t0 = time.perf_counter()
    for f in frames:
        vo.feed(f)
    dt = time.perf_counter() - t0
    fi, R, t, c = vo.trajectory()
    gt_c = cs[fi]
    travel = float(np.linalg.norm(np.diff(gt_c, axis=0),
                                  axis=1).sum())
    ate = float(ate_rmse_aligned(c, gt_c))
    # RPE needs a consistent scale: monocular VO is up-to-scale, so
    # align by the similarity first (use the ATE alignment's scale via
    # median landmark-free proxy: ratio of path lengths)
    est_len = float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
    s = travel / max(est_len, 1e-9)
    t_scaled = np.asarray(t, np.float64) * s
    te, re = rpe(np.asarray(R, np.float64), t_scaled,
                 np.asarray(Rs, np.float64)[fi],
                 np.asarray(ts, np.float64)[fi], delta=1)
    return {
        "n_frames": n_frames,
        "keyframes": len(fi),
        "landmarks": int(len(vo.map_points())),
        "travel_units": round(travel, 3),
        "ate_units": round(ate, 4),
        "ate_pct_travel": round(100.0 * ate / max(travel, 1e-9), 3),
        "rpe_trans_median_units": round(float(np.median(te)), 4),
        "rpe_rot_median_deg": round(float(np.degrees(np.median(re))),
                                    4),
        "wall_fps": round(n_frames / dt, 2),
        "vo": vo,
    }
