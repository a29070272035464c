"""Monocular keyframe visual odometry: live frames in, poses out, no
external initialization (PyTorch port of ``pyfeaturetrack_tpu/sfm/vo.py``).

Per keyframe (every ``kf_every`` frames):

1. BOOTSTRAP (until initialized): match the base keyframe to the newest
   one over surviving tracks; once median parallax clears
   ``min_parallax_px``, run two_view_bootstrap (or the H/E selection of
   ``bootstrap_model="auto"``); landmarks seed at unit baseline.
2. LOCALIZE: the new keyframe pose starts at the previous keyframe's and
   refines motion-only against the landmark map (pnp.refine_pose, Huber);
   PnP-RANSAC after a held pose.
3. MAP: tracks alive across >= 2 of the last ``window`` keyframes without
   a landmark triangulate (batched DLT) once their keyframe parallax
   clears ``min_tri_parallax_px``.
4. REFINE: windowed BA over the last ``window`` keyframes with the oldest
   pose fixed; the monocular scale gauge is re-anchored after each BA.

Track identity: a per-slot generation counter increments whenever the
tracker reports the slot lost, so a refilled slot never aliases the
landmark of the feature that died.

Tracking: the host route is the port's ``SequenceTracker`` with
``replace_lost=False`` plus ``replace_lost_features`` (K1's pyramid
launches, K1's eig-only level-0 launch with K3's map, K2, K4's stage A
and K5 on the card); ``device_loop=True`` advances each keyframe interval
with ``sequence_chain_device`` (K1 with K3's map, K2, K4, the captured
chain) and pulls the [k, N] history once. The geometry runs on the same
device as batched tensor programs; the control loop and the keyframe
bookkeeping stay on the host (numpy, float64), as in the JAX package,
and read the device through ``geometry.to_host``.

The JAX package pads geometry inputs to buckets (``_bucket``) to reuse
compiled XLA programs; eager PyTorch compiles nothing, so the port does
not pad. Checkpoint resume: ``utils/checkpoint.vo_state`` /
``resume_vo``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TrackerConfig, create_config
from ..features import feature_state_to_numpy
from ..models.sequence import SequenceTracker
from ..ops.select import replace_lost_features
from ..ops.track import build_track_pyramids
from ..utils.staging import stage_f32, target_device
from .ba import bundle_adjust, make_problem
from .epipolar import two_view_bootstrap
from .geometry import f32, project, to_host
from .pnp import pnp_ransac, refine_pose
from .triangulate import triangulate_dlt


def _place_signature(img: np.ndarray, gh: int = 12, gw: int = 16
                     ) -> np.ndarray:
    """Appearance signature for loop-closure place recognition: a
    mean-pooled gh x gw thumbnail, zero-mean and unit-norm so the dot
    product of two signatures is their NCC (invariant to gain/bias
    exposure drift)."""
    img = np.asarray(img, np.float64)
    h, w = img.shape
    ph, pw = h // gh, w // gw
    t = img[:ph * gh, :pw * gw].reshape(gh, ph, gw, pw).mean((1, 3))
    t -= t.mean()
    n = np.linalg.norm(t)
    return (t / n if n > 0 else t).astype(np.float32).ravel()


class VisualOdometry:
    """Incremental monocular VO over a frame stream, on ``device``
    ("cuda" unless the caller passes "cpu").

    ``feed`` each frame; read ``trajectory()`` (keyframe poses, world =
    first-keyframe camera, scale = first baseline) and ``map_points()``
    any time.
    """

    def __init__(self, K, cfg: Optional[TrackerConfig] = None,
                 n_features: int = 200, kf_every: int = 3,
                 window: int = 8, ba_iters: int = 8,
                 thresh_px: float = 2.0, min_parallax_px: float = 12.0,
                 min_tri_parallax_px: float = 4.0,
                 min_bootstrap_good: int = 20, huber_px: float = 2.0,
                 seed: int = 0, device_loop: bool = False,
                 loop_closure: bool = False, loop_min_gap: int = 6,
                 loop_radius: float = 1.0, loop_min_inliers: int = 12,
                 stereo_baseline: float | None = None,
                 max_disparity: float = 64.0,
                 bootstrap_model: str = "essential",
                 dist=None, dist_model: str = "radtan",
                 fb_max_displacement: float | None = None,
                 robust: bool = False, *, device="cuda"):
        # robust=True: the photometric-nuisance preset (gain/bias-
        # insensitive residuals + a 0.5 px forward-backward gate)
        if robust:
            if cfg is None:
                cfg = create_config(lighting_insensitive=True)
            elif not cfg.lighting_insensitive:
                cfg = cfg.replace(lighting_insensitive=True)
            if fb_max_displacement is None:
                fb_max_displacement = 0.5
        self.device = target_device(device)
        self.K = np.asarray(K, np.float64)
        self.device_loop = bool(device_loop)
        if device_loop:
            self.cfg = (cfg if cfg is not None else
                        create_config()).replace(
                sequentialMode=True).validated_window()
            self._dev_state = None     # (pyr, x, y, val, aff)
            self._dev_buf: list = []   # staged frames of the interval
            self._dev_carry = None
            self._dev_last = None      # the interval's last host frame
        else:
            self._tr = SequenceTracker(
                cfg, n_features, replace_lost=False,
                fb_max_displacement=fb_max_displacement, device=self.device)
        self.n_features = int(n_features)
        self.kf_every = int(kf_every)
        self.window = int(window)
        self.ba_iters = int(ba_iters)
        self.thresh_px = float(thresh_px)
        self.min_parallax_px = float(min_parallax_px)
        self.min_tri_parallax_px = float(min_tri_parallax_px)
        self.min_bootstrap_good = int(min_bootstrap_good)
        self.huber_px = float(huber_px)
        self.seed = int(seed)
        if bootstrap_model not in ("essential", "auto"):
            raise ValueError("(VisualOdometry) bootstrap_model must be "
                             f"'essential' or 'auto', got {bootstrap_model!r}")
        self.bootstrap_model = bootstrap_model

        # lens distortion: the tracker runs on raw images, the geometry
        # on ideal pinhole pixels (undistorted at every geometry boundary)
        if dist is not None:
            from .camera import _check_model
            _check_model(dist_model)
            if loop_closure:
                raise ValueError("(VisualOdometry) dist requires "
                                 "loop_closure=False — guided "
                                 "re-observation assumes an undistorted "
                                 "image; pre-rectify the stream instead")
            if stereo_baseline is not None:
                raise ValueError("(VisualOdometry) dist is incompatible "
                                 "with stereo mode: rectified stereo is "
                                 "undistorted by definition")
        self.dist = (np.asarray(dist, np.float64)
                     if dist is not None else None)
        self.dist_model = str(dist_model)

        # stereo mode: rectified right frames supply metric landmarks per
        # keyframe (no bootstrap, no monocular gauge, no BA re-anchor)
        self.stereo_baseline = (float(stereo_baseline)
                                if stereo_baseline is not None else None)
        self.max_disparity = float(max_disparity)
        if self.stereo_baseline is not None and device_loop:
            raise ValueError("(VisualOdometry) stereo_baseline is not "
                             "supported with device_loop")

        self.loop_closure = bool(loop_closure)
        self.loop_min_gap = int(loop_min_gap)
        self.loop_radius = float(loop_radius)
        self.loop_min_inliers = int(loop_min_inliers)
        self.loops_closed: list[tuple[int, int]] = []

        self.gen = np.zeros(self.n_features, np.int64)
        self.kf: list[dict] = []      # {frame, x, y, gen, live[, img]}
        self.poses: list = []         # (R, t) per keyframe once init
        self.landmarks: dict = {}     # (slot, gen) -> X [3]
        self.initialized = False
        self.n_frames = 0
        self.events: list[str] = []   # bootstrap/localize notes

    # ------------------------------------------------------------- feed

    def feed(self, frame, right=None) -> None:
        """Track one frame; run keyframe logic on keyframe cadence. In
        stereo mode pass the rectified RIGHT frame alongside every left
        frame (only keyframes actually match against it)."""
        if self.stereo_baseline is not None and right is None:
            raise ValueError("(VisualOdometry) stereo mode needs the "
                             "right frame: feed(left, right)")
        self._right = right
        if self.device_loop:
            self._feed_device(frame)
            return
        fl = self._tr.step(frame)
        arr = feature_state_to_numpy(fl)
        dead = arr[:, 2] < 0
        if dead.any():
            self.gen[dead] += 1
            fl = replace_lost_features(frame, fl, self._tr.cfg)
            self._tr.fl = fl           # refilled slots keep tracking
            arr = feature_state_to_numpy(fl)
        is_kf = (self.n_frames == 0
                 or self.n_frames - self.kf[-1]["frame"] >= self.kf_every)
        self.n_frames += 1
        if not is_kf:
            return
        self._push_keyframe(arr[:, 0], arr[:, 1], arr[:, 2] >= 0,
                            img=frame)

    def _feed_device(self, frame) -> None:
        """Device-resident variant: buffer ``kf_every`` frames, advance
        them in one chained call, pull the [k, N] history once, and
        recover per-frame deaths from it (a refilled slot's history val
        is its fresh positive eigenvalue)."""
        from ..models.device_sequence import (select_step_device,
                                              sequence_chain_device,
                                              sequence_step_device)
        img = stage_f32(frame, self.device)
        if self._dev_state is None:
            pyr, x, y, val, aff, _ = select_step_device(
                img, self.cfg, self.n_features)
            self._dev_state = (pyr, x, y, val, aff)
            self.n_frames += 1
            xs, ys, vs = to_host(torch.stack([x, y, val.to(torch.float32)]))
            self._push_keyframe(xs, ys, vs >= 0, img=frame)
            return
        self._dev_buf.append(img)
        self._dev_last = frame
        self.n_frames += 1
        if len(self._dev_buf) < self.kf_every:
            return
        pyr, x, y, val, aff = self._dev_state
        if len(self._dev_buf) == 1:
            pyr, x, y, val, aff, _, self._dev_carry = \
                sequence_step_device(
                    pyr, self._dev_buf[0], x, y, val, self.cfg, True,
                    aff=aff, carry=self._dev_carry)
            hist_v = val[None]
        else:
            pyr, hist, (x, y, val), aff, _, self._dev_carry = \
                sequence_chain_device(
                    pyr, tuple(self._dev_buf), x, y, val, self.cfg, True,
                    aff=aff, carry=self._dev_carry)
            hist_v = hist[2]
        self._dev_state = (pyr, x, y, val, aff)
        self._dev_buf = []
        # one pull: the interval's vals, then the keyframe's x, y, val
        k = hist_v.shape[0]
        pulled = to_host(torch.cat([hist_v.to(torch.float32),
                                    torch.stack([x, y, val.to(
                                        torch.float32)])]))
        hist_v, (xs, ys, vs) = pulled[:k], pulled[k:]
        # deaths: any positive history val marks a refill at that frame
        for row in hist_v:
            self.gen[row > 0] += 1
        self._push_keyframe(xs, ys, vs >= 0, img=self._dev_last)

    def _push_keyframe(self, x, y, live, img=None) -> None:
        keep_img = self.loop_closure and img is not None
        host = to_host(img) if img is not None else None
        self.kf.append({"frame": self.n_frames - 1,
                        "x": np.asarray(x, np.float64).copy(),
                        "y": np.asarray(y, np.float64).copy(),
                        "gen": self.gen.copy(),
                        "live": np.asarray(live).copy(),
                        "img": (np.asarray(host, np.float32).copy()
                                if keep_img else None),
                        "sig": (_place_signature(host)
                                if keep_img else None)})
        self._left = host
        if self.stereo_baseline is not None:
            if not self.initialized:
                self._stereo_init()
            else:
                self._localize_new_keyframe()
                self._stereo_landmarks()
                self._window_ba()
                if self.loop_closure:
                    self._try_close_loop()
            return
        if not self.initialized:
            self._try_bootstrap()
        else:
            self._localize_new_keyframe()
            self._triangulate_new()
            self._window_ba()
            if self.loop_closure:
                self._try_close_loop()

    # -------------------------------------------------------- bootstrap

    def _matches(self, a: dict, b: dict) -> np.ndarray:
        return a["live"] & b["live"] & (a["gen"] == b["gen"])

    def _ideal(self, uv: np.ndarray) -> np.ndarray:
        """Tracked (raw-sensor) pixels -> ideal pinhole pixels for the
        geometry; identity when no lens model is set."""
        if self.dist is None or len(uv) == 0:
            return uv
        from .camera import undistort_pixels
        return to_host(undistort_pixels(self.K, self.dist, uv,
                                        self.dist_model,
                                        device=self.device), np.float64)

    def _try_bootstrap(self) -> None:
        if len(self.kf) < 2:
            return
        base, cur = self.kf[0], self.kf[-1]
        m = self._matches(base, cur)
        if m.sum() < 8:
            # base keyframe's tracks died before parallax accrued
            self.events.append(f"bootstrap base slid to kf {len(self.kf) - 1}")
            del self.kf[:-1]
            return
        uv1 = self._ideal(np.stack([base["x"][m], base["y"][m]], -1))
        uv2 = self._ideal(np.stack([cur["x"][m], cur["y"][m]], -1))
        parallax = float(np.median(
            np.linalg.norm(uv2 - uv1, axis=-1)))
        if parallax < self.min_parallax_px:
            del self.kf[1:-1]          # keep [base, newest] only
            return
        if self.bootstrap_model == "auto":
            from .homography import two_view_bootstrap_auto
            out = two_view_bootstrap_auto(self.K, uv1, uv2,
                                          thresh_px=self.thresh_px,
                                          n_hypotheses=512,
                                          seed=self.seed, device=self.device)
        else:
            out = two_view_bootstrap(self.K, uv1, uv2,
                                     thresh_px=self.thresh_px,
                                     n_hypotheses=512, seed=self.seed,
                                     device=self.device)
        if out["good"].sum() < self.min_bootstrap_good:
            why = ("pure rotation" if out.get("degenerate")
                   else f"{int(out['good'].sum())} good")
            self.events.append(f"bootstrap rejected ({why})")
            del self.kf[1:-1]
            return
        del self.kf[1:-1]
        self.poses = [(np.eye(3), np.zeros(3)),
                      (out["R"], out["t"])]
        slots = np.nonzero(m)[0]
        for i, s in enumerate(slots):
            if out["good"][i]:
                self.landmarks[(int(s), int(base["gen"][s]))] = \
                    out["X"][i].copy()
        self.initialized = True
        model = f" [{out['model']}]" if "model" in out else ""
        self.events.append(
            f"bootstrap{model} at kf pair (frames {base['frame']},"
            f" {cur['frame']}): {int(out['good'].sum())} landmarks,"
            f" parallax {parallax:.1f}px")

    # ----------------------------------------------------------- stereo

    def _stereo_init(self) -> None:
        """Metric initialization from the first keyframe's stereo pair:
        the world frame is the first left camera, scale the baseline."""
        self.poses = [(np.eye(3), np.zeros(3))]
        n = self._stereo_landmarks()
        if n >= self.min_bootstrap_good:
            self.initialized = True
            self.events.append(f"stereo init: {n} metric landmarks")
        else:
            self.poses = []
            self.kf.clear()
            self.events.append(
                f"stereo init deferred ({n} matches) — retrying on the "
                "next keyframe")

    def _stereo_landmarks(self) -> int:
        """Stereo-triangulate the newest keyframe's unmapped live slots.
        Returns the number of landmarks added."""
        from .stereo import stereo_match, stereo_triangulate
        kf = self.kf[-1]
        if self._left is None or self._right is None:
            return 0
        slots = np.asarray(
            [s for s in np.nonzero(kf["live"])[0]
             if (int(s), int(kf["gen"][s])) not in self.landmarks],
            np.int64)
        if slots.size == 0:
            return 0
        x = kf["x"][slots]
        y = kf["y"][slots]
        disp, valid = stereo_match(
            self._left, self._right, x, y, self._tr.cfg,
            max_disparity=self.max_disparity, device=self.device)
        if not valid.any():
            return 0
        X_cam = stereo_triangulate(self.K, self.stereo_baseline,
                                   x[valid], y[valid], disp[valid])
        R, t = self.poses[-1]
        X_w = (R.T @ (X_cam.T - t[:, None])).T
        for s, X in zip(slots[valid], X_w):
            self.landmarks[(int(s), int(kf["gen"][s]))] = X.copy()
        return int(valid.sum())

    # --------------------------------------------------------- localize

    def _visible_landmarks(self, kf: dict):
        slots, Xs, uvs = [], [], []
        for s in np.nonzero(kf["live"])[0]:
            key = (int(s), int(kf["gen"][s]))
            X = self.landmarks.get(key)
            if X is not None:
                slots.append(s)
                Xs.append(X)
                uvs.append((kf["x"][s], kf["y"][s]))
        return (np.asarray(slots, np.int64),
                np.asarray(Xs, np.float64).reshape(-1, 3),
                self._ideal(np.asarray(uvs, np.float64).reshape(-1, 2)))

    def _localize_new_keyframe(self) -> None:
        kf = self.kf[-1]
        slots, X, uv = self._visible_landmarks(kf)
        R_prev, t_prev = self.poses[-1]
        if len(slots) < 6:
            self.poses.append((R_prev.copy(), t_prev.copy()))
            if self.loop_closure and getattr(self, "_pose_held", False):
                # second consecutive hold: try kidnapped-camera recovery
                if self._try_relocalize():
                    return
            self.events.append(
                f"kf {len(self.kf) - 1}: too few mapped landmarks"
                f" ({len(slots)}) — pose held")
            # a held pose is fiction: keep it out of triangulation, BA and
            # loop candidates
            self.kf[-1]["held"] = True
            self._pose_held = True
            return
        if getattr(self, "_pose_held", False):
            Rr, tr, _ = pnp_ransac(self.K, X, uv, seed=self.seed,
                                   thresh_px=2 * self.thresh_px,
                                   device=self.device)
            self.poses.append((Rr, tr))
            self._pose_held = False
            self.events.append(f"kf {len(self.kf) - 1}: relocalized by "
                               f"PnP-RANSAC over {len(slots)} landmarks")
            return
        R, t, _ = refine_pose(self.K, R_prev, t_prev, X, uv,
                              np.ones(len(slots), np.float32), n_iters=12,
                              huber_delta=self.huber_px, device=self.device)
        Rt = to_host(torch.cat([R, t[:, None]], 1), np.float64)
        self.poses.append((Rt[:, :3], Rt[:, 3].copy()))

    # -------------------------------------------------------------- map

    def _triangulate_new(self) -> None:
        win = self.kf[-self.window:]
        pose_w = self.poses[-len(win):]
        cur = win[-1]
        cand = []
        for s in np.nonzero(cur["live"])[0]:
            key = (int(s), int(cur["gen"][s]))
            if key in self.landmarks:
                continue
            obs = [(k, float(w["x"][s]), float(w["y"][s]))
                   for k, w in enumerate(win)
                   if w["live"][s] and w["gen"][s] == cur["gen"][s]
                   and not w.get("held")]
            if len(obs) < 2:
                continue
            uvs = np.asarray([(u, v) for (_, u, v) in obs])
            spread = np.linalg.norm(uvs.max(0) - uvs.min(0))
            if spread < self.min_tri_parallax_px:
                continue
            cand.append((key, obs))
        if not cand:
            return
        L, C = len(cand), len(win)
        uvs = np.zeros((L, C, 2), np.float32)
        mask = np.zeros((L, C), bool)
        for li, (_, obs) in enumerate(cand):
            for (k, u, v) in obs:
                uvs[li, k] = (u, v)
                mask[li, k] = True
        if self.dist is not None:
            uvs = self._ideal(uvs.reshape(-1, 2)).reshape(
                L, C, 2).astype(np.float32)
        Rs = np.stack([p[0] for p in pose_w]).astype(np.float32)
        ts = np.stack([p[1] for p in pose_w]).astype(np.float32)
        X = to_host(triangulate_dlt(self.K, Rs, ts, uvs, mask,
                                    device=self.device))
        # keep only cheirality-consistent points (in front of every
        # observing camera)
        for li, (key, obs) in enumerate(cand):
            ok = True
            for (k, _, _) in obs:
                d = Rs[k] @ X[li] + ts[k]
                if d[2] < 1e-3:
                    ok = False
                    break
            if ok:
                self.landmarks[key] = X[li].astype(np.float64)

    # ------------------------------------------------------------- BA

    def _window_ba(self, n_kf: Optional[int] = None) -> None:
        win = self.kf[-(n_kf if n_kf is not None else self.window):]
        pose_w = self.poses[-len(win):]
        keys, cam_idx, pt_idx, uv = [], [], [], []
        key_id = {}
        for k, w in enumerate(win):
            if w.get("held"):
                continue  # fictional pose: its observations poison BA
            for s in np.nonzero(w["live"])[0]:
                key = (int(s), int(w["gen"][s]))
                if key not in self.landmarks:
                    continue
                if key not in key_id:
                    key_id[key] = len(keys)
                    keys.append(key)
                cam_idx.append(k)
                pt_idx.append(key_id[key])
                uv.append((w["x"][s], w["y"][s]))
        counts = np.bincount(np.asarray(pt_idx, np.int64),
                             minlength=len(keys))
        if len(keys) < 8 or len(win) < 2:
            return
        w_obs = (counts[np.asarray(pt_idx)] >= 2).astype(np.float32)
        n_pts = len(keys)
        uv_id = self._ideal(np.asarray(uv, np.float64)).astype(np.float32)
        problem = make_problem(self.K, np.asarray(cam_idx, np.int64),
                               np.asarray(pt_idx, np.int64), uv_id, w_obs,
                               device=self.device)
        R0 = np.stack([p[0] for p in pose_w]).astype(np.float32)
        t0 = np.stack([p[1] for p in pose_w]).astype(np.float32)
        X0 = np.stack([self.landmarks[k] for k in keys]).astype(np.float32)
        R, t, X, _ = bundle_adjust(problem, R0, t0, X0,
                                   n_iters=self.ba_iters, fix_first=True,
                                   huber_delta=self.huber_px)
        n_c = R.shape[0]
        flat = to_host(torch.cat([R.reshape(-1), t.reshape(-1),
                                  X.reshape(-1)]), np.float64)
        R = flat[:9 * n_c].reshape(n_c, 3, 3)
        t = flat[9 * n_c:12 * n_c].reshape(n_c, 3)
        X = flat[12 * n_c:].reshape(n_pts, 3)
        # re-anchor the monocular scale gauge: preserve the window's
        # pre-BA scale via the median landmark distance to the
        # window-first camera
        c = np.einsum("kij,kj->ki", -np.transpose(R, (0, 2, 1)), t)
        c0_pre = np.einsum(
            "kij,kj->ki", -np.transpose(R0.astype(np.float64), (0, 2, 1)),
            t0.astype(np.float64))
        d_pre = np.median(np.linalg.norm(
            X0.astype(np.float64) - c0_pre[0], axis=-1))
        d_post = np.median(np.linalg.norm(X - c[0], axis=-1))
        # stereo mode: scale is pinned by the physical baseline
        if (self.stereo_baseline is None and d_post > 1e-9
                and d_pre > 1e-9):
            s = d_pre / d_post
            c = c[0] + s * (c - c[0])
            X = c[0] + s * (X - c[0])
            t = np.einsum("kij,kj->ki", -R, c)
        for k in range(len(win)):
            self.poses[len(self.poses) - len(win) + k] = (R[k], t[k])
        for i, key in enumerate(keys):
            self.landmarks[key] = X[i]

    # ----------------------------------------------------- relocalization

    def _tracker_cfg(self):
        return (self.cfg if self.device_loop
                else self._tr.cfg).validated_window()

    def _pyramids(self, img, cfg):
        return build_track_pyramids(stage_f32(img, self.device), cfg)

    def _try_relocalize(self) -> bool:
        """Kidnapped-camera recovery (loop_closure mode): re-observe
        retained keyframes' mapped features in the current image by
        guided re-tracking with the identity prior, and accept the best
        PnP-verified hypothesis; recovered landmarks are re-associated to
        the current tracker slots by position."""
        from .loop import guided_retrack

        j = len(self.kf) - 1
        kf_b = self.kf[j]
        if kf_b.get("img") is None:
            return False
        cfg = self._tracker_cfg()
        pyr_b = self._pyramids(kf_b["img"], cfg)
        cands = [i for i in range(j)
                 if self.kf[i].get("img") is not None
                 and not self.kf[i].get("held")]
        cands = cands[::max(1, len(cands) // 8)][:8]
        best = None
        for i in cands:
            slots, X, uv_a = self._visible_landmarks(self.kf[i])
            if len(slots) < self.loop_min_inliers:
                continue
            pyr_a = self._pyramids(self.kf[i]["img"], cfg)
            xb, yb, ok, _ = guided_retrack(
                pyr_a, pyr_b, uv_a[:, 0], uv_a[:, 1],
                uv_a[:, 0], uv_a[:, 1], cfg, fb_max_displacement=1.0)
            if int(ok.sum()) < self.loop_min_inliers:
                continue
            uv_b = np.stack([xb[ok], yb[ok]], -1)
            try:
                Rm, tm, inl = pnp_ransac(self.K, X[ok], uv_b,
                                         thresh_px=2 * self.thresh_px,
                                         seed=self.seed, device=self.device)
            except ValueError:
                continue
            n_inl = int(inl.sum())
            if n_inl >= self.loop_min_inliers and (
                    best is None or n_inl > best[0]):
                best = (n_inl, i, Rm, tm, X[ok][inl], uv_b[inl])
        if best is None:
            return False
        n_inl, i, Rm, tm, X_in, uv_in = best
        self.poses[-1] = (np.asarray(Rm, np.float64),
                          np.asarray(tm, np.float64))
        self._pose_held = False
        live = np.nonzero(kf_b["live"])[0]
        n_assoc = 0
        if len(live):
            bx = kf_b["x"][live]
            by = kf_b["y"][live]
            for Xl, (u, v) in zip(X_in, uv_in):
                d = np.hypot(bx - u, by - v)
                s = int(np.argmin(d))
                if d[s] < 1.5:
                    key = (int(live[s]), int(kf_b["gen"][live[s]]))
                    if key not in self.landmarks:
                        self.landmarks[key] = Xl.copy()
                        n_assoc += 1
        self.events.append(
            f"kf {j}: relocalized against kf {i} "
            f"({n_inl} PnP inliers, {n_assoc} landmarks re-associated)")
        return True

    # ------------------------------------------------------ loop closure

    def _centers(self) -> np.ndarray:
        R = np.stack([p[0] for p in self.poses])
        t = np.stack([p[1] for p in self.poses])
        return np.einsum("kij,kj->ki", -np.transpose(R, (0, 2, 1)), t)

    def _try_close_loop(self) -> None:
        """Detect a revisit of a mapped region and correct the drift:
        guided re-observation -> PnP loop edge -> Sim(3) chain correction
        -> global BA (sfm/loop.py). Candidates come from metric proximity
        in the current estimate and from the appearance NCC of the place
        signatures."""
        from .loop import close_loop_sim3, guided_retrack

        j = len(self.kf) - 1
        if j < self.loop_min_gap:
            return
        if (self.loops_closed
                and j - self.loops_closed[-1][1] < self.loop_min_gap):
            return  # drift was just redistributed; let new drift accrue
        c = self._centers()
        cand = np.arange(0, j - self.loop_min_gap + 1)
        cand = [i for i in cand if self.kf[i].get("img") is not None
                and not self.kf[i].get("held")]
        if not cand or self.kf[j].get("img") is None:
            return
        picks = []
        d = np.linalg.norm(c[cand] - c[j], axis=-1)
        if float(d.min()) <= self.loop_radius:
            picks.append(int(cand[int(np.argmin(d))]))
        sig_j = self.kf[j].get("sig")
        sigs = [self.kf[i].get("sig") for i in cand]
        if sig_j is not None and all(s is not None for s in sigs):
            ncc = np.asarray([float(s @ sig_j) for s in sigs])
            if float(ncc.max()) >= 0.7:
                best = int(cand[int(np.argmax(ncc))])
                if best not in picks:
                    picks.append(best)
        if not picks:
            return
        cfg = self._tracker_cfg()
        kf_b = self.kf[j]
        h, w = kf_b["img"].shape
        pyr_b = self._pyramids(kf_b["img"], cfg)
        best = None
        for i in picks:
            kf_a = self.kf[i]
            slots, X, uv_a = self._visible_landmarks(kf_a)
            if len(slots) < self.loop_min_inliers:
                continue
            R_j, t_j = self.poses[j]
            uv_init, depth = project(
                self.K, f32(R_j, self.device), f32(t_j, self.device),
                f32(X, self.device))
            proj = to_host(torch.cat([uv_init, depth[:, None]], 1))
            uv_init = proj[:, :2].astype(np.float64)
            depth = proj[:, 2]
            vis = ((depth > 0.1) &
                   (uv_init[:, 0] > 8) & (uv_init[:, 0] < w - 9) &
                   (uv_init[:, 1] > 8) & (uv_init[:, 1] < h - 9))
            pyr_a = self._pyramids(kf_a["img"], cfg)
            # two association hypotheses, best of: the map projected
            # through the current pose, and kf_a's own pixel positions
            hyps = []
            if vis.sum() >= self.loop_min_inliers:
                hyps.append((uv_init[vis, 0], uv_init[vis, 1], vis))
            allm = np.ones(len(uv_a), bool)
            hyps.append((uv_a[:, 0], uv_a[:, 1], allm))
            for init_x, init_y, msk in hyps:
                xb, yb, ok, _ = guided_retrack(
                    pyr_a, pyr_b, uv_a[msk, 0], uv_a[msk, 1],
                    init_x, init_y, cfg, fb_max_displacement=1.0)
                if ok.sum() < self.loop_min_inliers:
                    continue
                uv_b = np.stack([xb[ok], yb[ok]], -1)
                try:
                    Rm_c, tm_c, inl = pnp_ransac(
                        self.K, X[msk][ok], uv_b,
                        thresh_px=2 * self.thresh_px, seed=self.seed,
                        device=self.device)
                except ValueError:
                    continue
                n_inl = int(inl.sum())
                if best is None or n_inl > best[0]:
                    best = (n_inl, Rm_c, tm_c, i)
        if best is None or best[0] < self.loop_min_inliers:
            return
        inl_count, Rm, tm, i = best
        R_all = np.stack([p[0] for p in self.poses])
        t_all = np.stack([p[1] for p in self.poses])
        drift = float(np.linalg.norm((-Rm.T @ tm) - c[j]))
        Rn, tn, A, bvec = close_loop_sim3(R_all, t_all, i, j, Rm, tm)
        self.poses = [(Rn[k], tn[k]) for k in range(len(self.poses))]
        # move every landmark with the keyframe chain (anchor = last
        # keyframe that observed it) before the global re-convergence
        anchor: dict = {}
        for k, w_kf in enumerate(self.kf):
            for sl in np.nonzero(w_kf["live"])[0]:
                anchor[(int(sl), int(w_kf["gen"][sl]))] = k
        for key, X in self.landmarks.items():
            k = anchor.get(key)
            if k is not None:
                self.landmarks[key] = A[k] @ np.asarray(X) + bvec[k]
        self._window_ba(n_kf=len(self.kf))
        self.loops_closed.append((i, j))
        self.events.append(
            f"loop closed kf {i} -> kf {j}: {inl_count} inliers, "
            f"drift {drift:.4f} units redistributed")

    # ----------------------------------------------------------- output

    def finalize(self, n_iters: Optional[int] = None) -> None:
        """One global bundle adjustment over all keyframes (the
        end-of-sequence polish)."""
        if not self.initialized:
            return
        old = self.ba_iters
        if n_iters is not None:
            self.ba_iters = int(n_iters)
        try:
            self._window_ba(n_kf=len(self.kf))
        finally:
            self.ba_iters = old

    def trajectory(self):
        """Keyframe trajectory: (frame_indices [M], R [M,3,3] world->cam,
        t [M,3], centers [M,3])."""
        if not self.initialized:
            raise RuntimeError("(VisualOdometry) not initialized yet — "
                               "feed more frames (needs parallax)")
        frames = np.asarray([k["frame"] for k in self.kf], np.int64)
        R = np.stack([p[0] for p in self.poses])
        t = np.stack([p[1] for p in self.poses])
        c = np.einsum("kij,kj->ki", -np.transpose(R, (0, 2, 1)), t)
        return frames, R, t, c

    def map_points(self) -> np.ndarray:
        """[L, 3] current landmark positions (world frame)."""
        if not self.landmarks:
            return np.zeros((0, 3))
        return np.stack(list(self.landmarks.values()))
