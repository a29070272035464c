"""Recorded KITTI-style drives through the program's monocular keyframe
visual odometry: one ``VisualOdometry(device_loop=True)`` a drive, fed
host uint8 frames as fast as it takes them, drives back to back.

The drive is rendered on the card at set-up, with plain torch, from exact
ground truth: a camera ``camera_height_m`` above a road that runs along
+z and swings ``road_amp_m`` to either side over ``road_period_m``, moving
``step_m`` along the road's axis a frame with its yaw on the road's
tangent. Facades line both sides, each set back from the road's centre by
between ``walls_m`` as it runs (smooth steps, one every half
``WALL_PERIOD_M``), up to a wavy roofline; past the roofs the sky is one
flat grey. Each pixel's ray is cast against the road and both facades
(the facades' first crossing found by marching and bisection), and the
nearest surface's texture is sampled, mip-mapped by the ray's footprint,
then faded into the sky's grey beyond ``FOG_M``. Every surface shows the
seed's pan clip (``scene.render_clip``, one frame), tiled with mirrors at
``TEX_M`` metres a texel: the seed draws the texture and nothing else,
never the path or the facades.

The window feeds drives until ``seconds`` have passed and stops after a
keyframe, so every frame it fed has had its keyframe interval finished.
Held keyframes: of the window's keyframes past bootstrap that ran a
window BA, every ``stride``-th, the stride doubling each time the holds
reach ``2 * HOLD``, so that between ``HOLD`` and ``2 * HOLD`` holds
spread over the window. A hold keeps references to the program's own
``keyframe_record()`` (no copy, no sync). Each completed drive (set-up's
too) leaves its keyframe trajectory for the check.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from drive import SPAN_FEED, SPAN_SLICE, Spans, annotate

TEX_M = 0.03          # metres a texel on every surface
SKY = 180.0           # the sky's grey
FOG_M = 150.0         # surfaces fade into the sky's grey from 0.7 of this
WALL_PERIOD_M = 70.0  # a facade steps in and out once over this length
MARCH = 0.5 * 1.1 ** np.arange(61)   # ray samples, 0.5 m to 152 m
BISECT = 30
RENDER_BATCH = 4      # frames a render step (bounds the generator's memory)
HOLD = 16
OCTAVES = 5


def road_x(z: torch.Tensor, traffic: dict) -> torch.Tensor:
    """Lateral position of the road's centre at ``z``."""
    return float(traffic["road_amp_m"]) * torch.sin(
        2.0 * math.pi * z / float(traffic["road_period_m"]))


def drive_path(traffic: dict, n: int):
    """Ground truth of a drive of ``n`` frames: world->camera rotations
    [n, 3, 3] and translations [n, 3], and camera centres [n, 3] (float64;
    x right, y down, z forwards)."""
    step = float(traffic["step_m"])
    amp, period = float(traffic["road_amp_m"]), float(traffic["road_period_m"])
    z = step * np.arange(n, dtype=np.float64)
    yaw = np.arctan(amp * 2.0 * math.pi / period
                    * np.cos(2.0 * math.pi * z / period))
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((n, 3, 3))
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1] = c, -s, 1.0
    R[:, 2, 0], R[:, 2, 2] = s, c
    centres = np.stack([amp * np.sin(2.0 * math.pi * z / period),
                        np.zeros(n), z], 1)
    return R, -np.einsum("nij,nj->ni", R, centres), centres


def _wall_offset(z, side: float, walls):
    lo, hi = walls
    phase = 0.0 if side < 0 else 1.7
    return 0.5 * (lo + hi) + 0.5 * (hi - lo) * torch.tanh(
        3.0 * torch.sin(2.0 * math.pi * z / WALL_PERIOD_M + phase))


def _facade_gap(s, side: float, cx, cz, dx, dz, traffic: dict, walls):
    """How far past the facade on ``side`` (-1 left, +1 right) the ray's
    point at depth ``s`` lies, in metres across the road: negative before
    the facade."""
    z = cz + s * dz
    return side * (cx + s * dx - road_x(z, traffic)) - _wall_offset(
        z, side, walls)


def _roofline(z, side: float):
    """The facade's top (y, negative is up)."""
    return -(6.0 + 4.0 * torch.sin(2.0 * math.pi * z / 53.0
                                   + (0.0 if side < 0 else 1.0)) ** 2)


class _Mips:
    """A texture's mip levels (2x2 means) packed into one flat tensor."""

    def __init__(self, tex: torch.Tensor):
        levels = [tex]
        while min(levels[-1].shape) >= 16:
            levels.append(torch.nn.functional.avg_pool2d(
                levels[-1][None, None], 2)[0, 0])
        dev = tex.device
        self.n = len(levels)
        self.flat = torch.cat([t.reshape(-1) for t in levels])
        self.h = torch.tensor([t.shape[0] for t in levels], device=dev)
        self.w = torch.tensor([t.shape[1] for t in levels], device=dev)
        sizes = self.h * self.w
        self.off = torch.cumsum(sizes, 0) - sizes


def _mirror(a: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Integer texel coordinates folded into [0, n) by mirrored tiling."""
    a = torch.remainder(a, 2 * n)
    return torch.where(a >= n, 2 * n - 1 - a, a)


def _bilinear(m: _Mips, level: torch.Tensor, a, b) -> torch.Tensor:
    h, w, off = m.h[level], m.w[level], m.off[level]
    scale = torch.pow(2.0, level.to(a.dtype))
    x, y = a / scale - 0.5, b / scale - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).to(torch.float32), (y - y0).to(torch.float32)
    xi, yi = x0.long(), y0.long()
    xa, xb = _mirror(xi, w), _mirror(xi + 1, w)
    ya, yb = off + _mirror(yi, h) * w, off + _mirror(yi + 1, h) * w
    f = m.flat
    return ((1 - fx) * (1 - fy) * f[ya + xa] + fx * (1 - fy) * f[ya + xb]
            + (1 - fx) * fy * f[yb + xa] + fx * fy * f[yb + xb])


def _sample(m: _Mips, a, b, lod) -> torch.Tensor:
    """Trilinear texture value at texel coordinates (a along, b across)."""
    lod = lod.clamp(0.0, m.n - 1.0)
    l0 = lod.floor().long().clamp(max=m.n - 2)
    fr = (lod - l0).to(torch.float32)
    return ((1.0 - fr) * _bilinear(m, l0, a, b)
            + fr * _bilinear(m, l0 + 1, a, b))


def _surface(m: _Mips, a, b, lod) -> torch.Tensor:
    """A surface's grey at texel coordinates (a, b): the texture at
    ``OCTAVES`` scales, each twice the last, summed with equal weights
    and brought back to one scale's contrast, so that every pyramid level
    of the tracker sees structure, as in a natural image."""
    acc = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    for o in range(OCTAVES):
        f = 2.0 ** o
        acc += _sample(m, a / f + 211.0 * o, b / f + 97.0 * o, lod - o)
    return (acc - 127.5 * OCTAVES) / math.sqrt(OCTAVES) + 127.5


def render_drive(texture: np.ndarray, traffic: dict, K: np.ndarray, R, t,
                 centres, h: int, w: int, device) -> np.ndarray:
    """Host uint8 frames [n, h, w] of the drive whose ground truth is
    (R, t, centres), rendered on ``device`` (module notes)."""
    walls = tuple(float(v) for v in traffic["walls_m"])
    ground = float(traffic["camera_height_m"])
    f64 = torch.float64
    mips = _Mips(torch.as_tensor(texture, device=device).to(torch.float32))
    vv, uu = torch.meshgrid(torch.arange(h, dtype=f64, device=device),
                            torch.arange(w, dtype=f64, device=device),
                            indexing="ij")
    Kinv = torch.as_tensor(np.linalg.inv(K), device=device)
    rays = torch.stack([uu, vv, torch.ones_like(uu)], -1) @ Kinv.T
    focal = float(K[0, 0])
    march = torch.as_tensor(MARCH, device=device)
    n = R.shape[0]
    out = np.empty((n, h, w), np.uint8)
    for i0 in range(0, n, RENDER_BATCH):
        sl = slice(i0, min(i0 + RENDER_BATCH, n))
        Rb = torch.as_tensor(R[sl], device=device)
        cb = torch.as_tensor(centres[sl], device=device)[:, None, None, :]
        # world directions, scaled so that s is the depth along the camera
        d = torch.einsum("hwk,bjk->bhwj", rays, Rb.transpose(1, 2))
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        cx, cy, cz = cb[..., 0], cb[..., 1], cb[..., 2]
        norm = torch.linalg.vector_norm(d, dim=-1)
        best = torch.full(dx.shape, math.inf, dtype=f64, device=device)
        val = torch.full(dx.shape, SKY, dtype=torch.float32, device=device)
        # the road: y = ground
        s = (ground - cy) / torch.where(dy > 1e-9, dy, torch.ones_like(dy))
        hit = (dy > 1e-9) & (s > 0)
        zr = cz + s * dz
        a = (cx + s * dx - road_x(zr, traffic)) / TEX_M + 3000.0
        b = zr / TEX_M
        lod = torch.log2(torch.clamp(s / focal / TEX_M / torch.sqrt(
            torch.clamp(dy.abs() / norm, min=0.05)), min=1.0))
        shade = _surface(mips, a, b, lod) * 0.6 + 30.0
        best = torch.where(hit, s, best)
        val = torch.where(hit, shade, val)
        for side in (-1.0, 1.0):
            def gap(sv):
                return _facade_gap(sv, side, cx, cz, dx, dz, traffic, walls)
            lo = torch.full_like(dx, math.nan)
            hi = torch.full_like(dx, math.nan)
            prev = gap(march[0])
            for k in range(1, len(MARCH)):
                cur = gap(march[k])
                cross = (prev < 0) & (cur >= 0) & torch.isnan(lo)
                lo = torch.where(cross, march[k - 1], lo)
                hi = torch.where(cross, march[k], hi)
                prev = cur
            found = ~torch.isnan(lo)
            lo = torch.where(found, lo, torch.ones_like(lo))
            hi = torch.where(found, hi, torch.ones_like(hi))
            for _ in range(BISECT):
                mid = 0.5 * (lo + hi)
                neg = gap(mid) < 0
                lo = torch.where(neg, mid, lo)
                hi = torch.where(neg, hi, mid)
            s = 0.5 * (lo + hi)
            zw = cz + s * dz
            yw = cy + s * dy
            hit = found & (yw < ground) & (yw > _roofline(zw, side)) & (
                s < best)
            a = zw / TEX_M + (0.0 if side < 0 else 5000.0)
            b = yw / TEX_M + (0.0 if side < 0 else 777.0)
            lod = torch.log2(torch.clamp(s / focal / TEX_M / torch.sqrt(
                torch.clamp(dx.abs() / norm, min=0.05)), min=1.0))
            shade = _surface(mips, a, b, lod)
            best = torch.where(hit, s, best)
            val = torch.where(hit, shade, val)
        fog = torch.clamp((best - 0.7 * FOG_M) / (0.3 * FOG_M), 0.0,
                          1.0).to(torch.float32)
        val = val * (1.0 - fog) + SKY * fog
        out[sl] = val.floor().clamp_(0.0, 255.0).to(torch.uint8).cpu().numpy()
    return out


def camera_matrix(config: dict) -> np.ndarray:
    cam = config["camera"]
    return np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                     [0.0, 0.0, 1.0]])


class Session:
    """Drives through ``VisualOdometry(device_loop=True)``; ``held`` lists
    (frame, keyframe record) of the held keyframes, ``drives`` (keyframe
    frames, centres) of every completed drive, (None, None) for a drive
    that never bootstrapped."""

    def __init__(self, pft, cfg, config: dict, frames, traffic: dict,
                 device):
        from pyfeaturetrack_tpu_torch.sfm.vo import VisualOdometry
        # the record the holds take: a program without it fails here,
        # before any work
        if not hasattr(VisualOdometry, "keyframe_record"):
            raise RuntimeError("the program's VisualOdometry keeps no "
                               "keyframe_record(): the check has nothing "
                               "to compare")
        self.VO, self.cfg, self.device = VisualOdometry, cfg, device
        self.config, self.traffic = config, traffic
        self.K = camera_matrix(config)
        self.n = int(traffic["drive_frames"])
        self.kf_every = int(config["vo"]["kf_every"])
        if (self.n - 1) % self.kf_every:
            raise ValueError("a drive's last frame must end a keyframe "
                             "interval: drive_frames - 1 a multiple of "
                             "kf_every")
        self.R, self.t, self.centres = drive_path(traffic, self.n)
        h, w = config["frame"]["height"], config["frame"]["width"]
        self.frames = render_drive(np.asarray(frames[0]), traffic, self.K,
                                   self.R, self.t, self.centres, h, w,
                                   device)
        if torch.device(device).type == "cuda":
            # the peak the run reports is the program's, not the renderer's
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.spans = Spans()
        self.rows = None
        self.fed = 0
        self.vo = None
        self.pos = 0
        self.drives: list = []
        self.held: list = []
        self._holding = False
        self._seen = 0
        self._stride = 1

    def _new_vo(self):
        vo = self.config["vo"]
        return self.VO(self.K, self.cfg,
                       n_features=int(self.config["n_features"]),
                       kf_every=self.kf_every, window=int(vo["window"]),
                       ba_iters=int(vo["ba_iters"]),
                       huber_px=float(vo["huber_px"]),
                       min_parallax_px=float(vo["min_parallax_px"]),
                       min_tri_parallax_px=float(vo["min_tri_parallax_px"]),
                       outlier_px=float(vo["outlier_px"]),
                       device_loop=bool(self.config["device_loop"]),
                       device=self.device)

    def _feed(self, traced: bool) -> bool:
        """Feed the next frame of the drive (a new drive after the last);
        True when it finished a keyframe interval."""
        if self.vo is None or self.pos == self.n:
            self.vo, self.pos = self._new_vo(), 0
        with annotate(traced, SPAN_FEED):
            t0 = time.perf_counter_ns()
            self.vo.feed(self.frames[self.pos])
            t1 = time.perf_counter_ns()
        self.spans.add(SPAN_FEED, t0, t1)
        self.fed += 1
        self.pos += 1
        if (self.pos - 1) % self.kf_every:
            return False
        if self._holding:
            self._hold(self.vo.keyframe_record())
        if self.pos == self.n:
            self.drives.append(self.vo.trajectory()[::3]
                               if self.vo.initialized else (None, None))
        return True

    def _hold(self, rec: dict) -> None:
        if "ba" not in rec or "localize" not in rec or "track" not in rec:
            return
        self._seen += 1
        if self._seen % self._stride:
            return
        self.held.append((rec["frame"], rec))
        if len(self.held) == 2 * HOLD:
            self.held = self.held[1::2]
            self._stride *= 2

    def setup(self) -> None:
        """One whole drive, untimed: the k-frame chain's capture, the
        geometry's first allocations."""
        for _ in range(self.n):
            self._feed(False)

    def window(self, seconds: float) -> dict:
        """Frames until ``seconds`` have passed, ending on a keyframe."""
        self.spans = Spans()
        first = self.fed
        self._holding = True
        t0 = time.perf_counter()
        try:
            while True:
                if self._feed(False):
                    elapsed = time.perf_counter() - t0
                    if elapsed >= seconds:
                        break
        finally:
            self._holding = False
        return {"first_row": first, "rows": self.fed - first,
                "seconds": elapsed}

    def traced_slice(self) -> tuple:
        """A fresh drive fed up to the traffic's ``trace_frames`` untraced,
        then those frames inside one ``slice`` range; (first row, rows,
        spans of the slice)."""
        a, b = (int(v) for v in self.traffic["trace_frames"])
        self.vo = None
        self._feed(False)
        while self.pos < a:
            self._feed(False)
        spans, self.spans = self.spans, Spans()
        first = self.fed
        with annotate(True, SPAN_SLICE):
            t0 = time.perf_counter_ns()
            while self.pos < b:
                self._feed(True)
            t1 = time.perf_counter_ns()
        self.spans.add(SPAN_SLICE, t0, t1)
        sliced, self.spans = self.spans, spans
        return first, self.fed - first, sliced

    def close(self) -> None:
        self.vo = None
