"""Plain KLT in float64 PyTorch: the benchmark's reference.

Written from the KLT v1.3.4 algorithms as the repository's float64 oracle
transcribes them (pyramid, derivative-of-Gaussian gradients, Shi-Tomasi
minimum eigenvalue, greedy min-distance selection, pyramidal iterative
Lucas-Kanade with the KLT status codes, lost-feature replacement), in
vectorised float64 torch so that it runs over a full frame's features in
well under a second on the card. It imports nothing of the program and
takes nothing the program made but the state it is asked to step from.

Semantics kept from the oracle and the device route it specifies:

* convolution is true convolution, horizontal pass then vertical, with a
  zeroed border of the kernel's half-width on each side;
* level 0 is the frame smoothed by ``smooth_sigma_fact * max(window)``;
  each coarser level smooths the level above by ``subsampling *
  pyramid_sigma_fact`` and samples it at ``s * i + s // 2``;
* the selection map is the minimum eigenvalue of the windowed structure
  tensor of level 0's gradients, zero outside fully interior windows,
  truncated to an integer and clamped at 2**31 - 1;
* candidates are the lattice inside the borders, ranked by value, ties
  in scan order; a candidate is taken when it is at least
  ``min_eigenvalue`` and outside the (mindist - 1) box of every feature
  kept or taken before it; the r-th taken candidate fills the r-th free
  slot and free slots left over become (-1, -1, KLT_NOT_FOUND);
* a track runs the levels coarse to fine, each up to ``max_iterations``
  Gauss-Newton steps of the 2x2 system, stops a lane's level loop on
  SMALL_DET or OOB, then classifies: OOB, out of view (the border), small
  determinant, residue, iteration cap. A tracked lane's value is 0 and a
  freshly selected one's is its eigenvalue.
"""

from __future__ import annotations

import math

import numpy as np
import torch

KLT_TRACKED = 0
KLT_NOT_FOUND = -1
KLT_SMALL_DET = -2
KLT_MAX_ITERATIONS = -3
KLT_OOB = -4
KLT_LARGE_RESIDUE = -5

_MAX_KERNEL_WIDTH = 71
_INT_LIMIT = 2 ** 31 - 1
F64 = torch.float64


def kernels(sigma: float):
    """(gauss, deriv) float64 taps of ``sigma``, trimmed where they fall
    below 1 % of their peak, normalised as KLT normalises them."""
    hw = _MAX_KERNEL_WIDTH // 2
    i = np.arange(-hw, hw + 1, dtype=np.float64)
    gauss = np.exp(-(i * i) / (2.0 * sigma * sigma))
    deriv = -i * gauss
    max_deriv = sigma * math.exp(-0.5)
    k = int(np.argmax(np.abs(gauss) >= 0.01))
    gauss = gauss[k:len(gauss) - k]
    k = int(np.argmax(np.abs(deriv / max_deriv) >= 0.01))
    deriv = deriv[k:len(deriv) - k]
    gauss = gauss / gauss.sum()
    dhw = len(deriv) // 2
    deriv = deriv / -(np.arange(-dhw, dhw + 1) * deriv).sum()
    return gauss, deriv


def _conv(img: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    krev = kernel[::-1]
    r = len(krev) // 2
    n = img.shape[dim]
    out = torch.zeros_like(img)
    if 2 * r >= n:
        return out
    m = n - 2 * r
    acc = torch.zeros_like(img.narrow(dim, 0, m))
    for t, k in enumerate(krev):
        acc += float(k) * img.narrow(dim, t, m)
    out.narrow(dim, r, m).copy_(acc)
    return out


def conv_sep(img, hk, vk):
    """Horizontal pass with ``hk``, then vertical with ``vk``."""
    return _conv(_conv(img, hk, -1), vk, -2)


def pyramids(frame: torch.Tensor, cfg) -> tuple:
    """(levels, gradx, grady) float64 lists, finest first, of a frame."""
    g_smooth, _ = kernels(cfg["smooth_sigma_fact"]
                          * max(cfg["window_width"], cfg["window_height"]))
    g_grad, d_grad = kernels(cfg["grad_sigma"])
    s = int(cfg["subsampling"])
    g_pyr, _ = kernels(s * cfg["pyramid_sigma_fact"])
    cur = conv_sep(frame.to(F64), g_smooth, g_smooth)
    imgs, gxs, gys = [], [], []
    for level in range(int(cfg["nPyramidLevels"])):
        if level:
            sm = conv_sep(cur, g_pyr, g_pyr)
            h, w = cur.shape[0] // s, cur.shape[1] // s
            cur = sm[s // 2::s, s // 2::s][:h, :w].contiguous()
        imgs.append(cur)
        gxs.append(conv_sep(cur, d_grad, g_grad))
        gys.append(conv_sep(cur, g_grad, d_grad))
    return imgs, gxs, gys


def eig_map(gx: torch.Tensor, gy: torch.Tensor, ww: int, wh: int):
    """int64 [H, W]: truncated minimum eigenvalue of the windowed structure
    tensor, clamped at 2**31 - 1, 0 outside fully interior windows."""
    def wsum(a):
        c = a.unfold(0, wh, 1).unfold(1, ww, 1)
        return c.sum(dim=(-2, -1))
    gxx, gxy, gyy = wsum(gx * gx), wsum(gx * gy), wsum(gy * gy)
    val = ((gxx + gyy) - torch.sqrt((gxx - gyy) ** 2 + 4.0 * gxy * gxy)) / 2
    out = torch.zeros(gx.shape, dtype=torch.int64, device=gx.device)
    h, w = gx.shape
    out[wh // 2:h - wh // 2, ww // 2:w - ww // 2] = torch.clamp(
        val, max=float(_INT_LIMIT)).to(torch.int64)
    return out


def _lattice(cfg, shape):
    nrows, ncols = shape
    bx = max(int(cfg["borderx"]), max(int(cfg["window_width"]) // 2, 1))
    by = max(int(cfg["bordery"]), max(int(cfg["window_height"]) // 2, 1))
    step = int(cfg["nSkippedPixels"]) + 1
    return np.arange(by, nrows - by, step), np.arange(bx, ncols - bx, step)


def select(eig: torch.Tensor, x, y, val, cfg, replacing: bool):
    """Selection (``replacing`` False: every slot) or refill of the lost
    slots (val < 0) from ``eig``. x, y, val: float64 / int64 numpy [N].
    Returns new numpy (x, y, val)."""
    nrows, ncols = eig.shape
    x, y, val = x.copy(), y.copy(), val.copy()
    free = np.ones(len(val), bool) if not replacing else val < 0
    md = int(cfg["mindist"]) - 1
    min_eig = max(int(cfg["min_eigenvalue"]), 1)
    ys, xs = _lattice(cfg, eig.shape)
    taken_xy: list = []
    if free.any() and len(ys) and len(xs):
        dev = eig.device
        cand = eig[torch.as_tensor(ys, device=dev)][
            :, torch.as_tensor(xs, device=dev)].reshape(-1)
        cy = torch.as_tensor(ys, device=dev).repeat_interleave(len(xs))
        cx = torch.as_tensor(xs, device=dev).repeat(len(ys))
        keep = cand >= min_eig
        fmap = torch.zeros((nrows, ncols), dtype=torch.bool, device=dev)
        if replacing and md >= 0:
            kept = ~free
            kx = torch.as_tensor(np.trunc(x[kept]).astype(np.int64), device=dev)
            ky = torch.as_tensor(np.trunc(y[kept]).astype(np.int64), device=dev)
            fmap[ky.clamp(0, nrows - 1), kx.clamp(0, ncols - 1)] = True
            fmap = torch.nn.functional.max_pool2d(
                fmap[None, None].to(F64), 2 * md + 1, stride=1,
                padding=md)[0, 0] > 0
            keep &= ~fmap[cy, cx]
        order = torch.sort(cand, descending=True, stable=True)[1]
        order = order[keep[order]]
        taken_xy = _greedy(cx[order].cpu().numpy(), cy[order].cpu().numpy(),
                           cand[order].cpu().numpy(), fmap.cpu().numpy(),
                           md, int(free.sum()))
    slots = np.flatnonzero(free)
    for i, slot in enumerate(slots):
        if i < len(taken_xy):
            x[slot], y[slot], val[slot] = taken_xy[i]
        else:
            x[slot], y[slot], val[slot] = -1.0, -1.0, KLT_NOT_FOUND
    return x, y, val


def _greedy(cx, cy, cv, fmap, md: int, budget: int, chunk: int = 4096):
    """The greedy scan over ranked candidates: a chunk at a time, those
    already covered dropped at once, the rest taken in order."""
    nrows, ncols = fmap.shape
    out = []
    for a in range(0, len(cx), chunk):
        bx, by, bv = cx[a:a + chunk], cy[a:a + chunk], cv[a:a + chunk]
        live = ~fmap[by, bx]
        for px, py, pv in zip(bx[live].tolist(), by[live].tolist(),
                              bv[live].tolist()):
            if fmap[py, px]:
                continue
            out.append((float(px), float(py), int(pv)))
            if len(out) >= budget:
                return out
            if md >= 0:
                fmap[max(py - md, 0):min(py + md, nrows - 1) + 1,
                     max(px - md, 0):min(px + md, ncols - 1) + 1] = True
    return out


def _window(img: torch.Tensor, x, y, hw: int, hh: int):
    """[N, (2hh+1)(2hw+1)] bilinear samples of ``img`` on the window grid
    around (x, y): each tap truncated and blended on its own."""
    h, w = img.shape
    ox = torch.arange(-hw, hw + 1, dtype=F64, device=img.device)
    oy = torch.arange(-hh, hh + 1, dtype=F64, device=img.device)
    xs = (x[:, None, None] + ox[None, None, :]).expand(-1, len(oy), -1)
    ys = (y[:, None, None] + oy[None, :, None]).expand(-1, -1, len(ox))
    xt = torch.trunc(xs).clamp(0, w - 2)
    yt = torch.trunc(ys).clamp(0, h - 2)
    ax, ay = xs - xt, ys - yt
    i = (yt.long() * w + xt.long())
    f = img.reshape(-1)
    v = ((1 - ax) * (1 - ay) * f[i] + ax * (1 - ay) * f[i + 1]
         + (1 - ax) * ay * f[i + w] + ax * ay * f[i + w + 1])
    return v.reshape(len(x), -1)


def _in_bounds(x, y, hw, hh, ncols, nrows):
    eps = 1.001
    return ((x - hw >= 0.0) & (ncols - (x + hw) >= eps)
            & (y - hh >= 0.0) & (nrows - (y + hh) >= eps))


def track_level(x1, y1, x2, y2, p1, p2, level, cfg, active):
    """One level's iterative LK for every lane; (x2, y2, status)."""
    img1, gx1, gy1 = (p[level] for p in p1)
    img2, gx2, gy2 = (p[level] for p in p2)
    hw, hh = int(cfg["window_width"]) // 2, int(cfg["window_height"]) // 2
    nrows, ncols = img1.shape
    npx = (2 * hw + 1) * (2 * hh + 1)
    th = float(cfg["min_displacement"])
    w1 = _window(img1, x1, y1, hw, hh)
    g1x = _window(gx1, x1, y1, hw, hh)
    g1y = _window(gy1, x1, y1, hw, hh)
    ok1 = _in_bounds(x1, y1, hw, hh, ncols, nrows)
    status = torch.full_like(x1, KLT_TRACKED, dtype=torch.int64)
    its = torch.zeros_like(status)
    x, y, act = x2.clone(), y2.clone(), active.clone()
    for _ in range(int(cfg["max_iterations"])):
        ok = ok1 & _in_bounds(x, y, hw, hh, ncols, nrows)
        status = torch.where(act & ~ok, KLT_OOB, status)
        live = act & ok
        diff = w1 - _window(img2, x, y, hw, hh)
        gx = g1x + _window(gx2, x, y, hw, hh)
        gy = g1y + _window(gy2, x, y, hw, hh)
        gxx, gxy, gyy = (gx * gx).sum(1), (gx * gy).sum(1), (gy * gy).sum(1)
        ex = float(cfg["step_factor"]) * (diff * gx).sum(1)
        ey = float(cfg["step_factor"]) * (diff * gy).sum(1)
        det = gxx * gyy - gxy * gxy
        small = det < float(cfg["min_determinant"])
        status = torch.where(live & small, KLT_SMALL_DET, status)
        live = live & ~small
        safe = torch.where(small, 1.0, det)
        dx = (gyy * ex - gxy * ey) / safe
        dy = (gxx * ey - gxy * ex) / safe
        x = torch.where(live, x + dx, x)
        y = torch.where(live, y + dy, y)
        its = its + live.long()
        act = (live & ((dx.abs() >= th) | (dy.abs() >= th))
               & (its < int(cfg["max_iterations"])))
        if not bool(act.any()):
            break
    status = torch.where(active & ~_in_bounds(x, y, hw, hh, ncols, nrows),
                         KLT_OOB, status)
    tracked = active & (status == KLT_TRACKED)
    residue = (w1 - _window(img2, x, y, hw, hh)).abs().sum(1) / npx
    status = torch.where(tracked & (residue > float(cfg["max_residue"])),
                         KLT_LARGE_RESIDUE, status)
    tracked = active & (status == KLT_TRACKED)
    status = torch.where(tracked & (its >= int(cfg["max_iterations"])),
                         KLT_MAX_ITERATIONS, status)
    return x, y, status


def track(p1, p2, x, y, val, cfg):
    """Pyramidal LK of the live lanes (val >= 0) from pyramids ``p1`` to
    ``p2``; torch float64 x, y and int64 val in, the same out."""
    nrows, ncols = p1[0][0].shape
    s = float(cfg["subsampling"])
    levels = int(cfg["nPyramidLevels"])
    live = val >= 0
    xloc, yloc = x / s ** levels, y / s ** levels
    xout, yout = xloc.clone(), yloc.clone()
    status = torch.full_like(val, KLT_TRACKED)
    broken = torch.zeros_like(live)
    for r in range(levels - 1, -1, -1):
        xloc, yloc = xloc * s, yloc * s
        xout = torch.where(broken, xout, xout * s)
        yout = torch.where(broken, yout, yout * s)
        active = live & ~broken
        nx, ny, st = track_level(xloc, yloc, xout, yout, p1, p2, r, cfg,
                                 active)
        xout = torch.where(active, nx, xout)
        yout = torch.where(active, ny, yout)
        status = torch.where(active, st, status)
        broken |= active & ((st == KLT_SMALL_DET) | (st == KLT_OOB))
    bx, by = int(cfg["borderx"]), int(cfg["bordery"])
    out_of_view = ((xout < bx) | (xout > ncols - 1 - bx)
                   | (yout < by) | (yout > nrows - 1 - by))
    lost = (status != KLT_TRACKED) | out_of_view
    final = torch.where(out_of_view & (status != KLT_OOB), KLT_OOB, status)
    return (torch.where(live, torch.where(lost, -1.0, xout), x),
            torch.where(live, torch.where(lost, -1.0, yout), y),
            torch.where(live, final, val))


class Reference:
    """Steps of one configuration, with each frame's pyramids kept for the
    steps that share it."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = device
        self._pyr: dict = {}

    def pyr(self, key, frame: np.ndarray):
        if key not in self._pyr:
            if len(self._pyr) > 8:
                self._pyr.clear()
            self._pyr[key] = pyramids(
                torch.as_tensor(frame, device=self.device), self.cfg)
        return self._pyr[key]

    def start(self, key, frame: np.ndarray, n: int):
        """The first frame's selection: numpy (x, y, val) [n]."""
        imgs, gxs, gys = self.pyr(key, frame)
        eig = eig_map(gxs[0], gys[0], int(self.cfg["window_width"]),
                      int(self.cfg["window_height"]))
        return select(eig, np.full(n, -1.0), np.full(n, -1.0),
                      np.full(n, KLT_NOT_FOUND, np.int64), self.cfg,
                      replacing=False)

    def step(self, key_prev, frame_prev, key_new, frame_new, x, y, val,
             replace_lost: bool = True):
        """One frame step from the state (x, y, val) [N] numpy: track
        into the new frame, then refill the lost slots. numpy out."""
        p1 = self.pyr(key_prev, frame_prev)
        p2 = self.pyr(key_new, frame_new)
        dev = self.device
        tx, ty, tv = track(p1, p2, torch.as_tensor(x, dtype=F64, device=dev),
                           torch.as_tensor(y, dtype=F64, device=dev),
                           torch.as_tensor(val, dtype=torch.int64,
                                           device=dev), self.cfg)
        tx, ty, tv = (t.cpu().numpy() for t in (tx, ty, tv))
        if not replace_lost:
            return tx, ty, tv
        eig = eig_map(p2[1][0], p2[2][0], int(self.cfg["window_width"]),
                      int(self.cfg["window_height"]))
        return select(eig, tx, ty, tv, self.cfg, replacing=True)
