"""KLT v1.3.4's affine-consistency stage in plain float64 PyTorch: the
reference of the affine cells.

After the translational track of a step, KLT re-verifies each tracked
feature against the template it captured at its first successful track
(``affineConsistencyCheck`` 0, 1 or 2: a 2-, 4- or 6-parameter warp),
as ``_am_trackFeatureAffine`` and its helpers in ``trackFeatures.c`` do
and PyFeatureTrack's ``trackFeatures.py`` transcribes. Per step, for lanes
in slot order:

* a lane live before the step that the translational track lost drops its
  template and its warp goes back to the identity;
* a lane tracked with no template captures one: the bilinear windows of
  the previous frame's level 0 around its position before the step, the
  identity warp, and is not checked in that step;
* a lane tracked with a template runs Gauss-Newton on the warp against it:
  samples at ``(x + Axx i + Axy j, y + Ayx i + Ayy j)`` over the affine
  window, ``J J^T d = J (T - I2w)`` with the rows of ``J`` from image 2's
  gradients at the samples, up to ``affine_max_iterations`` updates, out
  of bounds (any sample outside ``[0, W - 1.001] x [0, H - 1.001]``) and
  a small determinant end the loop, and a step below
  ``affine_min_displacement`` in x and y converges; then a warp out of
  bounds, a mean ``|T - I2w|`` above ``affine_max_residue``
  (``KLT_LARGE_RESIDUE``) or a position more than
  ``affine_max_displacement_differ`` from the translational one
  (``KLT_OOB``) rejects it: its position becomes (-1, -1), its value the
  status, and it loses its template. A lane that passes keeps the refined
  position and warp;
* the refill (``reference/klt.select``) follows, and a refilled slot
  drops its template.

Pyramids, the translational track and the selection are ``reference/klt``'s.
The module imports nothing of the program and takes nothing the program
made but the state it is asked to step from. Every product is float64;
TF32 is switched off all the same, so that no float32 matmul of the
process is rounded further.

Departures from ``klt.c`` / PyFeatureTrack, each as the repository's
specification (the float64 oracle of the JAX package) makes it:

* the template is the 15x15 window of bilinear samples centred on the
  feature, where ``klt.c`` keeps a (w + 2) x (h + 2) sub-image at the
  integer pixel and samples it at the sub-pixel anchor; the template's own
  gradients, which ``klt.c`` also stores, are not kept, since the
  Gauss-Newton reads image 2's;
* the normal equations are solved by float64 LU (``torch.linalg.solve``)
  and a system whose ``|det|`` is below ``min_determinant`` is
  ``KLT_SMALL_DET``, where ``klt.c`` runs Gauss-Jordan elimination and
  flags a singular matrix;
* every lane runs the same fixed loop with masks (a finished lane changes
  nothing), where ``klt.c`` loops per feature.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.klt import (F64, KLT_LARGE_RESIDUE, KLT_OOB, KLT_SMALL_DET,
                           KLT_TRACKED, Reference, eig_map, pyramids, select,
                           track)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_ONE_PLUS_EPS = 1.001


class Templates(NamedTuple):
    """A step's affine state, float64 on one device: ``img`` [N, wh, ww]
    templates, ``A`` [N, 2, 2] warps (rows [[Axx, Axy], [Ayx, Ayy]]),
    ``valid`` [N] bool (template captured)."""
    img: torch.Tensor
    A: torch.Tensor
    valid: torch.Tensor


def empty(n: int, cfg: dict, device) -> Templates:
    """No template captured: zero windows, identity warps."""
    wh, ww = int(cfg["affine_window_height"]), int(cfg["affine_window_width"])
    return Templates(torch.zeros((n, wh, ww), dtype=F64, device=device),
                     torch.eye(2, dtype=F64, device=device).repeat(n, 1, 1),
                     torch.zeros(n, dtype=torch.bool, device=device))


def _offsets(cfg: dict, device):
    """(i, j) [wh, ww]: column and row offsets of the affine window."""
    hw = int(cfg["affine_window_width"]) // 2
    hh = int(cfg["affine_window_height"]) // 2
    i = torch.arange(-hw, hw + 1, dtype=F64, device=device)
    j = torch.arange(-hh, hh + 1, dtype=F64, device=device)
    return i[None, :].expand(len(j), -1), j[:, None].expand(-1, len(i))


def _coords(x, y, A, i, j):
    """Warped sample coordinates [N, wh, ww]."""
    xs = x[:, None, None] + A[:, 0, 0, None, None] * i + A[:, 0, 1, None, None] * j
    ys = y[:, None, None] + A[:, 1, 0, None, None] * i + A[:, 1, 1, None, None] * j
    return xs, ys


def _sample(img: torch.Tensor, xs, ys):
    """Bilinear samples of ``img`` at ``xs``, ``ys`` (any shape): the top-left
    tap truncated and clamped into the image, then blended."""
    h, w = img.shape
    xt = torch.trunc(xs).clamp(0, w - 2)
    yt = torch.trunc(ys).clamp(0, h - 2)
    ax, ay = xs - xt, ys - yt
    k = yt.long() * w + xt.long()
    f = img.reshape(-1)
    return ((1 - ax) * (1 - ay) * f[k] + ax * (1 - ay) * f[k + 1]
            + (1 - ax) * ay * f[k + w] + ax * ay * f[k + w + 1])


def _out(xs, ys, h: int, w: int):
    """[N]: a sample of the lane's window lies outside the image."""
    bad = (xs < 0) | (w - xs < _ONE_PLUS_EPS) | (ys < 0) | (h - ys < _ONE_PLUS_EPS)
    return bad.flatten(1).any(1)


def _jacobian(gx, gy, i, j, mode: int):
    """[N, P, wh * ww] rows of the warp's Jacobian by mode."""
    if mode == 0:
        rows = [gx, gy]
    elif mode == 1:
        rows = [gx * i + gy * j, gy * i - gx * j, gx, gy]
    else:
        rows = [gx * i, gy * i, gx * j, gy * j, gx, gy]
    return torch.stack([r.flatten(1) for r in rows], 1)


def _update(d, A, mode: int):
    """(A + dA, dx, dy) from the solution ``d`` [N, P]."""
    if mode == 0:
        return A, d[:, 0], d[:, 1]
    if mode == 1:
        dA = torch.stack([torch.stack([d[:, 0], -d[:, 1]], -1),
                          torch.stack([d[:, 1], d[:, 0]], -1)], -2)
        return A + dA, d[:, 2], d[:, 3]
    dA = torch.stack([torch.stack([d[:, 0], d[:, 2]], -1),
                      torch.stack([d[:, 1], d[:, 3]], -1)], -2)
    return A + dA, d[:, 4], d[:, 5]


def gauss_newton(tmpl, level2, x0, y0, A0, check, cfg: dict):
    """The warp's Gauss-Newton against ``tmpl`` for the lanes in ``check``
    from (x0, y0, A0) into level 0 ``level2`` = (img, gx, gy) of the new
    frame: (x, y, A, status [N] int64, updates [N] int64). Unchecked lanes
    pass through, TRACKED."""
    img2, gx2, gy2 = level2
    h, w = img2.shape
    mode = int(cfg["affineConsistencyCheck"])
    i, j = _offsets(cfg, x0.device)
    n = x0.shape[0]
    t = tmpl.flatten(1)
    th = float(cfg["affine_min_displacement"])
    x, y, A = x0.clone(), y0.clone(), A0.clone()
    status = torch.full((n,), KLT_TRACKED, dtype=torch.int64, device=x0.device)
    its = torch.zeros_like(status)
    active = check.clone()
    for _ in range(int(cfg["affine_max_iterations"])):
        if not bool(active.any()):
            break
        xs, ys = _coords(x, y, A, i, j)
        out = _out(xs, ys, h, w)
        status = torch.where(active & out, KLT_OOB, status)
        live = active & ~out
        diff = t - _sample(img2, xs, ys).flatten(1)
        J = _jacobian(_sample(gx2, xs, ys), _sample(gy2, xs, ys), i, j, mode)
        T = J @ J.transpose(1, 2)
        e = (J @ diff[:, :, None])[:, :, 0]
        det = torch.linalg.det(T)
        small = det.abs() < float(cfg["min_determinant"])
        status = torch.where(live & small, KLT_SMALL_DET, status)
        live = live & ~small
        eye = torch.eye(T.shape[1], dtype=F64, device=T.device)
        d = torch.linalg.solve(torch.where(live[:, None, None], T, eye),
                               torch.where(live[:, None], e, 0.0))
        nA, dx, dy = _update(d, A, mode)
        x = torch.where(live, x + dx, x)
        y = torch.where(live, y + dy, y)
        A = torch.where(live[:, None, None], nA, A)
        its = its + live.long()
        active = live & ((dx.abs() >= th) | (dy.abs() >= th))
    xs, ys = _coords(x, y, A, i, j)
    ok = check & (status == KLT_TRACKED)
    status = torch.where(ok & _out(xs, ys, h, w), KLT_OOB, status)
    ok = check & (status == KLT_TRACKED)
    residue = (t - _sample(img2, xs, ys).flatten(1)).abs().mean(1)
    status = torch.where(ok & (residue > float(cfg["affine_max_residue"])),
                         KLT_LARGE_RESIDUE, status)
    ok = check & (status == KLT_TRACKED)
    drift = torch.maximum((x - x0).abs(), (y - y0).abs())
    status = torch.where(
        ok & (drift > float(cfg["affine_max_displacement_differ"])),
        KLT_OOB, status)
    return x, y, A, status, its


def stage(level1, level2, before, after, st: Templates, cfg: dict):
    """The affine stage of one step: ``before`` (x, y, val) at the previous
    frame, ``after`` the translational track's; ``level1``/``level2`` the
    two frames' level 0 (img, gx, gy). Returns ((x, y, val), Templates,
    (lanes checked, their Gauss-Newton updates, lanes rejected))."""
    bx, by, bv = before
    ax, ay, av = after
    n = ax.shape[0]
    eye = torch.eye(2, dtype=F64, device=ax.device).expand(n, 2, 2)
    tracked = av == KLT_TRACKED
    lost = (bv >= 0) & ~tracked
    valid = st.valid & ~lost
    A = torch.where(lost[:, None, None], eye, st.A)
    capture = tracked & ~valid
    i, j = _offsets(cfg, ax.device)
    fresh = _sample(level1[0], bx[:, None, None] + i, by[:, None, None] + j)
    img = torch.where(capture[:, None, None], fresh, st.img)
    A = torch.where(capture[:, None, None], eye, A)
    valid = valid | capture
    check = tracked & valid & ~capture
    x, y, nA, status, its = gauss_newton(img, level2, ax, ay, A, check, cfg)
    failed = check & (status != KLT_TRACKED)
    keep = check & ~failed
    out = (torch.where(check, torch.where(failed, -1.0, x), ax),
           torch.where(check, torch.where(failed, -1.0, y), ay),
           torch.where(failed, status, av))
    counts = (int(check.sum()), int(its[check].sum()), int(failed.sum()))
    return out, Templates(img, torch.where(keep[:, None, None], nA, A),
                          valid & ~failed), counts


class AffineReference(Reference):
    """``reference/klt.Reference``'s steps with the affine stage between the
    track and the refill. Every frame's pyramids and selection map are kept
    (the clips are short and replayed). ``counts`` sums the stages' (lanes
    checked, Gauss-Newton updates, lanes rejected)."""

    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self._eig: dict = {}
        self.counts = [0, 0, 0]

    def pyr(self, key, frame: np.ndarray):
        if key not in self._pyr:
            self._pyr[key] = pyramids(
                torch.as_tensor(frame, device=self.device), self.cfg)
        return self._pyr[key]

    def eig(self, key, frame: np.ndarray):
        if key not in self._eig:
            _, gxs, gys = self.pyr(key, frame)
            self._eig[key] = eig_map(gxs[0], gys[0],
                                     int(self.cfg["window_width"]),
                                     int(self.cfg["window_height"]))
        return self._eig[key]

    def affine_step(self, key_prev, frame_prev, key_new, frame_new, x, y,
                    val, st: Templates, replace_lost: bool = True):
        """One step from the state (x, y, val) [N] numpy and ``st``: track,
        the affine stage, the refill (a refilled slot drops its template).
        Returns ((x, y, val) numpy, Templates)."""
        p1 = self.pyr(key_prev, frame_prev)
        p2 = self.pyr(key_new, frame_new)
        dev = self.device
        before = (torch.as_tensor(x, dtype=F64, device=dev),
                  torch.as_tensor(y, dtype=F64, device=dev),
                  torch.as_tensor(val, dtype=torch.int64, device=dev))
        after = track(p1, p2, *before, self.cfg)
        (tx, ty, tv), st, counts = stage(tuple(p[0] for p in p1),
                                         tuple(p[0] for p in p2), before,
                                         after, st, self.cfg)
        self.counts = [a + b for a, b in zip(self.counts, counts)]
        tx, ty, tv = (t.cpu().numpy() for t in (tx, ty, tv))
        if not replace_lost:
            return (tx, ty, tv), st
        lost = torch.as_tensor(tv < 0, device=dev)
        out = select(self.eig(key_new, frame_new), tx, ty, tv, self.cfg,
                     replacing=True)
        eye = torch.eye(2, dtype=F64, device=dev).expand_as(st.A)
        return out, Templates(st.img,
                              torch.where(lost[:, None, None], eye, st.A),
                              st.valid & ~lost)
