"""Dense pyramidal Lucas-Kanade optical flow: the tracker at every pixel.

Port of ``pyfeaturetrack_tpu/ops/flow.py``. Dense flow is the sparse
tracker's per-level math (``ops/track.track_feature_level``) applied to
every pixel centre; each level solves on its own pixel grid, started from
the coarser level's flow upsampled bilinearly (``upsample_flow``), and the
status map is the finest level's. Each level is one launch of K8 on CUDA
tensors (ops/cuda_lk_dense.dense_level_up: the kernel reads the coarser
level's maps and computes the upsampled start itself; the coarsest level
starts at zero with no map); the pyramids are K1.

``compute_dense_flow`` takes numpy arrays or tensors: an array runs on
"cuda" unless ``device="cpu"`` is given (with no CUDA device that
raises), a tensor on its own device. No host read happens between the
pyramid build and the returned maps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda_lk_dense import dense_level, dense_level_up
from .interp import bilinear, upsample_flow  # noqa: F401
from .track import TrackPyramids, as_frame, build_track_pyramids


class DenseFlow(NamedTuple):
    """Per-pixel flow field + KLT status map for one frame pair."""
    u: torch.Tensor       # [H, W] float32, x-displacement
    v: torch.Tensor       # [H, W] float32, y-displacement
    status: torch.Tensor  # [H, W] int32, KLT status codes


def warp_image(img: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """Backward warp: out[y, x] = img(x + u[y, x], y + v[y, x]), bilinear.
    Coordinates clamp at the rim (the last row and column resolve to the
    previous texel, interp.bilinear's clamp)."""
    h, w = img.shape
    gx = torch.arange(w, dtype=u.dtype, device=u.device)[None, :] + u
    gy = torch.arange(h, dtype=v.dtype, device=v.device)[:, None] + v
    return bilinear(img, gx, gy)


def flow_level(img1, gx1, gy1, img2, gx2, gy2, u, v, cfg):
    """One pyramid level of dense LK, started at grid + (u, v): (u, v,
    status) maps. K8 on CUDA tensors, its plain version on CPU ones."""
    u, v, status, _ = dense_level(img1, gx1, gy1, img2, gx2, gy2, u, v, cfg)
    return u, v, status


def dense_flow_pyramids(pyr1: TrackPyramids, pyr2: TrackPyramids,
                        cfg) -> DenseFlow:
    """Coarse-to-fine dense LK over prebuilt pyramids. Flow starts at zero
    on the coarsest level; each finer level re-solves on its own grid from
    the upsampled field (a level of the coarser one's shape from that field
    as it is). The status map is the finest level's. One K8 launch per
    level on CUDA tensors."""
    s = float(cfg.subsampling)
    u = v = status = None
    for r in range(cfg.nPyramidLevels - 1, -1, -1):
        lvl = (pyr1.img[r], pyr1.gradx[r], pyr1.grady[r], pyr2.img[r],
               pyr2.gradx[r], pyr2.grady[r])
        if u is not None and tuple(u.shape) == tuple(lvl[0].shape):
            u, v, status, _ = dense_level(*lvl, u, v, cfg)
        else:
            u, v, status, _ = dense_level_up(*lvl, u, v, s, cfg)
    return DenseFlow(u=u, v=v, status=status)


def flow_consistency(fwd: DenseFlow, bwd: DenseFlow, max_err: float = 0.5):
    """Forward-backward flow consistency (occlusion detection).

    e(p) = |flow_fwd(p) + flow_bwd(p + flow_fwd(p))|. Returns (err [H, W],
    valid [H, W] bool); valid needs the forward status TRACKED, a TRACKED
    backward status at the landing pixel (nearest: ``torch.round``, half
    to even like ``jnp.round``) and err <= max_err."""
    ub = warp_image(bwd.u, fwd.u, fwd.v)
    vb = warp_image(bwd.v, fwd.u, fwd.v)
    err = torch.hypot(fwd.u + ub, fwd.v + vb)
    h, w = fwd.u.shape
    lx = torch.round(torch.arange(w, dtype=fwd.u.dtype,
                                  device=fwd.u.device)[None, :]
                     + fwd.u).clamp(0, w - 1).long()
    ly = torch.round(torch.arange(h, dtype=fwd.v.dtype,
                                  device=fwd.v.device)[:, None]
                     + fwd.v).clamp(0, h - 1).long()
    bwd_ok = bwd.status[ly, lx] == 0
    valid = (fwd.status == 0) & bwd_ok & (err <= max_err)
    return err, valid


def dense_flow_fb(pyr1: TrackPyramids, pyr2: TrackPyramids, cfg,
                  max_err: float = 0.5):
    """Dense flow with the forward-backward occlusion gate: (forward
    DenseFlow, round-trip err map, valid mask)."""
    fwd = dense_flow_pyramids(pyr1, pyr2, cfg)
    bwd = dense_flow_pyramids(pyr2, pyr1, cfg)
    err, valid = flow_consistency(fwd, bwd, max_err=max_err)
    return fwd, err, valid


def dense_flow_batched(imgs1, imgs2, cfg, device=None) -> DenseFlow:
    """Dense flow for B frame pairs: ``imgs1``/``imgs2`` are [B, H, W]
    stacks (arrays or tensors, placed as ``compute_dense_flow`` places
    them), the result maps [B, H, W]. The JAX package runs the pairs as one
    vmapped program; the port loops over them (one K1 build per frame and
    one K8 launch per level and pair)."""
    cfg = cfg.validated_window()
    outs = []
    for a, b in zip(imgs1, imgs2):
        p1 = build_track_pyramids(as_frame(a, device), cfg)
        p2 = build_track_pyramids(as_frame(b, p1.img[0].device), cfg)
        outs.append(dense_flow_pyramids(p1, p2, cfg))
    return DenseFlow(*(torch.stack(t) for t in zip(*outs)))


def compute_dense_flow(img1, img2, cfg=None, device=None) -> DenseFlow:
    """High-level entry: dense flow from frame 1 to frame 2. Arrays go to
    ``device`` (default "cuda"), tensors stay on theirs unless ``device``
    is given."""
    from ..config import create_config
    cfg = (cfg or create_config()).validated_window()
    f1 = as_frame(img1, device)
    p1 = build_track_pyramids(f1, cfg)
    p2 = build_track_pyramids(as_frame(img2, f1.device), cfg)
    return dense_flow_pyramids(p1, p2, cfg)


def flow_to_rgb(u, v, max_mag: float | None = None):
    """Flow-wheel visualization: hue = direction, saturation = magnitude.
    Returns a uint8 [H, W, 3] numpy array (for utils/io.ppm_write); maps
    may be tensors on any device or arrays (a copy of the JAX package's
    numpy code)."""
    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    mag = np.hypot(u, v)
    if max_mag is None:
        max_mag = max(float(np.percentile(mag, 99)), 1e-6)
    ang = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0  # [0, 1)
    sat = np.clip(mag / max_mag, 0.0, 1.0)
    # minimal HSV->RGB (value fixed at 1)
    i = np.floor(ang * 6.0).astype(np.int32) % 6
    f = ang * 6.0 - np.floor(ang * 6.0)
    p = 1.0 - sat
    q = 1.0 - sat * f
    t = 1.0 - sat * (1.0 - f)
    one = np.ones_like(sat)
    lut = np.stack([
        np.stack([one, t, p], -1), np.stack([q, one, p], -1),
        np.stack([p, one, t], -1), np.stack([p, q, one], -1),
        np.stack([t, p, one], -1), np.stack([one, p, q], -1)], 0)
    rgb = np.take_along_axis(lut, i[None, ..., None], axis=0)[0]
    return (rgb * 255.0 + 0.5).astype(np.uint8)
