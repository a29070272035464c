"""Batched bilinear window sampling (plain PyTorch).

Reference parity: trackFeatures.py -> _interpolate; port of
``pyfeaturetrack_tpu/ops/interp.py``. Every tap of a window shares one
fractional offset, so one integer (h+1) x (w+1) patch gather plus a blend
of its four shifted views gives the whole window.
"""

from __future__ import annotations

import torch


def _int_floor(v: torch.Tensor) -> torch.Tensor:
    """floor(v) as int32, bounded so runaway lanes convert defined (same
    clamp as csrc/lk.cu and csrc/affine.cu)."""
    return torch.floor(v).clamp(-1.0e8, 1.0e8).to(torch.int32)


def bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
             ) -> torch.Tensor:
    """Sample ``img[y, x]`` bilinearly at float coords of any (equal)
    shape (interp.py:14-35 of the JAX package). The top-left tap is
    clamped to [0, w-2] x [0, h-2] for memory safety; callers mask
    validity separately, so the clamp never changes an active lane."""
    h, w = img.shape[-2], img.shape[-1]
    xt = _int_floor(xs)
    yt = _int_floor(ys)
    ax = xs - xt.to(xs.dtype)
    ay = ys - yt.to(ys.dtype)
    x0 = xt.clamp(0, w - 2).long()
    y0 = yt.clamp(0, h - 2).long()
    # the taps upcast to float32: levels may be stored as bfloat16
    flat = img.reshape(-1).to(xs.dtype)
    i00 = y0 * w + x0
    p00 = flat[i00]
    p01 = flat[i00 + 1]
    p10 = flat[i00 + w]
    p11 = flat[i00 + w + 1]
    return ((1.0 - ax) * (1.0 - ay) * p00 + ax * (1.0 - ay) * p01 +
            (1.0 - ax) * ay * p10 + ax * ay * p11)


def upsample_flow(u: torch.Tensor, shape: tuple[int, int],
                  scale: float) -> torch.Tensor:
    """Upscale a flow component to ``shape`` and rescale its magnitude:
    half-pixel-centre bilinear sampling, src = (dst + 0.5) / zoom - 0.5,
    clamped (flow.py:53-69 of the JAX package)."""
    h_out, w_out = shape
    h_in, w_in = u.shape
    ys = (torch.arange(h_out, dtype=u.dtype, device=u.device) + 0.5) \
        * (h_in / h_out) - 0.5
    xs = (torch.arange(w_out, dtype=u.dtype, device=u.device) + 0.5) \
        * (w_in / w_out) - 0.5
    ys = ys.clamp(0.0, h_in - 1.0)
    xs = xs.clamp(0.0, w_in - 1.0)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return bilinear(u, grid_x, grid_y) * scale


def window_coords(x: torch.Tensor, y: torch.Tensor, hw: int, hh: int):
    """Per-feature window sample coordinates (xs, ys) [N, 2hh+1, 2hw+1]:
    xs[n, j, i] = x[n] + (i - hw), ys[n, j, i] = y[n] + (j - hh)."""
    offs_x = torch.arange(-hw, hw + 1, dtype=x.dtype, device=x.device)
    offs_y = torch.arange(-hh, hh + 1, dtype=y.dtype, device=y.device)
    xs = x[:, None, None] + offs_x[None, None, :]
    ys = y[:, None, None] + offs_y[None, :, None]
    return torch.broadcast_tensors(xs, ys)


def gather_window(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  hw: int, hh: int) -> torch.Tensor:
    """Bilinear window stack [N, 2hh+1, 2hw+1] centred at (x, y)."""
    xs, ys = window_coords(x, y, hw, hh)
    return bilinear(img, xs, ys)


def patch_indices(img_shape, x: torch.Tensor, y: torch.Tensor, hw: int,
                  hh: int):
    """(rows [N,h+1,1], cols [N,1,w+1], ax [N], ay [N]) for the integer
    (h+1)x(w+1) patch whose top-left is floor(x)-hw / floor(y)-hh.

    The patch is clamped into the image (interp.py:73-74 of the JAX
    package); clamping only moves lanes that the bounds checks reject, so
    it never changes an active lane's window. The int conversion is
    bounded for runaway lanes (same clamp as csrc/lk.cu), and a level
    smaller than the patch keeps every index in the image (its lanes are
    all out of bounds)."""
    hsz, wsz = img_shape[-2], img_shape[-1]
    xt = _int_floor(x)
    yt = _int_floor(y)
    ax = x - xt.to(x.dtype)
    ay = y - yt.to(y.dtype)
    x0 = (xt - hw).clamp(0, wsz - 2 - 2 * hw).clamp(min=0)
    y0 = (yt - hh).clamp(0, hsz - 2 - 2 * hh).clamp(min=0)
    rows = y0[:, None, None] + torch.arange(2 * hh + 2, dtype=torch.int32,
                                            device=x.device)[None, :, None]
    cols = x0[:, None, None] + torch.arange(2 * hw + 2, dtype=torch.int32,
                                            device=x.device)[None, None, :]
    return (rows.clamp(max=hsz - 1).long(), cols.clamp(max=wsz - 1).long(),
            ax, ay)


def window_from_patch(patch: torch.Tensor, ax: torch.Tensor,
                      ay: torch.Tensor) -> torch.Tensor:
    """Blend the four shifted (h x w) views of an (h+1 x w+1) patch with
    the shared per-feature bilinear weights (blend order of interp.py:
    104-109 of the JAX package); a bfloat16 patch is upcast first."""
    patch = patch.to(ax.dtype)
    a = ax[:, None, None]
    b = ay[:, None, None]
    p00 = patch[:, :-1, :-1]
    p01 = patch[:, :-1, 1:]
    p10 = patch[:, 1:, :-1]
    p11 = patch[:, 1:, 1:]
    return ((1.0 - a) * (1.0 - b) * p00 + a * (1.0 - b) * p01 +
            (1.0 - a) * b * p10 + a * b * p11)


def gather_patch(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 hw: int, hh: int):
    """Integer patch [N, 2hh+2, 2hw+2] whose top-left is floor(x)-hw /
    floor(y)-hh, plus the per-feature fractional offsets (ax, ay): every
    tap of a window shares one fractional part, so one integer gather and
    ``window_from_patch`` give the window (interp.py:82-95 of the JAX
    package)."""
    rows, cols, ax, ay = patch_indices(img.shape, x, y, hw, hh)
    return img[rows, cols], ax, ay


def gather_window_fast(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       hw: int, hh: int) -> torch.Tensor:
    """Patch-gather + blend form of ``gather_window`` (the same values)."""
    return window_from_patch(*gather_patch(img, x, y, hw, hh))


def gather_windows(imgs, x: torch.Tensor, y: torch.Tensor, hw: int, hh: int):
    """Bilinear windows [N, 2hh+1, 2hw+1] of each image in ``imgs`` at the
    same per-feature positions (one index computation, shared blend)."""
    rows, cols, ax, ay = patch_indices(imgs[0].shape, x, y, hw, hh)
    return tuple(window_from_patch(im[rows, cols], ax, ay) for im in imgs)
