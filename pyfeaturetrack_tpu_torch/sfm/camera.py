"""Camera models with lens distortion: Brown-Conrady radial-tangential
and equidistant fisheye (plain PyTorch).

Port of ``pyfeaturetrack_tpu/sfm/camera.py``: batched maps between
DISTORTED and IDEAL normalized coordinates (``radtan``: k1, k2, p1, p2,
k3, OpenCV's order; ``fisheye``: equidistant, k1..k4), plus pixel-level
helpers through the intrinsics K. Undistortion is a fixed-trip iteration
(fixed point for radtan, Newton on the ray angle for fisheye) over all
points at once. The tracker runs on raw images; only the geometry
consumes ideal coordinates (VisualOdometry(dist=...)).
"""

from __future__ import annotations

import torch

from .geometry import f32, se3_apply


def _coeffs(dist, n: int, dev) -> list:
    d = f32(dist, dev).reshape(-1)
    d = torch.cat([d, torch.zeros(n - d.shape[0], dtype=torch.float32,
                                  device=dev)])
    return list(d)


def distort_radtan(x, dist):
    """Ideal normalized [..., 2] -> distorted normalized [..., 2] under
    Brown-Conrady (k1, k2, p1, p2, k3); shorter ``dist`` zero-pads."""
    k1, k2, p1, p2, k3 = _coeffs(dist, 5, x.device)
    u, v = x[..., 0], x[..., 1]
    r2 = u * u + v * v
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
    yd = v * radial + p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v
    return torch.stack([xd, yd], -1)


def undistort_radtan(xd, dist, n_iter: int = 10):
    """Distorted normalized [..., 2] -> ideal normalized [..., 2]:
    the standard fixed point x <- (xd - tangential(x)) / radial(x)."""
    xd = f32(xd)
    k1, k2, p1, p2, k3 = _coeffs(dist, 5, xd.device)
    x = xd
    for _ in range(n_iter):
        u, v = x[..., 0], x[..., 1]
        r2 = u * u + v * v
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        tx = 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
        ty = p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v
        x = torch.stack([(xd[..., 0] - tx) / radial,
                         (xd[..., 1] - ty) / radial], -1)
    return x


def distort_fisheye(x, dist):
    """Ideal normalized [..., 2] -> distorted normalized [..., 2] under
    the equidistant fisheye model (k1..k4): theta_d = theta (1 + k1
    theta^2 + ... + k4 theta^8), point scaled by theta_d / r."""
    k1, k2, k3, k4 = _coeffs(dist, 4, x.device)
    r = torch.sqrt((x * x).sum(-1))
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r < 1e-9, 1.0, theta_d / torch.clamp(r, min=1e-9))
    return x * scale[..., None]


def undistort_fisheye(xd, dist, n_iter: int = 10):
    """Distorted normalized [..., 2] -> ideal normalized [..., 2]:
    Newton iterations on theta solving theta_d(theta) = r_d, then the
    ideal radius is tan(theta)."""
    xd = f32(xd)
    k1, k2, k3, k4 = _coeffs(dist, 4, xd.device)
    rd = torch.sqrt((xd * xd).sum(-1))
    th = rd  # identity initialization (exact for a zero-coefficient lens)
    for _ in range(n_iter):
        t2 = th * th
        f = th * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - rd
        df = (1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2
                                           + t2 * (7.0 * k3
                                                   + t2 * 9.0 * k4))))
        th = th - f / torch.clamp(df, min=1e-9)
    scale = torch.where(rd < 1e-9, 1.0,
                        torch.tan(th) / torch.clamp(rd, min=1e-9))
    return xd * scale[..., None]


_DISTORT = {"radtan": distort_radtan, "fisheye": distort_fisheye}
_UNDISTORT = {"radtan": undistort_radtan, "fisheye": undistort_fisheye}


def _check_model(model: str) -> None:
    if model not in _DISTORT:
        raise ValueError(f"(camera) unknown distortion model {model!r}; "
                         f"expected one of {sorted(_DISTORT)}")


def _pixels(K, dist, uv, fn):
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    y = fn(x, dist)
    return torch.stack([y[..., 0] * fx + cx, y[..., 1] * fy + cy], -1)


def undistort_pixels(K, dist, uv, model: str = "radtan", *, device=None):
    """Observed (distorted) pixels [..., 2] -> ideal pinhole pixels under
    intrinsics K, on the device of ``uv`` (arrays go to ``device``,
    default "cuda")."""
    _check_model(model)
    uv = f32(uv, device)
    return _pixels(f32(K, uv.device), f32(dist, uv.device), uv,
                   _UNDISTORT[model])


def distort_pixels(K, dist, uv, model: str = "radtan", *, device=None):
    """Ideal pinhole pixels [..., 2] -> observed (distorted) pixels."""
    _check_model(model)
    uv = f32(uv, device)
    return _pixels(f32(K, uv.device), f32(dist, uv.device), uv,
                   _DISTORT[model])


def project_distorted(K, dist, R, t, X, model: str = "radtan", *,
                      device=None):
    """Full lens projection: world points [..., 3] -> observed pixels
    [..., 2] and depth [...] (geometry.project composed with the
    distortion map)."""
    _check_model(model)
    X = f32(X, device)
    dev = X.device
    Y = se3_apply(f32(R, dev), f32(t, dev), X)
    z = torch.clamp(Y[..., 2], min=1e-8)
    x = torch.stack([Y[..., 0] / z, Y[..., 1] / z], -1)
    xd = _DISTORT[model](x, f32(dist, dev))
    K = f32(K, dev)
    uv = torch.stack([xd[..., 0] * K[0, 0] + K[0, 2],
                      xd[..., 1] * K[1, 1] + K[1, 2]], -1)
    return uv, Y[..., 2]
