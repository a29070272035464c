"""SO(3)/SE(3) primitives and the pinhole camera model (plain PyTorch).

Port of ``pyfeaturetrack_tpu/sfm/geometry.py``: batched over leading dims,
float32. The JAX package runs its products at ``precision=HIGHEST``; here
every product is an IEEE float32 product, which the SfM entry points
require of the process (``require_fp32``: no TF32 for CUDA matmuls).
Also holds the small helpers the SfM modules share: the float32 staging of
host arrays onto a device and the device-to-host pull.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.staging import target_device

_EPS = 1e-8

def require_fp32(device) -> None:
    """Raise when CUDA float32 products on ``device`` may run as TF32: the
    geometry (rotation algebra, normal equations, Schur complements) needs
    full float32, as the JAX package's HIGHEST precision gives it."""
    if torch.device(device).type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the SfM modules need IEEE float32 matmuls on the card: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def f32(a, device=None) -> torch.Tensor:
    """``a`` as a float32 tensor: a tensor stays on its device (or moves to
    ``device`` when given), an array goes to ``device`` (default "cuda")."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device if device is not None else a.device,
                    dtype=torch.float32)
    dev = target_device(device if device is not None else "cuda")
    return torch.as_tensor(np.array(a, np.float32), device=dev)


def as_device(a, dtype, device) -> torch.Tensor:
    """``a`` (array or tensor) as a ``dtype`` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def to_host(t, dtype=None) -> np.ndarray:
    """A tensor as a numpy array (a stream sync when it lives on the card);
    arrays pass through."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t) if dtype is None else np.asarray(t, dtype)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] rotation vector -> [..., 3, 3] rotation matrix."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    theta = torch.clamp(theta, min=_EPS)
    axis = w / theta
    K = skew(axis)
    th = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * torch.matmul(K, K)
    small = th < 10 * _EPS
    return torch.where(small, eye + skew(w), R)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation matrix -> [..., 3] rotation vector."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w_hat = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    s = torch.clamp(2.0 * torch.sin(theta), min=_EPS)[..., None]
    # small-angle: w ~ w_hat / 2
    return torch.where(theta[..., None] < 1e-4, w_hat / 2.0,
                       w_hat * (theta[..., None] / s))


def se3_apply(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor
              ) -> torch.Tensor:
    """Y = R X + t. R: [..., 3, 3], t: [..., 3], X: [..., 3]."""
    return torch.matmul(R, X[..., None])[..., 0] + t


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b then a."""
    return torch.matmul(Ra, Rb), se3_apply(Ra, ta, tb)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.matmul(Rt, t[..., None])[..., 0]


def se3_exp(xi: torch.Tensor):
    """[..., 6] (rotation, translation) tangent vector -> (R, t).
    First-order coupling (V ~ I) is sufficient for GN increments."""
    return so3_exp(xi[..., :3]), xi[..., 3:]


def project(K, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pinhole projection. Returns (uv [..., 2], depth [...])."""
    Y = se3_apply(R, t, X)
    z = torch.clamp(Y[..., 2], min=_EPS)
    K = f32(K, Y.device)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * Y[..., 0] / z + cx
    v = fy * Y[..., 1] / z + cy
    return torch.stack([u, v], -1), Y[..., 2]
