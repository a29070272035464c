"""Batched linear (DLT) triangulation (plain PyTorch).

Port of ``pyfeaturetrack_tpu/sfm/triangulate.py``."""

from __future__ import annotations

import torch

from ..ops.linalg import inv3x3
from .geometry import as_device, f32


def triangulate_dlt(K, Rs, ts, uvs, mask, *, device=None) -> torch.Tensor:
    """Triangulate L landmarks from up to C views each.

    K: [3, 3]; Rs/ts: [C, 3, 3]/[C, 3] world->camera; uvs: [L, C, 2]
    pixel observations; mask: [L, C] validity. Returns X: [L, 3] on the
    device of ``uvs`` (arrays go to ``device``, default "cuda").

    Standard DLT: for each observation, two rows of A X_h = 0 with
    A rows = u * P_2 - P_0 and v * P_2 - P_1 (P = K [R | t]); solved per
    landmark through the normal equations (masked rows are zero).
    """
    uvs = f32(uvs, device)
    dev = uvs.device
    K, Rs, ts = f32(K, dev), f32(Rs, dev), f32(ts, dev)
    P = torch.matmul(K, torch.cat([Rs, ts[..., None]], dim=-1))  # [C, 3, 4]

    u = uvs[..., 0]  # [L, C]
    v = uvs[..., 1]
    m = as_device(mask, torch.float32, dev)[..., None]  # [L, C, 1]
    row_u = (u[..., None] * P[None, :, 2, :] - P[None, :, 0, :]) * m
    row_v = (v[..., None] * P[None, :, 2, :] - P[None, :, 1, :]) * m
    A = torch.cat([row_u, row_v], dim=1)  # [L, 2C, 4]

    # min ||A x||, x = (X, 1): solve A33 X = -a4 where A = [A33 | a4]
    AtA = torch.matmul(A.transpose(1, 2), A)  # [L, 4, 4]
    M = AtA[:, :3, :3]
    b = -AtA[:, :3, 3]
    # regularize singular systems (too few views) minimally
    eye = torch.eye(3, dtype=A.dtype, device=dev) * 1e-6
    Minv, _ = inv3x3(M + eye[None])
    return torch.matmul(Minv, b[..., None])[..., 0]
