"""Batched small-matrix linear algebra (plain PyTorch).

Port of ``pyfeaturetrack_tpu/ops/linalg.py``: closed forms and unpivoted
Gauss-Jordan on [..., P, P] batches of tiny symmetric (semi)definite
normal matrices, in the JAX package's operation order so that the results
agree bit for bit. ``csrc/affine.cu`` runs the same elimination per
feature.
"""

from __future__ import annotations

import torch


def inv3x3(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form inverse + determinant of [..., 3, 3] matrices.
    Singular inputs give garbage inverses: callers mask on |det|."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    safe = torch.where(det.abs() < 1e-30, 1.0, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / safe[..., None, None], det


def gauss_solve_det(A: torch.Tensor, b: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve A x = b for [..., P, P] / [..., P] batches by unpivoted
    Gauss-Jordan (unrolled over P). Returns (x, det).

    Per pivot k: det *= pivot; a pivot with |pivot| < 1e-30 divides as 1;
    the scaled pivot row is subtracted from every row, then row k is
    replaced by the scaled pivot row (the JAX package's order)."""
    p = A.shape[-1]
    aug = torch.cat([A, b[..., None]], dim=-1)          # [..., P, P+1]
    det = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    is_k = torch.arange(p, device=A.device)
    for k in range(p):
        piv = aug[..., k, k]
        det = det * piv
        safe = torch.where(piv.abs() < 1e-30, 1.0, piv)
        row = aug[..., k, :] / safe[..., None]          # [..., P+1]
        factors = aug[..., :, k]                         # [..., P]
        elim = aug - factors[..., :, None] * row[..., None, :]
        aug = torch.where((is_k == k)[:, None], row[..., None, :], elim)
    return aug[..., :, p], det
