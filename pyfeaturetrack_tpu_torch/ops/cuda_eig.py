"""K3: quantized min-eigenvalue map (csrc/eig.cu) and its plain version.

Port of ``pyfeaturetrack_tpu/ops/pallas_eig.py`` (min_eig_map_pallas):
gradient products, window sums (rows then columns, ascending taps), the
min-eig formula, zeroed border, clamp at ``_EIG_LIMIT`` and truncation to
int32, in one launch. A CUDA tensor launches the kernel; a CPU tensor
takes ``min_eig_reference``.
"""

from __future__ import annotations

import torch

from ..utils import cuda
from .select import _EIG_LIMIT, compute_min_eig_map

# Kernel launches made by this wrapper.
launches = 0


def min_eig_reference(gradx: torch.Tensor, grady: torch.Tensor,
                      window_width: int, window_height: int) -> torch.Tensor:
    """Plain version of K3: int32 [H, W] with a zeroed border."""
    eig = compute_min_eig_map(gradx, grady, window_width, window_height)
    return torch.clamp(eig, max=_EIG_LIMIT).to(torch.int32)


def _launch(gx, gy, out, window_width, window_height):
    global launches
    fn = cuda.function("pft_min_eig_map", [cuda.c_ptr] * 3 + [cuda.c_int] * 4
                       + [cuda.c_ptr])
    h, w = gx.shape
    rc = fn(gx.data_ptr(), gy.data_ptr(), out.data_ptr(), h, w,
            window_width, window_height, cuda.stream_ptr(gx.device))
    cuda.check(rc, "pft_min_eig_map")
    launches += 1


def min_eig_map(gradx: torch.Tensor, grady: torch.Tensor, window_width: int,
                window_height: int) -> torch.Tensor:
    """Quantized min-eig map, int32 [H, W] (same contract as
    ``quantized_min_eig_map`` of the JAX package)."""
    if not cuda.use_kernel(gradx, grady):
        return min_eig_reference(gradx, grady, window_width, window_height)
    cuda.require(gradx.dim() == 2 and gradx.shape == grady.shape
                 and gradx.numel() > 0
                 and all(t.dtype == torch.float32 and t.is_contiguous()
                         for t in (gradx, grady)),
                 "min_eig_map takes two contiguous float32 [H, W] gradients")
    cuda.require(window_width % 2 == 1 and window_height % 2 == 1,
                 "min_eig_map takes odd windows")
    out = torch.empty(gradx.shape, dtype=torch.int32, device=gradx.device)
    _launch(gradx, grady, out, int(window_width), int(window_height))
    return out
