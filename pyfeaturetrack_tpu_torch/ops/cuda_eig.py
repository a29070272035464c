"""K3: quantized min-eigenvalue map (csrc/eig.cu) and its plain version.

Port of ``pyfeaturetrack_tpu/ops/pallas_eig.py`` (min_eig_map_pallas):
gradient products, window sums (rows then columns, ascending taps), the
min-eig formula, zeroed border, clamp at ``_EIG_LIMIT`` and truncation to
int32, in one launch. A CUDA tensor launches the kernel; a CPU tensor
takes ``min_eig_reference``. The same arithmetic (csrc/eig_common.cuh)
runs inside K1's level-0 launch (ops/cuda_pyramid ``pyramid_build`` with
``eig_window``, ``level0_eig``), which is where every selection of the
package takes its map; ``min_eig_map`` is the counterpart of
``min_eig_map_pallas`` for gradients already on the device.

The plain version's window sums are explicit shifted adds, rows then
columns, in ascending tap order: the order of the kernel and of the JAX
package's Pallas eig kernel. Every selection in the port ranks by these
values (a +-1 change in quantization reorders candidates).
"""

from __future__ import annotations

import torch

from ..utils import cuda, profiling

# Largest float32 strictly below 2^31: the float->int32 cast then
# saturates like the reference's int clamp instead of overflowing.
_EIG_LIMIT = 2147483520.0


def _window_sum(img: torch.Tensor, window_height: int,
                window_width: int) -> torch.Tensor:
    """Box-filter sum over fully interior windows, zero elsewhere (the
    oracle writes results only for fully-interior windows)."""
    h, w = img.shape
    hh, hw = window_height // 2, window_width // 2
    out = torch.zeros_like(img)
    mh, mw = h - window_height + 1, w - window_width + 1
    if mh <= 0 or mw <= 0:
        return out
    v = img[0:mh, :]
    for k in range(1, window_height):
        v = v + img[k:k + mh, :]
    s = v[:, 0:mw]
    for k in range(1, window_width):
        s = s + v[:, k:k + mw]
    out[hh:hh + mh, hw:hw + mw] = s
    return out


def compute_min_eig_map(gradx: torch.Tensor, grady: torch.Tensor,
                        window_width: int, window_height: int) -> torch.Tensor:
    """Per-pixel min eigenvalue of the windowed structure tensor (float32,
    zero border)."""
    gxx = _window_sum(gradx * gradx, window_height, window_width)
    gxy = _window_sum(gradx * grady, window_height, window_width)
    gyy = _window_sum(grady * grady, window_height, window_width)
    disc = torch.sqrt((gxx - gyy) * (gxx - gyy) + 4.0 * gxy * gxy)
    return ((gxx + gyy) - disc) * 0.5


# Kernel launches made by this wrapper.
launches = 0
profiling.launch_counter(__name__, "launches")


@cuda.plain_version
def min_eig_reference(gradx: torch.Tensor, grady: torch.Tensor,
                      window_width: int, window_height: int) -> torch.Tensor:
    """Plain version of K3: int32 [H, W] with a zeroed border. Gradients
    stored as bfloat16 are upcast first: the sums are float32."""
    eig = compute_min_eig_map(gradx.to(torch.float32),
                              grady.to(torch.float32), window_width,
                              window_height)
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
