"""Operations and bytes that a frame's kernels need, from shapes and from
what the benchmark knows of the inputs: the least any implementation of
the stage could move and compute, so that a roofline share stays the
same whatever implements the stage.

Counting model (copied from the repository's chip smoke script and
``utils/roofline.py``, then made to count what these inputs need): each
input byte is read once and each output byte written once; a 1-D filter
pass costs a multiply and an add per tap and output sample; data-dependent
loops count what the inputs need at least (one Gauss-Newton step per live
lane and level reached). No count reads a counter of the program.
``bound_s`` turns a count into the least time on one H100 SXM: the larger
of bytes over 3.35 TB/s and float32 operations over 67 TFLOP/s (NVIDIA's
data sheet, dense, 700 W).
"""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds one H100 needs to move ``nbytes`` and compute ``ops``
    float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def _trim(taps: np.ndarray, peak: float) -> int:
    """Width left when taps below 1 % of ``peak`` are trimmed from both
    ends (KLT's kernel rule)."""
    k = int(np.argmax(np.abs(taps / peak) >= 0.01))
    return len(taps) - 2 * k


def kernel_widths(sigma: float) -> tuple:
    """(gauss, derivative) tap counts of KLT's kernels for ``sigma``."""
    i = np.arange(-35, 36, dtype=np.float64)
    gauss = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return _trim(gauss, 1.0), _trim(-i * gauss, sigma * math.exp(-0.5))


def level_shapes(cfg: dict, h: int, w: int) -> list:
    s = int(cfg["subsampling"])
    out = [(h, w)]
    for _ in range(1, int(cfg["nPyramidLevels"])):
        h, w = h // s, w // s
        out.append((h, w))
    return out


def storage_bytes(cfg: dict) -> int:
    return 2 if cfg.get("image_dtype", "float32") == "bfloat16" else 4


def eig_ops(cfg: dict, h: int, w: int) -> int:
    """K3's map: per pixel three products, each product's two 1-D window
    sums, and the eigenvalue (8)."""
    ww, wh = int(cfg["window_width"]), int(cfg["window_height"])
    return (3 + 3 * (ww - 1 + wh - 1) + 8) * h * w


def k1(cfg: dict, h: int, w: int, with_eig: bool = True) -> tuple:
    """K1, one frame's pyramid: the float32 frame read once; each level's
    image and gradient pair written once in the storage type; the level-0
    pre-smooth, each level's four gradient passes and the pyramid
    smoothing at the decimated samples only. ``with_eig``: K3's int32 map
    of level 0 written, with its arithmetic. (bytes, operations)."""
    ks, _ = kernel_widths(cfg["smooth_sigma_fact"]
                          * max(cfg["window_width"], cfg["window_height"]))
    kg, kd = kernel_widths(cfg["grad_sigma"])
    s = int(cfg["subsampling"])
    kp, _ = kernel_widths(s * cfg["pyramid_sigma_fact"])
    b = storage_bytes(cfg)
    nbytes, ops = 4 * h * w, 0
    shapes = level_shapes(cfg, h, w)
    for level, (hl, wl) in enumerate(shapes):
        if level == 0:
            ops += 2 * 2 * ks * hl * wl
        ops += (4 * kd + 4 * kg) * hl * wl
        nbytes += 3 * b * hl * wl
        if level + 1 < len(shapes):
            h2, w2 = shapes[level + 1]
            ops += 2 * kp * hl * w2 + 2 * kp * h2 * w2
    if with_eig:
        nbytes += 4 * h * w
        ops += eig_ops(cfg, h, w)
    return nbytes, ops


def k2(cfg: dict, n: int, tracked: int, lost: int) -> tuple:
    """K2, one track call over ``n`` slots: ``tracked`` lanes that ended
    tracked reached every level, ``lost`` lanes that were live and ended
    lost reached at least the coarsest. Per lane and level reached its
    (ww+1)(wh+1) patch of the six level images read once, 31 operations a
    window pixel for the frame-1 windows and the residue, and one
    Gauss-Newton step (34 a window pixel and 12 for the solve); the slots
    read and written once. (bytes, operations)."""
    ww, wh = int(cfg["window_width"]), int(cfg["window_height"])
    npx, patch = ww * wh, (ww + 1) * (wh + 1)
    reached = tracked * int(cfg["nPyramidLevels"]) + lost
    nbytes = reached * 6 * patch * storage_bytes(cfg) + n * 24
    return nbytes, reached * (npx * 31 + npx * 34 + 12)


def lattice(cfg: dict, h: int, w: int) -> tuple:
    """(rows, cols) of the candidate lattice inside the borders."""
    bx = max(int(cfg["borderx"]), max(int(cfg["window_width"]) // 2, 1))
    by = max(int(cfg["bordery"]), max(int(cfg["window_height"]) // 2, 1))
    step = int(cfg["nSkippedPixels"]) + 1
    return (len(range(by, h - by, step)), len(range(bx, w - bx, step)))


def k4(cfg: dict, h: int, w: int, n: int, accepted: int) -> tuple:
    """K4, one selection or refill: the map's lattice cells and the n slots
    read once, the slots (x, y, val, filled) written once; one compare a
    candidate and one store a cell of each accepted box. (bytes,
    operations)."""
    ny, nx = lattice(cfg, h, w)
    dg = max(0, (int(cfg["mindist"]) - 1) // (int(cfg["nSkippedPixels"]) + 1))
    return 4 * ny * nx + 12 * n + 13 * n, ny * nx + accepted * (2 * dg + 1) ** 2


def k6(cfg: dict, n: int, checked: int, iterations: int) -> tuple:
    """K6, one affine batch: each checked lane's template and the
    footprint of the three images read once, lanes in and out; per sample
    and Gauss-Newton iteration the warp (8), bounds (2), weights (6),
    three blends (21), residual (1), Jacobian and normal equations, per
    iteration the unpivoted solve, after the loop 26 a sample. (bytes,
    operations)."""
    mode = int(cfg["affineConsistencyCheck"])
    p = (2, 4, 6)[mode]
    ns = p * (p + 1) // 2 + p
    jac = (0, 6, 4)[mode]
    aw, ah = int(cfg["affine_window_width"]), int(cfg["affine_window_height"])
    npx, foot = aw * ah, (aw + 1) * (ah + 1)
    nbytes = (checked * (npx * 4 + 3 * foot * storage_bytes(cfg))
              + n * (8 + 16 + 1 + 8 + 16 + 8))
    per_sample = 8 + 2 + 6 + 21 + 1 + jac + 2 * ns
    ops = (iterations * (npx * per_sample + 2 * p * p * (p + 1))
           + checked * npx * 26)
    return nbytes, ops


def k8(cfg: dict, h: int, w: int, reached: int, iterations: int,
       one_d: bool = False, coarse=None) -> tuple:
    """K8, one dense LK level of h x w pixels: the level images read once
    (six; four in the 1-D mode), the maps in (level-sized, or of the
    ``coarse`` shape when upsampled in the kernel, 20 operations a pixel
    and map) and out; per iteration and window pixel 34 (2-D) or 20 (1-D)
    operations and 12 or 4 for the solve; 10 a window pixel for the final
    residue of the ``reached`` pixels. (bytes, operations)."""
    ww, wh = int(cfg["window_width"]), int(cfg["window_height"])
    npx, n = ww * wh, h * w
    nmaps = 1 if one_d else 2
    hm, wm = (h, w) if coarse is None else coarse
    maps = 4 * nmaps * hm * wm
    up = 0 if coarse is None else 20 * nmaps * n
    b = storage_bytes(cfg)
    if one_d:
        return (4 * b * n + maps + n * 12,
                reached * npx * 10 + iterations * (npx * 20 + 4) + up)
    return (6 * b * n + maps + n * 16,
            reached * npx * 10 + iterations * (npx * 34 + 12) + up)


def frame_counts(cfg: dict, h: int, w: int, prev_val: np.ndarray,
                 val: np.ndarray) -> dict:
    """{kernel: (bytes, operations)} of one tracked frame from the slots'
    values before and after the step: K1 with the map, K2 over the lanes
    that were live, K4 over the slots refilled (value > 0 after)."""
    live = prev_val >= 0
    tracked = int((live & (val == 0)).sum())
    lost = int((live & (val < 0)).sum()) + int((live & (val > 0)).sum())
    n = int(val.shape[-1])
    return {"k1": k1(cfg, h, w), "k2": k2(cfg, n, tracked, lost),
            "k4": k4(cfg, h, w, n, int((val > 0).sum()))}
