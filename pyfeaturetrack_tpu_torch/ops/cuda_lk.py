"""K2: pyramidal translational LK (csrc/lk.cu) and its plain versions.

Port of ``pyfeaturetrack_tpu/ops/pallas_lk_vec.py`` (vec_track_level /
vec_track_level_with_fallback), whose semantics are
``ops/track.track_feature_level``, with the coarse-to-fine level loop the
JAX package runs around it in XLA (``ops/track.py:337-402``).

* ``track_pyramid``: a whole track call, every level coarse to fine, the
  coarse-level "broken" rule and the final classification, in one launch.
  Its plain version, ``track_pyramid_reference``, is the level loop around
  ``lk_level_reference``. Guided starts (``x_init``/``y_init``: loop
  closure, relocalization, stereo) enter the same launch.
* ``lk_level``: one level for given positions. ``lk_level_reference`` is
  ``track_feature_level`` in PyTorch: the same fixed-trip masked
  iteration, the same status order, with every window sum taken in the
  kernel's reduction order (``tree_sum``), so the plain version and the
  kernel compute the same bits. K8's plain version (``cuda_lk_dense``) is
  the same function with its own sum order and 1-D mode.

Levels stored as float32 or bfloat16 (``cfg.image_dtype``): every tap is
upcast to float32 where it is read, and all blending and sums are float32.

A CUDA tensor launches the kernel (one launch per call); a CPU tensor
takes the plain version. ``track_pyramid``'s launch adds the Gauss-Newton
steps it ran and the levels its lanes entered to the card's device counters
(``utils/profiling.DEVICE_COUNTERS``).
"""

from __future__ import annotations

from typing import NamedTuple

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..features import (KLT_LARGE_RESIDUE, KLT_MAX_ITERATIONS, KLT_OOB,
                        KLT_SMALL_DET, KLT_TRACKED)
from ..utils import cuda, profiling
from .interp import gather_windows

_ONE_PLUS_EPS = 1.001     # ops/track._ONE_PLUS_EPS (reference bound check)
# csrc/lk.cu PFT_LK_MAX_LEVELS: levels whose pointers pass by value; a
# deeper pyramid passes them as a table in device memory
LEVELS_BY_VALUE = 32

# Kernel launches made by this module's wrappers; guided_launches counts
# the track_pyramid launches that took guided starts (also in launches).
launches = 0
guided_launches = 0
profiling.launch_counter(__name__, "launches", "guided_launches")


class _Levels(NamedTuple):
    """A pyramid's level tuples (the fields of ``ops/track.TrackPyramids``)."""
    img: tuple
    gradx: tuple
    grady: tuple


class TrackCarry(NamedTuple):
    """Sequential-mode frame-1 window carry; the signature of
    ``pyfeaturetrack_tpu.ops.pallas_lk_vec.TrackCarry``.

    The port threads it through the sequence step but does not reuse the
    windows yet: a passed carry comes back with ``ok`` all False, and
    results are the same with or without one.
    ``bundle``: [N, 3, wh, ww] img / gx / gy windows; ``x``/``y``: where
    they were taken; ``ok``: lanes whose bundle is usable.
    """
    bundle: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    ok: torch.Tensor


def empty_track_carry(n: int, cfg, device="cuda") -> TrackCarry:
    """Structure-stable 'no carry' value (``ok`` all False)."""
    return TrackCarry(
        bundle=torch.zeros((n, 3, cfg.window_height, cfg.window_width),
                           dtype=torch.float32, device=device),
        x=torch.full((n,), -1e30, dtype=torch.float32, device=device),
        y=torch.full((n,), -1e30, dtype=torch.float32, device=device),
        ok=torch.zeros((n,), dtype=torch.bool, device=device))


_LEVEL_DTYPES = (torch.float32, torch.bfloat16)


def _is_bf16(imgs, what: str) -> bool:
    """The one storage dtype of a launch's level images (float32 or
    bfloat16) as the C entries' flag."""
    dtypes = {t.dtype for t in imgs}
    cuda.require(len(dtypes) == 1 and dtypes <= set(_LEVEL_DTYPES),
                 f"{what}: the level images share one dtype, float32 or "
                 f"bfloat16, not {sorted(map(str, dtypes))}")
    return dtypes == {torch.bfloat16}


def _f32(v: float) -> float:
    """A config threshold as the float32 value the kernel compares with."""
    return float(np.float32(v))


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of [..., P] over P in the kernel's warp order: window pixel
    p = lane + 32 k; each lane adds its pixels in ascending k (padding
    pixels count 0), then the 32 lane totals combine by an xor butterfly
    (offsets 16, 8, 4, 2, 1)."""
    p = v.shape[-1]
    k = -(-p // 32)
    v = F.pad(v, (0, 32 * k - p)).reshape(*v.shape[:-1], k, 32)
    acc = v[..., 0, :]
    for j in range(1, k):
        acc = acc + v[..., j, :]
    w = 16
    while w >= 1:
        acc = acc[..., :w] + acc[..., w:2 * w]
        w //= 2
    return acc[..., 0]


def _bounds_ok(x, y, hw: int, hh: int, ncols: int, nrows: int):
    """Window-fits-in-image test (ops/track._bounds_ok)."""
    eps = _f32(_ONE_PLUS_EPS)
    return ((x - hw >= 0.0) & (ncols - (x + hw) >= eps) &
            (y - hh >= 0.0) & (nrows - (y + hh) >= eps))


def lk_level_reference(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2,
                       cfg, active, sum_fn=tree_sum, one_d=False):
    """Plain version of K2 = ``track_feature_level`` (track.py:155-234),
    and of K8 (``cuda_lk_dense``) with ``sum_fn`` its sequential sum.

    ``sum_fn`` sums [..., P] over the window in the kernel's order.
    ``one_d``: K8's disparity mode (disparity.py:134-178), the scalar step
    ``du = step_factor sum(diff gx) / gxx`` with gx = g1x + g2x, SMALL_DET
    when ``gxx < min_determinant``, convergence on |du| alone, y fixed so
    bounds are checked at (x2, y1); gy1 and gy2 are not read.
    Returns (x2, y2, status, iteration) [N]; lanes with ``active`` False
    pass through with status KLT_TRACKED and iteration 0."""
    hw, hh = cfg.window_width // 2, cfg.window_height // 2
    nrows, ncols = img1.shape
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from the
    # kernel's (and the CPU's) true division
    n_px = torch.full((), float((2 * hw + 1) * (2 * hh + 1)),
                      dtype=torch.float32, device=x1.device)
    th = _f32(cfg.min_displacement)
    min_det = _f32(cfg.min_determinant)
    step = _f32(cfg.step_factor)
    # the 1-D mode follows the JAX XLA route, which ignores
    # lighting_insensitive (disparity.py:144 and :168); the fused TPU
    # kernel's one_d mode would honour it
    li = cfg.lighting_insensitive and not one_d
    nf = x1.shape[0]

    def flat(t):
        return t.reshape(nf, -1)

    def sums(*terms):
        return sum_fn(torch.stack(terms))

    # K8's frame-1 windows sit on integer coordinates; the blend is kept
    # (weights 1, 0, 0, 0 give p00 exactly), as in its kernel
    frame1 = (img1, gx1) if one_d else (img1, gx1, gy1)
    w1, g1x, *g1y = (flat(t) for t in gather_windows(frame1, x1, y1, hw, hh))
    if li:
        s11, sw1 = sums(w1 * w1, w1)
        m1 = sw1 / n_px

    def diff_and_gain(w2):
        if not li:
            return w1 - w2, None
        s22, sw2 = sums(w2 * w2, w2)
        alpha = torch.sqrt((s11 / n_px) / (s22 / n_px))
        beta = m1 - alpha * (sw2 / n_px)
        return w1 - w2 * alpha[:, None] - beta[:, None], alpha[:, None]

    ok1 = _bounds_ok(x1, y1, hw, hh, ncols, nrows)
    x, y = x2, y2
    status = torch.full_like(x2, KLT_TRACKED, dtype=torch.int32)
    iteration = torch.zeros_like(x2, dtype=torch.int32)
    act = active
    for _ in range(cfg.max_iterations):
        ok = ok1 & _bounds_ok(x, y, hw, hh, ncols, nrows)
        status = torch.where(act & ~ok, KLT_OOB, status)
        live = act & ok
        if one_d:
            w2, g2x = (flat(t) for t in
                       gather_windows((img2, gx2), x, y, hw, hh))
            gx = g1x + g2x
            gxx, ex = sums(gx * gx, (w1 - w2) * gx)
            ex = step * ex
            # SMALL_DET is the 1-D analogue gxx < min_determinant
            small = gxx < min_det
            status = torch.where(live & small, KLT_SMALL_DET, status)
            live = live & ~small
            dx = ex / torch.where(small, 1.0, gxx)
            moving = dx.abs() >= th
        else:
            w2, g2x, g2y = (flat(t) for t in
                            gather_windows((img2, gx2, gy2), x, y, hw, hh))
            dif, alpha = diff_and_gain(w2)
            if alpha is None:
                gx, gy = g1x + g2x, g1y[0] + g2y
            else:
                gx, gy = g1x + alpha * g2x, g1y[0] + alpha * g2y
            gxx, gxy, gyy, ex, ey = sums(gx * gx, gx * gy, gy * gy, dif * gx,
                                         dif * gy)
            ex = step * ex
            ey = step * ey
            det = gxx * gyy - gxy * gxy
            small = det < min_det
            status = torch.where(live & small, KLT_SMALL_DET, status)
            live = live & ~small
            safe_det = torch.where(small, 1.0, det)
            dx = (gyy * ex - gxy * ey) / safe_det
            dy = (gxx * ey - gxy * ex) / safe_det
            y = torch.where(live, y + dy, y)
            moving = (dx.abs() >= th) | (dy.abs() >= th)
        x = torch.where(live, x + dx, x)
        iteration = torch.where(live, iteration + 1, iteration)
        act = live & moving & (iteration < cfg.max_iterations)

    # post-loop: OOB overrides any status, then residue, then max-iterations
    final_ok = _bounds_ok(x, y, hw, hh, ncols, nrows)
    status = torch.where(active & ~final_ok, KLT_OOB, status)
    (w2,) = (flat(t) for t in gather_windows((img2,), x, y, hw, hh))
    dif, _ = diff_and_gain(w2)
    residue = sum_fn(dif.abs()) / n_px
    tracked = active & (status == KLT_TRACKED)
    status = torch.where(tracked & (residue > _f32(cfg.max_residue)),
                         KLT_LARGE_RESIDUE, status)
    tracked = active & (status == KLT_TRACKED)
    status = torch.where(tracked & (iteration >= cfg.max_iterations),
                         KLT_MAX_ITERATIONS, status)
    return x, y, status, iteration


def _launch(x1, y1, x2, y2, active, img1, gx1, gy1, img2, gx2, gy2, cfg,
            xo, yo, st, it):
    global launches
    fn = cuda.function("pft_lk_level",
                       [cuda.c_ptr] * 11 + [cuda.c_int] * 7
                       + [cuda.c_float] * 4 + [cuda.c_int]
                       + [cuda.c_ptr] * 5)
    nrows, ncols = img1.shape
    rc = fn(*(t.data_ptr() for t in (x1, y1, x2, y2, active, img1, gx1, gy1,
                                     img2, gx2, gy2)),
            int(img1.dtype == torch.bfloat16), nrows, ncols, x1.shape[0],
            cfg.window_width, cfg.window_height, cfg.max_iterations,
            _f32(cfg.min_displacement), _f32(cfg.min_determinant),
            _f32(cfg.max_residue),
            _f32(cfg.step_factor), int(bool(cfg.lighting_insensitive)),
            xo.data_ptr(), yo.data_ptr(), st.data_ptr(), it.data_ptr(),
            cuda.stream_ptr(img1.device))
    cuda.check(rc, "pft_lk_level")
    launches += 1


def lk_level(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2, gy2, cfg, active):
    """One LK pyramid level for a feature batch: (x2, y2, status, iteration).

    ``x1``/``y1``: frame-1 positions, ``x2``/``y2``: frame-2 starting
    guesses (float32 [N]); six [H, W] level images of one dtype (float32
    or bfloat16, upcast at the tap); ``active``: bool [N]. Same contract
    as ``track_feature_level``."""
    feats = (x1, y1, x2, y2, active)
    imgs = (img1, gx1, gy1, img2, gx2, gy2)
    if not cuda.use_kernel(*feats, *imgs):
        return lk_level_reference(x1, y1, x2, y2, img1, gx1, gy1, img2, gx2,
                                  gy2, cfg, active)
    ww, wh = cfg.window_width, cfg.window_height
    cuda.require(ww % 2 == 1 and wh % 2 == 1,
                 f"lk_level kernel takes odd windows, got {ww}x{wh}")
    n = x1.shape[0]
    cuda.require(all(t.dtype == torch.float32 and t.shape == (n,)
                     and t.is_contiguous() for t in feats[:4])
                 and active.dtype == torch.bool and active.shape == (n,)
                 and active.is_contiguous(),
                 "lk_level takes contiguous float32 [N] positions and a bool "
                 "[N] mask")
    shape = img1.shape
    _is_bf16(imgs, "lk_level")
    cuda.require(len(shape) == 2 and all(
        t.shape == shape and t.is_contiguous() for t in imgs),
        "lk_level takes six contiguous [H, W] images of one shape")
    xo = torch.empty_like(x2)
    yo = torch.empty_like(y2)
    st = torch.empty((n,), dtype=torch.int32, device=x2.device)
    it = torch.empty((n,), dtype=torch.int32, device=x2.device)
    if n:
        _launch(x1, y1, x2, y2, active, img1, gx1, gy1, img2, gx2, gy2, cfg,
                xo, yo, st, it)
    return xo, yo, st, it


def track_pyramid_reference(pyr1, pyr2, x, y, val, cfg, x_init=None,
                            y_init=None):
    """Plain version of ``track_pyramid``: the coarse-to-fine level loop of
    ``ops/track.py`` around ``lk_level_reference``, with its coarse-level
    "broken" rule and the final classification. ``x_init``/``y_init``: the
    guided frame-2 starts (ops/track.py:305-309), divided by s^L as ``x``
    is; the frame-1 anchor stays ``x / s^L``."""
    nrows, ncols = pyr1.img[0].shape
    s = float(cfg.subsampling)
    n_levels = cfg.nPyramidLevels

    live = val >= 0
    # a tensor divisor keeps CUDA from dividing by a reciprocal product
    scale = torch.full((), s ** n_levels, dtype=torch.float32,
                       device=x.device)
    xloc = x / scale
    yloc = y / scale
    xout, yout = xloc, yloc
    if x_init is not None:
        xout, yout = x_init / scale, y_init / scale

    status = torch.full_like(val, KLT_TRACKED)
    # 'broken' freezes lanes that hit SMALL_DET / OOB at a coarser level
    # (the reference breaks out of the level loop for those two codes only).
    broken = torch.zeros_like(live)
    for r in range(n_levels - 1, -1, -1):
        xloc, yloc = xloc * s, yloc * s
        # lanes broken at a coarser level keep their break-level coords
        xout = torch.where(broken, xout, xout * s)
        yout = torch.where(broken, yout, yout * s)
        active = live & ~broken
        nx, ny, lvl_status, _ = lk_level_reference(
            xloc, yloc, xout, yout,
            pyr1.img[r], pyr1.gradx[r], pyr1.grady[r],
            pyr2.img[r], pyr2.gradx[r], pyr2.grady[r], cfg, active)
        xout = torch.where(active, nx, xout)
        yout = torch.where(active, ny, yout)
        status = torch.where(active, lvl_status, status)
        broken = broken | (active & ((lvl_status == KLT_SMALL_DET) |
                                     (lvl_status == KLT_OOB)))

    # Final classification (reference: KLTTrackFeatures post-loop).
    out_of_view = ((xout < cfg.borderx) | (xout > ncols - 1 - cfg.borderx) |
                   (yout < cfg.bordery) | (yout > nrows - 1 - cfg.bordery))
    lost = (status != KLT_TRACKED) | out_of_view
    final_status = torch.where(
        status == KLT_OOB, KLT_OOB,
        torch.where(out_of_view, KLT_OOB, status))

    new_x = torch.where(live, torch.where(lost, -1.0, xout), x)
    new_y = torch.where(live, torch.where(lost, -1.0, yout), y)
    new_val = torch.where(live, final_status, val)
    return new_x, new_y, new_val


def _device_table(values, dtype, dev):
    """A small host table in device memory without a host sync: a pinned
    copy, sent on the current stream."""
    return torch.tensor(values, dtype=dtype).pin_memory().to(
        dev, non_blocking=True)


def _launch_pyramid(pyr1, pyr2, x, y, val, cfg, x_init, y_init, xo, yo, vo):
    global launches, guided_launches
    fn = cuda.function("pft_lk_pyramid",
                       [cuda.c_ptr] * 3 + [cuda.c_int] + [cuda.c_ptr] * 2
                       + [cuda.c_int] * 5 + [cuda.c_float] * 4 + [cuda.c_int]
                       + [cuda.c_float] * 2 + [cuda.c_int] * 2
                       + [cuda.c_ptr] * 9)
    n_levels = cfg.nPyramidLevels
    ptr_list = [p[r].data_ptr() for r in range(n_levels)
                for p in (pyr1.img, pyr1.gradx, pyr1.grady, pyr2.img,
                          pyr2.gradx, pyr2.grady)]
    shape_list = [d for r in range(n_levels) for d in pyr1.img[r].shape]
    ptrs = (ctypes.c_void_p * (6 * n_levels))(*ptr_list)
    shapes = (ctypes.c_int * (2 * n_levels))(*shape_list)
    dev_ptrs = dev_shapes = None
    if n_levels > LEVELS_BY_VALUE:
        dev_ptrs = _device_table(ptr_list, torch.int64, x.device)
        dev_shapes = _device_table(shape_list, torch.int32, x.device)
    s = float(cfg.subsampling)
    counts = profiling.device_counters(x.device)
    rc = fn(x.data_ptr(), y.data_ptr(), val.data_ptr(), x.shape[0],
            ctypes.addressof(ptrs), ctypes.addressof(shapes), n_levels,
            int(pyr1.img[0].dtype == torch.bfloat16), cfg.window_width,
            cfg.window_height, cfg.max_iterations,
            _f32(cfg.min_displacement), _f32(cfg.min_determinant),
            _f32(cfg.max_residue), _f32(cfg.step_factor),
            int(bool(cfg.lighting_insensitive)), _f32(s ** n_levels), _f32(s),
            int(cfg.borderx), int(cfg.bordery),
            *(None if t is None else t.data_ptr()
              for t in (dev_ptrs, dev_shapes, x_init, y_init)),
            xo.data_ptr(), yo.data_ptr(), vo.data_ptr(),
            None if counts is None else counts.data_ptr(),
            cuda.stream_ptr(x.device))
    cuda.check(rc, "pft_lk_pyramid")
    launches += 1
    guided_launches += x_init is not None


def track_pyramid(pyr1, pyr2, x: torch.Tensor, y: torch.Tensor,
                  val: torch.Tensor, cfg, x_init: torch.Tensor | None = None,
                  y_init: torch.Tensor | None = None):
    """Pyramidal LK for a feature batch from prebuilt pyramids (objects
    with ``img``/``gradx``/``grady`` level tuples, finest first): every
    level coarse to fine, then the final classification. Returns (x, y,
    val); lost features get (-1, -1, status), lanes with ``val < 0`` pass
    through. ``x_init``/``y_init`` (both or neither): guided frame-2 starts
    in level-0 pixels. The level images share one dtype, float32 or
    bfloat16 (upcast at the tap). One launch on CUDA, differentiable in
    the positions and the level images through the plain version's VJP."""
    if (x_init is None) != (y_init is None):
        raise ValueError("track_pyramid: give both x_init and y_init, or "
                         "neither")
    n_levels = cfg.nPyramidLevels
    imgs = [p[r] for r in range(n_levels)
            for p in (pyr1.img, pyr1.gradx, pyr1.grady, pyr2.img, pyr2.gradx,
                      pyr2.grady)]
    starts = () if x_init is None else (x_init, y_init)
    if not cuda.use_kernel(x, y, val, *starts, *imgs):
        return track_pyramid_reference(pyr1, pyr2, x, y, val, cfg, x_init,
                                       y_init)
    ww, wh = cfg.window_width, cfg.window_height
    cuda.require(ww % 2 == 1 and wh % 2 == 1,
                 f"track_pyramid kernel takes odd windows, got {ww}x{wh}")
    cuda.require(n_levels >= 1, f"track_pyramid: {n_levels} levels")
    n = x.shape[0]
    cuda.require(x.dtype == y.dtype == torch.float32 and val.dtype == torch.int32
                 and x.shape == y.shape == val.shape == (n,)
                 and all(t.is_contiguous() for t in (x, y, val)),
                 "track_pyramid takes contiguous float32 x, y and int32 val "
                 "[N]")
    cuda.require(all(t.dtype == torch.float32 and t.shape == (n,)
                     and t.is_contiguous() for t in starts),
                 "track_pyramid takes contiguous float32 [N] starts")
    _is_bf16(imgs, "track_pyramid")
    for r in range(n_levels):
        level = imgs[6 * r:6 * r + 6]
        cuda.require(all(t.dim() == 2 and t.shape == level[0].shape
                         and t.is_contiguous() for t in level),
                     f"track_pyramid: level {r} needs six contiguous [H, W] "
                     "images of one shape")
    n_starts = len(starts)

    def split(feats):
        # (x, y, val, x_init-or-None, y_init-or-None, pyr1, pyr2)
        x, y, val = feats[:3]
        xi, yi = feats[3:3 + n_starts] or (None, None)
        lv = feats[3 + n_starts:]
        pyr = tuple(_Levels(*(tuple(lv[6 * r + k + 3 * j]
                                    for r in range(n_levels))
                              for k in range(3))) for j in range(2))
        return x, y, val, xi, yi, pyr

    def launch(*feats):
        x, y, val, xi, yi, (p1, p2) = split(feats)
        xo, yo = torch.empty_like(x), torch.empty_like(y)
        vo = torch.empty_like(val)
        if n:
            _launch_pyramid(p1, p2, x, y, val, cfg, xi, yi, xo, yo, vo)
        return xo, yo, vo

    def plain(*feats):
        x, y, val, xi, yi, (p1, p2) = split(feats)
        return track_pyramid_reference(p1, p2, x, y, val, cfg, xi, yi)

    return cuda.with_plain_vjp(launch, plain, x, y, val, *starts, *imgs)
