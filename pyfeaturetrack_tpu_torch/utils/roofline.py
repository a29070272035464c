"""Roofline accounting for the hot stages, against one NVIDIA H100.

Port of ``pyfeaturetrack_tpu/utils/roofline.py``: the same counting model
under the same names, with this card's peaks in place of the TPU's.

Counting model: per stage the ALGORITHMIC lower bound on device-memory
traffic (each logical array read once and each output written once) and
the arithmetic of the math as written. Speed-of-light time = max(bytes /
HBM bandwidth, flops / peak flops); achieved fraction = that time over the
measured one. The traffic is a lower bound, so the fraction is
conservative.

Storage: a stored pyramid level or gradient takes the bytes of
``cfg.image_dtype`` (4 for float32, 2 for bfloat16). Construction reads
float32 (the frame, and the float32 image each coarser level is built
from), so a bfloat16 pyramid also writes a float32 copy of every level
past the first: the source the next stages build from
(``ops/cuda_pyramid.pyramid_build``). With float32 storage every count
equals the JAX module's.

``measure_stage_times`` (CUDA events) and ``measure_stage_device_times``
(kernel time from a torch.profiler trace) time the port's stages on the
card through ``utils/profiling``; without a card they raise:

    python -m pyfeaturetrack_tpu_torch.utils.roofline     # prints JSON
"""

from __future__ import annotations

import json

import numpy as np

# NVIDIA H100 SXM (80 GB HBM3) public peaks (NVIDIA's data sheet, dense, at
# the 700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the
# tensor cores, 989 TFLOP/s bf16 in them.
CARD = "NVIDIA H100 SXM 80GB"
H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops": 67e12,
    "bf16_flops": 989e12,
}
# NVLink 4 between two H100 SXM cards: 900 GB/s both ways, 450 GB/s in one
# direction (the same data sheet); parallel/scaling's link rate.
NVLINK_BYTES_PER_S = 450e9

_F32 = 4  # bytes


def _image_bytes(cfg) -> int:
    """Bytes of one stored level element under ``cfg.image_dtype``."""
    name = getattr(cfg, "image_dtype", "float32")
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"image_dtype={name!r}: float32 or bfloat16")
    return 2 if name == "bfloat16" else _F32


def _kernel_width(sigma: float) -> int:
    """Trimmed Gaussian width (ops/kernels.py semantics: symmetric trim of
    taps below 1% of the max)."""
    hw = 71 // 2
    xs = np.arange(-hw, hw + 1, dtype=np.float64)
    g = np.exp(-xs * xs / (2.0 * sigma * sigma))
    keep = g >= 0.01 * g.max()
    return int(keep.sum())


def pyramid_counts(h: int, w: int, cfg) -> dict:
    """Per-frame pyramid build: smooth + per-level images + gradients."""
    ks = _kernel_width(cfg.smooth_sigma)
    kg = _kernel_width(cfg.grad_sigma)
    kp = _kernel_width(cfg.pyramid_sigma_fact * cfg.subsampling)
    b = _image_bytes(cfg)

    bytes_total = 0.0
    flops = 0.0
    lh, lw = h, w
    for level in range(cfg.nPyramidLevels):
        px = lh * lw
        if level == 0:
            # read the float32 frame; store the smoothed level-0 image
            bytes_total += px * _F32 + px * b
            flops += 2 * 2 * ks * px          # separable smooth (2 passes)
        else:
            # read the level above (float32), smooth + decimate, store the
            # level image (and, stored in bfloat16, its float32 source)
            prev = (lh * cfg.subsampling) * (lw * cfg.subsampling)
            bytes_total += prev * _F32 + px * b
            if b != _F32:
                bytes_total += px * _F32
            flops += 2 * 2 * kp * prev
        # gradients: read the float32 level once, store gx + gy
        bytes_total += px * _F32 + 2 * px * b
        flops += 2 * (2 * 2 * kg) * px        # two separable conv pairs
        lh //= cfg.subsampling
        lw //= cfg.subsampling
    return {"bytes": bytes_total, "flops": flops}


def lk_counts(h: int, w: int, n_features: int, cfg) -> dict:
    """Batched pyramidal LK for one frame step (all levels, worst-case
    fixed-trip iterations)."""
    ph = cfg.window_height // 2 * 2 + 2      # gathered patch edge (h+1)
    pw = cfg.window_width // 2 * 2 + 2
    patch = ph * pw
    win = cfg.window_height * cfg.window_width
    it = cfg.max_iterations
    levels = cfg.nPyramidLevels

    # per level: 1 hoisted 3-patch gather (frame 1) + per iteration a
    # 3-patch gather (frame 2) + final residue 1-patch gather
    gathers_per_level = 3 + 3 * it + 1
    bytes_total = (levels * n_features * gathers_per_level * patch
                   * _image_bytes(cfg))
    # blend (~8 flops/px/patch) + window reductions (5 sums x ~2 flops)
    flops = levels * n_features * (
        (3 + 3 * it + 1) * patch * 8 + it * win * 10)
    return {"bytes": float(bytes_total), "flops": float(flops)}


def flow_counts(h: int, w: int, cfg) -> dict:
    """Dense per-pixel LK flow for one frame pair (ops/flow.py): the
    lk_counts model with the feature set = each level's own pixel grid."""
    ph = cfg.window_height // 2 * 2 + 2
    pw = cfg.window_width // 2 * 2 + 2
    patch = ph * pw
    win = cfg.window_height * cfg.window_width
    it = cfg.max_iterations
    s = cfg.subsampling
    b = _image_bytes(cfg)
    bytes_total = 0.0
    flops = 0.0
    for lvl in range(cfg.nPyramidLevels):
        n_px = (h // s**lvl) * (w // s**lvl)
        gathers = 3 + 3 * it + 1
        bytes_total += n_px * gathers * patch * b
        flops += n_px * (gathers * patch * 8 + it * win * 10)
    return {"bytes": float(bytes_total), "flops": float(flops)}


def affine_counts(n_features: int, cfg, h: int = 480, w: int = 640
                  ) -> dict:
    """Affine-consistency GN for one frame step (mode 2: 6-param).

    Bytes = compulsory traffic: the three level-0 channels (img, gx, gy,
    in the storage dtype) and the per-feature float32 templates read once.
    FLOPs count every fixed-trip iteration."""
    t = cfg.affine_window_width * cfg.affine_window_height
    patch = (cfg.affine_window_width + 1) ** 2
    it = cfg.affine_max_iterations
    params = 6
    bytes_total = (3 * h * w * _image_bytes(cfg)
                   + (n_features * 3 * patch + 4 * n_features) * _F32)
    flops = n_features * it * (
        3 * patch * 8 + t * (params * 4 + params * params * 2)
        + params ** 3)
    return {"bytes": float(bytes_total), "flops": float(flops)}


def config4_counts(cfg=None, h: int = 1088, w: int = 1920,
                   n_features: int = 4096) -> dict:
    """Config-4 (1080p, 4096 features, 4 levels, subsampling 2) frame
    step: pyramid build + pyramidal LK, the algorithmic once-through bound.

    The JAX module also returns ``fetch_bytes``, the per-feature DMA blocks
    of its Pallas LK kernel: that is the traffic of one TPU kernel's design,
    not work the step must do, and K2 on this card reads no such blocks, so
    it is left out here."""
    from ..config import create_config
    if cfg is None:
        cfg = create_config().replace(nPyramidLevels=4, subsampling=2)
    p = pyramid_counts(h, w, cfg)
    lk = lk_counts(h, w, n_features, cfg)
    return {"bytes": p["bytes"] + lk["bytes"],
            "flops": p["flops"] + lk["flops"]}


def ba_iter_counts(C: int, L: int, kw: int) -> dict:
    """One windowed GN iteration (sfm/ba_windowed._gn_step_windowed)."""
    obs = L * kw
    # residuals/Jacobians ~300 flops/obs; U/V/W outer products
    # (72+18+36 MACs x2); S_blocks einsum L*kw^2*6*6*3*2
    flops = obs * (300 + 2 * (72 + 18 + 36) * 2) + L * kw * kw * 6 * 6 * 6
    # dominant traffic: per-obs Jacobian blocks written+read once
    bytes_total = obs * (2 * 6 + 2 * 3 + 6 * 3 + 6 * 6) * _F32 * 2
    return {"bytes": float(bytes_total), "flops": float(flops)}


def bound_s(counts: dict, peak_flops_key: str = "f32_flops"):
    """(speed-of-light seconds, "memory" or "compute") of a stage's
    counts on the card."""
    t_mem = counts["bytes"] / H100["hbm_bytes_per_s"]
    t_cmp = counts["flops"] / H100[peak_flops_key]
    return max(t_mem, t_cmp), "memory" if t_mem >= t_cmp else "compute"


def summarize(counts: dict, measured_s: float, peak_flops_key: str =
              "f32_flops") -> dict:
    """Achieved fractions of the H100 rooflines for one stage."""
    sol, bound = bound_s(counts, peak_flops_key)
    return {
        "measured_us": round(measured_s * 1e6, 2),
        "sol_us": round(sol * 1e6, 2),
        "bound": bound,
        "achieved_fraction": round(sol / measured_s, 4),
        "hbm_gbytes_per_s": round(
            counts["bytes"] / measured_s / 1e9, 2),
        "gflops_per_s": round(counts["flops"] / measured_s / 1e9, 2),
        "bytes": counts["bytes"],
        "flops": counts["flops"],
    }


def _stage_inputs(h, w, n_features, cfg):
    """Two float32 frames and n_features positions on the card (seeded)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("roofline: the stage times are device times and "
                           "need a CUDA device; a CPU time is not one")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    imgs = [torch.as_tensor(rng.uniform(0, 255, (h, w)), dtype=torch.float32,
                            device=dev) for _ in range(2)]
    x = torch.as_tensor(rng.uniform(30, w - 30, n_features),
                        dtype=torch.float32, device=dev)
    y = torch.as_tensor(rng.uniform(30, h - 30, n_features),
                        dtype=torch.float32, device=dev)
    val = torch.ones((n_features,), dtype=torch.int32, device=dev)
    return imgs, x, y, val


def _stage_calls(h, w, n_features, cfg):
    """The stages as argument-free calls on the card: pyramid build, LK,
    the affine batch (mode 2) and dense flow."""
    import torch
    from ..config import create_config
    from ..ops.cuda_affine import affine_track_batch
    from ..ops.flow import dense_flow_pyramids
    from ..ops.interp import gather_window
    from ..ops.track import build_track_pyramids, track_features_pyramids
    (img, img2), x, y, val = _stage_inputs(h, w, n_features, cfg)
    p1 = build_track_pyramids(img, cfg)
    p2 = build_track_pyramids(img2, cfg)
    acfg = create_config(affineConsistencyCheck=2,
                         image_dtype=getattr(cfg, "image_dtype", "float32"))
    hw, hh = acfg.affine_window_width // 2, acfg.affine_window_height // 2
    tmpl = gather_window(p1.img[0], x, y, hw, hh).contiguous()
    A0 = torch.eye(2, device=x.device).expand(n_features, 2, 2).contiguous()
    chk = torch.ones((n_features,), dtype=torch.bool, device=x.device)
    return {
        "pyramid": lambda: build_track_pyramids(img2, cfg),
        "lk": lambda: track_features_pyramids(p1, p2, x, y, val, cfg),
        "affine": lambda: affine_track_batch(tmpl, p2.img[0], p2.gradx[0],
                                             p2.grady[0], x, y, A0, chk,
                                             acfg),
        "flow": lambda: dense_flow_pyramids(p1, p2, cfg),
    }


def measure_stage_times(h=480, w=640, n_features=1000, iters=200,
                        cfg=None) -> dict:
    """Seconds per call of the pyramid build, LK, the affine batch and
    dense flow on the card, by CUDA events (``utils/profiling.
    time_jitted``: back-to-back calls, so the host's launch time counts
    where it exceeds the kernels'). Raises without a card."""
    from ..config import create_config
    from .profiling import time_jitted
    cfg = cfg or create_config()
    calls = _stage_calls(h, w, n_features, cfg)
    few = max(iters // 4, 1)
    return {"pyramid_s": time_jitted(calls["pyramid"], iters=iters),
            "lk_s": time_jitted(calls["lk"], iters=iters),
            "affine_s": time_jitted(calls["affine"], iters=few),
            "flow_s": time_jitted(calls["flow"], iters=few)}


def measure_stage_device_times(h=480, w=640, n_features=1000,
                               n_calls=8, cfg=None) -> dict:
    """Kernel seconds per call of the same stages from torch.profiler
    traces (``utils/profiling.device_time_per_call``). Raises without a
    card."""
    from ..config import create_config
    from .profiling import device_time_per_call
    cfg = cfg or create_config()
    calls = _stage_calls(h, w, n_features, cfg)
    return {f"{k}_device_s": device_time_per_call(
        fn, iters=n_calls if k in ("pyramid", "lk") else max(n_calls // 2, 2))
        for k, fn in calls.items()}


def roofline_report(h=480, w=640, n_features=1000, stage_times=None,
                    ba_iter_s=None, ba_shape=(60, 6000, 12),
                    with_device_trace: bool = True, cfg=None) -> dict:
    """The roofline dict: each stage's counts against its time on the card
    (``stage_times``, else measured with CUDA events), the config-4 bound,
    and (``with_device_trace``) the profiler's kernel times per stage."""
    from ..config import create_config
    cfg = cfg or create_config()
    if stage_times is None:
        stage_times = measure_stage_times(h, w, n_features, cfg=cfg)
    acfg = create_config(affineConsistencyCheck=2,
                         image_dtype=getattr(cfg, "image_dtype", "float32"))
    rep = {
        "card": CARD,
        "image_dtype": getattr(cfg, "image_dtype", "float32"),
        "peaks": {"hbm_gbytes_per_s": H100["hbm_bytes_per_s"] / 1e9,
                  "f32_tflops": H100["f32_flops"] / 1e12,
                  "bf16_tflops": H100["bf16_flops"] / 1e12},
        "pyramid_build": summarize(pyramid_counts(h, w, cfg),
                                   stage_times["pyramid_s"]),
        "lk_track": summarize(lk_counts(h, w, n_features, cfg),
                              stage_times["lk_s"]),
        "affine_check": summarize(affine_counts(n_features, acfg, h=h, w=w),
                                  stage_times["affine_s"]),
    }
    if "flow_s" in stage_times:
        rep["dense_flow"] = summarize(flow_counts(h, w, cfg),
                                      stage_times["flow_s"])
    c4 = config4_counts(create_config(
        nPyramidLevels=4, subsampling=2,
        image_dtype=getattr(cfg, "image_dtype", "float32")))
    rep["config4_1080p_sol_us"] = round(bound_s(c4)[0] * 1e6, 1)
    if ba_iter_s is not None:
        C, L, kw = ba_shape
        rep["ba_iteration"] = summarize(ba_iter_counts(C, L, kw), ba_iter_s)
    if with_device_trace:
        rep["device_stage_times"] = measure_stage_device_times(
            h, w, n_features, cfg=cfg)
    return rep


if __name__ == "__main__":
    print(json.dumps(roofline_report(), indent=2))
