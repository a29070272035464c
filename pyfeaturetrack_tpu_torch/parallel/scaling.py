"""Weak-scaling harness and the collective census.

Port of ``pyfeaturetrack_tpu/parallel/scaling.py``:

* ``measure_scaling``: the weak-scaling sweep of the batched two-frame
  tracking step over the ``frame`` axis, each rank tracking its own frame
  pair (B = ranks), so perfect scaling keeps the step time flat. On one
  card the sweep is d = 1; under a split mesh it times the ranks' bodies
  run one after another, which is no scaling number.
* ``collective_census(fn, ...)``: the collectives a sharded call runs,
  read from the combine layer's record (``parallel/sharding.census``),
  where the JAX package parses the partitioned HLO (``_collective_bytes``).
* ``predict_scaling_efficiency``: a roofline model of the weak-scaling
  step time against the H100's peaks. Where the JAX package reads XLA's
  cost analysis of the partitioned HLO, the per-device flops and bytes
  here come from the port's counting model (``utils/roofline``), and the
  collectives from ``collective_census`` of the same sharded call on an
  in-process split of d ranks (one process, on the CPU or one card).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import create_config
from ..utils.roofline import H100, NVLINK_BYTES_PER_S
from . import sharding
from .sharding import make_mesh, track_batch_sharded


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_scaling(device_counts=None, image_shape=(240, 320),
                    n_features: int = 256, iters: int = 10, cfg=None, *,
                    device="cuda") -> dict:
    """Weak-scaling sweep over the world's rank counts (``make_mesh(d, 1)``
    over the first d ranks; ranks outside a mesh skip its count). Returns
    {"seconds_per_step": {d: s}, "efficiency_vs_smallest": {d: ratio},
    "device_counts": [...]} as measured on this rank. With no process
    group the counts run as splits on ``device`` (d = 1 by default)."""
    cfg = cfg if cfg is not None else create_config()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    h, w = image_shape
    rng = np.random.default_rng(0)
    results = {}
    for d in device_counts:
        if dist.is_initialized():
            mesh = make_mesh(n_frame=d, n_feature=1,
                             devices=list(range(d)))
        else:
            mesh = sharding.split_mesh((d, 1), (sharding.FRAME_AXIS,
                                                sharding.FEATURE_AXIS),
                                       device)
        imgs1 = rng.uniform(0, 255, (d, h, w)).astype(np.float32)
        imgs2 = np.roll(imgs1, 1, axis=-1)
        xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2,
                         (d, n_features)).astype(np.float32)
        ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2,
                         (d, n_features)).astype(np.float32)
        vals = np.ones((d, n_features), np.int32)
        if not isinstance(mesh, sharding.SplitMesh) \
                and mesh.get_coordinate() is None:
            continue
        dev = sharding.mesh_device(mesh)

        def step():
            return track_batch_sharded(imgs1, imgs2, xs, ys, vals, cfg,
                                       mesh)
        step()                                  # build the kernels, warm up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        _sync(dev)
        results[d] = (time.perf_counter() - t0) / iters
    base = device_counts[0]
    efficiency = {d: results[base] / results[d] for d in results
                  if base in results}
    return {"seconds_per_step": results,
            "efficiency_vs_smallest": efficiency,
            "device_counts": list(device_counts)}


def _summarize(records) -> dict:
    """Census records -> {kind: {"count", "bytes"}, "by_label": {label:
    {"count", "bytes"}}, "total_bytes"}."""
    out: dict = {"by_label": {}, "total_bytes": 0}
    for r in records:
        for key, table in ((r["kind"], out), (r["label"], out["by_label"])):
            row = table.setdefault(key, {"count": 0, "bytes": 0})
            row["count"] += 1
            row["bytes"] += r["bytes"]
        out["total_bytes"] += r["bytes"]
    return out


def collective_census(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return (its result, the census of
    the collectives it ran through the combine layer: ``_summarize`` of
    their records plus the records themselves under "records")."""
    sharding.reset_census()
    result = fn(*args, **kwargs)
    records = list(sharding.census)
    return result, dict(_summarize(records), records=records)


def _workload_counts(workload: str, h: int, w: int, n_features: int, cfg):
    """Per-device (flops, bytes) of one weak-scaling step: a frame pair
    (both pyramids, then LK) for ``track`` and ``config4``; one serving
    step (the new frame's pyramid, then LK) for ``serving_tick``. The
    selection's refill is not in the counting model."""
    from ..utils.roofline import lk_counts, pyramid_counts
    pyr = pyramid_counts(h, w, cfg)
    lk = lk_counts(h, w, n_features, cfg)
    n_pyr = 1 if workload == "serving_tick" else 2
    return (n_pyr * pyr["flops"] + lk["flops"],
            n_pyr * pyr["bytes"] + lk["bytes"])


def _sharded_call(workload: str, d: int, h: int, w: int, n_features: int,
                  cfg, mesh):
    """The workload's sharded call on ``mesh`` (d frame ranks), seeded
    random inputs: one frame pair per rank, or one stream per rank that
    selects on its first frame and tracks one step with replace-lost on."""
    rng = np.random.default_rng(0)
    imgs1 = rng.uniform(0, 255, (d, h, w)).astype(np.float32)
    imgs2 = np.roll(imgs1, 1, axis=-1)
    if workload == "serving_tick":
        return lambda: sharding.batched_serving_sharded(
            [imgs1, imgs2], cfg, n_features, mesh, chain=1,
            replace_lost=True, top_k=64)
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2,
                     (d, n_features)).astype(np.float32)
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2,
                     (d, n_features)).astype(np.float32)
    vals = np.ones((d, n_features), np.int32)
    return lambda: track_batch_sharded(imgs1, imgs2, xs, ys, vals, cfg, mesh)


def predict_scaling_efficiency(device_counts=None, image_shape=(240, 320),
                               n_features: int = 256, cfg=None,
                               ici_bytes_per_s: float = NVLINK_BYTES_PER_S,
                               hbm_bytes_per_s: float = H100[
                                   "hbm_bytes_per_s"],
                               peak_flops: float = H100["f32_flops"],
                               workload: str = "track", *,
                               device="cuda") -> dict:
    """Weak-scaling prediction over the ``frame`` axis for one of three
    workloads, with the JAX package's keys:

    * ``track``: the batched two-frame tracking step, one pair per rank;
    * ``config4``: the same step at config 4 (1088x1920, 4096 features,
      4 levels, subsampling 2);
    * ``serving_tick``: the stream-sharded serving tick, one camera stream
      per rank, replace-lost on.

    For each d in ``device_counts`` (default 1, 2, 4, 8): per-device flops
    and bytes from ``utils/roofline``'s counting model, the collective
    census of the sharded call on ``split_mesh((d, 1))`` on ``device``, the
    step time t(d) = max(flops / ``peak_flops``, bytes / ``hbm_bytes_per_s``)
    + step collective bytes / ``ici_bytes_per_s``, and the weak efficiency
    t(min d) / t(d). ``ici_bytes_per_s`` keeps the JAX name: here it is
    the NVLink rate of one direction (450 GB/s on the H100 SXM).

    The port's sharded entries end in an ``output`` gather that hands the
    global result to every rank, where JAX leaves its result sharded: the
    census reports it (``census``) and the step's collectives
    (``collectives``) leave it out."""
    from ..config import create_config as _create
    if workload == "config4":
        image_shape, n_features = (1088, 1920), 4096
        if cfg is None:
            cfg = _create().replace(nPyramidLevels=4, subsampling=2)
    elif workload not in ("track", "serving_tick"):
        raise ValueError(f"unknown workload {workload!r}")
    cfg = cfg if cfg is not None else _create()
    if workload == "serving_tick":
        cfg = cfg.replace(sequentialMode=True)
    cfg = cfg.validated_window()
    device_counts = list(device_counts or (1, 2, 4, 8))
    h, w = image_shape
    flops, nbytes = _workload_counts(workload, h, w, n_features, cfg)
    t_comp = max(flops / peak_flops, nbytes / hbm_bytes_per_s)
    rows = {}
    for d in device_counts:
        mesh = sharding.split_mesh((d, 1), (sharding.FRAME_AXIS,
                                            sharding.FEATURE_AXIS), device)
        _, census = collective_census(_sharded_call(workload, d, h, w,
                                                    n_features, cfg, mesh))
        step = _summarize([r for r in census["records"]
                           if r["label"] != "output"])
        step["total_approx_bytes"] = float(step["total_bytes"])
        rows[d] = {"per_device_flops": flops, "per_device_bytes": nbytes,
                   "collectives": step, "census": census,
                   "model_step_s": t_comp + step["total_approx_bytes"]
                   / ici_bytes_per_s}
    base = rows[device_counts[0]]["model_step_s"]
    for d in device_counts:
        t = rows[d]["model_step_s"]
        rows[d]["predicted_weak_efficiency"] = round(base / t, 4) if t \
            else 1.0
    return {"workload": workload, "device_counts": device_counts,
            "per_device": rows,
            "note": "per-device flops and bytes from the port's counting "
                    "model (utils/roofline), collectives from the census "
                    "of the sharded call on an in-process split; the "
                    "HBM, float32 and NVLink peaks are the H100 SXM's "
                    "published ones"}
