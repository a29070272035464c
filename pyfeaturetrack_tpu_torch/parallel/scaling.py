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

Not ported: ``predict_scaling_efficiency``, the HLO cost-analysis
prediction against TPU v5e roofline constants (ROADMAP Queue 1 item 9:
TPU-only).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import create_config
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
