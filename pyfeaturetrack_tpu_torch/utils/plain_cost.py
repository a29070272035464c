"""What the calling-thread rule costs on the CPU.

Times the port's CPU route at the VO's frame size (240x320), once as the
package runs it (K3's plain map inside ``cuda.calling_thread_only``: one
intra-op thread; ``utils/cuda.plain_version``) and once with that block
replaced by a no-op (the process's intra-op threads), and prints one JSON
line of medians in ms:

    python -m pyfeaturetrack_tpu_torch.utils.plain_cost [--threads N]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from . import cuda


def _frames(h: int, w: int, seed: int = 0):
    """Two float32 frames of a seeded smooth texture, the second shifted
    by (+2, +1) px."""
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0.0, 255.0, (h + 8, w + 8))
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for axis in (0, 1):
        for _ in range(2):
            tex = sum(c * np.roll(tex, s - 2, axis=axis)
                      for s, c in enumerate(k))
    a = tex[4:4 + h, 4:4 + w]
    b = tex[3:3 + h, 2:2 + w]
    return [torch.as_tensor(np.floor(f), dtype=torch.float32) for f in (a, b)]


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> int:
    from ..config import create_config
    from ..models.device_sequence import select_step_device
    from ..ops.flow import compute_dense_flow
    from ..ops.track import build_track_pyramids, track_features_pyramids
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=torch.get_num_threads())
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = create_config()
    a, b = _frames(240, 320)
    pa, pb = build_track_pyramids(a, cfg), build_track_pyramids(b, cfg)
    _, x, y, val, _, _ = select_step_device(a, cfg, 1000)
    calls = {
        "K1 build_track_pyramids": lambda: build_track_pyramids(a, cfg),
        "K1+K3+K4 select_step_device, 1000 features":
            lambda: select_step_device(a, cfg, 1000),
        "K2 track_features_pyramids, 1000 features":
            lambda: track_features_pyramids(pa, pb, x, y, val, cfg),
        "K1+K8 compute_dense_flow": lambda: compute_dense_flow(a, b, cfg),
    }
    out = {"threads": args.threads, "shape": [240, 320], "ms": {}}
    serial = cuda.calling_thread_only
    for name, fn in calls.items():
        one = _median_ms(fn, args.reps)
        cuda.calling_thread_only = contextlib.nullcontext
        try:
            many = _median_ms(fn, args.reps)
        finally:
            cuda.calling_thread_only = serial
        out["ms"][name] = {"calling_thread": one, "intra_op_threads": many}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
