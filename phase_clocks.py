#!/usr/bin/env python3
"""Where the time goes inside K6's affine stage, K1's pyramid build (with
K3's map in its level-0 launch), K5's greedy scan, K8's dense LK level and
K9's window terms, by clock64() counters, on one GPU.

    python3 phase_clocks.py [--reps N]

Builds pyfeaturetrack_tpu_torch/csrc/*.cu a second time with
-DPFT_PHASE_CLOCKS into build/phase_clocks/ (the library the package
loads has the counters compiled out), points the package's wrappers at it,
then:

* K6: the config-3 sequence of chip_smoke.py (480x640, 1000 features,
  similarity motion) is stepped to its middle; that step's affine stage
  runs N times (its device time first, by the profiler, with the
  package's library). Thread 0 of each feature sums the cycles of each
  phase of its feature (csrc/affine.cu: lane state and template capture
  or copy; per Gauss-Newton iteration the samples with the bounds vote
  and the per-lane sums, the butterflies with the wait for the feature's
  warps, the solve and the update; after the loop; the
  outputs), in all and feature by feature: each phase's mean over the
  checked features beside the slowest feature's, and the distribution of
  updates per checked feature. ``--k6-only`` stops there.
* K1: the default build (2 levels, 480x640) and the config-3 build (3
  levels) N times each, as the device route runs them (with K3's map in
  the level-0 launch), and the default build without the map. Thread 0
  of each block sums the cycles of each phase of its tile
  (csrc/pyramid.cu: the frame tile, the horizontal pre-smooth, base, the
  horizontal passes, the vertical passes, the eig stage's vertical window
  sums, its horizontal sums, eigenvalue and store; level 0 and the
  coarser levels apart; the grid barrier).
* K5: the host API's 480x640 initial selection (255,744 sorted candidates,
  budget 1000) and a refill (40 free slots after the pre-mask) of
  chip_smoke.py, N times each through the fused entry (suppress_and_fill)
  and the list entry (greedy_suppress). Thread 0 marks each phase
  (csrc/suppress.cu: zeroing and the budget; per window the test and
  compaction; per walked batch the serial walk and the stamps; the slot
  fill).
* K8: 2-D level 0 of chip_smoke.py's dense case (a) and 1-D level 0 of its
  case (c), started from the coarser level as the paths run them, N times
  each. Every thread sums its own cycles per phase; the sums are over
  threads, divided by 32 (csrc/lk_dense.cu: the start and the staging, the
  frame-1 lighting sums, per iteration the taps and the solve, the final
  residue, the outputs; and a count of the frame-2 patches read from
  device memory). Beside them, from the iteration map: the mean iterations
  per pixel and the mean over warps of each warp's largest count, for
  warps of 1x32, 2x16 and 4x8 pixels. Before the clock build, with the
  package's own library: the same two levels timed by CUDA events at
  several K8 tile shapes (each result held equal to the default tile's).
* K9: the main pair's 1000 features of chip_smoke.py (7x7 window) and
  65,536 features at seeded positions of the same frame, N times each.
  Lane 0 of each feature marks each phase (csrc/window_terms.cu: the
  position and frame-1 loads, the frame-2 patch staged, the blends and
  per-lane sums, the butterflies and the store).

Prints, per phase, cycles per launch summed over features (K6) or blocks
(K1), marks per launch and the share of the kernel's counted cycles, and
the card's name and power limit. The counters add atomics, so the totals
are not the production kernels' times: the shares are what to read.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
UNITS = 4096           # PFT_PHASE_UNITS (csrc/common.cuh)
K6_PHASES = dict(enumerate([
    "lane state, template capture or copy",
    "samples, bounds vote, per-lane sums (per iteration)",
    "butterflies, the feature's wait (per iteration)",
    "solve and update (per iteration)",
    "after the loop: bounds, residue, drift", "outputs"]))
K6_GN_PHASE = 1        # the first phase only a checked feature marks
K6_UPDATE_PHASE = 3    # marked once per Gauss-Newton update
K5_PHASES = {0: "zeroing (grid, outputs) and the budget",
             1: "window: test, compaction (per 512 candidates)",
             2: "serial walk (per batch of 32 survivors)",
             3: "box stamps (per batch)", 4: "slot fill"}
K8_PHASES = {0: "start and staging", 1: "frame-1 lighting sums",
             2: "taps (per iteration)", 3: "solve and update (per iteration)",
             4: "final bounds and residue", 5: "outputs",
             6: "(count) frame-2 patches read from device memory"}
K1_PHASES = {0: "level 0: frame tile + halo loaded", 1: "level 0: pre-smooth, "
             "horizontal", 2: "level 0: base (pre-smooth, vertical)",
             3: "level 0: horizontal passes", 4: "level 0: vertical passes "
             "and stores", 5: "level 0: K3's vertical window sums",
             6: "level 0: K3's horizontal sums, eigenvalue, store",
             10: "coarser: base tile loaded (L2)",
             11: "coarser: horizontal passes", 12: "coarser: vertical passes "
             "and stores", 16: "coarser: grid barrier"}


def build_clock_library() -> Path:
    """csrc/*.cu with -DPFT_PHASE_CLOCKS, one nvcc per source, linked into
    build/phase_clocks/."""
    from pyfeaturetrack_tpu_torch.utils import cuda
    out_dir = ROOT / "build" / "phase_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda._nvcc()
    srcs = sorted((ROOT / "pyfeaturetrack_tpu_torch" / "csrc").glob("*.cu"))
    jobs = [(out_dir / f"{s.stem}.o",
             subprocess.Popen([nvcc, *cuda.NVCC_FLAGS, "-DPFT_PHASE_CLOCKS",
                               "-c", str(s), "-o", str(out_dir / f"{s.stem}.o")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)) for s in srcs]
    for obj, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"phase_clocks: nvcc failed for {obj.stem}.cu:\n{err}")
    lib = out_dir / "libpft_phase_clocks.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), *(str(o) for o, _ in jobs)],
                   check=True)
    return lib


def use_library(path: Path):
    """Point the package's wrappers at the library at ``path``."""
    from pyfeaturetrack_tpu_torch.utils import cuda
    lib = ctypes.CDLL(str(path))
    lib.pft_error_string.argtypes = [ctypes.c_int]
    lib.pft_error_string.restype = ctypes.c_char_p
    cuda._lib = lib
    cuda._functions.clear()
    return lib


def read_clocks(lib, entry: str):
    cycles = (ctypes.c_ulonglong * 32)()
    counts = (ctypes.c_ulonglong * 32)()
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(ctypes.addressof(cycles), ctypes.addressof(counts)) != 0:
        sys.exit(f"phase_clocks: {entry} failed")
    return list(cycles), list(counts)


def read_units(lib, entry: str, n: int):
    """The unit records of PFT_PHASE_UNIT and PFT_PHASE_STAMP: uint32
    [n, 2, 16]."""
    import numpy as np
    units = (ctypes.c_uint * (UNITS * 2 * 16))()
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(ctypes.addressof(units)) != 0:
        sys.exit(f"phase_clocks: {entry} failed")
    got = np.frombuffer(units, dtype=np.uint32).reshape(UNITS, 2, 16)
    return got[:n].copy()


def report_k6_units(units, reps: int):
    """K6 by feature: each phase's mean cycles over the checked features
    beside the slowest one's (the largest total), the distribution of
    Gauss-Newton updates per checked feature, and the last launch's
    timeline (each feature's start and end by the global timer: whether
    the slowest feature or later waves of blocks set the launch's
    time)."""
    import numpy as np
    cycles, marks = units[:, 0] / reps, units[:, 1] / reps
    checked = marks[:, K6_GN_PHASE] > 0
    phases = list(K6_PHASES)
    total = cycles[:, phases].sum(axis=1)
    slow = int(np.flatnonzero(checked)[np.argmax(total[checked])])
    print(f"\nK6 by feature, per launch: {int(checked.sum())} checked of "
          f"{len(checked)}; the slowest is feature {slow}")
    print(f"  {'phase':58s} {'mean cycles':>12s} {'slowest':>10s} "
          f"{'its marks':>10s}")
    for k, name in K6_PHASES.items():
        print(f"  {name:58s} {cycles[checked, k].mean():12.0f} "
              f"{cycles[slow, k]:10.0f} {marks[slow, k]:10.1f}")
    print(f"  {'total':58s} {total[checked].mean():12.0f} "
          f"{total[slow]:10.0f}")
    ups = marks[checked, K6_UPDATE_PHASE]
    hist = np.bincount(np.rint(ups).astype(int))
    print(f"  updates per checked feature: mean {ups.mean():.4f}, p99 "
          f"{np.percentile(ups, 99):.1f}, max {ups.max():.0f}; histogram "
          f"{dict(enumerate(hist.tolist()))}")
    print(f"  total cycles by updates: " + ", ".join(
        f"{u}: {total[checked][np.rint(ups) == u].mean():.0f}"
        for u in range(len(hist)) if hist[u]))
    # the stamps are the timer's low 32 bits: differences modulo 2**32
    ref = int(units[0, 0, 14])
    start, end = ((units[:, 0, k].astype(np.int64) - ref + 2 ** 31) % 2 ** 32
                  - 2 ** 31 for k in (14, 15))
    t0 = start.min()
    start, end = (start - t0) / 1e3, (end - t0) / 1e3          # us
    last = int(np.argmax(end))
    upd = np.rint(marks[:, K6_UPDATE_PHASE]).astype(int)
    print(f"  timeline of the last launch (us from the first start): last "
          f"end {end.max():.2f}; the last feature to end ({last}, "
          f"{upd[last]} updates) ran {start[last]:.2f}-{end[last]:.2f}; "
          f"the slowest ({slow}) {start[slow]:.2f}-{end[slow]:.2f}; "
          f"{len(set(units[:, 1, 14].tolist()))} SMs")
    bins = np.arange(0.0, end.max() + 2.0, 2.0)
    print("  features started by 2 us bin: "
          f"{np.histogram(start, bins)[0].tolist()}; ended: "
          f"{np.histogram(end, bins)[0].tolist()}")
    for u in range(len(hist)):
        m = checked & (upd == u)
        if m.any():
            print(f"  {u} updates: {int(m.sum())} features, run "
                  f"{np.median(end[m] - start[m]):.2f} us median, "
                  f"{(end[m] - start[m]).max():.2f} max")


def report(title, names: dict, cycles, counts, launches):
    total = sum(cycles[k] for k in names)
    print(f"\n{title} ({launches} launches)")
    print(f"  {'phase':58s} {'cycles/launch':>14s} {'marks/launch':>13s} "
          f"{'share':>7s}")
    for k, name in names.items():
        print(f"  {name:58s} {cycles[k] / launches:14.0f} "
              f"{counts[k] / launches:13.1f} {cycles[k] / max(total, 1):7.3f}")


def k5_inputs(pft, cs, cfg, img, dev):
    """The host API's sorted candidate lattices at 480x640 with their
    slots: the initial selection and a refill (every 25th of 1000 selected
    features lost)."""
    import torch
    from pyfeaturetrack_tpu_torch.ops import cuda_eig, cuda_select
    from pyfeaturetrack_tpu_torch.ops.select_device import (_candidate_grid,
                                                            premask_radius)
    n = cs.N_FEATURES
    pyr = pft.build_track_pyramids(img, cfg)
    eig = cuda_eig.min_eig_map(pyr.gradx[0], pyr.grady[0], cfg.window_width,
                               cfg.window_height)
    geom = _candidate_grid(cfg, eig.shape)
    min_eig = max(int(cfg.min_eigenvalue), 1)
    x0 = torch.full((n,), -1.0, device=dev)
    v0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sel = pft.select_step_device(img, cfg, n)
    lost = torch.zeros(n, dtype=torch.bool, device=dev)
    lost[::25] = True
    v_lost = torch.where(lost, -4, sel[3])
    out = {}
    for name, (x, y, v), replacing in (
            ("initial", (x0, x0, v0), False),
            ("refill", (sel[1], sel[2], v_lost), True)):
        cand = cuda_select.candidate_lattice(
            eig, x, y, v, geom, min_eig=min_eig,
            radius=premask_radius(cfg, replacing)).cells[:, :geom[4]]
        neg, order = torch.sort(-cand.reshape(-1), stable=True)
        out[name] = (neg, order, dict(
            geom=geom, min_eig=min_eig, shape=tuple(img.shape),
            mindist=int(cfg.mindist), x=x, y=y, val=v, replacing=replacing))
    return out


K9_PHASES = {0: "position and frame-1 loads", 1: "frame-2 patch staged",
             2: "blends and per-lane sums", 3: "butterflies and store"}
K8_TILES = ((16, 16), (8, 32), (16, 32), (32, 32), (8, 64), (32, 16))


def k9_inputs(pft, cs, cfg, frames, dev):
    """K9's calls of chip_smoke.py's K9 phase: the 1000 features selected
    on the main pair's first frame (frame-1 windows there, frame-2
    positions at K2's tracks), and 65,536 features at seeded positions of
    the same frame (frame-2 positions at the drift)."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch.ops import cuda_window_terms
    from pyfeaturetrack_tpu_torch.ops.interp import gather_window
    pa, pb = (pft.build_track_pyramids(torch.as_tensor(f, device=dev).to(
        torch.float32), cfg) for f in frames[:2])
    _, xa, ya, va, _, _ = pft.select_step_device(pa.img[0], cfg,
                                                 cs.N_FEATURES)
    xb, yb, _ = pft.track_features_pyramids(pa, pb, xa, ya, va, cfg)
    rng = np.random.default_rng(cs.SEED + 9)
    big = [torch.as_tensor(rng.uniform(0, hi, 65536), dtype=torch.float32,
                           device=dev) for hi in (cs.W - 1, cs.H - 1)]
    hw, hh = cfg.window_width // 2, cfg.window_height // 2
    kw = dict(hw=hw, hh=hh, step_factor=cfg.step_factor)
    calls = {}
    for name, (x1, y1, x2, y2) in (
            ("1000 features", (xa, ya, xb, yb)),
            ("65,536 features", (big[0], big[1], big[0] + cs.DRIFT[0],
                                 big[1] + cs.DRIFT[1]))):
        w1 = [gather_window(im, x1, y1, hw, hh).contiguous()
              for im in (pa.img[0], pa.gradx[0], pa.grady[0])]
        args = (pb.img[0], pb.gradx[0], pb.grady[0], *w1, x2, y2)
        calls[name] = (lambda a=args: cuda_window_terms.window_terms(*a, **kw))
    return calls


def k8_tile_sweep(cs, cfg, levels, reps):
    """CUDA-event time of K8's level 0 (2-D of dense (a), 1-D of (c)) per
    tile shape, each result equal to the default tile's."""
    import torch
    from pyfeaturetrack_tpu_torch.ops import cuda_lk_dense
    s = float(cfg.subsampling)
    lvl0, u1, v1, lvl0_d, d1 = levels
    calls = {"2-D": lambda: cuda_lk_dense.dense_level_up(*lvl0, u1, v1, s,
                                                         cfg),
             "1-D": lambda: cuda_lk_dense.dense_level_1d_up(*lvl0_d, d1, s,
                                                            cfg)}
    default = cuda_lk_dense.TILE
    want = {k: f() for k, f in calls.items()}
    print(f"\nK8 level 0 by tile shape (rows x columns), CUDA events, mean "
          f"of {reps} launches")
    try:
        for tile in K8_TILES:
            cuda_lk_dense.TILE = tile
            row = []
            for k, f in calls.items():
                if not all(torch.equal(a, b) for a, b in zip(f(), want[k])
                           if a is not None):
                    sys.exit(f"phase_clocks: K8 tile {tile} changed the {k} "
                             "result")
                row.append(f"{k} {cs.time_ms(f, reps=reps):.4f} ms")
            print(f"  {tile[0]:3d} x {tile[1]:3d}: " + ", ".join(row))
    finally:
        cuda_lk_dense.TILE = default


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--k6-only", action="store_true",
                        help="measure K6's affine stage alone")
    opts = parser.parse_args(argv)
    reps = opts.reps
    import torch
    if not torch.cuda.is_available():
        sys.exit("phase_clocks: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import pyfeaturetrack_tpu_torch as pft
    from pyfeaturetrack_tpu_torch.ops.affine import affine_consistency_check
    smi = cs.smi_line()
    dev = torch.device("cuda", 0)
    cfg = pft.create_config().replace(sequentialMode=True).validated_window()
    main_frames = cs.make_frames(cs.N_FRAMES)
    if not opts.k6_only:
        _, _, lvl0, u1, v1 = cs.dense_flow_levels(pft, main_frames, cfg, dev)
        k8_levels = (lvl0, u1, v1, *cs.dense_depth_levels(pft, cfg, dev))
        k8_tile_sweep(cs, cfg, k8_levels, reps)
        k9_calls = k9_inputs(pft, cs, cfg, main_frames, dev)
    cfg3 = cs.config3()
    frames = [torch.as_tensor(f, device=dev).to(torch.float32)
              for f in cs.make_similarity_frames(cs.N_FRAMES // 2 + 1)]
    pyr, x, y, v, aff, _ = pft.select_step_device(frames[0], cfg3,
                                                  cs.N_FEATURES)
    for img in frames[1:-1]:
        pyr, x, y, v, aff, _, _ = pft.sequence_step_device(pyr, img, x, y, v,
                                                           cfg3, aff=aff)
    pyr_new = pft.build_track_pyramids(frames[-1], cfg3)
    tx, ty, tv = pft.track_features_pyramids(pyr, pyr_new, x, y, v, cfg3)
    args = (pyr, pyr_new, pft.FeatureState(x, y, v, aff),
            pft.FeatureState(tx, ty, tv, aff), cfg3)
    k6_ms, _ = cs.device_ms(lambda: affine_consistency_check(*args),
                            ("stage_kernel",), ROOT / "build" / "phase_clocks",
                            reps)
    print(f"K6 stage_kernel with the package's library, config-3 step "
          f"{cs.N_FRAMES // 2}: {k6_ms * 1e3:.2f} us a launch (profiler)")
    t0 = time.perf_counter()
    lib = use_library(build_clock_library())
    print(f"card: {smi}; clock build {time.perf_counter() - t0:.1f} s")

    affine_consistency_check(*args)
    read_clocks(lib, "pft_affine_phase_clocks")
    read_units(lib, "pft_affine_phase_units", cs.N_FEATURES)
    for _ in range(reps):
        affine_consistency_check(*args)
    cycles, counts = read_clocks(lib, "pft_affine_phase_clocks")
    report(f"K6 affine stage, config-3 step {cs.N_FRAMES // 2}, "
           f"{cs.N_FEATURES} lanes, summed over features", K6_PHASES, cycles,
           counts, reps)
    report_k6_units(read_units(lib, "pft_affine_phase_units", cs.N_FEATURES),
                    reps)
    if opts.k6_only:
        print(f"\n{smi}")
        return 0

    for name, c, img, eig in (
            ("default build with K3's map, 2 levels", cfg, frames[0], True),
            ("default build without the map", cfg, frames[0], False),
            ("config-3 build with K3's map, 3 levels", cfg3, frames[0],
             True)):
        pft.build_track_pyramids(img, c, with_eig=eig)
        read_clocks(lib, "pft_pyramid_phase_clocks")
        for _ in range(reps):
            pft.build_track_pyramids(img, c, with_eig=eig)
        cycles, counts = read_clocks(lib, "pft_pyramid_phase_clocks")
        report(f"K1 {name}, 480x640, summed over blocks", K1_PHASES, cycles,
               counts, reps)

    from pyfeaturetrack_tpu_torch.ops import cuda_lk_dense, cuda_suppress
    img0 = torch.as_tensor(main_frames[0], device=dev).to(torch.float32)
    for name, (neg, order, kw) in k5_inputs(pft, cs, cfg, img0, dev).items():
        cx, cy, _, valid = cuda_suppress.decode_candidates(
            neg, order, kw["geom"], kw["min_eig"])
        free = (kw["val"] < 0) if kw["replacing"] else kw["val"] < 1 << 30
        budget = free.sum().to(torch.int32).reshape(1)
        lkw = dict(shape=kw["shape"], mindist=kw["mindist"],
                   max_out=cs.N_FEATURES, budget=budget)
        for entry, call in (
                ("fused entry", lambda: cuda_suppress.suppress_and_fill(
                    neg, order, **kw)),
                ("list entry", lambda: cuda_suppress.greedy_suppress(
                    cx, cy, valid, **lkw))):
            call()
            read_clocks(lib, "pft_suppress_phase_clocks")
            for _ in range(reps):
                call()
            cycles, counts = read_clocks(lib, "pft_suppress_phase_clocks")
            report(f"K5 {entry}, {name} (480x640, {neg.shape[0]} sorted "
                   f"candidates, budget {int(budget.item())})", K5_PHASES,
                   cycles, counts, reps)

    s = float(cfg.subsampling)
    lvl0, u1, v1, lvl0_d, d1 = k8_levels
    for name, call in (("2-D level 0 of dense (a)",
                        lambda: cuda_lk_dense.dense_level_up(*lvl0, u1, v1, s,
                                                             cfg)),
                       ("1-D level 0 of dense (c)",
                        lambda: cuda_lk_dense.dense_level_1d_up(*lvl0_d, d1, s,
                                                                cfg))):
        call()
        read_clocks(lib, "pft_lk_dense_phase_clocks")
        for _ in range(reps):
            out = call()
        cycles, counts = read_clocks(lib, "pft_lk_dense_phase_clocks")
        cycles = [c // 32 for c in cycles]
        report(f"K8 {name}, 480x640, summed over threads / 32", K8_PHASES,
               cycles, counts, reps)
        print(f"  {name}: {cs.iteration_line(out[-1])}; 2x16 warps "
              f"{cs.warp_max_mean(out[-1], 2, 16):.4f}")

    for name, call in k9_calls.items():
        call()
        read_clocks(lib, "pft_window_terms_phase_clocks")
        for _ in range(reps):
            call()
        cycles, counts = read_clocks(lib, "pft_window_terms_phase_clocks")
        report(f"K9 {name}, 7x7 window, 480x640, summed over features",
               K9_PHASES, cycles, counts, reps)
    print(f"\n{smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
