#!/usr/bin/env python3
"""Where the time goes inside K6's affine stage and K1's pyramid build, by
clock64() counters, on one GPU.

    python3 phase_clocks.py [--reps N]

Builds pyfeaturetrack_tpu_torch/csrc/*.cu a second time with
-DPFT_PHASE_CLOCKS into build/phase_clocks/ (the library the package
loads has the counters compiled out), points the package's wrappers at it,
then:

* K6: the config-3 sequence of chip_smoke.py (480x640, 1000 features,
  similarity motion) is stepped to its middle; that step's affine stage
  runs N times. Each warp's lane 0 sums the cycles of each phase of its
  feature (csrc/affine.cu: lane state and template capture or copy; the
  template into registers; per Gauss-Newton iteration the bounds vote, the
  samples, the butterflies, the solve; after the loop; the outputs).
* K1: the default build (2 levels, 480x640) and the config-3 build (3
  levels) N times each. Thread 0 of each block sums the cycles of each
  phase of its tile (csrc/pyramid.cu: the frame tile, the horizontal
  pre-smooth, base, the horizontal passes, the vertical passes; level 0
  and the coarser levels apart; the grid barrier).

Prints, per phase, cycles per launch summed over warps (K6) or blocks
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
K6_PHASES = dict(enumerate([
    "lane state, template capture or copy", "template into registers",
    "bounds vote (per iteration)",
    "samples: taps, blends, products (per iteration)",
    "butterflies (per iteration)", "solve and update (per iteration)",
    "after the loop: bounds, residue, drift", "outputs"]))
K1_PHASES = {0: "level 0: frame tile + halo loaded", 1: "level 0: pre-smooth, "
             "horizontal", 2: "level 0: base (pre-smooth, vertical)",
             3: "level 0: horizontal passes", 4: "level 0: vertical passes "
             "and stores", 10: "coarser: base tile loaded (L2)",
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


def report(title, names: dict, cycles, counts, launches):
    total = sum(cycles[k] for k in names)
    print(f"\n{title} ({launches} launches)")
    print(f"  {'phase':58s} {'cycles/launch':>14s} {'marks/launch':>13s} "
          f"{'share':>7s}")
    for k, name in names.items():
        print(f"  {name:58s} {cycles[k] / launches:14.0f} "
              f"{counts[k] / launches:13.1f} {cycles[k] / max(total, 1):7.3f}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    reps = parser.parse_args(argv).reps
    import torch
    if not torch.cuda.is_available():
        sys.exit("phase_clocks: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import pyfeaturetrack_tpu_torch as pft
    from pyfeaturetrack_tpu_torch.ops.affine import affine_consistency_check
    smi = cs.smi_line()
    t0 = time.perf_counter()
    lib = use_library(build_clock_library())
    print(f"card: {smi}; clock build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)

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
    affine_consistency_check(*args)
    read_clocks(lib, "pft_affine_phase_clocks")
    for _ in range(reps):
        affine_consistency_check(*args)
    cycles, counts = read_clocks(lib, "pft_affine_phase_clocks")
    report(f"K6 affine stage, config-3 step {cs.N_FRAMES // 2}, "
           f"{cs.N_FEATURES} lanes, summed over warps", K6_PHASES, cycles,
           counts, reps)

    cfg = pft.create_config()
    for name, c, img in (("default build, 2 levels", cfg, frames[0]),
                         ("config-3 build, 3 levels", cfg3, frames[0])):
        pft.build_track_pyramids(img, c)
        read_clocks(lib, "pft_pyramid_phase_clocks")
        for _ in range(reps):
            pft.build_track_pyramids(img, c)
        cycles, counts = read_clocks(lib, "pft_pyramid_phase_clocks")
        report(f"K1 {name}, 480x640, summed over blocks", K1_PHASES, cycles,
               counts, reps)
    print(f"\n{smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
