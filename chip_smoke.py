#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (pyfeaturetrack_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; the first failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit
   (nvidia-smi) and the torch / CUDA versions;
2. build   — compile pyfeaturetrack_tpu_torch/csrc/*.cu with nvcc for
   sm_90a into build/torch_kernels/ and load it;
3. kernels — each hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes (480x640 frame, 1000 features,
   default config), timed with CUDA events. K2 and K4 must match their
   plain versions bit for bit, K1 within 1e-3 abs and K3 within one int
   step at under 1e-3 of pixels; K2 runs both levels of a real tracked
   pair and of a status mix whose lanes end in every K2 status;
4. main    — track_sequence_device on 100 synthetic 480x640 frames of a
   texture scrolling at a known drift, 1000 features, replace-lost on:
   every kernel must have launched, the tracks must recover the drift,
   the last frame must be fully live, and a 10-frame run through the
   plain versions must give the identical feature table (x, y, val);
5. profile (only with --profile) — the step time by CUDA events, by host
   wall clock and through track_sequence_device, three repeats each, then
   a torch.profiler trace of 30 steps: device kernels, busy time and idle
   share per step, and the largest device items.

Prints the per-kernel JSON line, then the nvidia-smi line, then, as the
last line, {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

H, W = 480, 640
N_FEATURES = 1000
N_FRAMES = 100
N_PLAIN_FRAMES = 10
DRIFT = (2, 1)            # (dx, dy) px per frame: the texture moves right/down
SEED = 0
DRIFT_TOL = 0.05          # px: median displacement vs the known drift


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def make_frames(n_frames: int):
    """uint8 frames of a seeded smooth texture that moves by DRIFT each
    frame (frame i is a crop of one large texture)."""
    import numpy as np
    dx, dy = DRIFT
    rng = np.random.default_rng(SEED)
    bh, bw = H + dy * n_frames, W + dx * n_frames
    tex = rng.uniform(0.0, 255.0, (bh, bw))
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for axis in (0, 1):
        for _ in range(2):
            tex = sum(w * np.roll(tex, s - 2, axis=axis) for s, w in enumerate(k))
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    tex = np.floor(tex).astype(np.uint8)
    y0, x0 = dy * n_frames, dx * n_frames
    return [np.ascontiguousarray(tex[y0 - dy * i:y0 - dy * i + H,
                                     x0 - dx * i:x0 - dx * i + W])
            for i in range(n_frames)]


def make_status_mix():
    """A float32 frame pair of the main path's size whose K2 lanes end in
    every status: the content moves by (+5, +3) px, a flat block gives
    SMALL_DET, a block of fresh noise in the second frame gives
    LARGE_RESIDUE or MAX_ITERATIONS, and lanes near the edges go OOB."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    tex = rng.uniform(0.0, 255.0, (H + 16, W + 16))
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for axis in (0, 1):
        for _ in range(2):
            tex = sum(w * np.roll(tex, s - 2, axis=axis) for s, w in enumerate(k))
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    a = tex[8:8 + H, 8:8 + W].copy()
    b = tex[5:5 + H, 3:3 + W].copy()
    a[100:200, 100:260] = 128.0
    b[103:203, 105:265] = 128.0
    b[300:400, 400:560] = rng.uniform(0.0, 255.0, (100, 160))
    return np.floor(a).astype(np.float32), np.floor(b).astype(np.float32)


def k2_levels(pa, pb, x, y, live, cfg, cuda_lk, reference_path):
    """The coarse-to-fine level loop of ops/track.py (with its "broken"
    rule), yielding (level, args, kernel result, plain result) per level;
    the next level starts from the kernel's result."""
    import torch
    from pyfeaturetrack_tpu_torch.features import KLT_OOB, KLT_SMALL_DET
    s = float(cfg.subsampling)
    scale = torch.full((), s ** cfg.nPyramidLevels, device=x.device)
    xloc, yloc = x / scale, y / scale
    xout, yout = xloc, yloc
    broken = torch.zeros_like(live)
    for r in range(cfg.nPyramidLevels - 1, -1, -1):
        xloc, yloc = xloc * s, yloc * s
        xout = torch.where(broken, xout, xout * s)
        yout = torch.where(broken, yout, yout * s)
        active = live & ~broken
        args = (xloc, yloc, xout, yout, pa.img[r], pa.gradx[r], pa.grady[r],
                pb.img[r], pb.gradx[r], pb.grady[r], cfg, active)
        got = cuda_lk.lk_level(*args)
        with reference_path():
            want = cuda_lk.lk_level(*args)
        torch.cuda.synchronize()
        yield r, args, got, want
        xout = torch.where(active, got[0], xout)
        yout = torch.where(active, got[1], yout)
        broken = broken | (active & ((got[2] == KLT_SMALL_DET) |
                                     (got[2] == KLT_OOB)))


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_times(pft, cfg, staged, replace_lost=True, warmup=10):
    """CUDA-event time of each sequence_step_device over the staged frames
    (ms), after ``warmup`` steps."""
    import torch
    pyr, x, y, v, _, _ = pft.select_step_device(staged[0], cfg, N_FEATURES)
    events = []
    for img in staged[1:]:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        pyr, x, y, v, _, _, _ = pft.sequence_step_device(pyr, img, x, y, v, cfg,
                                                         replace_lost)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events[warmup:]]


def host_wall_ms(pft, cfg, staged, replace_lost, warmup=10):
    """Host wall time per sequence_step_device, one sync at the end (ms)."""
    import torch
    pyr, x, y, v, _, _ = pft.select_step_device(staged[0], cfg, N_FEATURES)
    for img in staged[1:warmup + 1]:
        pyr, x, y, v, _, _, _ = pft.sequence_step_device(pyr, img, x, y, v, cfg,
                                                         replace_lost)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for img in staged[warmup + 1:]:
        pyr, x, y, v, _, _, _ = pft.sequence_step_device(pyr, img, x, y, v, cfg,
                                                         replace_lost)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (len(staged) - warmup - 1)


def profile_phase(pft, cfg, frames, staged, root, n_prof=30, repeats=3):
    """Where the step's time goes (``--profile``): the step time three ways,
    each repeated, then a torch.profiler trace of n_prof refill steps whose
    kernels give the device's busy time and idle share per step. The trace
    is written to build/profile/step_trace.json."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    phase(f"profile: step time, {repeats} repeats; then {n_prof} traced steps")
    for rep in range(repeats):
        ev = {rl: np.median(step_times(pft, cfg, staged, rl))
              for rl in (True, False)}
        wall = {rl: host_wall_ms(pft, cfg, staged, rl) for rl in (True, False)}
        t0 = time.perf_counter()
        pft.track_sequence_device(frames, cfg=cfg, n_features=N_FEATURES,
                                  replace_lost=True, device="cuda")
        entry = (time.perf_counter() - t0) * 1e3 / len(frames)
        print(f"repeat {rep}: CUDA-event step median {ev[True]:.4f} ms with "
              f"refill, {ev[False]:.4f} ms without; host wall per step "
              f"{wall[True]:.4f} ms with refill, {wall[False]:.4f} ms without;"
              f" track_sequence_device {entry:.4f} ms per numpy frame")
    pyr, x, y, v, _, _ = pft.select_step_device(staged[0], cfg, N_FEATURES)
    for img in staged[1:11]:
        pyr, x, y, v, _, _, _ = pft.sequence_step_device(pyr, img, x, y, v, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for img in staged[11:11 + n_prof]:
            pyr, x, y, v, _, _, _ = pft.sequence_step_device(pyr, img, x, y, v,
                                                             cfg)
        torch.cuda.synchronize()
    out = root / "build" / "profile" / "step_trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    trace = json.loads(out.read_text())
    kern = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in trace.get("traceEvents", trace)
                  if e.get("cat") == "kernel")
    if not kern:
        fail("the profiler recorded no device kernels")
    busy, cur_a, cur_b = 0.0, kern[0][0], kern[0][1]
    for a, b, _ in kern[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    span = max(b for _, b, _ in kern) - kern[0][0]
    print(f"traced {n_prof} steps: {len(kern) / n_prof:.1f} device kernels "
          f"per step, device busy {busy / n_prof:.1f} us per step (union of "
          f"kernel intervals), span {span / n_prof:.1f} us per step, idle "
          f"share {1.0 - busy / span:.3f}; trace {out}")
    per_name: dict = {}
    for a, b, name in kern:
        short = name.removeprefix("void ")[:90]
        t, c = per_name.get(short, (0.0, 0))
        per_name[short] = (t + b - a, c + 1)
    for short, (t, c) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / n_prof:8.1f} us/step  {c / n_prof:5.1f} launches/step  "
              f"{short}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the smoke, time the step three ways and "
                        "trace it with torch.profiler")
    profile = parser.parse_args(argv).profile

    phase("device")
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    root = Path(__file__).resolve().parent
    if not (root / "pyfeaturetrack_tpu_torch" / "csrc").is_dir():
        fail(f"{root} holds no pyfeaturetrack_tpu_torch package: run from a "
             "checkout of the repository")
    sys.path.insert(0, str(root))
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    import numpy as np

    import pyfeaturetrack_tpu_torch as pft
    from pyfeaturetrack_tpu_torch.features import (
        KLT_LARGE_RESIDUE, KLT_MAX_ITERATIONS, KLT_OOB, KLT_SMALL_DET,
        KLT_TRACKED)
    from pyfeaturetrack_tpu_torch.ops import (cuda_eig, cuda_lk, cuda_pyramid,
                                              cuda_select)
    from pyfeaturetrack_tpu_torch.ops.select_device import (
        _candidate_grid, candidate_map)
    from pyfeaturetrack_tpu_torch.utils import cuda
    if "jax" in sys.modules:
        fail("the port imported jax")

    phase("build")
    t0 = time.perf_counter()
    cuda.build()
    cuda.library()
    print(f"built {cuda.build_info['path']} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{cuda.build_info['seconds']:.1f} s)")
    for line in cuda.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    cfg = pft.create_config().replace(sequentialMode=True).validated_window()
    frames = make_frames(N_FRAMES)
    report = {}

    # ---- phase 3: every kernel against its plain version on the card ----
    phase("kernels vs plain versions (480x640, 1000 features)")
    img0 = torch.as_tensor(frames[0], device=dev).to(torch.float32)
    img1 = torch.as_tensor(frames[1], device=dev).to(torch.float32)
    taps = cuda_pyramid.level_taps(cfg)

    # K1, both levels, on the same inputs
    k1_err = 0.0
    lvl_in = img0
    for level in range(cfg.nPyramidLevels):
        smooth, with_pyr = level == 0, level < cfg.nPyramidLevels - 1
        got = cuda_pyramid.pyramid_level(lvl_in, taps, smooth, with_pyr)
        with cuda.reference_path():
            want = cuda_pyramid.pyramid_level(lvl_in, taps, smooth, with_pyr)
        torch.cuda.synchronize()
        for name, a, b in zip(("base", "gradx", "grady", "next"), got, want):
            if a is None:
                continue
            err = (a - b).abs().max().item()
            k1_err = max(k1_err, err)
            print(f"K1 level {level} {name} {tuple(a.shape)}: max abs "
                  f"{err:.3g}, bit-equal {torch.equal(a, b)}")
        lvl_in = got[3]
    if k1_err > 1e-3:
        fail(f"K1 max abs error {k1_err} > 1e-3 (0..255 scale)")

    def build_frame(img):
        return pft.build_track_pyramids(img, cfg)

    k1_ms = time_ms(lambda: build_frame(img0))
    with cuda.reference_path():
        k1_plain = time_ms(lambda: build_frame(img0))
    print(f"K1 full pyramid build: kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain:.4f} ms")
    report["K1"] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain)

    # K3 on the level-0 gradients
    pyr0 = build_frame(img0)
    gx0, gy0 = pyr0.gradx[0], pyr0.grady[0]
    eig_k = cuda_eig.min_eig_map(gx0, gy0, cfg.window_width, cfg.window_height)
    with cuda.reference_path():
        eig_p = cuda_eig.min_eig_map(gx0, gy0, cfg.window_width,
                                     cfg.window_height)
    torch.cuda.synchronize()
    d = (eig_k.to(torch.int64) - eig_p.to(torch.int64)).abs()
    k3_err = int(d.max().item())
    frac = (d != 0).float().mean().item()
    print(f"K3 eig map: max |int step| {k3_err}, fraction of pixels off "
          f"{frac:.3g}, bit-equal {torch.equal(eig_k, eig_p)}")
    if k3_err > 1 or frac >= 1e-3:
        fail(f"K3 differs by {k3_err} int steps at {frac} of pixels "
             "(bar: <= 1 step at < 1e-3)")
    ww, wh = cfg.window_width, cfg.window_height
    k3_ms = time_ms(lambda: cuda_eig.min_eig_map(gx0, gy0, ww, wh))
    with cuda.reference_path():
        k3_plain = time_ms(lambda: cuda_eig.min_eig_map(gx0, gy0, ww, wh))
    print(f"K3: kernel {k3_ms:.4f} ms, plain {k3_plain:.4f} ms")
    report["K3"] = dict(max_abs_err=float(k3_err), ms=k3_ms, plain_ms=k3_plain)

    # K4: initial selection (budget 1000) and a refill (budget of tens)
    n = N_FEATURES
    x0 = torch.full((n,), -1.0, device=dev)
    v0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    _, _, step_, _, _ = _candidate_grid(cfg, eig_k.shape)
    dg = max(0, (int(cfg.mindist) - 1) // step_)
    k4_cases, k4_err = {}, 0
    cand_init, free_init = candidate_map(eig_k, x0, x0, v0, cfg,
                                         replacing=False)
    sel = pft.select_step_device(img0, cfg, n)
    x_sel, y_sel, v_sel = sel[1], sel[2], sel[3]
    lost = torch.zeros(n, dtype=torch.bool, device=dev)
    lost[torch.arange(0, n, 25, device=dev)] = True   # 40 lost slots
    v_lost = torch.where(lost, -4, v_sel)
    cand_ref, free_ref = candidate_map(eig_k, x_sel, y_sel, v_lost, cfg,
                                       replacing=True)
    for name, cand, free in (("initial", cand_init, free_init),
                             ("refill", cand_ref, free_ref)):
        budget = free.sum().to(torch.int32).reshape(1)
        got = cuda_select.greedy_extract(cand, min_eig=1, dg=dg, budget=budget,
                                         max_out=n)
        with cuda.reference_path():
            want = cuda_select.greedy_extract(cand, min_eig=1, dg=dg,
                                              budget=budget, max_out=n)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        k4_err = max([k4_err] + [int((a - b).abs().max().item())
                                 for a, b in zip(got, want)])
        print(f"K4 {name}: budget {int(budget.item())}, accepted "
              f"{int(got[3].item())} (plain {int(want[3].item())}), "
              f"exact {same}")
        if not same:
            fail(f"K4 {name} selection differs from its plain version")
        kms = time_ms(lambda: cuda_select.greedy_extract(
            cand, min_eig=1, dg=dg, budget=budget, max_out=n), reps=5)
        with cuda.reference_path():
            pms = time_ms(lambda: cuda_select.greedy_extract(
                cand, min_eig=1, dg=dg, budget=budget, max_out=n), reps=2)
        print(f"K4 {name}: kernel {kms:.4f} ms, plain {pms:.4f} ms")
        k4_cases[name] = (kms, pms)
    report["K4"] = dict(max_abs_err=float(k4_err), ms=k4_cases["refill"][0],
                        plain_ms=k4_cases["refill"][1])

    # K2: both levels of the real tracked pair (frame 0 -> frame 1, every
    # lane TRACKED), then a status mix at the same shapes whose lanes end
    # in every K2 status. Kernel and plain version must agree bit for bit.
    k2_err = 0.0
    k2_seen = set()
    mix0, mix1 = (torch.as_tensor(f, device=dev) for f in make_status_mix())
    rng = np.random.default_rng(SEED + 1)
    mix_x = torch.as_tensor(rng.uniform(-4, W + 4, n), dtype=torch.float32,
                            device=dev)
    mix_y = torch.as_tensor(rng.uniform(-4, H + 4, n), dtype=torch.float32,
                            device=dev)
    all_live = torch.ones(n, dtype=torch.bool, device=dev)
    k2_cases = [("tracked pair", cfg, img0, img1, x_sel, y_sel, v_sel >= 0)]
    for name, over in (("status mix", {}),
                       ("status mix, lighting-insensitive",
                        {"lighting_insensitive": True}),
                       ("status mix, max_iterations 3", {"max_iterations": 3})):
        gain = 0.8 if over.get("lighting_insensitive") else 1.0
        bias = 20.0 if over.get("lighting_insensitive") else 0.0
        k2_cases.append((name, cfg.replace(**over), mix0, mix1 * gain + bias,
                         mix_x, mix_y, all_live))
    for name, kcfg, fa, fb, x, y, live in k2_cases:
        pa, pb = pft.build_track_pyramids(fa, kcfg), pft.build_track_pyramids(
            fb, kcfg)
        for r, args, got, want in k2_levels(pa, pb, x, y, live, kcfg, cuda_lk,
                                             cuda.reference_path):
            active = args[-1]
            codes = got[2][active].cpu().numpy()
            k2_seen.update(codes.tolist())
            err = max((a - b).abs().max().item() for a, b in zip(got[:2],
                                                                   want[:2]))
            k2_err = max(k2_err, err)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"K2 {name}, level {r}: {int(active.sum().item())} active, "
                  f"statuses (0,-1..-5) "
                  f"{np.bincount(-codes, minlength=6).tolist()}, bit-equal "
                  f"{same}")
            if not same:
                for i in torch.nonzero((got[0] != want[0]) | (got[1] != want[1])
                                       | (got[2] != want[2])
                                       | (got[3] != want[3])).flatten()[:20]:
                    i = int(i)
                    print(f"  lane {i}: kernel ({got[0][i].item()}, "
                          f"{got[1][i].item()}, {got[2][i].item()}, it "
                          f"{got[3][i].item()}) plain ({want[0][i].item()}, "
                          f"{want[1][i].item()}, {want[2][i].item()}, it "
                          f"{want[3][i].item()})")
                fail(f"K2 ({name}, level {r}) differs from its plain version")
            if name == "tracked pair" and r == 0:
                k2_in = args
    k2_codes = {KLT_TRACKED, KLT_SMALL_DET, KLT_MAX_ITERATIONS, KLT_OOB,
                KLT_LARGE_RESIDUE}
    if not k2_codes <= k2_seen:
        fail(f"the K2 cases never produced statuses {sorted(k2_codes - k2_seen)}")
    k2_ms = time_ms(lambda: cuda_lk.lk_level(*k2_in))
    with cuda.reference_path():
        k2_plain = time_ms(lambda: cuda_lk.lk_level(*k2_in))
    print(f"K2 level 0: kernel {k2_ms:.4f} ms, plain {k2_plain:.4f} ms")
    report["K2"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain)
    torch.cuda.synchronize()

    # ---- phase 4: the main path ----
    phase(f"main path: track_sequence_device, {N_FRAMES} frames, "
          f"{N_FEATURES} features, replace-lost")
    mods = {"K1": cuda_pyramid, "K2": cuda_lk, "K3": cuda_eig,
            "K4": cuda_select}
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    xs, ys, vs = pft.track_sequence_device(frames, cfg=cfg,
                                           n_features=N_FEATURES,
                                           replace_lost=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: m.launches for k, m in mods.items()}
    print(f"launches in the main-path run: {counts} ({wall:.2f} s wall, "
          "first calls included)")
    for k, c in counts.items():
        if c <= 0:
            fail(f"{k} was never launched on the main path")
    if not (np.isfinite(xs).all() and np.isfinite(ys).all()):
        fail("non-finite positions")
    if xs.shape != (N_FRAMES, N_FEATURES):
        fail(f"feature table shape {xs.shape}")
    pair = (vs[1:] == KLT_TRACKED) & (vs[:-1] >= 0)
    ddx = np.median((xs[1:] - xs[:-1])[pair])
    ddy = np.median((ys[1:] - ys[:-1])[pair])
    refills = int(((vs[1:] > 0)).sum())
    print(f"tracked pairs {int(pair.sum())}, median displacement "
          f"({ddx:.4f}, {ddy:.4f}) px vs drift {DRIFT}; refilled slots "
          f"{refills}; live in last frame {int((vs[-1] >= 0).sum())}")
    if abs(ddx - DRIFT[0]) > DRIFT_TOL or abs(ddy - DRIFT[1]) > DRIFT_TOL:
        fail("median displacement is not the drift")
    if refills == 0:
        fail("no refill fired")
    if not (vs[-1] >= 0).all():
        fail("the last frame is not fully live")

    # the same frames through the plain versions on the card
    with cuda.reference_path():
        px, py, pv = pft.track_sequence_device(
            frames[:N_PLAIN_FRAMES], cfg=cfg, n_features=N_FEATURES,
            replace_lost=True, device="cuda")
    kx, ky, kv = xs[:N_PLAIN_FRAMES], ys[:N_PLAIN_FRAMES], vs[:N_PLAIN_FRAMES]
    diff = np.argwhere((pv != kv) | (px != kx) | (py != ky))
    print(f"plain-version run, {N_PLAIN_FRAMES} frames: {len(diff)} "
          f"(frame, lane) entries differ from the kernel run")
    for f, i in diff[:20]:
        print(f"  frame {f} lane {i}: kernel ({kx[f, i]}, {ky[f, i]}, "
              f"{kv[f, i]}) plain ({px[f, i]}, {py[f, i]}, {pv[f, i]})")
    if len(diff):
        fail("the plain versions' feature table differs from the kernels'")
    report["K1"]["launches"] = counts["K1"]
    report["K2"]["launches"] = counts["K2"]
    report["K3"]["launches"] = counts["K3"]
    report["K4"]["launches"] = counts["K4"]

    staged = [torch.as_tensor(fr, device=dev).to(torch.float32)
              for fr in frames]
    ms = step_times(pft, cfg, staged)
    print(f"main path per-frame step (track + refill), median of "
          f"{len(ms)}: {np.median(ms):.4f} ms (min {min(ms):.4f}, max "
          f"{max(ms):.4f})")
    if profile:
        profile_phase(pft, cfg, frames, staged, root)

    names = {"K1": ("pyramid", "pyfeaturetrack_tpu_torch/csrc/pyramid.cu",
                    "pyfeaturetrack_tpu/ops/pallas_pyramid.py:132"),
             "K2": ("lk_level", "pyfeaturetrack_tpu_torch/csrc/lk.cu",
                    "pyfeaturetrack_tpu/ops/pallas_lk_vec.py:663"),
             "K3": ("min_eig_map", "pyfeaturetrack_tpu_torch/csrc/eig.cu",
                    "pyfeaturetrack_tpu/ops/pallas_eig.py:100"),
             "K4": ("greedy_extract", "pyfeaturetrack_tpu_torch/csrc/extract.cu",
                    "pyfeaturetrack_tpu/ops/pallas_select.py:251")}
    kernels = []
    for k in ("K1", "K2", "K3", "K4"):
        name, source, replaces = names[k]
        r = report[k]
        kernels.append({"name": f"{k} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
