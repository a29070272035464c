#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (pyfeaturetrack_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; the first failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit
   (nvidia-smi) and the torch / CUDA versions;
2. build   — compile pyfeaturetrack_tpu_torch/csrc/*.cu with nvcc for
   sm_90a (one nvcc per source, all started together) into
   build/torch_kernels/ and load it;
3. kernels — each hand-written kernel against its plain PyTorch version on
   the card, at the main paths' shapes (480x640 frame, 1000 features),
   timed with CUDA events and, from torch.profiler's kernel durations, by
   device time. Default config: K1, K2, K3 and K4 must match their plain
   versions bit for bit. K3 standalone on the level-0 gradients and K3
   inside K1's level-0 launch (the build with the map: the map equal to
   the standalone entry on the gradients the same build stored and the
   levels equal to the build without the map; the eig-only entry with and
   without the pre-smooth) on the 480x640, 481x643 and 480x70 frames at
   the default, 51x51, 97x97 (the widest the taps allow: a smaller tile)
   and 13x13 (3 levels, subsampling 2) windows, timed
   with the build beside the build without the map. K1 each level on its
   own and whole pyramids (at most two
   launches each) at 1-4 levels, subsampling 2 and 4, the default and the
   13x13 window's sigmas, on the 480x640 frame, a 481x643 frame and a
   480x70 frame whose coarse levels are narrower than a tile. K4's two stages (the candidate lattice and its maxima;
   the greedy chain and the slot fill) on the initial selection (1000 of
   255,744 candidates) and a refill (40 free slots), both also at mindist
   0, and on initial selections at 1080x1920, 768x1280, 1440x2560,
   2160x3840, 2880x5120 and 4320x7680 (segments of 128, 64, 256, 512,
   1024 and 2048 columns), with a 2160x3840 refill. K2's pyramidal entry
   (one launch per track call) and its per-level entry on a real tracked pair
   and on a status mix whose lanes end in every K2 status (also
   lighting-insensitive, at 3 iterations and with 13x13, 17x17, 25x25,
   31x31 and 51x51 windows) and on pyramids of 9 (480x640) and 12
   (2048x4096) levels at subsampling 2; the track call timed beside K2's
   earlier design (the level loop around one launch per level). K4 also
   on a 64 x 41,100 and a 27,900 x 64 frame (lattices beyond its earlier
   shared-memory caps), initial selection and refill.
   Config 3 (affine check, 3 levels, subsampling 2): K1 on all three
   levels and K2 (per level and per track call) on a similarity pair and
   on the status mix, at the same bars; K6 bit-equal in x, y, A, status and
   iteration count, modes 0, 1 and 2, on a real pair and on an affine
   status mix that must reach TRACKED, SMALL_DET, LARGE_RESIDUE, warp OOB
   and drift OOB and pass its unchecked lanes through, and on the mix at
   17x17, 25x25, 31x31 and 51x51 windows; K6's stage kernel (the whole
   affine stage in one launch) bit-equal in x, y, val and all eight
   AffineState fields on a stage mix (checked lanes, captures, lost and
   dead lanes), modes 0, 1 and 2;
4. main    — track_sequence_device on 100 synthetic 480x640 frames of a
   texture scrolling at a known drift, 1000 features, replace-lost on:
   every kernel must have launched (K1 twice per frame's pyramid, 200
   times, the first of them with K3's map, 100 times; K2 once per track
   call, 99 times; K4 two stages per selection, 200 times) and K3's
   standalone entry never, the tracks must recover the drift,
   the last frame must be fully live, and a 10-frame run through the
   plain versions must give the identical feature table (x, y, val);
   K5 bit-equal on the host API's sorted candidate lattice of a real
   480x640 frame (255,744 candidates, budget 1000), of a refill (40 free
   slots after the pre-mask), of a synthetic mix and of a 1080x1920 frame
   (the coverage grid in global memory), through both entries: the list
   entry (flags, index list and count; the mix: pixel lists with
   candidates at every edge, 10 % invalid, mindist 0, 1, 10, 25, 60,
   budgets 0, 7, unlimited) and the fused entry (the slots x, y, val, one
   launch; the mix: a full-frame lattice of tied values with 2000 slots at
   budgets 0, 7 and all); the sort and both entries timed beside K4's
   initial selection on the same map, the fused entry on the refill, and
   the two routes' selections equal;
5. affine  — track_sequence_device with config 3 on 100 synthetic 480x640
   frames under a known slow similarity motion, 1000 features,
   replace-lost on: K1-K4 and K6 must have launched (K1 200, K3 in K1's
   level 0 100, K2 99, K4 200 and K6 99 times: one launch per affine
   stage) and K3's standalone entry never, the tracks must
   recover the motion, refills must fire, the affine stage must hold
   templates and reject lanes, every step's affine stage must equal its
   plain version on the same inputs (x, y, val and all eight AffineState
   fields), and a 10-frame run through the plain versions must give the
   identical table and AffineState warps and valid flags; then the stage
   timed (one launch against the eager stage) and the config-3 step time
   (CUDA events);
6. config 1 — example 1 through the facade (KLTSelectGoodFeatures,
   KLTTrackFeatures) on examples/data/img0.pgm -> img1.pgm, 100 features:
   K1 (five launches: two builds and the selection's eig-only level 0,
   which carries K3's map), K2 (once), K4 (stage A, once) and K5 (once:
   one launch per host-API selection) must have launched, K3's standalone
   entry never, and the selected and tracked lists must
   equal the same calls through the plain versions;
7. config 2 — track_sequence (the host-API loop: sort + K5 refills) on the
   main phase's 100 frames, 1000 features, replace-lost on: one K5
   launch, one K4 stage A and one eig-only K1 level 0 (K3's map) per
   host-API selection (the first frame and every refill), K3's standalone
   entry never, K2 once per step, the table must equal
   track_sequence_device's, and a 10-frame config-3 run must equal the
   device route's table and AffineState; then the SequenceTracker.step
   time (CUDA events);
8. dense   — (a) compute_dense_flow on the main phase's first 480x640
   pair (default config): K1 and K8 launch 4 and 2 times and no
   upsample_flow runs outside K8, the maps equal the plain route's bit for
   bit, the median flow of the tracked interior is the drift within 0.05
   px; dense_flow_fb (K8 4 launches); the call timed by CUDA events; K8's
   2-D mode at level 0, started from the level-1 flow upsampled in the
   kernel, bit-equal and timed, and equal to the level started from the
   plain upsample_flow's maps; its mean iterations per pixel beside the
   mean of each warp's largest count (32 consecutive pixels, 4 x 8).
   (b) example 9's pair (examples/data): tracked share and median flow
   beside the sparse facade's median displacement, maps equal to the plain
   route's. (c) dense_depth on a rectified 480x640 two-plane pair
   (background disparity 4, box 32, max_disparity 64): K1 8 and K8 4
   launches, no upsample_flow outside K8, maps equal to the plain route's,
   each plane's median disparity within 0.1 px, the occluded band mostly
   invalid, the call timed; K8's 1-D mode at level 0 (upsampled start)
   bit-equal and timed, as in (a). K9 bit-equal on
   the main pair's 1000 features (windows at the selected features,
   frame-2 positions at K2's tracked ones; also at 17x17 to 51x51
   windows) and on a mix with lanes beyond every edge, timed; beside it
   the device time of a one-element fill (the card's floor for one small
   kernel), and K9 on 65,536 features of the same frame, bit-equal and
   timed. (d) track_sequence(subpixel_refine=True) on 10
   frames: the table equals the plain route's, the first frame is refined
   off the integers;
9. serving — the serving and long-video path on the main phase's 100
   frames and the config-3 phase's, 1000 features, chain k = 8:
   (a) track_sequence_device(chain=8) (12 replays of the captured graph,
   numpy uint8 frames through its pinned buffer, a 3-step eager tail)
   equal to chain=1's table on both configs, and two
   sequence_chain_device calls: the first call's outputs (history, final
   state, AffineState, pyramid) unchanged by the second; (b) a
   torch.profiler trace of 24 eager steps and of 3 replays of each
   config (build/profile/serving_<config>_{eager,chain}.json, after a
   warm-up window): the port's kernels per frame equal, the replay's
   device kernels per frame the eager step's plus the chain's one
   exhausted-flag reduction (2 / k), no ::eig_kernel; (c) per-frame
   times by CUDA events of the eager step and of the chain (frames on
   the card, and numpy uint8 frames), with the traces' busy time and
   idle share; (d) serve_stream(chain=8, prefetch=2, stage_uint8=True)
   equal to track_sequence_device on both configs, with the serving
   path's launches counted (K1 200, K2 99, K3 in K1 100, K4 200, K6 99
   on config 3, K3's standalone entry never); (e) the 100 frames written
   as PGMs and read back through FrameLoader into serve_stream: the table
   of (d); (f) a BatchedStreamingTracker of 8 streams (each its own seeded
   crop, 41 ticks, chain=8) equal to 8 separate StreamingTrackers, and its
   aggregate frames/s by CUDA events, three runs; (g)
   track_sequence_chunked(batched=True, n_chunks=4, chain=8) equal to
   batched=False. Prints {"serving": ...};
10. sfm    — the SfM back end and monocular VO (BASELINE config 5): (a)
   K2 with guided starts at 480x640 / 1000 features, starts 20-40 px
   from the anchors, on the default and config-3 pyramids (a drift pair
   30 px apart and the status mix), bit-equal to the plain level loop
   with the same starts, one launch counted as guided, timed beside the
   start-free call on the same lanes; then at the VO's size (240x320)
   K2's guided entry as loop closure and relocalization call it (the
   circuit's lighting-insensitive config, photometric drift, a few and
   all visible landmarks, identity and projected priors) and as stereo
   does (five disparity hypotheses), both directions of each round trip
   bit-equal to the plain version; select_step_device and
   sequence_step_device over a 30-frame corridor at 100 features
   bit-equal to their plain versions, a chain of 3 equal to its steps,
   and the 30-frame corridor VO on both routes with kernels equal to the
   run with plain versions (events, poses, landmarks); (b) dense bundle
   adjustment on bench.py's 20 x 2000 x 40,000 problem, 8 iterations:
   final/initial cost under 1e-3, a second run bit-equal, iterations/s
   by CUDA events, the device's busy share and kernels per iteration from
   a trace; (c)
   run_vo_on_corridor(n_frames=100, kf_every=3, n_features=100) on the
   host route and with device_loop=True, each run twice (identical
   trajectories, landmarks and events), ATE under 1 % of travel,
   launches counted over the first run (K1, K2, K3 in K1, K4, and K5 on
   the host route; K3's standalone entry never; guided K2 never: the
   count per route goes into the kernels line), host syncs per
   keyframe (torch.cuda.set_sync_debug_mode), frames/s; (d)
   run_vo_on_circuit(n_frames=260, finalize=False): a loop closed, ATE
   under 1 %, K2's guided launches counted; (e) stereo VO on
   tests/test_stereo.py's 12 frames: raw error under 3 % of travel.
   Prints {"sfm": ...};
11. grad    — tests/test_differentiability.py's losses on the card, each
   gradient with respect to the second frame: (a) tracked positions at
   480x640 with 1000 features (K1, K2), (b) dense flow on the config-1
   pair (K1, K8), (c) a config-3 step's positions (K1, K2, K6's stage,
   K4's refill), (d) K9's window terms. Each forward's launches counted
   (set to 0 just before it, read just after); the gradient finite and
   nonzero, repeated bit for bit, and against the same loss under
   reference_path() bit-equal or within GRAD_BAR of the largest
   gradient with the differing pixels listed (deterministic algorithms
   on for the phase); forward and backward (the plain versions' VJP) by
   CUDA events; (e) the captured chain refuses a frame that requires
   grad. Prints {"grad": ...};
12. sfm (f)-(h) — the windowed BA on bench.py's configs 5b (60 cameras x
   6000 landmarks x 12-frame windows, dense solver, 8 iterations) and 5c
   (500 x 20,000 x 8, banded PCG with 16-camera groups, 6 iterations),
   built draw for draw as bench.py builds them: final/initial cost under
   1e-3 (5b) and 1e-2 (5c), a second run bit-equal, iterations/s by CUDA
   events, busy share, kernels per iteration and the largest kernels from
   a trace, host reads per GN step (fewer than the CG iterations), CG
   iterations per step; (h) run_sfm_windowed, both solvers, on
   tests/test_sfm_e2e.py's rendered scene tracked on the card: the final
   cost under half the first, the aligned ATE below the initial, a rerun
   bit-equal. Prints {"sfm_windowed": ...};
13. tools   — checkpoint files of a SequenceTracker, a
   StreamingTracker(chain=8) and the corridor VO (both routes), resumed
   into fresh objects that continue bit-equal to the uninterrupted runs;
   python -m pyfeaturetrack_tpu_torch on PGM files in its default,
   --device-loop, --stream --chain 8, --flow and --vo modes, each output
   equal to the API calls it wraps; utils/profiling.trace naming K1's and
   K2's kernels, device_time_per_call and time_jitted. Prints
   {"tools": ...};
14. parallel — the sharded paths of pyfeaturetrack_tpu_torch/parallel on
   torch.distributed: (a) a one-rank NCCL group through
   initialize_cluster (127.0.0.1, a free port), its (frame, feature),
   pixrow and landmark meshes (an NCCL all_gather over each axis's group
   returns its input: the combine layer skips axes of one rank), and on
   them every sharded entry at the main paths' shapes against its
   unsharded route: track_batch_sharded (4 pairs of the main frames and
   the config-3 frames, 1000 features) and the full pair step (affine
   mode 2, lighting-insensitive, refill) bit-equal; dense_flow_sharded
   (the main pair) and dense_disparity_sharded (the dense-depth pair)
   bit-equal; batched_serving_sharded (8 streams, chain 8) and
   track_chunks_sharded (the 100 frames in 4 chunks, chain 8) bit-equal;
   the dense BA (20 x 2000 x 40,000) and configs 5b and 5c with mesh=
   bit-equal; track_sequence_multiprocess equal to track_sequence_chunked;
   (b) the same entries as a 4-way split on the card (the ranks' bodies
   one after another: meshes 2x2, 4x1, 1x4, pixrow 4, frame 4, landmark
   4), equal to the unsharded routes, the BAs within the JAX package's
   mesh bars (a converged cost within its residuals' float32
   resolution), with each run's launches and collective census; K8's
   row band: every level of the main pair's flow and of the stereo pair's
   1-D disparity cut into 4 bands (120 rows at level 0, 30 at level 1),
   each band launch bit-equal to the whole-level launch's rows and to the
   plain band, the level-0 band timed by events and by the replay of a
   captured graph of 20 launches (each band, and the whole level), with
   its bound; (c) the one-rank overhead: each
   sharded entry against its unsharded route by CUDA events, BA
   iterations/s with and without mesh=; (d) the group destroyed however
   the phase ends. Prints {"parallel": ...}; the kernels line's K8 entry
   gains its band launches, times and bound;
15. profile (only with --profile) — for config 2's host loop, its step
   time beside the device route's, three repeats, and for the config-3
   and the default device step, the step time by CUDA events, by host
   wall clock and through track_sequence_device, three repeats each;
   then for each a torch.profiler trace of 30 steps
   (build/profile/step_trace_<config>.json): device kernels, busy time
   and idle share per step, and the largest device items, and no launch
   of K3's standalone kernel; the same for 10
   compute_dense_flow calls (build/profile/dense_flow_trace.json), each
   of which must show nPyramidLevels K8 launches.

Prints the per-kernel JSON line (times by events and on the device,
launches, error, and the bound (K3 twice: inside K1's level-0 launch,
timed as the eig-only launch, and its standalone entry, with launches per
path):
the larger of the bytes each kernel must move over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, computed from this run's inputs;
K8's entry also carries its 1-D mode's times and bound and its row
band's (launches in the parallel phase, times, bound), K5's its list
entry's, K2's the windows its status mix ran at; K2 twice more: its
guided entry, with the circuit's guided launches and the start-free
time on the same lanes; K9's launches are those
of its own phase's driven
call, since no path of the package runs it; every entry's grad_launches
are its launches in the grad phase's forwards),
the script's wall time, then the nvidia-smi line, then, as the last line,
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
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
# config 3's motion per frame: about the frame centre, scale x1.001 and a
# 0.05 degree rotation, then a (2, 1) px shift
SIM_SHIFT, SIM_ROT_DEG, SIM_SCALE = (2.0, 1.0), 0.05, 1.001
SIM_PAD = 320             # texture margin around frame 0 (px)
OVERLAY = ((300, 400), (240, 400))   # rows, cols of the static overlay
# the dense-depth pair: background and box disparities (px) and the box
# span (right-image columns b0..b1, rows y0..y1)
STEREO_BG, STEREO_BOX = 4, 32
STEREO_BOX_SPAN = (240, 400, 120, 360)
# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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


def smooth_texture(rng, h, w):
    """A seeded smooth random texture on 0..255 (binomial smoothing)."""
    import numpy as np
    tex = rng.uniform(0.0, 255.0, (h, w))
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for axis in (0, 1):
        for _ in range(2):
            tex = sum(w * np.roll(tex, s - 2, axis=axis) for s, w in enumerate(k))
    return (tex - tex.min()) / (tex.max() - tex.min()) * 255.0


def make_frames(n_frames: int, seed: int = SEED):
    """uint8 frames of a seeded smooth texture that moves by DRIFT each
    frame (frame i is a crop of one large texture)."""
    import numpy as np
    dx, dy = DRIFT
    rng = np.random.default_rng(seed)
    bh, bw = H + dy * n_frames, W + dx * n_frames
    tex = np.floor(smooth_texture(rng, bh, bw)).astype(np.uint8)
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
    tex = smooth_texture(rng, H + 16, W + 16)
    a = tex[8:8 + H, 8:8 + W].copy()
    b = tex[5:5 + H, 3:3 + W].copy()
    a[100:200, 100:260] = 128.0
    b[103:203, 105:265] = 128.0
    b[300:400, 400:560] = rng.uniform(0.0, 255.0, (100, 160))
    return np.floor(a).astype(np.float32), np.floor(b).astype(np.float32)


def k2_levels(pa, pb, x, y, live, cfg, cuda_lk, reference_path, starts=None):
    """The coarse-to-fine level loop of ops/track.py (with its "broken"
    rule), yielding (level, args, kernel result, plain result) per level;
    the next level starts from the kernel's result. ``starts``: guided
    frame-2 starts (x_init, y_init) in level-0 pixels."""
    import torch
    from pyfeaturetrack_tpu_torch.features import KLT_OOB, KLT_SMALL_DET
    s = float(cfg.subsampling)
    scale = torch.full((), s ** cfg.nPyramidLevels, device=x.device)
    xloc, yloc = x / scale, y / scale
    xout, yout = xloc, yloc
    if starts is not None:
        xout, yout = starts[0] / scale, starts[1] / scale
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


@contextlib.contextmanager
def counted(modules, name):
    """Count the calls of ``name`` in each of ``modules`` while active: the
    list yielded gets one entry per call."""
    calls = []
    saved = [(m, getattr(m, name)) for m in modules]
    for m, f in saved:
        setattr(m, name, lambda *a, _f=f, **k: calls.append(1) or _f(*a, **k))
    try:
        yield calls
    finally:
        for m, f in saved:
            setattr(m, name, f)


def expect_launches(counts, expect, path):
    """Fail unless each kernel of ``expect`` launched exactly that often."""
    for k, want in expect.items():
        if counts[k] != want:
            fail(f"{k} launched {counts[k]} times on the {path} (expected "
                 f"{want})")


class K3InK1:
    """K3's launches inside K1's level-0 launch (ops/cuda_pyramid
    ``eig_launches``: the build with the map, the eig-only entry) under the
    ``launches`` name every path's count reads and resets."""

    def __init__(self, cuda_pyramid):
        self.mod = cuda_pyramid

    @property
    def launches(self):
        return self.mod.eig_launches

    @launches.setter
    def launches(self, value):
        self.mod.eig_launches = value


# K3's standalone entry (ops/cuda_eig): no path launches it any more.
K3_STANDALONE = "K3 standalone"


def path_counts(mods, path):
    """Each kernel's launches since the counts were set to 0; every kernel
    but K3's standalone entry must have launched, and that one not at all."""
    counts = {k: m.launches for k, m in mods.items()}
    for k, c in counts.items():
        if k == K3_STANDALONE:
            if c != 0:
                fail(f"K3's standalone entry launched {c} times on the {path}")
        elif c <= 0:
            fail(f"{k} was never launched on the {path}")
    return counts


def k2_call_check(pa, pb, x, y, live, cfg, cuda_lk, reference_path, name):
    """K2's pyramidal entry (one launch per track call) against its plain
    level loop on one case, bit for bit: x, y, val, with the lanes that
    are not ``live`` dead (val -1). Returns the kernel's (x, y, val)."""
    import numpy as np
    import torch
    val = torch.where(live, 0, -1).to(torch.int32)
    before = cuda_lk.launches
    got = cuda_lk.track_pyramid(pa, pb, x, y, val, cfg)
    if cuda_lk.launches != before + 1:
        fail("track_pyramid did not launch once")
    with reference_path():
        want = cuda_lk.track_pyramid(pa, pb, x, y, val, cfg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    codes = got[2][live].cpu().numpy()
    print(f"K2 {name}, whole track call ({cfg.nPyramidLevels} levels, "
          f"subsampling {cfg.subsampling}): final statuses (0,-1..-5) "
          f"{np.bincount(-codes, minlength=6).tolist()}, bit-equal {same}")
    if not same:
        fail(f"K2 track call ({name}) differs from its plain version")
    return got


def earlier_k2(cuda_lk, *args):
    """K2's earlier design, timed beside the new one: the plain level loop
    (cuda_lk.track_pyramid_reference) around one per-level kernel launch
    (cuda_lk.lk_level) per level."""
    plain_level = cuda_lk.lk_level_reference
    cuda_lk.lk_level_reference = cuda_lk.lk_level
    try:
        return cuda_lk.track_pyramid_reference(*args)
    finally:
        cuda_lk.lk_level_reference = plain_level


def config3():
    """BASELINE config 3: affine-consistency check (6-parameter warp,
    15x15 window) on a 3-level pyramid at subsampling 2 (border 32)."""
    import pyfeaturetrack_tpu_torch as pft
    return pft.create_config(affineConsistencyCheck=2, nPyramidLevels=3,
                             subsampling=2).replace(
                                 sequentialMode=True).validated_window()


def similarity():
    """(S, c, t): frame i+1 shows a point of frame i at c + S (p - c) + t."""
    import numpy as np
    th = np.deg2rad(SIM_ROT_DEG)
    S = SIM_SCALE * np.array([[np.cos(th), -np.sin(th)],
                              [np.sin(th), np.cos(th)]])
    return S, np.array([(W - 1) / 2.0, (H - 1) / 2.0]), np.array(SIM_SHIFT)


def make_similarity_frames(n_frames: int):
    """uint8 frames of one seeded smooth texture under the slow similarity
    motion of ``similarity()`` (bilinear rendering with numpy), with a
    static textured overlay (OVERLAY, a logo burned into the video) that
    the scene slides under: it hides part of a template before it reaches
    the 7x7 tracking window, which is what the affine stage rejects."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    tex = smooth_texture(rng, H + 2 * SIM_PAD, W + 2 * SIM_PAD)
    (r0, r1), (c0, c1) = OVERLAY
    overlay = np.floor(smooth_texture(rng, r1 - r0, c1 - c0))
    S, c, t = similarity()
    Sinv = np.linalg.inv(S)
    # frame-i pixel p shows frame-0 point M p + b; frame i+1 composes the
    # inverse step H(p) = Sinv (p - c - t) + c
    Mh, bh = Sinv, c - Sinv @ (c + t)
    M, b = np.eye(2), np.zeros(2)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    grid = np.stack([xx.ravel(), yy.ravel()])
    frames = []
    for _ in range(n_frames):
        q = M @ grid + b[:, None] + SIM_PAD
        qx = np.clip(q[0], 0, tex.shape[1] - 1.001)
        qy = np.clip(q[1], 0, tex.shape[0] - 1.001)
        x0, y0 = np.floor(qx).astype(np.int64), np.floor(qy).astype(np.int64)
        ax, ay = qx - x0, qy - y0
        v = ((1 - ax) * (1 - ay) * tex[y0, x0] + ax * (1 - ay) * tex[y0, x0 + 1]
             + (1 - ax) * ay * tex[y0 + 1, x0] + ax * ay * tex[y0 + 1, x0 + 1])
        frame = np.floor(v).reshape(H, W)
        frame[r0:r1, c0:c1] = overlay
        frames.append(frame.astype(np.uint8))
        M, b = M @ Mh, M @ bh + b
    return frames


def predicted(x, y):
    """Where the similarity motion takes frame-i points (x, y) in i+1."""
    import numpy as np
    S, c, t = similarity()
    p = S @ (np.stack([x, y]) - c[:, None]) + c[:, None] + t[:, None]
    return p[0], p[1]


def make_affine_mix(cfg, dev):
    """K6's inputs at config-3 shapes whose lanes are built to end in each
    affine status: (args, groups, (pa, pb)), pa and pb the pair's
    pyramids. The content moves by (+3, +2) px; a
    flat block gives SMALL_DET, fresh noise in frame 2 LARGE_RESIDUE,
    windows across the left edge warp OOB, starts 2.5 px off the optimum
    drift OOB, and unchecked lanes pass through."""
    import numpy as np
    import torch
    import pyfeaturetrack_tpu_torch as pft
    from pyfeaturetrack_tpu_torch.ops.interp import gather_window
    rng = np.random.default_rng(SEED + 4)
    tex = smooth_texture(rng, H + 16, W + 16)
    a = tex[8:8 + H, 8:8 + W].copy()
    b = tex[6:6 + H, 5:5 + W].copy()          # content at (x + 3, y + 2)
    a[100:200, 100:260] = 128.0
    b[102:202, 103:263] = 128.0
    b[300:400, 400:560] = rng.uniform(0.0, 255.0, (100, 160))
    pa = pft.build_track_pyramids(torch.as_tensor(np.floor(a), dtype=torch.float32,
                                                  device=dev), cfg)
    pb = pft.build_track_pyramids(torch.as_tensor(np.floor(b), dtype=torch.float32,
                                                  device=dev), cfg)

    def uniform(n, x_lo, x_hi, y_lo, y_hi):
        return rng.uniform(x_lo, x_hi, n), rng.uniform(y_lo, y_hi, n)

    def textured(n):
        xs, ys = [], []
        while len(xs) < n:
            x, y = uniform(1, 40, W - 40, 40, H - 40)
            if (95 <= x[0] <= 265 and 95 <= y[0] <= 205) or (
                    390 <= x[0] <= 570 and 290 <= y[0] <= 410):
                continue
            xs.append(x[0])
            ys.append(y[0])
        return np.array(xs), np.array(ys)

    sizes = {"tracked": 400, "flat": 120, "noise": 120, "edge": 120,
             "drift": 120, "unchecked": 120}
    xs, ys, start_dx, start_dy, groups = [], [], [], [], []
    for name, n in sizes.items():
        if name == "flat":
            x, y = uniform(n, 115, 245, 115, 185)
        elif name == "noise":
            x, y = uniform(n, 407, 547, 308, 388)     # frame-2 windows in noise
        elif name == "edge":
            x, y = uniform(n, 0.5, 5.0, 40, H - 40)
        else:
            x, y = textured(n)
        off = {"drift": (2.5, -2.0), "edge": (0.0, 0.0)}.get(name, (0.3, -0.2))
        xs.append(x)
        ys.append(y)
        start_dx.append(np.full(n, 3.0 + off[0]))
        start_dy.append(np.full(n, 2.0 + off[1]))
        groups += [name] * n
    f32 = lambda v: torch.as_tensor(np.concatenate(v), dtype=torch.float32,  # noqa: E731
                                    device=dev)
    x, y = f32(xs), f32(ys)
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    tmpl = gather_window(pa.img[0], x, y, hw, hh).contiguous()
    n = x.shape[0]
    A0 = torch.eye(2, device=dev).repeat(n, 1, 1).contiguous()
    groups = np.array(groups)
    check = torch.as_tensor(groups != "unchecked", device=dev)
    args = (tmpl, pb.img[0], pb.gradx[0], pb.grady[0], x + f32(start_dx),
            y + f32(start_dy), A0, check)
    return args, groups, (pa, pb)


def make_stage_mix(cfg, mix_args, groups, pyrs, dev):
    """The affine stage's inputs built on the affine status mix: (args,
    groups) with args = (pyr1, pyr2, fl_before, fl_after). The mix's lanes
    arrive tracked with a template (checked); its "unchecked" lanes split
    into first tracks without a template (captured), lanes lost by
    translational tracking and dead lanes."""
    import numpy as np
    import torch
    import pyfeaturetrack_tpu_torch as pft
    from pyfeaturetrack_tpu_torch.ops.interp import gather_window
    tmpl, _, _, _, xs, ys, A0, _ = mix_args
    pa, pb = pyrs
    n = tmpl.shape[0]
    groups = np.array(groups, dtype=object)
    un = np.flatnonzero(groups == "unchecked")
    groups[un[0::3]] = "capture"
    groups[un[1::3]] = "lost"
    groups[un[2::3]] = "dead"
    g = {k: torch.as_tensor(groups == k, device=dev)
         for k in ("capture", "lost", "dead")}
    x = xs - 3.3          # the mix's anchors (starts are about +3.3, +1.8)
    y = ys - 1.8
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    val_before = torch.where(g["dead"], -1, zero)
    val_after = torch.where(g["dead"], -1, torch.where(g["lost"], -4, zero))
    aff = pft.AffineState(
        img=tmpl, gradx=gather_window(pa.gradx[0], x, y, hw, hh).contiguous(),
        grady=gather_window(pa.grady[0], x, y, hw, hh).contiguous(),
        x=x.contiguous(), y=y.contiguous(), A=A0,
        valid=~(g["capture"] | g["dead"]),
        nit=(torch.arange(n, device=dev) % 7).to(torch.int32))
    before = pft.FeatureState(x.contiguous(), y.contiguous(), val_before, aff)
    after = pft.FeatureState(xs, ys, val_after, aff)
    return (pa, pb, before, after), groups


def stage_check(stage, cuda_affine, cuda, args, name, groups=None):
    """The affine stage (one K6 launch) against its plain version on the
    card: x, y, val and all eight AffineState fields bit for bit. Returns
    the kernel's result."""
    import numpy as np
    import torch
    before = cuda_affine.launches
    got = stage(*args)
    if cuda_affine.launches != before + 1:
        fail(f"the affine stage ({name}) did not launch once")
    with cuda.reference_path():
        want = stage(*args)
    torch.cuda.synchronize()
    same = {f: torch.equal(a, b) for f, a, b in
            zip(("x", "y", "val"), got[:3], want[:3])}
    same.update({f"aff.{f}": torch.equal(getattr(got.aff, f),
                                         getattr(want.aff, f))
                 for f in got.aff._fields})
    if groups is not None:
        codes = got.val.cpu().numpy()
        per = {k: np.bincount(-np.minimum(codes[groups == k], 0),
                              minlength=6).tolist()
               for k in dict.fromkeys(groups.tolist())}
        print(f"K6 stage {name}: statuses (0,-1..-5) by group {per}; "
              f"templates held {int(got.aff.valid.sum().item())}; fields "
              f"bit-equal {all(same.values())}")
    if not all(same.values()):
        fail(f"the affine stage ({name}) differs from its plain version: "
             f"{same}")
    return got


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` float32 operations on one H100."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_build_check(pft, cuda_pyramid, cuda, img, cfg, name):
    """K1's whole-pyramid entry against the plain level composition, bit
    for bit in every level's image and gradient pair, at most two launches
    (one for a single level)."""
    import torch
    before = cuda_pyramid.launches
    got = pft.build_track_pyramids(img, cfg)
    n_launch = cuda_pyramid.launches - before
    with cuda.reference_path():
        want = pft.build_track_pyramids(img, cfg)
    torch.cuda.synchronize()
    same = all(a.shape == b.shape and torch.equal(a, b)
               for ga, wa in zip(got, want) for a, b in zip(ga, wa))
    shapes = [tuple(t.shape) for t in got.img]
    print(f"K1 build {name}: {cfg.nPyramidLevels} levels, subsampling "
          f"{cfg.subsampling}, levels {shapes}: {n_launch} launches, "
          f"bit-equal {same}")
    if not same:
        fail(f"K1 build ({name}) differs from its plain version")
    if n_launch != min(cfg.nPyramidLevels, 2):
        fail(f"K1 build ({name}) took {n_launch} launches")
    return got


def k1_work(cfg, h, w, with_eig=False):
    """Bytes and operations of one frame's pyramid build: the frame read
    once, each level's image and gradient pair written once; per output
    sample one multiply and one add per tap of each 1-D pass (the level-0
    pre-smooth, the four gradient passes, and the pyramid smoothing at the
    decimated samples only). ``with_eig``: and K3's int32 map written, with
    its arithmetic (k3_work's operations)."""
    from pyfeaturetrack_tpu_torch.ops.cuda_pyramid import level_taps
    taps = level_taps(cfg)
    ks, kg, kd, kp = (len(t) for t in (taps.smooth, taps.grad_g, taps.grad_d,
                                       taps.pyr))
    s = cfg.subsampling
    nbytes, ops, hl, wl = 4 * h * w, 0, h, w
    for level in range(cfg.nPyramidLevels):
        if level == 0:
            ops += 2 * 2 * ks * hl * wl
        ops += (4 * kd + 4 * kg) * hl * wl
        nbytes += 3 * 4 * hl * wl
        if level < cfg.nPyramidLevels - 1:
            h2, w2 = hl // s, wl // s
            ops += 2 * kp * hl * w2 + 2 * kp * h2 * w2
            hl, wl = h2, w2
    if with_eig:
        nbytes += 4 * h * w
        ops += k3_work(cfg, h, w)[1]
    return nbytes, ops


def k2_work(cfg, active, iterations):
    """Bytes and operations of one K2 level as this run's lanes needed
    them: each active lane's (ww+1)(wh+1) patch of the six level images
    read once, positions in and out; per window pixel 31 operations for
    the frame-1 windows and the final residue, 34 per iteration (three
    blends, residual, gradient sums, five products and sums), plus 12 per
    iteration for the 2x2 solve."""
    npx = cfg.window_width * cfg.window_height
    patch = (cfg.window_width + 1) * (cfg.window_height + 1)
    n = active.shape[0]
    na = int(active.sum().item())
    its = int(iterations[active].sum().item())
    nbytes = na * 6 * patch * 4 + n * (4 * 4 + 1 + 4 * 4)
    return nbytes, na * npx * 31 + its * (npx * 34 + 12)


def k3_work(cfg, h, w):
    """Two gradients read and the int32 map written once; per pixel three
    products, the two 1-D window sums of each, and the eigenvalue."""
    per_px = 3 + 3 * (cfg.window_width - 1 + cfg.window_height - 1) + 8
    return 3 * 4 * h * w, per_px * h * w


def k3_in_k1_work(cfg, h, w):
    """K3 in K1's level-0 launch, eig-only, pre-smoothed: the frame read and
    the int32 map written once; per pixel the pre-smooth, the gradient pair
    (one multiply and one add per tap of each 1-D pass) and k3_work's
    arithmetic."""
    from pyfeaturetrack_tpu_torch.ops.cuda_pyramid import level_taps
    taps = level_taps(cfg)
    ks, kg, kd = (len(t) for t in (taps.smooth, taps.grad_g, taps.grad_d))
    per_px = 2 * 2 * ks + 4 * kd + 4 * kg
    return 8 * h * w, per_px * h * w + k3_work(cfg, h, w)[1]


def k3_fused_check(pft, cuda_pyramid, cuda_eig, cuda, img, cfg, name):
    """K3 inside K1's level-0 launch, bit for bit: the build's map against
    K3's standalone entry on the gradients the same build stored and against
    the plain versions, the build's levels against the build without the
    map; the eig-only entry with and without the pre-smooth against the
    build's map, K3's standalone entry and the plain version."""
    import torch
    win = (cfg.window_width, cfg.window_height)
    taps = cuda_pyramid.level_taps(cfg)
    pyr, eig = pft.build_track_pyramids(img, cfg, with_eig=True)
    bare = pft.build_track_pyramids(img, cfg)
    only = {sm: cuda_pyramid.level0_eig(img, taps, sm, *win)
            for sm in (True, False)}
    _, gx_raw, gy_raw, _ = cuda_pyramid.pyramid_level(img, taps, False, False)
    with cuda.reference_path():
        _, peig = pft.build_track_pyramids(img, cfg, with_eig=True)
        ponly = {sm: cuda_pyramid.level0_eig(img, taps, sm, *win)
                 for sm in (True, False)}
    checks = {
        "build map = K3 standalone on its gradients": torch.equal(
            eig, cuda_eig.min_eig_map(pyr.gradx[0], pyr.grady[0], *win)),
        "build map = plain": torch.equal(eig, peig),
        "levels = build without the map": all(
            torch.equal(a, b) for ga, gb in zip(pyr, bare)
            for a, b in zip(ga, gb)),
        "eig-only, pre-smoothed = build map": torch.equal(only[True], eig),
        "eig-only = plain": all(torch.equal(only[sm], ponly[sm])
                                for sm in only),
        "eig-only, raw = K3 standalone": torch.equal(
            only[False], cuda_eig.min_eig_map(gx_raw, gy_raw, *win)),
    }
    torch.cuda.synchronize()
    print(f"K3 in K1 level 0, {name}, {win[0]}x{win[1]} window, "
          f"{cfg.nPyramidLevels} levels: " + ", ".join(
              f"{k} {v}" for k, v in checks.items()))
    if not all(checks.values()):
        fail(f"K3 in K1's level-0 launch ({name}) differs: {checks}")


def k4_work(ny, nx, n, n_acc, dg):
    """One selection (stage A + stage B): the eig map's ny x nx lattice
    cells and the n feature slots read once, the n slots (x, y, val,
    filled) written once; one compare per candidate and one store per cell
    of each accepted box."""
    return (4 * ny * nx + 12 * n + 13 * n,
            ny * nx + int(n_acc) * (2 * dg + 1) ** 2)


def k5_scanned(k, n_acc, order, budget):
    """Candidates K5's scan read: up to the last acceptance when the
    budget ran out, else all k."""
    n = int(n_acc.item())
    return int(order[n - 1].item()) + 1 if 0 < n == budget else k


def k5_work(k, n_acc, order, budget, mindist, max_out):
    """The candidates this run's scan read (x, y, valid) and the outputs
    written once (flags, index list, count); one coverage test per
    candidate read and one store per cell of each accepted box."""
    scanned = k5_scanned(k, n_acc, order, budget)
    box = (2 * max(mindist - 1, -1) + 1) ** 2
    return (scanned * 9 + k + 4 * max_out + 4,
            scanned + int(n_acc.item()) * box)


def k5_fill_work(k, n_acc, order, budget, mindist, n):
    """One call of K5's fused entry: the candidates its scan read (int32
    key, int64 order) and the n slots (x, y, val) read and written once;
    one coverage test per candidate read and one store per cell of each
    accepted box."""
    scanned = k5_scanned(k, n_acc, order, budget)
    box = (2 * max(mindist - 1, -1) + 1) ** 2
    return scanned * 12 + 24 * n, scanned + int(n_acc.item()) * box


def k6_work(cfg, check, nit):
    """Bytes and operations of one K6 call as this run's lanes needed them:
    each checked lane's template and the (ww+1)(wh+1) footprint of the
    three images read once, lanes in and out; per sample and Gauss-Newton
    iteration 8 operations for the warp, 2 for the bounds, 6 for the
    weights, 21 for three blends, 1 for the residual, the Jacobian, and a
    multiply and an add per normal-equation entry; per iteration the
    unpivoted solve; after the loop 26 per sample (warp, bounds, weights,
    one blend, residue)."""
    mode = int(cfg.affineConsistencyCheck)
    p = (2, 4, 6)[mode]
    ns = p * (p + 1) // 2 + p
    jac = (0, 6, 4)[mode]
    npx = cfg.affine_window_width * cfg.affine_window_height
    foot = (cfg.affine_window_width + 1) * (cfg.affine_window_height + 1)
    nc = int(check.sum().item())
    its = int(nit.sum().item())
    n = check.shape[0]
    nbytes = nc * (npx + 3 * foot) * 4 + n * (8 + 16 + 1 + 8 + 16 + 8)
    per_sample = 8 + 2 + 6 + 21 + 1 + jac + 2 * ns
    ops = its * (npx * per_sample + 2 * p * p * (p + 1)) + nc * npx * 26
    return nbytes, ops


def k6_stage_work(cfg, args, out):
    """Bytes and operations of one affine stage as this step's lanes needed
    them: the feature lists and the AffineState read once and the new ones
    written once (templates included: the stage writes a new state), the
    three-image footprint of each captured lane in frame 1 and of each
    checked lane in frame 2 read once; K6's Gauss-Newton operations
    (k6_work) for the checked lanes, 3 blends (27 operations with the
    weights) per captured sample."""
    import torch
    from pyfeaturetrack_tpu_torch.features import KLT_TRACKED
    pyr1, pyr2, before, after = args[:4]
    aff = after.aff
    n = after.x.shape[0]
    npx = cfg.affine_window_width * cfg.affine_window_height
    foot = (cfg.affine_window_width + 1) * (cfg.affine_window_height + 1)
    tracked = after.val == KLT_TRACKED
    lost = (before.val >= 0) & ~tracked
    valid = aff.valid & ~lost
    check = tracked & valid
    n_cap = int((tracked & ~valid).sum().item())
    per_lane = 2 * (3 * npx * 4 + 2 * 4 + 16 + 1 + 4) + 3 * 12 + 3 * 4
    nbytes = n * per_lane + (n_cap + int(check.sum().item())) * 3 * foot * 4
    # the Gauss-Newton updates the kernel made: recount them with the batch
    # entry on the same inputs (the stage does not return them)
    from pyfeaturetrack_tpu_torch.ops import cuda_affine
    nit = cuda_affine.affine_track_batch(
        aff.img, pyr2.img[0], pyr2.gradx[0], pyr2.grady[0], after.x, after.y,
        torch.where(lost[:, None, None], torch.eye(2, device=aff.A.device),
                    aff.A).contiguous(), check, cfg)[4]
    gn_bytes, gn_ops = k6_work(cfg, check, nit)
    del gn_bytes
    return nbytes, gn_ops + n_cap * npx * 27


def k8_work(cfg, status, iterations, one_d, coarse=None):
    """Bytes and operations of one K8 level as this run's pixels needed
    them. Bytes: the level images it reads once (six; four in the 1-D mode,
    which reads no gy), the maps in (2-D: u, v; 1-D: d; level-sized, or of
    the ``coarse`` shape when the kernel upsamples them, 20 operations per
    pixel and map) and out (u, v or d, status, iteration).
    Operations per window pixel: the frame-1 windows sit on integer
    coordinates and need no blend; per iteration 2-D 34 (three frame-2
    blends, the residual, two gradient sums, five products and sums) and
    12 per iteration for the 2x2 solve, 1-D 20 (two blends, the residual,
    the gradient sum, two products and sums) and 4 for the scalar step;
    10 for the final residue (one blend, difference, magnitude, sum) at
    each pixel that reached it, those in bounds and not SMALL_DET."""
    from pyfeaturetrack_tpu_torch.features import (
        KLT_LARGE_RESIDUE, KLT_MAX_ITERATIONS, KLT_TRACKED)
    npx = cfg.window_width * cfg.window_height
    n = iterations.numel()
    its = int(iterations.sum().item())
    reached = int(((status == KLT_TRACKED) | (status == KLT_LARGE_RESIDUE)
                   | (status == KLT_MAX_ITERATIONS)).sum().item())
    h, w = iterations.shape
    nmaps = 1 if one_d else 2
    hm, wm = (h, w) if coarse is None else coarse
    maps = 4 * nmaps * hm * wm
    up = 0 if coarse is None else 20 * nmaps * n
    if one_d:
        return (4 * 4 * h * w + maps + n * 12,
                reached * npx * 10 + its * (npx * 20 + 4) + up)
    return (6 * 4 * h * w + maps + n * 16,
            reached * npx * 10 + its * (npx * 34 + 12) + up)


def warp_max_mean(iterations, wh: int, ww: int) -> float:
    """Mean over warps of each warp's largest iteration count, for warps
    covering wh x ww pixel blocks of the map (edge blocks padded with 0)."""
    import torch.nn.functional as F
    it = iterations.float()[None, None]
    return F.max_pool2d(it, (wh, ww), ceil_mode=True).mean().item()


def iteration_line(iterations) -> str:
    """Mean iterations per pixel and the warp-max means of the parent's
    layout (32 consecutive row-major pixels per warp) and K8's (4 x 8)."""
    return (f"iterations per pixel mean {iterations.float().mean().item():.4f}"
            f", mean of each warp's largest count: 32 consecutive pixels "
            f"{warp_max_mean(iterations, 1, 32):.4f}, 4 x 8 blocks "
            f"{warp_max_mean(iterations, 4, 8):.4f}")


def dense_flow_levels(pft, frames, cfg, dev):
    """K8's inputs at level 0 of dense case (a): the pair's pyramids, the
    level-0 images and the level-1 flow (solved from zero) that the path
    upsamples into level 0's start."""
    import torch
    from pyfeaturetrack_tpu_torch.ops import cuda_lk_dense
    p1, p2 = (pft.build_track_pyramids(
        torch.as_tensor(f, device=dev).to(torch.float32), cfg)
        for f in frames[:2])
    lvl = [tuple(p[r] for p in (p1.img, p1.gradx, p1.grady, p2.img, p2.gradx,
                                p2.grady)) for r in (0, 1)]
    u1, v1, _, _ = cuda_lk_dense.dense_level_up(*lvl[1], None, None,
                                                float(cfg.subsampling), cfg)
    return p1, p2, lvl[0], u1, v1


def dense_depth_levels(pft, cfg, dev):
    """K8's 1-D inputs at level 0 of dense case (c): the left-reference
    pass's level-0 images and its level-1 disparity (refined from the SSD
    seed map), which the path upsamples into level 0's start."""
    import torch
    from pyfeaturetrack_tpu_torch.ops import cuda_lk_dense
    from pyfeaturetrack_tpu_torch.ops.disparity import _hypothesis_init
    left, right, _ = make_stereo_pair()
    pl, pr = (pft.build_track_pyramids(torch.as_tensor(f, device=dev), cfg)
              for f in (left, right))
    hw, n_lv = cfg.window_width // 2, cfg.nPyramidLevels
    hyp = tuple(range(0, int(64.0 / float(cfg.subsampling) ** (n_lv - 1)) + 1,
                      hw + 1))
    dseed = _hypothesis_init(pl.img[1], pr.img[1], hyp, hw,
                             cfg.window_height // 2)
    lvl = [tuple(p[r] for p in (pl.img, pl.gradx, pl.grady, pr.img, pr.gradx,
                                pr.grady)) for r in (0, 1)]
    d1, _, _ = cuda_lk_dense.dense_level_1d(*lvl[1], dseed, cfg)
    return lvl[0], d1


def k9_work(n, ww, wh, frame_px):
    """Bytes and operations of one K9 call on n features: the three frame-1
    windows read once, the three (ww+1)(wh+1) frame-2 patches read once but
    never more than the three frame-2 images of frame_px pixels (each input
    read once), positions in, five sums out; per window pixel three blends
    (21), the residual and two gradient sums (3), five products and five
    sums (10); per feature the clamp (4) and the two step scalings (2)."""
    npx, patch = ww * wh, (ww + 1) * (wh + 1)
    frame2 = min(n * 3 * patch * 4, 3 * frame_px * 4)
    return n * (3 * npx * 4 + 8 + 20) + frame2, n * (npx * 34 + 6)


def k4_check(cuda_select, cuda, eig, x, y, v, geom, cfg, replacing, name,
             prof_dir, timed=True):
    """K4's two stages against their plain versions on one selection:
    stage A's lattice and maxima, then stage B's slots (x, y, val, filled),
    bit for bit. ``timed``: then the selection's time by CUDA events, the
    plain version's, and each stage's device time from the profiler;
    "events": the kernels' time by events only. Returns the times and the
    work of the selection (None untimed)."""
    import torch
    from pyfeaturetrack_tpu_torch.ops.select_device import premask_radius
    min_eig = max(int(cfg.min_eigenvalue), 1)
    kw = dict(min_eig=min_eig, radius=premask_radius(cfg, replacing),
              dg=max(0, (int(cfg.mindist) - 1) // geom[2]),
              replacing=replacing)
    cands = cuda_select.candidate_lattice(eig, x, y, v, geom,
                                          min_eig=min_eig,
                                          radius=kw["radius"])
    fill_kw = dict(min_eig=min_eig, dg=kw["dg"], replacing=replacing)
    with cuda.reference_path():
        plain = cuda_select.candidate_lattice(eig, x, y, v, geom,
                                              min_eig=min_eig,
                                              radius=kw["radius"])
        want = cuda_select.greedy_fill(cands, x, y, v, geom, **fill_kw)
    torch.cuda.synchronize()
    same_a = all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                 for a, b in zip(cands, plain))
    got = cuda_select.greedy_fill(cands, x, y, v, geom, **fill_kw)
    torch.cuda.synchronize()
    same_b = all(torch.equal(a, b) for a, b in zip(got, want))
    budget = int((v < 0).sum().item()) if replacing else v.shape[0]
    n_acc = int(got[3].sum().item())
    print(f"K4 {name}: lattice {geom[3]}x{geom[4]} (segments of {cands.seg} "
          f"columns), budget {budget}, accepted {n_acc}; stage A bit-equal "
          f"{same_a}, stage B bit-equal {same_b}")
    if not (same_a and same_b):
        bad = torch.nonzero((got[0] != want[0]) | (got[2] != want[2])).flatten()
        for i in bad[:10].tolist():
            print(f"  slot {i}: kernel ({got[0][i].item()}, {got[1][i].item()}, "
                  f"{got[2][i].item()}) plain ({want[0][i].item()}, "
                  f"{want[1][i].item()}, {want[2][i].item()})")
        fail(f"K4 ({name}) differs from its plain version")
    if not timed:
        return None

    def select():
        return cuda_select.select_from_eig(eig, x, y, v, geom, **kw)

    reps = 20 if replacing else 5
    out = dict(ms=time_ms(select, reps=reps),
               work=k4_work(geom[3], geom[4], v.shape[0], n_acc, kw["dg"]))
    if timed == "events":
        print(f"K4 {name}: stage A + stage B {out['ms']:.4f} ms by events")
        return out
    with cuda.reference_path():
        out["plain_ms"] = time_ms(select, reps=2)
    dev_a, _ = device_ms(select, ["::lattice_kernel"], prof_dir, reps=reps)
    dev_b, _ = device_ms(select, ["::chain_kernel"], prof_dir, reps=reps)
    out.update(device_ms=dev_a + dev_b, device_a_ms=dev_a, device_b_ms=dev_b)
    print(f"K4 {name}: stage A + stage B {out['ms']:.4f} ms by events, "
          f"device {dev_a:.4f} + {dev_b:.4f} ms; plain {out['plain_ms']:.4f} "
          "ms")
    return out


def make_stereo_pair():
    """A rectified 480x640 pair built the way examples/example11_depth.py
    builds its own, at this size: two textures (a seeded uniform noise with
    one binomial pass per axis), a background plane at disparity
    STEREO_BG and a raised box at STEREO_BOX, composited with real
    visibility, so the background band just left of the box is occluded in
    the right view. Returns (left, right, box) with box = (b0, b1, y0, y1)
    in right-image coordinates."""
    import numpy as np
    pad = 2 * STEREO_BOX

    def tex(seed):
        img = np.random.default_rng(seed).uniform(0.0, 255.0, (H, W + pad))
        k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
        for axis in (0, 1):
            img = sum(c * np.roll(img, s - 2, axis=axis) for s, c in enumerate(k))
        return img

    bg, fg = tex(SEED + 11), tex(SEED + 12)
    xs = np.arange(W)[None, :]
    ys = np.arange(H)[:, None]
    b0, b1, y0, y1 = STEREO_BOX_SPAN
    d_bg, d_box = STEREO_BG, STEREO_BOX
    in_box_r = (xs >= b0) & (xs < b1) & (ys >= y0) & (ys < y1)
    right = np.where(in_box_r, fg[:, d_box:W + d_box], bg[:, d_bg:W + d_bg])
    in_box_l = (xs >= b0 + d_box) & (xs < b1 + d_box) & (ys >= y0) & (ys < y1)
    left = np.where(in_box_l, fg[:, :W], bg[:, :W])
    return (left.astype(np.float32), right.astype(np.float32),
            (b0, b1, y0, y1))


def maps_equal(got, want, what):
    """Fail unless every map of ``got`` equals ``want``'s bit for bit."""
    import numpy as np
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            bad = np.argwhere(a != b) if a.shape == b.shape else []
            print(f"  {what}: output {i} differs at {len(bad)} pixels, first "
                  f"{[tuple(int(v) for v in q) for q in bad[:10]]}")
            fail(f"{what} differs from the plain route")


def device_ms(fn, kernels, out_dir, reps: int = 20):
    """Device time per fn() call (ms) of the kernels whose names hold one of
    ``kernels``, summed over their launches, from torch.profiler's kernel
    durations over reps calls after one warm-up; and their launches per
    call. The trace goes to out_dir/kernel_times.json. A trace that holds
    none of the kernels is read again through the profiler's own event
    list, then taken again, twice at most. If none of three traces holds
    a launch (the profiler can lose a kernel's records on this card), both
    numbers are NaN, which the kernels line writes as null: CUDA events
    around back-to-back calls count the host's launch time too, so they
    are printed under their own name and never stand in for device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "kernel_times.json"
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        durs = [e["dur"] for e in trace.get("traceEvents", trace)
                if e.get("cat") == "kernel"
                and any(k in e.get("name", "") for k in kernels)]
        if durs:
            return sum(durs) / reps / 1e3, len(durs) / reps
        evs = [e for e in prof.events()
               if e.device_type.name == "CUDA"
               and any(k in e.name for k in kernels)]
        if evs:
            return (sum(e.device_time for e in evs) / reps / 1e3,
                    len(evs) / reps)
        print(f"the profiler recorded no launch of {kernels} (attempt "
              f"{attempt + 1})")
    print(f"no device time for {kernels}: the profiler recorded none of "
          f"their launches in three traces (CUDA events around the same "
          f"back-to-back calls, launch time included: {time_ms(fn, reps):.4f} "
          "ms per call)")
    return float("nan"), float("nan")


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
    pyr, x, y, v, aff, _ = pft.select_step_device(staged[0], cfg, N_FEATURES)
    events = []
    for img in staged[1:]:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        pyr, x, y, v, aff, _, _ = pft.sequence_step_device(
            pyr, img, x, y, v, cfg, replace_lost, aff=aff)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events[warmup:]]


def host_wall_ms(pft, cfg, staged, replace_lost, warmup=10):
    """Host wall time per sequence_step_device, one sync at the end (ms)."""
    import torch
    pyr, x, y, v, aff, _ = pft.select_step_device(staged[0], cfg, N_FEATURES)
    for img in staged[1:warmup + 1]:
        pyr, x, y, v, aff, _, _ = pft.sequence_step_device(
            pyr, img, x, y, v, cfg, replace_lost, aff=aff)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for img in staged[warmup + 1:]:
        pyr, x, y, v, aff, _, _ = pft.sequence_step_device(
            pyr, img, x, y, v, cfg, replace_lost, aff=aff)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (len(staged) - warmup - 1)


def profile_phase(pft, cfg, frames, staged, root, tag, n_prof=30, repeats=3):
    """Where the step's time goes (``--profile``): the step time three ways,
    each repeated, then a torch.profiler trace of n_prof refill steps whose
    kernels give the device's busy time and idle share per step. The trace
    is written to build/profile/step_trace_<tag>.json."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    phase(f"profile, {tag}: step time, {repeats} repeats; then {n_prof} "
          "traced steps")
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
    pyr, x, y, v, aff, _ = pft.select_step_device(staged[0], cfg, N_FEATURES)
    for img in staged[1:11]:
        pyr, x, y, v, aff, _, _ = pft.sequence_step_device(pyr, img, x, y, v,
                                                           cfg, aff=aff)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for img in staged[11:11 + n_prof]:
            pyr, x, y, v, aff, _, _ = pft.sequence_step_device(
                pyr, img, x, y, v, cfg, aff=aff)
        torch.cuda.synchronize()
    no_standalone_k3(trace_summary(
        prof, root / "build" / "profile" / f"step_trace_{tag}.json", n_prof),
        tag)


def trace_summary(prof, out, n_steps):
    """Write the trace to ``out`` and print, per step, the device kernels,
    the device's busy time (union of kernel intervals), the span, the idle
    share and the largest device items."""
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    trace = json.loads(out.read_text())
    kern = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in trace.get("traceEvents", trace)
                  if e.get("cat") == "kernel")
    if not kern:
        fail("the profiler recorded no device kernels")
    busy, span = busy_span(kern)
    print(f"traced {n_steps} steps: {len(kern) / n_steps:.1f} device kernels "
          f"per step, device busy {busy / n_steps:.1f} us per step (union of "
          f"kernel intervals), span {span / n_steps:.1f} us per step, idle "
          f"share {1.0 - busy / span:.3f}; trace {out}")
    per_name: dict = {}
    for a, b, name in kern:
        short = name.removeprefix("void ")[:90]
        t, c = per_name.get(short, (0.0, 0))
        per_name[short] = (t + b - a, c + 1)
    for short, (t, c) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {t / n_steps:8.1f} us/step  {c / n_steps:5.1f} launches/step  "
              f"{short}")
    return kern


def busy_span(kern):
    """(busy, span) in us of sorted (start, end, name) kernel intervals:
    the union of the intervals and first start to last end."""
    busy, cur_a, cur_b = 0.0, kern[0][0], kern[0][1]
    for a, b, _ in kern[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return busy, max(b for _, b, _ in kern) - kern[0][0]


def no_standalone_k3(kern, tag):
    """Fail if a traced step ran K3's standalone kernel: every step takes
    its map from K1's level-0 launch."""
    n = sum("eig_kernel" in name for _, _, name in kern)
    print(f"standalone K3 launches (::eig_kernel) in the traced {tag} steps: "
          f"{n}")
    if n:
        fail(f"the traced {tag} steps launched K3's standalone kernel")


def profile_dense(pft, frames, root, n_prof=10):
    """Dense flow under ``--profile``: a torch.profiler trace of n_prof
    compute_dense_flow calls on the main phase's first pair
    (build/profile/dense_flow_trace.json); a "step" is one call. Each call
    must show nPyramidLevels K8 launches among its device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    phase(f"profile, dense flow: {n_prof} traced compute_dense_flow calls "
          f"({H}x{W} numpy pair)")
    for _ in range(3):
        pft.compute_dense_flow(frames[0], frames[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            pft.compute_dense_flow(frames[0], frames[1])
        torch.cuda.synchronize()
    kern = trace_summary(prof, root / "build" / "profile" /
                         "dense_flow_trace.json", n_prof)
    levels = pft.create_config().nPyramidLevels
    k8 = sum("lk_tile_kernel" in name for _, _, name in kern) / n_prof
    print(f"device kernels per compute_dense_flow call: "
          f"{len(kern) / n_prof:.1f}, of them K8 {k8:.1f} "
          f"(nPyramidLevels {levels})")
    if k8 != levels:
        fail(f"the traced dense calls ran {k8} K8 launches each")


def host_loop_times(pft, cfg, staged, warmup=10):
    """CUDA-event time of each SequenceTracker.step over the staged frames
    (ms), after ``warmup`` steps, and the tracker."""
    import torch
    st = pft.SequenceTracker(cfg, n_features=N_FEATURES, device="cuda")
    st.start(staged[0])
    events = []
    for img in staged[1:]:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st.step(img)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events[warmup:]]


def profile_host_loop(pft, cfg, staged, root, n_prof=30, repeats=3):
    """Config 2's host loop under ``--profile``: its step time beside the
    device route's, in turns, repeated; then a torch.profiler trace of
    n_prof steps (build/profile/step_trace_config2_host.json)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    phase(f"profile, config 2 host loop: step time beside the device "
          f"route's, {repeats} repeats; then {n_prof} traced steps")
    for rep in range(repeats):
        host = np.median(host_loop_times(pft, cfg, staged))
        dev_step = np.median(step_times(pft, cfg, staged))
        host2 = np.median(host_loop_times(pft, cfg, staged))
        print(f"repeat {rep}: SequenceTracker.step median {host:.4f} ms, "
              f"device-route step median {dev_step:.4f} ms, "
              f"SequenceTracker.step again {host2:.4f} ms")
    st = pft.SequenceTracker(cfg, n_features=N_FEATURES, device="cuda")
    for img in staged[:11]:
        st.step(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for img in staged[11:11 + n_prof]:
            st.step(img)
        torch.cuda.synchronize()
    no_standalone_k3(trace_summary(
        prof, root / "build" / "profile" / "step_trace_config2_host.json",
        n_prof), "config-2 host loop")


def event_ms(fn, reps: int = 10, warmup: int = 2):
    """Median CUDA-event time of fn() over reps calls, each timed on its
    own, after ``warmup`` calls (ms); the host wall median beside it."""
    import numpy as np
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev, wall = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(e0.elapsed_time(e1))
    return float(np.median(ev)), float(np.median(wall))


def dense_phase(pft, frames, ex, sparse, mods, report, dev, smi, prof_dir):
    """Dense flow (configurations a and b), dense depth (c) and sub-pixel
    refinement in the host loop (d), each through the entry points a user
    calls, with K8 and K9 against their plain versions; see the module
    docstring. ``mods`` maps kernel ids to their wrapper modules."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch.features import KLT_TRACKED
    from pyfeaturetrack_tpu_torch.ops import (cuda_lk_dense, cuda_window_terms,
                                              flow, interp)
    from pyfeaturetrack_tpu_torch.ops.flow import dense_flow_fb
    from pyfeaturetrack_tpu_torch.ops.interp import (gather_window,
                                                     upsample_flow)
    from pyfeaturetrack_tpu_torch.utils import cuda
    up_mods = (interp, flow, cuda_lk_dense)  # every name upsample_flow has

    def drive(fn, expect):
        """fn() with every count set to 0 just before and read just after;
        each kernel of ``expect`` must have launched that many times (None:
        at least once)."""
        for m in mods.values():
            m.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {k: m.launches for k, m in mods.items()}
        for k, want in expect.items():
            if counts[k] <= 0 or (want is not None and counts[k] != want):
                fail(f"{k} launched {counts[k]} times (expected "
                     f"{'some' if want is None else want})")
        return out, counts

    cfg = pft.create_config()
    k1_per_frame = min(cfg.nPyramidLevels, 2)  # a build: at most two launches

    # ---- (a) dense flow on the main phase's first pair ----
    phase(f"dense (a): compute_dense_flow, {H}x{W} pair of the main phase "
          f"(drift {DRIFT}), default config, then dense_flow_fb")
    a0, a1 = frames[0], frames[1]
    with counted(up_mods, "upsample_flow") as ups:
        fl, counts = drive(lambda: pft.compute_dense_flow(a0, a1),
                           {"K1": 2 * k1_per_frame, "K8": cfg.nPyramidLevels})
    print(f"launches in the dense-flow run: {counts}; upsample_flow calls "
          f"{len(ups)}")
    if ups:
        fail("compute_dense_flow upsampled a map outside K8")
    k8_launches = counts["K8"]
    with cuda.reference_path():
        pl = pft.compute_dense_flow(a0, a1)
    maps_equal(fl, pl, "dense flow (u, v, status)")
    st = fl.status.cpu().numpy()
    u, v = fl.u.cpu().numpy(), fl.v.cpu().numpy()
    inner = np.zeros_like(st, bool)
    inner[24:-24, 24:-24] = True
    ok = (st == KLT_TRACKED) & inner
    mu, mv = float(np.median(u[ok])), float(np.median(v[ok]))
    print(f"tracked share {float((st == KLT_TRACKED).mean()):.4f} (interior "
          f"{float(ok.sum() / inner.sum()):.4f}); median flow over tracked "
          f"interior pixels ({mu:.4f}, {mv:.4f}) px vs drift {DRIFT}; maps "
          f"equal to the plain route's")
    if abs(mu - DRIFT[0]) > DRIFT_TOL or abs(mv - DRIFT[1]) > DRIFT_TOL:
        fail("the dense flow does not recover the drift")
    p1, p2, lvl0, u1, v1 = dense_flow_levels(pft, frames, cfg, dev)
    with counted(up_mods, "upsample_flow") as ups:
        (fwd, err, valid), counts = drive(lambda: dense_flow_fb(p1, p2, cfg),
                                          {"K8": 2 * cfg.nPyramidLevels})
    if ups:
        fail("dense_flow_fb upsampled a map outside K8")
    if not torch.equal(fwd.u, fl.u):
        fail("dense_flow_fb's forward flow differs from compute_dense_flow's")
    print(f"dense_flow_fb: launches {counts}; valid share "
          f"{valid.float().mean().item():.4f}; median round-trip error "
          f"{err[valid].median().item():.5f} px")
    flow_ms, flow_wall = event_ms(lambda: pft.compute_dense_flow(a0, a1))
    print(f"compute_dense_flow ({H}x{W} numpy pair: two K1 pyramids, "
          f"{cfg.nPyramidLevels} K8 levels), median of 10: CUDA events "
          f"{flow_ms:.4f} ms, host wall {flow_wall:.4f} ms; card {smi}")

    # K8 at level 0 of (a) as the path runs it: the start upsampled from
    # the level-1 flow in the kernel; then from the plain upsample_flow's
    # maps (the map start), which must give the same maps
    s = float(cfg.subsampling)
    k8_args = (*lvl0, u1, v1, s, cfg)
    got = cuda_lk_dense.dense_level_up(*k8_args)
    with cuda.reference_path():
        want = cuda_lk_dense.dense_level_up(*k8_args)
    maps_equal(got, want, "K8 2-D level 0, upsampled start")
    maps_args = (*lvl0, upsample_flow(u1, (H, W), s),
                 upsample_flow(v1, (H, W), s), cfg)
    got_m = cuda_lk_dense.dense_level(*maps_args)
    with cuda.reference_path():
        want_m = cuda_lk_dense.dense_level(*maps_args)
    maps_equal(got_m, want_m, "K8 2-D level 0, map start")
    maps_equal(got_m, got, "K8 2-D level 0, map start vs upsampled start")
    k8_ms = time_ms(lambda: cuda_lk_dense.dense_level_up(*k8_args))
    k8_dev, _ = device_ms(lambda: cuda_lk_dense.dense_level_up(*k8_args),
                          ["::lk_tile_kernel"], prof_dir, reps=10)
    with cuda.reference_path():
        k8_plain = time_ms(lambda: cuda_lk_dense.dense_level_up(*k8_args),
                           reps=2)
    k8_w = k8_work(cfg, got[2], got[3], False, coarse=tuple(u1.shape))
    print(f"K8 2-D level 0 ({H * W} pixels, {iteration_line(got[3])}, max "
          f"{int(got[3].max().item())}): kernel {k8_ms:.4f} ms by events, "
          f"{k8_dev:.4f} ms device, plain {k8_plain:.4f} ms, bound "
          f"{bound_ms(*k8_w)[0]:.5f} ms ({bound_ms(*k8_w)[1]}); bit-equal")

    # ---- (b) example 9's pair ----
    phase("dense (b): compute_dense_flow on examples/data/img0.pgm -> "
          "img1.pgm (example 9)")
    fl9 = pft.compute_dense_flow(*ex)
    with cuda.reference_path():
        pl9 = pft.compute_dense_flow(*ex)
    maps_equal(fl9, pl9, "example 9 dense flow")
    st9 = fl9.status.cpu().numpy()
    t9 = st9 == KLT_TRACKED
    sel, trk = sparse
    sok = (trk.val == KLT_TRACKED).cpu().numpy()
    sdx = (trk.x - sel.x).cpu().numpy()[sok]
    sdy = (trk.y - sel.y).cpu().numpy()[sok]
    print(f"dense flow: {t9.mean():.1%} of pixels tracked; median flow "
          f"(tracked) ({np.median(fl9.u.cpu().numpy()[t9]):+.2f}, "
          f"{np.median(fl9.v.cpu().numpy()[t9]):+.2f}); sparse median "
          f"displacement ({int(sok.sum())} features) ({np.median(sdx):+.2f}, "
          f"{np.median(sdy):+.2f}); maps equal to the plain route's")

    # ---- (c) dense depth ----
    b0, b1, y0, y1 = STEREO_BOX_SPAN
    phase(f"dense (c): dense_depth, rectified {H}x{W} pair, background at "
          f"disparity {STEREO_BG}, box at {STEREO_BOX}, max_disparity 64")
    left, right, _ = make_stereo_pair()
    K = np.array([[500.0, 0.0, W / 2], [0.0, 500.0, H / 2], [0.0, 0.0, 1.0]])
    baseline = 0.1
    with counted(up_mods, "upsample_flow") as ups:
        (depth, d, vmask), counts = drive(
            lambda: pft.dense_depth(left, right, K, baseline,
                                    max_disparity=64.0),
            {"K1": 4 * k1_per_frame, "K8": 2 * cfg.nPyramidLevels})
    print(f"launches in the dense-depth run: {counts}; upsample_flow calls "
          f"{len(ups)}")
    if ups:
        fail("dense_depth upsampled a map outside K8")
    with cuda.reference_path():
        plain_depth = pft.dense_depth(left, right, K, baseline,
                                      max_disparity=64.0)
    maps_equal((depth, d, vmask), plain_depth, "dense depth (depth, d, valid)")
    bg = np.zeros_like(vmask)
    bg[24:-24, 24:b0 - 8] = True
    box = np.zeros_like(vmask)
    box[y0 + 16:y1 - 16, b0 + STEREO_BOX + 16:b1 + STEREO_BOX - 16] = True
    occ = np.zeros_like(vmask)
    occ[y0 + 16:y1 - 16, b0 + STEREO_BG + 4:b0 + STEREO_BOX - 4] = True
    med_bg = float(np.median(d[bg & vmask]))
    med_box = float(np.median(d[box & vmask]))
    occ_invalid = 1.0 - float(vmask[occ].mean())
    fx = K[0, 0]
    print(f"valid share {vmask.mean():.4f} (background interior "
          f"{vmask[bg].mean():.4f}, box interior {vmask[box].mean():.4f}); "
          f"median disparity: background {med_bg:.4f} (true {STEREO_BG}), "
          f"box {med_box:.4f} (true {STEREO_BOX}); median depth background "
          f"{np.median(depth[bg & vmask]):.4f} (true "
          f"{fx * baseline / STEREO_BG:.4f}), box "
          f"{np.median(depth[box & vmask]):.4f} (true "
          f"{fx * baseline / STEREO_BOX:.4f}); occluded band invalid "
          f"{occ_invalid:.4f}; maps equal to the plain route's")
    if abs(med_bg - STEREO_BG) > 0.1 or abs(med_box - STEREO_BOX) > 0.1:
        fail("dense depth does not recover the planes' disparities")
    if occ_invalid <= 0.5:
        fail("the occluded band is not mostly invalid")
    depth_ms, depth_wall = event_ms(lambda: pft.dense_depth(
        left, right, K, baseline, max_disparity=64.0), reps=5, warmup=1)
    print(f"dense_depth (four K1 pyramids, SSD sweep, {2 * cfg.nPyramidLevels}"
          f" K8 1-D levels, LR gate, maps to the host), median of 5: CUDA "
          f"events {depth_ms:.4f} ms, host wall {depth_wall:.4f} ms; card {smi}")

    # K8 1-D at level 0 of (c) as the path runs it: the start upsampled from
    # the level-1 disparity (refined from the seed sweep) in the kernel; then
    # from the plain upsample_flow's map
    lvl0_d, d1 = dense_depth_levels(pft, cfg, dev)
    k8d_args = (*lvl0_d, d1, s, cfg)
    got = cuda_lk_dense.dense_level_1d_up(*k8d_args)
    with cuda.reference_path():
        want = cuda_lk_dense.dense_level_1d_up(*k8d_args)
    maps_equal(got, want, "K8 1-D level 0, upsampled start")
    d_args = (*lvl0_d, upsample_flow(d1, (H, W), s), cfg)
    got_m = cuda_lk_dense.dense_level_1d(*d_args)
    with cuda.reference_path():
        want_m = cuda_lk_dense.dense_level_1d(*d_args)
    maps_equal(got_m, want_m, "K8 1-D level 0, map start")
    maps_equal(got_m, got, "K8 1-D level 0, map start vs upsampled start")
    k8d_ms = time_ms(lambda: cuda_lk_dense.dense_level_1d_up(*k8d_args))
    k8d_dev, _ = device_ms(lambda: cuda_lk_dense.dense_level_1d_up(*k8d_args),
                           ["::lk_tile_kernel"], prof_dir, reps=10)
    with cuda.reference_path():
        k8d_plain = time_ms(
            lambda: cuda_lk_dense.dense_level_1d_up(*k8d_args), reps=2)
    k8d_w = k8_work(cfg, got[1], got[2], True, coarse=tuple(d1.shape))
    print(f"K8 1-D level 0 ({H * W} pixels, {iteration_line(got[2])}, max "
          f"{int(got[2].max().item())}): kernel {k8d_ms:.4f} ms by events, "
          f"{k8d_dev:.4f} ms device, plain {k8d_plain:.4f} ms, bound "
          f"{bound_ms(*k8d_w)[0]:.5f} ms ({bound_ms(*k8d_w)[1]}); bit-equal")
    report["K8"] = dict(max_abs_err=0.0, ms=k8_ms, plain_ms=k8_plain,
                        device_ms=k8_dev,
                        work=k8_w, launches=k8_launches,
                        ms_1d=k8d_ms, device_ms_1d=k8d_dev,
                        plain_ms_1d=k8d_plain, work_1d=k8d_w)

    # ---- K9 at the main phase's 1000 features and on a status mix ----
    phase("K9 window terms: 1000 selected features of the main pair, "
          "level 0; a mix with lanes beyond every edge")
    feats, mix = report.pop("K9_inputs")
    k9_cases = {}
    for name, (pa, pb, xa, ya, xb, yb) in (("main pair", feats),
                                           ("edge mix", mix)):
        ww, wh = cfg.window_width, cfg.window_height
        w1, g1x, g1y = (gather_window(im, xa, ya, ww // 2, wh // 2).contiguous()
                        for im in (pa.img[0], pa.gradx[0], pa.grady[0]))
        args = (pb.img[0], pb.gradx[0], pb.grady[0], w1, g1x, g1y, xb, yb)
        kw = dict(hw=ww // 2, hh=wh // 2, step_factor=cfg.step_factor)
        if name == "main pair":
            got, counts = drive(lambda: cuda_window_terms.window_terms(
                *args, **kw), {"K9": 1})
            k9_launches = counts["K9"]
        else:
            got = cuda_window_terms.window_terms(*args, **kw)
        with cuda.reference_path():
            want = cuda_window_terms.window_terms(*args, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        clamped = int(((xb < ww // 2) | (xb > W - ww // 2 - 1.001) |
                       (yb < wh // 2) | (yb > H - wh // 2 - 1.001)).sum().item())
        print(f"K9 {name}: {xb.shape[0]} lanes ({clamped} clamped), "
              f"bit-equal {same}")
        if not same:
            fail(f"K9 ({name}) differs from its plain version")
        k9_cases[name] = (args, kw)
    # windows above 256 pixels (walked pixel by pixel) on the main pair
    pa, pb, xa, ya, xb, yb = feats
    for k in (17, 25, 31, 51):
        w1, g1x, g1y = (gather_window(im, xa, ya, k // 2, k // 2).contiguous()
                        for im in (pa.img[0], pa.gradx[0], pa.grady[0]))
        wargs = (pb.img[0], pb.gradx[0], pb.grady[0], w1, g1x, g1y, xb, yb)
        wkw = dict(hw=k // 2, hh=k // 2, step_factor=cfg.step_factor)
        got = cuda_window_terms.window_terms(*wargs, **wkw)
        with cuda.reference_path():
            want = cuda_window_terms.window_terms(*wargs, **wkw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"K9 main pair, {k}x{k} window: bit-equal {same}")
        if not same:
            fail(f"K9 ({k}x{k} window) differs from its plain version")
    args, kw = k9_cases["main pair"]
    k9_ms = time_ms(lambda: cuda_window_terms.window_terms(*args, **kw))
    k9_dev, _ = device_ms(lambda: cuda_window_terms.window_terms(*args, **kw),
                          ["::window_terms_kernel"], prof_dir)
    with cuda.reference_path():
        k9_plain = time_ms(lambda: cuda_window_terms.window_terms(*args, **kw))
    k9_w = k9_work(args[-1].shape[0], cfg.window_width, cfg.window_height,
                   H * W)
    print(f"K9, 1000 features: kernel {k9_ms:.4f} ms by events, "
          f"{k9_dev:.4f} ms device, plain {k9_plain:.4f} ms, bound "
          f"{bound_ms(*k9_w)[0]:.6f} ms ({bound_ms(*k9_w)[1]})")
    # the card's floor for one small kernel: a one-element fill
    one = torch.zeros(1, device=dev)
    floor_dev, _ = device_ms(lambda: one.fill_(1), ["FillFunctor"], prof_dir)
    # K9 at 65,536 features on the same frame: frame-1 windows at seeded
    # positions over the whole frame, frame-2 positions at the drift (lanes
    # past the right and bottom edges are clamped in)
    rng9 = np.random.default_rng(SEED + 9)
    n_big = 65536
    xa, ya = (torch.as_tensor(rng9.uniform(0, hi, n_big), dtype=torch.float32,
                              device=dev) for hi in (W - 1, H - 1))
    xb, yb = xa + DRIFT[0], ya + DRIFT[1]
    ww, wh = cfg.window_width, cfg.window_height
    w1, g1x, g1y = (gather_window(im, xa, ya, ww // 2, wh // 2).contiguous()
                    for im in (pa.img[0], pa.gradx[0], pa.grady[0]))
    bargs = (pb.img[0], pb.gradx[0], pb.grady[0], w1, g1x, g1y, xb, yb)
    got = cuda_window_terms.window_terms(*bargs, **kw)
    with cuda.reference_path():
        want = cuda_window_terms.window_terms(*bargs, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"K9, {n_big} features: bit-equal {same}")
    if not same:
        fail(f"K9 ({n_big} features) differs from its plain version")
    def big():
        return cuda_window_terms.window_terms(*bargs, **kw)

    # its inputs (about 44 MB) fit the card's 50 MB L2, so back-to-back
    # calls may find them there: device time warm (three readings of 20
    # calls) and cold (a 128 MB read before each call evicts them)
    scrub = torch.zeros(32 << 20, device=dev)
    big_ms = time_ms(big)
    big_warm = [device_ms(big, ["::window_terms_kernel"], prof_dir)[0]
                for _ in range(3)]
    big_dev = big_warm[0]
    big_cold, _ = device_ms(lambda: (scrub.sum(), big()),
                            ["::window_terms_kernel"], prof_dir)
    del scrub
    with cuda.reference_path():
        big_plain = time_ms(big, reps=5)
    big_b = bound_ms(*k9_work(n_big, ww, wh, H * W))
    print(f"K9, {n_big} features: kernel {big_ms:.4f} ms by events, "
          f"device {', '.join(f'{t:.4f}' for t in big_warm)} ms back to "
          f"back, {big_cold:.4f} ms with L2 evicted before each call, plain "
          f"{big_plain:.4f} ms, bound {big_b[0]:.6f} ms ({big_b[1]}); "
          f"one-element fill (the card's floor for one small kernel) "
          f"{floor_dev:.4f} ms device")
    report["K9"] = dict(max_abs_err=0.0, ms=k9_ms, plain_ms=k9_plain,
                        device_ms=k9_dev,
                        work=k9_w, launches=k9_launches,
                        floor_device_ms=floor_dev, n65536_ms=big_ms,
                        n65536_device_ms=big_dev,
                        n65536_cold_device_ms=big_cold,
                        n65536_plain_ms=big_plain,
                        n65536_bound_ms=big_b[0], n65536_bound_by=big_b[1])

    # ---- (d) config 2 with sub-pixel refinement ----
    phase(f"dense (d): track_sequence(subpixel_refine=True), "
          f"{N_PLAIN_FRAMES} frames of the main phase, {N_FEATURES} features")
    kcfg = cfg.replace(sequentialMode=True)
    (ft, _), counts = drive(lambda: pft.track_sequence(
        frames[:N_PLAIN_FRAMES], cfg=kcfg, n_features=N_FEATURES,
        subpixel_refine=True, device="cuda"),
        {"K1": None, "K2": None, "K3": None, "K5": None})
    print(f"launches in the refine run: {counts}")
    with cuda.reference_path():
        pft_, _ = pft.track_sequence(frames[:N_PLAIN_FRAMES], cfg=kcfg,
                                     n_features=N_FEATURES,
                                     subpixel_refine=True, device="cuda")
    maps_equal(tuple(ft), tuple(pft_), "the refine table (x, y, val)")
    x0 = ft.x[0]
    frac = (x0 != torch.round(x0)).float().mean().item()
    off = (ft.x[0] - torch.round(ft.x[0])).abs()
    print(f"first frame: {frac:.1%} of the refined x off the integers (median "
          f"|x - round(x)| {off.median().item():.4f} px); live in the last "
          f"frame {int((ft.val[-1] >= 0).sum().item())}; table equal to the "
          f"plain route's")
    if frac < 0.5:
        fail("sub-pixel refinement left the first frame's features on integers")


# the k of the captured chain on the serving path, and the streams of the
# batched phase
CHAIN = 8
N_STREAMS = 8
STREAM_TICKS = 1 + 5 * CHAIN
# the port's kernels on the sparse step (K1's two launches, K2, K4's two
# stages, K6's stage): a replay must launch each as often as the eager step
STEP_KERNELS = ("level0_kernel", "coarse_kernel", "lk_pyramid_kernel",
                "lattice_kernel", "chain_kernel", "stage_kernel")


def tables_equal(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def chain_event_ms(pft, cfg, frames, staged0, k=CHAIN, skip=2):
    """CUDA-event ms per frame of each sequence_chain_device call over
    ``frames`` (tensors on the card, or host arrays: the pinned path),
    after ``skip`` calls."""
    import torch
    pyr, x, y, v, aff, _ = pft.select_step_device(staged0, cfg, N_FEATURES)
    events = []
    for i in range(1, len(frames) - k + 1, k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        pyr, _, (x, y, v), aff, _, _ = pft.sequence_chain_device(
            pyr, frames[i:i + k], x, y, v, cfg, aff=aff)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) / k for a, b in events[skip:]]


def serving_traces(pft, cfg, staged, root, tag, k=CHAIN, n_chains=3):
    """torch.profiler traces of n_chains * k frames through the eager step
    and through chain replays (build/profile/serving_<tag>_{eager,chain}
    .json): device kernels per frame, busy time and idle share, and the
    port's kernels per frame of each (they must agree)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    n = n_chains * k
    out = {}
    for route in ("eager", "chain"):
        state = list(pft.select_step_device(staged[0], cfg, N_FEATURES)[:5])

        def advance(imgs):
            pyr, x, y, v, aff = state
            if route == "eager":
                for img in imgs:
                    pyr, x, y, v, aff, _, _ = pft.sequence_step_device(
                        pyr, img, x, y, v, cfg, aff=aff)
            else:
                for i in range(0, len(imgs), k):
                    pyr, _, (x, y, v), aff, _, _ = pft.sequence_chain_device(
                        pyr, imgs[i:i + k], x, y, v, cfg, aff=aff)
            state[:] = [pyr, x, y, v, aff]

        advance(staged[1:1 + k])          # the graph is cached by now
        torch.cuda.synchronize()
        # the profiler's first window only warms it up (it can miss the
        # first launches after it starts): k frames there, n recorded
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            advance(staged[1 + k:1 + 2 * k])
            torch.cuda.synchronize()
            prof.step()
            advance(staged[1 + 2 * k:1 + 2 * k + n])
            torch.cuda.synchronize()
            prof.step()
        print(f"{tag}, {route}:")
        kern = trace_summary(prof, root / "build" / "profile" /
                             f"serving_{tag}_{route}.json", n)
        no_standalone_k3(kern, f"{tag} {route}")
        busy, span = busy_span(kern)
        out[route] = dict(
            kernels=len(kern) / n, busy_us=busy / n,
            idle=1.0 - busy / span,
            port={name: sum(name in e[2] for e in kern) / n
                  for name in STEP_KERNELS})
    return out


def serving_phase(pft, path_mods, k6, frames, sim, tables, cfg, cfg3,
                  staged, staged3, smi, root):
    """The serving and long-video path (ROADMAP Queue 1 items 1, 3 and 4):
    (a) the captured chain against the eager steps, (b) kernels per frame
    in a replay's trace, (c) times, (d) serve_stream, (e) FrameLoader,
    (f) batched streams, (g) chunked lockstep. Returns the numbers."""
    import shutil

    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch.models import device_sequence as ds
    from pyfeaturetrack_tpu_torch.utils.io import pgm_write
    report = {}
    configs = (("default", cfg, frames, staged),
               ("config 3", cfg3, sim, staged3))

    phase(f"serving (a): track_sequence_device(chain={CHAIN}) against "
          f"chain=1, {N_FRAMES} frames, both configs; two "
          "sequence_chain_device calls")
    for tag, c, fr, _ in configs:
        t0 = time.perf_counter()
        got = pft.track_sequence_device(fr, cfg=c, n_features=N_FEATURES,
                                        chain=CHAIN)
        wall = time.perf_counter() - t0
        same = tables_equal(got, tables[tag])
        print(f"{tag}: chain={CHAIN} table (12 replays and 3 eager tail "
              f"steps, numpy uint8 frames through the pinned buffer; "
              f"{wall:.2f} s with the capture) equal to chain=1's: {same}")
        if not same:
            fail(f"the captured chain differs from the eager steps ({tag})")
    pyr, x, y, v, aff, _ = pft.select_step_device(staged3[0], cfg3,
                                                  N_FEATURES)
    first = pft.sequence_chain_device(pyr, staged3[1:1 + CHAIN], x, y, v,
                                      cfg3, aff=aff)
    held = [*first[1], *first[2], *first[3], first[4], *first[0].img,
            *first[0].gradx, *first[0].grady]
    kept = [t.clone() for t in held]
    second = pft.sequence_chain_device(first[0],
                                       staged3[1 + CHAIN:1 + 2 * CHAIN],
                                       *first[2], cfg3, aff=first[3])
    torch.cuda.synchronize()
    unchanged = all(torch.equal(a, b) for a, b in zip(held, kept))
    moved = not torch.equal(second[1][0], first[1][0])
    print(f"config 3: the first call's {len(held)} outputs unchanged by the "
          f"second call: {unchanged}; the second call's history differs: "
          f"{moved}; graphs cached: {len(ds._GRAPHS)}")
    if not (unchanged and moved):
        fail("a chain call changed an earlier call's outputs")

    phase(f"serving (b), (c): the eager step and the chain (k={CHAIN}) "
          "traced and timed")
    for tag, c, fr, st in configs:
        # the profiler can lose a kernel's records (PERF.md section 7): a
        # pair of traces whose counts disagree is taken again, twice at most
        for attempt in range(3):
            traces = serving_traces(pft, c, st, root, tag.replace(" ", ""))
            eager, chained = traces["eager"], traces["chain"]
            print(f"{tag}: device kernels per frame, eager "
                  f"{eager['kernels']:.2f}, chain {chained['kernels']:.2f}; "
                  f"the port's kernels per frame, eager {eager['port']}, "
                  f"chain {chained['port']}")
            # beside the step's kernels a replay runs one reduction of the
            # steps' exhausted flags (a cat and an any) per chain
            if (eager["port"] == chained["port"] and chained["kernels"]
                    == eager["kernels"] + 2 / CHAIN):
                break
            print(f"the traces' kernel counts disagree (attempt "
                  f"{attempt + 1})")
        else:
            fail(f"a replay runs other kernels than the eager step ({tag})")
        step = step_times(pft, c, st)
        dev_chain = chain_event_ms(pft, c, st, st[0])
        host_chain = chain_event_ms(pft, c, fr, st[0])
        rep = dict(eager_ms=float(np.median(step)),
                   eager_ms_range=[min(step), max(step)],
                   chain_ms=float(np.median(dev_chain)),
                   chain_ms_range=[min(dev_chain), max(dev_chain)],
                   chain_host_uint8_ms=float(np.median(host_chain)),
                   eager_busy_us=eager["busy_us"], eager_idle=eager["idle"],
                   chain_busy_us=chained["busy_us"],
                   chain_idle=chained["idle"],
                   eager_kernels=eager["kernels"],
                   chain_kernels=chained["kernels"])
        report[tag] = rep
        print(f"{tag}: per frame by CUDA events, eager step median "
              f"{rep['eager_ms']:.4f} ms ({min(step):.4f}-{max(step):.4f}, "
              f"{len(step)} steps); chain of {CHAIN} median "
              f"{rep['chain_ms']:.4f} ms ({min(dev_chain):.4f}-"
              f"{max(dev_chain):.4f}, frames on the card), "
              f"{rep['chain_host_uint8_ms']:.4f} ms (numpy uint8 frames, "
              f"pinned staging in the graph); device busy "
              f"{eager['busy_us']:.1f} us eager, {chained['busy_us']:.1f} us "
              f"chain; idle share {eager['idle']:.3f} eager, "
              f"{chained['idle']:.3f} chain; card {smi}")

    phase(f"serving (d): serve_stream(chain={CHAIN}, prefetch=2, "
          "stage_uint8=True) against track_sequence_device")
    for tag, c, fr, _ in configs:
        pmods = dict(path_mods, **({"K6": k6} if tag == "config 3" else {}))
        pft.serve_stream(fr[:1 + CHAIN], cfg=c, n_features=N_FEATURES,
                         chain=CHAIN, prefetch=2, stage_uint8=True)
        for m in pmods.values():
            m.launches = 0
        t0 = time.perf_counter()
        got = pft.serve_stream(fr, cfg=c, n_features=N_FEATURES,
                               chain=CHAIN, prefetch=2, stage_uint8=True)
        wall = time.perf_counter() - t0
        counts = path_counts(pmods, f"serving path ({tag})")
        expect = {"K1": 2 * N_FRAMES, "K2": N_FRAMES - 1, "K3": N_FRAMES,
                  "K4": 2 * N_FRAMES}
        if tag == "config 3":
            expect["K6"] = N_FRAMES - 1
        expect_launches(counts, expect, f"serving path ({tag})")
        same = tables_equal(got, tables[tag])
        report[tag].update(serve_launches=counts, serve_wall_s=wall)
        print(f"{tag}: launches in the serve_stream run {counts} ({wall:.3f} "
              f"s wall, {N_FRAMES / wall:.1f} frames/s from numpy frames); "
              f"table equal to track_sequence_device's: {same}")
        if not same:
            fail(f"serve_stream differs from track_sequence_device ({tag})")

    phase(f"serving (e): the {N_FRAMES} default frames as PGM files through "
          "FrameLoader into serve_stream")
    folder = root / "build" / "serving_frames"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    try:
        paths = []
        for i, fr in enumerate(frames):
            paths.append(folder / f"frame{i:04d}.pgm")
            pgm_write(paths[-1], fr)
        t0 = time.perf_counter()
        got = pft.serve_stream(pft.FrameLoader(paths), cfg=cfg,
                               n_features=N_FEATURES, chain=CHAIN,
                               prefetch=2, stage_uint8=True)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    same = tables_equal(got, tables["default"])
    print(f"FrameLoader -> serve_stream: {wall:.3f} s wall for {N_FRAMES} "
          f"files; table equal to (d)'s: {same}")
    if not same:
        fail("the loader's frames track differently")

    phase(f"serving (f): BatchedStreamingTracker, {N_STREAMS} streams of "
          f"their own seeded crops, {STREAM_TICKS} ticks, chain={CHAIN}, "
          "against separate StreamingTrackers")
    streams = [make_frames(STREAM_TICKS, seed=SEED + 10 + b)
               for b in range(N_STREAMS)]
    singles = []
    for s in streams:
        tr = pft.StreamingTracker(cfg, n_features=N_FEATURES, chain=CHAIN)
        for f in s:
            tr.feed(f)
        singles.append(tr.table())
    batches = [np.stack([s[i] for s in streams]) for i in range(STREAM_TICKS)]

    def batched():
        bt = pft.BatchedStreamingTracker(cfg, n_streams=N_STREAMS,
                                         n_features=N_FEATURES, chain=CHAIN)
        bt.feed(batches[0])
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for b in batches[1:]:
            bt.feed(b)
        e1.record()
        bt.block()
        return bt.table(), e0.elapsed_time(e1)

    batched()                       # capture
    fps = []
    for _ in range(3):
        table, ms = batched()
        fps.append(N_STREAMS * (STREAM_TICKS - 1) / ms * 1e3)
    same = all(tables_equal([t[:, b] for t in table], singles[b])
               for b in range(N_STREAMS))
    report["batched"] = dict(streams=N_STREAMS, ticks=STREAM_TICKS,
                             frames_per_s=fps)
    print(f"batched table ({table[0].shape}) equal to {N_STREAMS} separate "
          f"trackers: {same}; aggregate frames/s by events (ticks 1-"
          f"{STREAM_TICKS - 1}, numpy uint8 batches fed and staged): "
          + ", ".join(f"{f:.1f}" for f in fps) + f"; card {smi}")
    if not same:
        fail("the batched streams differ from separate trackers")

    phase(f"serving (g): track_sequence_chunked(batched=True, n_chunks=4, "
          f"chain={CHAIN}) against batched=False, {N_FRAMES} frames")
    t0 = time.perf_counter()
    lock, _, _ = pft.track_sequence_chunked(frames, n_features=N_FEATURES,
                                            n_chunks=4, batched=True,
                                            chain=CHAIN)
    t1 = time.perf_counter()
    serial, _, _ = pft.track_sequence_chunked(frames, n_features=N_FEATURES,
                                              n_chunks=4)
    t2 = time.perf_counter()
    same = all(np.array_equal(lock[k], serial[k]) for k in ("x", "y", "val"))
    print(f"lockstep table {lock['x'].shape} ({t1 - t0:.2f} s with the "
          f"capture) equal to the serial chunks' ({t2 - t1:.2f} s): {same}")
    if not same:
        fail("the chunked lockstep differs from the serial chunks")
    return report


# ---- the SfM back end and monocular VO (BASELINE config 5) ----

GUIDED_GAP = 15           # frames between the guided pair: (30, 15) px
VO_FRAMES, VO_KF_EVERY, VO_FEATURES = 100, 3, 100
CIRCUIT_FRAMES = 260
BA_CAMS, BA_POINTS, BA_ITERS = 20, 2000, 8
STEREO_BASELINE = 0.3
STEREO_MAX_DISPARITY = 40.0
VO_H, VO_W = 240, 320     # the VO's frames
VO_CHECK_FRAMES = 30      # a corridor that bootstraps, held to the plain run
VO_LANES = (37, 120)      # guided round trips: a few and all the features
GUIDED_VO_GAP = 6         # circuit frames between a guided pair


def guided_case(pft, cuda_lk, cuda, pa, pb, x, y, val, xi, yi, c, name):
    """K2 with guided starts against its plain level loop, bit for bit,
    one launch counted as guided. Returns the kernel's (x, y, val)."""
    import numpy as np
    import torch
    before, guided = cuda_lk.launches, cuda_lk.guided_launches
    got = cuda_lk.track_pyramid(pa, pb, x, y, val, c, xi, yi)
    if (cuda_lk.launches, cuda_lk.guided_launches) != (before + 1,
                                                       guided + 1):
        fail(f"guided track_pyramid ({name}) did not launch once as guided")
    with cuda.reference_path():
        want = cuda_lk.track_pyramid(pa, pb, x, y, val, c, xi, yi)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    codes = got[2][val >= 0].cpu().numpy()
    print(f"K2 guided, {name} ({c.nPyramidLevels} levels, subsampling "
          f"{c.subsampling}): final statuses (0,-1..-5) "
          f"{np.bincount(-codes, minlength=6).tolist()}, bit-equal {same}")
    if not same:
        fail(f"K2 with guided starts ({name}) differs from its plain version")
    return got


def guided_k2(pft, cuda_lk, cuda, frames, cfg, cfg3, dev, smi, prof_dir):
    """(a): K2's guided entry at 480x640 / 1000 features, starts 20-40 px
    from the anchors, on the default and config-3 pyramids: the drift
    pair (frames 0 and GUIDED_GAP: the texture moved 30 px right, 15 down;
    starts within 2 px of it) and the status mix (starts 20-40 px off in
    any direction). Returns the K2-guided report entry."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 10)
    n = N_FEATURES
    dx, dy = DRIFT[0] * GUIDED_GAP, DRIFT[1] * GUIDED_GAP
    mix0, mix1 = make_status_mix()
    entry = None
    for tag, c in (("default", cfg), ("config 3", cfg3)):
        c = c.validated_window()
        pairs = {
            "drift pair": [torch.as_tensor(f, device=dev).to(torch.float32)
                           for f in (frames[0], frames[GUIDED_GAP])],
            "status mix": [torch.as_tensor(f, device=dev)
                           for f in (mix0, mix1)]}
        for name, (fa, fb) in pairs.items():
            pa, pb = (pft.build_track_pyramids(f, c) for f in (fa, fb))
            x = rng.uniform(-3.0, W + 3.0, n)
            y = rng.uniform(-3.0, H + 3.0, n)
            if name == "drift pair":
                xi = x + dx + rng.uniform(-2.0, 2.0, n)
                yi = y + dy + rng.uniform(-2.0, 2.0, n)
            else:
                ang = rng.uniform(0.0, 2 * np.pi, n)
                r = rng.uniform(20.0, 40.0, n)
                xi, yi = x + r * np.cos(ang), y + r * np.sin(ang)
            val = np.where(rng.uniform(size=n) < 0.1, -1, 0)
            t = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (x, y, xi, yi)]
            v = torch.as_tensor(val, dtype=torch.int32, device=dev)
            got = guided_case(pft, cuda_lk, cuda, pa, pb, t[0], t[1], v,
                              t[2], t[3], c, f"{tag}, {name}")
            if name != "drift pair" or tag != "default":
                continue
            ok = got[2] == 0
            err = (got[0][ok] - t[0][ok] - dx).abs().median().item()
            print(f"drift pair: {int(ok.sum())} of {n} tracked across the "
                  f"({dx}, {dy}) px shift, median x error {err:.4f} px")
            if int(ok.sum()) < n // 2 or err > DRIFT_TOL:
                fail("guided K2 did not recover the 30 px shift")
            live = v >= 0
            work = [0.0, 0.0]
            for r, args, lg, lw in k2_levels(pa, pb, t[0], t[1], live, c,
                                             cuda_lk, cuda.reference_path,
                                             starts=(t[2], t[3])):
                if not all(torch.equal(a, b) for a, b in zip(lg, lw)):
                    fail(f"K2 guided level {r} differs from its plain "
                         "version")
                lw_ = k2_work(c, args[-1], lg[3])
                work = [work[0] + lw_[0], work[1] + lw_[1]]
            call = (pa, pb, t[0], t[1], v, c, t[2], t[3])
            free = (pa, pb, t[0], t[1], v, c)
            ms = time_ms(lambda: cuda_lk.track_pyramid(*call))
            free_ms = time_ms(lambda: cuda_lk.track_pyramid(*free))
            dev_ms, _ = device_ms(lambda: cuda_lk.track_pyramid(*call),
                                  ["::lk_pyramid_kernel"], prof_dir)
            free_dev, _ = device_ms(lambda: cuda_lk.track_pyramid(*free),
                                    ["::lk_pyramid_kernel"], prof_dir)
            with cuda.reference_path():
                plain_ms = time_ms(lambda: cuda_lk.track_pyramid(*call),
                                   reps=5)
            print(f"K2 guided track call (drift pair, {n} features): "
                  f"{ms:.4f} ms by events, {dev_ms:.4f} ms device; the same "
                  f"lanes start-free {free_ms:.4f} ms by events, "
                  f"{free_dev:.4f} ms device; plain {plain_ms:.4f} ms; "
                  f"card {smi}")
            entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         device_ms=dev_ms, start_free_ms=free_ms,
                         start_free_device_ms=free_dev, work=tuple(work))
    return entry


def guided_vo_cases(pft, cuda_lk, cuda, dev):
    """(a) at the VO's size: K2's guided entry as loop closure,
    relocalization and stereo call it (240x320), bit-equal to its plain
    version in both directions of each round trip (sfm/loop.guided_retrack:
    forward from the prior, then back from the forward result with the
    anchors as starts). Loop closure and relocalization: the circuit's
    robust config (lighting-insensitive residuals) on circuit frames 0 and
    GUIDED_VO_GAP with their photometric drift, VO_LANES landmarks
    projected into frame 0, starts at the anchors (relocalization's prior)
    and at the landmarks' projections into the second frame (loop
    closure's). Stereo: the VO's default config on the stereo scene's
    left and right views, 120 lanes, hypotheses 0-40 px. Returns the
    number of guided calls checked."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.utils import synthscene

    def t32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    def visible(K, R, t, pts, n):
        """Pixels of up to n points in view (a spread over the list)."""
        Xc = pts @ R.T + t
        uv = (Xc @ K.T)[:, :2] / Xc[:, 2:]
        idx = np.nonzero((Xc[:, 2] > 0.1) & (uv[:, 0] > 8)
                         & (uv[:, 0] < VO_W - 9) & (uv[:, 1] > 8)
                         & (uv[:, 1] < VO_H - 9))[0]
        return idx[::max(1, len(idx) // n)][:n]

    def round_trip(pa, pb, xa, ya, xi, yi, c, name):
        val = torch.zeros(xa.shape[0], dtype=torch.int32, device=dev)
        fx, fy, fv = guided_case(pft, cuda_lk, cuda, pa, pb, xa, ya, val,
                                 xi, yi, c, f"{name}, forward")
        guided_case(pft, cuda_lk, cuda, pb, pa, fx, fy, fv, xa, ya, c,
                    f"{name}, back")
        return 2

    calls = 0
    g = GUIDED_VO_GAP
    K, Rs, ts, _, pts = synthscene.circuit_scene(CIRCUIT_FRAMES, VO_H, VO_W)
    frames = synthscene.apply_photometric_drift(synthscene.render_blobs(
        K, Rs[:g + 1], ts[:g + 1], pts, VO_H, VO_W))
    robust = sfm.VisualOdometry(K, robust=True, device=dev)._tracker_cfg()
    pa, pb = (pft.build_track_pyramids(t32(frames[i]), robust)
              for i in (0, g))
    for n in VO_LANES:
        sel = visible(K, Rs[0], ts[0], pts, n)
        uva = (pts[sel] @ Rs[0].T + ts[0]) @ K.T
        uvb = (pts[sel] @ Rs[g].T + ts[g]) @ K.T
        xa, ya = t32(uva[:, 0] / uva[:, 2]), t32(uva[:, 1] / uva[:, 2])
        priors = {"identity prior": (xa, ya),
                  "projected prior": (t32(uvb[:, 0] / uvb[:, 2]),
                                      t32(uvb[:, 1] / uvb[:, 2]))}
        for prior, (xi, yi) in priors.items():
            calls += round_trip(pa, pb, xa, ya, xi, yi, robust,
                                f"240x320 robust, {len(sel)} lanes, {prior}")
    K, render, pts = stereo_scene()
    c0 = np.zeros(3)
    default = sfm.VisualOdometry(K, device=dev)._tracker_cfg()
    pl, pr = (pft.build_track_pyramids(t32(render(c)), default)
              for c in (c0, c0 + [STEREO_BASELINE, 0, 0]))
    sel = visible(K, np.eye(3), -c0, pts, 120)
    uv = (pts[sel] - c0) @ K.T
    xl, yl = t32(uv[:, 0] / uv[:, 2]), t32(uv[:, 1] / uv[:, 2])
    for d0 in np.arange(0.0, STEREO_MAX_DISPARITY + 1e-6, 10.0):
        calls += round_trip(pl, pr, xl, yl, xl - float(d0), yl, default,
                            f"240x320 stereo, {len(sel)} lanes, "
                            f"hypothesis {d0:g} px")
    return calls


def vo_route_checks(pft, cuda_lk, cuda, dev, smi):
    """The VO's tracking at its own size (240x320, VO_FEATURES features),
    kernels against plain versions, bit for bit: select_step_device, then
    sequence_step_device over a VO_CHECK_FRAMES-frame corridor with the
    device_loop config (K1 with K3's map, K2, K4), and a chain of
    VO_KF_EVERY frames equal to its steps; then run_vo_on_corridor over
    those frames on each route (the host route: K1's eig-only launch, K2,
    K4's stage A, K5), with kernels and with plain versions: the same
    events, poses and landmarks."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.utils import synthscene
    n, k = VO_CHECK_FRAMES, VO_KF_EVERY
    K, Rs, ts, _, pts = synthscene.corridor_scene(n, VO_H, VO_W)
    imgs = [torch.as_tensor(f, dtype=torch.float32, device=dev)
            for f in synthscene.render_blobs(K, Rs, ts, pts, VO_H, VO_W)]
    c = sfm.VisualOdometry(K, device_loop=True, device=dev).cfg

    def steps():
        pyr, x, y, v, aff, _ = pft.select_step_device(imgs[0], c,
                                                      VO_FEATURES)
        first = (pyr, x, y, v, aff)
        hist, carry = [(x, y, v)], None
        for img in imgs[1:]:
            pyr, x, y, v, aff, _, carry = pft.sequence_step_device(
                pyr, img, x, y, v, c, True, aff=aff, carry=carry)
            hist.append((x, y, v))
        table = [torch.stack([h[j] for h in hist]).cpu().numpy()
                 for j in range(3)]
        return table, first

    before = cuda_lk.launches
    got, first = steps()
    k2 = cuda_lk.launches - before
    with cuda.reference_path():
        want, _ = steps()
    same = tables_equal(got, want)
    pyr, x, y, v, aff = first
    _, hist, _, _, _, _ = pft.sequence_chain_device(
        pyr, tuple(imgs[1:1 + k]), x, y, v, c, True, aff=aff)
    chain = [h.cpu().numpy() for h in hist]
    chain_same = all(np.array_equal(a, b[1:1 + k])
                     for a, b in zip(chain, got))
    live = (got[2] >= 0).sum(axis=1)
    print(f"device_loop steps, 240x320, {VO_FEATURES} features, {n} "
          f"frames: K2 launched {k2}, live lanes per frame {live.min()}-"
          f"{live.max()}, bit-equal to the plain versions {same}; a chain "
          f"of {k} == its steps {chain_same}")
    if not same:
        fail("the device_loop steps at 240x320 differ from the plain "
             "versions")
    if k2 != n - 1 or not chain_same:
        fail("the device_loop steps at 240x320 did not launch K2 once a "
             "step, or the chain differs from them")
    out = {"device_loop_steps_bit_equal": same}
    for route, dl in (("host", False), ("device_loop", True)):
        kw = dict(n_frames=n, kf_every=k, n_features=VO_FEATURES,
                  device=dev, device_loop=dl)
        res = synthscene.run_vo_on_corridor(**kw)
        with cuda.reference_path():
            ref = synthscene.run_vo_on_corridor(**kw)
        same = same_trajectory(res["vo"], ref["vo"])
        print(f"corridor VO ({route}), {n} frames, kernels against plain "
              f"versions: {res['keyframes']} keyframes, "
              f"{res['landmarks']} landmarks, events "
              f"{res['vo'].events[:1]}..., identical {same}; card {smi}")
        if not same:
            fail(f"the {n}-frame corridor VO ({route}) with kernels differs "
                 "from the run with plain versions")
        out[f"{route}_vo_equals_plain"] = same
    return out


def ba_problem(dev):
    """The config-5 core problem of bench.py's bench_sfm: 20 cameras on a
    lateral track, 2000 landmarks 5-10 units deep, every landmark seen by
    every camera (40,000 observations), exact poses, points perturbed by
    0.05 units."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.sfm.ba import make_problem
    rng = np.random.default_rng(0)
    C, L = BA_CAMS, BA_POINTS
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Rs = sfm.so3_exp(torch.as_tensor(0.02 * rng.standard_normal((C, 3)),
                                     dtype=torch.float32, device=dev))
    ts = torch.as_tensor(np.stack([[-0.2 * i, 0.0, 0.0] for i in range(C)]),
                         dtype=torch.float32, device=dev)
    X = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                  rng.uniform(5, 10, L)], -1).astype(np.float32)
    uv, _ = sfm.project(K, Rs[:, None], ts[:, None],
                        torch.as_tensor(X, device=dev)[None])
    cam = np.repeat(np.arange(C), L)
    pt = np.tile(np.arange(L), C)
    problem = make_problem(K, cam, pt, uv.reshape(-1, 2), np.ones(C * L),
                           device=dev)
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    return problem, Rs, ts, torch.as_tensor(X0, device=dev)


def dense_ba(prof_dir, dev, smi):
    """(b): dense bundle adjustment on the 20 x 2000 x 40,000 problem, 8
    iterations: cost ratio, a second run bit-equal, iterations/s by CUDA
    events, the device's busy share and kernels per iteration."""
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    problem, Rs, ts, X0 = ba_problem(dev)

    def run():
        return sfm.bundle_adjust(problem, Rs, ts, X0, n_iters=BA_ITERS)

    first = run()
    second = run()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    costs = first[3].cpu().numpy()
    ratio = float(costs[-1] / max(costs[0], 1e-30))
    print(f"BA {BA_CAMS} cameras x {BA_POINTS} landmarks x "
          f"{BA_CAMS * BA_POINTS} observations, {BA_ITERS} iterations: "
          f"costs {costs[0]:.6g} -> {costs[-1]:.6g} (ratio {ratio:.3e}); "
          f"second run bit-equal {same}")
    if not same:
        fail("two BA runs on the card differ")
    if not ratio < 1e-3:
        fail(f"BA final/initial cost {ratio} is not below 1e-3")
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(3):
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    ms = sorted(times)[1]
    busy, kernels = device_ms(run, [""], prof_dir, reps=3)
    out = {"iters_per_s": BA_ITERS / (ms / 1e3), "ms_per_call": ms,
           "cost_ratio": ratio, "device_busy_ms": busy,
           "busy_share": busy / ms, "kernels_per_iter": kernels / BA_ITERS,
           "bit_equal_rerun": same}
    print(f"BA: {out['iters_per_s']:.2f} iterations/s by CUDA events "
          f"({ms:.3f} ms per {BA_ITERS}-iteration call, host syncs "
          f"included), device busy {busy:.3f} ms = share "
          f"{out['busy_share']:.3f}, {out['kernels_per_iter']:.1f} kernels "
          f"per iteration; card {smi}")
    return out


def count_syncs(fn):
    """fn() with torch's sync debug mode on: returns (result, number of
    synchronizing CUDA calls it made)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return res, sum("synchroniz" in str(w.message) for w in caught)


def same_trajectory(a, b) -> bool:
    """Two VO runs took the same decisions and reached the same bits."""
    import numpy as np
    ta, tb = a.trajectory(), b.trajectory()
    return (a.events == b.events and all(np.array_equal(x, y)
                                         for x, y in zip(ta, tb))
            and set(a.landmarks) == set(b.landmarks)
            and all(np.array_equal(a.landmarks[k], b.landmarks[k])
                    for k in a.landmarks))


def vo_runs(mods, cuda_lk, smi):
    """(c) and (d): the corridor VO on the host route and with
    device_loop=True, each twice (identical trajectories), launches
    counted over the first run, syncs per keyframe; then the 260-frame
    circuit with loop closure, K2's guided launches counted."""
    import torch
    from pyfeaturetrack_tpu_torch.utils import synthscene
    out = {}
    for route, dl in (("host", False), ("device_loop", True)):
        pmods = {k: m for k, m in mods.items()
                 if not (dl and k == "K5")}
        for m in pmods.values():
            m.launches = 0
        guided0 = cuda_lk.guided_launches
        res, syncs = count_syncs(lambda: synthscene.run_vo_on_corridor(
            n_frames=VO_FRAMES, kf_every=VO_KF_EVERY,
            n_features=VO_FEATURES, device="cuda", device_loop=dl))
        torch.cuda.synchronize()
        counts = path_counts(pmods, f"corridor VO ({route})")
        guided = cuda_lk.guided_launches - guided0
        res2 = synthscene.run_vo_on_corridor(
            n_frames=VO_FRAMES, kf_every=VO_KF_EVERY,
            n_features=VO_FEATURES, device="cuda", device_loop=dl)
        same = same_trajectory(res.pop("vo"), res2.pop("vo"))
        kf = res["keyframes"]
        print(f"corridor VO ({route}): {VO_FRAMES} frames, {kf} keyframes, "
              f"{res['landmarks']} landmarks, ATE {res['ate_units']} units "
              f"= {res['ate_pct_travel']}% of {res['travel_units']} units; "
              f"{res2['wall_fps']} frames/s by wall clock (second run; "
              f"first {res['wall_fps']} with sync counting); launches "
              f"{counts}, guided K2 {guided}; "
              f"host syncs {syncs} = {syncs / kf:.1f} per keyframe; "
              f"second run identical {same}; "
              f"card {smi}")
        if not same:
            fail(f"two corridor VO runs ({route}) differ")
        if guided != 0:
            fail(f"the corridor VO ({route}) has no loop closure or stereo "
                 f"but launched K2 with guided starts {guided} times")
        if not res["ate_pct_travel"] < 1.0:
            fail(f"corridor VO ({route}) ATE {res['ate_pct_travel']}% of "
                 "travel is not under 1%")
        out[route] = dict(res, second_wall_fps=res2["wall_fps"],
                          launches=counts, syncs=syncs,
                          syncs_per_keyframe=syncs / kf,
                          identical_rerun=same, guided_launches=guided)
    for m in mods.values():
        m.launches = 0
    guided0 = cuda_lk.guided_launches
    res = synthscene.run_vo_on_circuit(n_frames=CIRCUIT_FRAMES,
                                       finalize=False, device="cuda")
    vo = res.pop("vo")
    torch.cuda.synchronize()
    counts = path_counts(mods, "circuit VO")
    guided = cuda_lk.guided_launches - guided0
    print(f"circuit VO: {CIRCUIT_FRAMES} frames, {res['keyframes']} "
          f"keyframes, {res['landmarks']} landmarks, loops closed "
          f"{vo.loops_closed}, ATE {res['ate_units']} units = "
          f"{res['ate_pct_travel']}% of {res['travel_units']} units, RPE "
          f"median {res['rpe_trans_median_units']} units / "
          f"{res['rpe_rot_median_deg']} deg; {res['wall_fps']} frames/s; "
          f"launches {counts}, K2 guided {guided}; card {smi}")
    if res["loop_closures"] < 1:
        fail(f"the circuit closed no loop: {vo.events[-5:]}")
    if not res["ate_pct_travel"] < 1.0:
        fail(f"circuit ATE {res['ate_pct_travel']}% is not under 1%")
    if guided <= 0:
        fail("loop closure launched no guided K2 call")
    out["circuit"] = dict(res, launches=counts, guided_launches=guided)
    return out


def stereo_scene():
    """tests/test_stereo.py's scene: (K, render, points): 300 textured
    points 6-20 units deep, render(c) the 240x320 view from camera
    centre c with the identity rotation."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    h, w = VO_H, VO_W
    K = np.array([[260.0, 0, w / 2], [0, 260.0, h / 2], [0, 0, 1]])
    rng = np.random.default_rng(80)
    n_pts = 300
    pts = np.stack([rng.uniform(-9.0, 9.0, n_pts),
                    rng.uniform(-6.0, 6.0, n_pts),
                    rng.uniform(6.0, 20.0, n_pts)], -1).astype(np.float32)
    amp = rng.uniform(120, 255, n_pts)

    def render(c):
        uv, depth = sfm.project(K, torch.eye(3), torch.as_tensor(
            -c, dtype=torch.float32), torch.as_tensor(pts))
        uv, depth = uv.numpy(), depth.numpy()
        img = np.full((h, w), 20.0)
        rad = 6
        for j in range(n_pts):
            u, v = uv[j]
            if depth[j] <= 1.0 or not (rad < u < w - rad - 1
                                       and rad < v < h - rad - 1):
                continue
            cu, cv = int(u), int(v)
            yy, xx = np.mgrid[cv - rad:cv + rad + 1, cu - rad:cu + rad + 1]
            img[cv - rad:cv + rad + 1, cu - rad:cu + rad + 1] += (
                amp[j] * np.exp(-((xx - u) ** 2 + (yy - v) ** 2) / 6.48))
        return np.clip(img, 0, 255)

    return K, render, pts


def stereo_vo(smi):
    """(e): stereo VO on tests/test_stereo.py's scene (12 frames, 0.3
    units baseline): metric error under 3% of travel with no alignment."""
    import numpy as np
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.ops import cuda_lk
    K, render, _ = stereo_scene()
    cs = [np.array([0.2 * i, 0.03 * i, 0.08 * i]) for i in range(12)]
    guided0 = cuda_lk.guided_launches
    vo = sfm.VisualOdometry(K, n_features=120, kf_every=2, window=6,
                            stereo_baseline=STEREO_BASELINE,
                            max_disparity=STEREO_MAX_DISPARITY)
    for c in cs:
        vo.feed(render(c), right=render(c + [STEREO_BASELINE, 0, 0]))
    fi, _, _, c_est = vo.trajectory()
    err = np.linalg.norm(c_est - np.stack(cs)[fi], axis=-1)
    travel = float(np.linalg.norm(np.diff(np.stack(cs), axis=0),
                                  axis=-1).sum())
    guided = cuda_lk.guided_launches - guided0
    print(f"stereo VO: {len(fi)} keyframes, {len(vo.landmarks)} metric "
          f"landmarks, raw error max {err.max():.4f} units = "
          f"{100 * err.max() / travel:.3f}% of {travel:.3f} units (bar 3%), "
          f"K2 guided launches {guided}; card {smi}")
    if not vo.initialized or not err.max() < 0.03 * travel:
        fail(f"stereo VO error {err.max()} over the 3% bar: {vo.events}")
    return {"keyframes": int(len(fi)), "landmarks": len(vo.landmarks),
            "max_err_units": float(err.max()), "travel_units": travel,
            "guided_launches": guided}


def sfm_phase(pft, mods, frames, cfg, cfg3, report, dev, smi, prof_dir):
    """The SfM back end and monocular VO on the card: (a) K2's guided
    starts, (b) dense BA, (c) the 100-frame corridor VO (host route and
    device_loop=True), (d) the 260-frame circuit with loop closure, (e)
    stereo VO. Returns the numbers; adds K2's guided entry to ``report``."""
    from pyfeaturetrack_tpu_torch.ops import cuda_lk
    from pyfeaturetrack_tpu_torch.utils import cuda
    out = {}
    phase("sfm (a): K2 with guided starts, 480x640, 1000 features, starts "
          "20-40 px from the anchors")
    report["K2 guided"] = guided_k2(pft, cuda_lk, cuda, frames, cfg, cfg3,
                                    dev, smi, prof_dir)
    phase("sfm (a), at the VO's size: K2 with guided starts as loop "
          "closure, relocalization and stereo call it (240x320); the VO's "
          "tracking routes against their plain versions")
    n_guided = guided_vo_cases(pft, cuda_lk, cuda, dev)
    print(f"{n_guided} guided K2 calls at 240x320 bit-equal to the plain "
          "version")
    out["vo_kernels"] = dict(vo_route_checks(pft, cuda_lk, cuda, dev, smi),
                             guided_calls_bit_equal=n_guided)
    phase(f"sfm (b): dense bundle adjustment, {BA_CAMS} x {BA_POINTS} x "
          f"{BA_CAMS * BA_POINTS}, {BA_ITERS} iterations")
    out["ba"] = dense_ba(prof_dir, dev, smi)
    phase(f"sfm (c, d): corridor VO ({VO_FRAMES} frames, kf_every "
          f"{VO_KF_EVERY}, {VO_FEATURES} features), host route and "
          f"device_loop; {CIRCUIT_FRAMES}-frame circuit with loop closure")
    out.update(vo_runs(mods, cuda_lk, smi))
    report["K2 guided"]["launches"] = out["circuit"]["guided_launches"]
    phase("sfm (e): stereo VO, 12 frames, 0.3 units baseline")
    out["stereo"] = stereo_vo(smi)
    report["K2 guided"]["launches_per_path"] = {
        "corridor host": out["host"]["guided_launches"],
        "corridor device_loop": out["device_loop"]["guided_launches"],
        "circuit": out["circuit"]["guided_launches"],
        "stereo": out["stereo"]["guided_launches"]}
    return out


# ---- phase 11: gradients through the kernels (the plain versions' VJP) ----

GRAD_BAR = 1e-5           # |g - g_plain| <= GRAD_BAR max|g_plain| where not bit-equal
GRAD_LISTED = 10          # differing pixels printed


def with_event_ms(fn):
    """(result, ms) of one fn() call by CUDA events."""
    import torch
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def grad_case(name, loss_fn, img, mods, expect, cuda, smi):
    """The gradient of ``loss_fn`` with respect to ``img`` with kernels
    (after one warm-up gradient; each kernel's launches counted over the
    forward: the counts are set to 0 just before it and read just after)
    and under reference_path() (twice: the plain route repeats bit for
    bit); forward and backward timed by CUDA events; the two gradients
    compared bit for bit, else at GRAD_BAR with the differing pixels
    listed."""
    import torch
    warm = img.detach().clone().requires_grad_(True)
    (g_warm,) = torch.autograd.grad(loss_fn(warm), warm)
    leaf = img.detach().clone().requires_grad_(True)
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    loss, fwd_ms = with_event_ms(lambda: loss_fn(leaf))
    counts = {k: m.launches for k, m in mods.items()}
    (g,), bwd_ms = with_event_ms(lambda: torch.autograd.grad(loss, leaf))
    if not torch.equal(g, g_warm):
        fail(f"grad ({name}): two gradients through the kernels differ")
    for k, n in expect.items():
        if counts[k] < n:
            fail(f"grad ({name}): the forward launched {k} {counts[k]} "
                 f"times, expected at least {n}")
    ref = []
    with cuda.reference_path():
        for _ in range(2):
            leaf_p = img.detach().clone().requires_grad_(True)
            loss_p, pf_ms = with_event_ms(lambda: loss_fn(leaf_p))
            (gp,), pb_ms = with_event_ms(lambda: torch.autograd.grad(loss_p,
                                                                 leaf_p))
            ref.append(gp)
    if not torch.equal(ref[0], ref[1]):
        fail(f"grad ({name}): two plain-route gradients differ")
    gp = ref[0]
    finite = bool(torch.isfinite(g).all())
    gmax = float(gp.abs().max())
    diff = (g - gp).abs()
    bad = torch.nonzero(g != gp)
    listed = [(tuple(int(v) for v in p), float(g[tuple(p)]),
               float(gp[tuple(p)])) for p in bad[:GRAD_LISTED].tolist()]
    out = {"launches": counts, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
           "plain_forward_ms": pf_ms, "plain_backward_ms": pb_ms,
           "loss": float(loss.detach()),
           "loss_equal": bool(loss.detach() == loss_p.detach()),
           "max_abs_grad": gmax, "nonzero": int((g != 0).sum()),
           "bit_equal": len(bad) == 0, "pixels_differing": len(bad),
           "max_abs_diff": float(diff.max()), "listed": listed}
    print(f"grad ({name}): forward launches {counts}; loss {out['loss']:.6g} "
          f"(plain route equal {out['loss_equal']}); gradient max "
          f"{gmax:.6g}, {out['nonzero']} nonzero pixels, finite {finite}; "
          f"against the plain route: bit-equal {out['bit_equal']}, "
          f"{len(bad)} pixels differ, max diff {out['max_abs_diff']:.3g}"
          + (f", first {listed}" if listed else "")
          + f"; forward {fwd_ms:.3f} ms, backward (plain VJP) {bwd_ms:.3f} "
          f"ms; plain route forward {pf_ms:.3f} ms, backward {pb_ms:.3f} ms "
          f"(CUDA events); card {smi}")
    if not finite or gmax <= 0.0 or out["nonzero"] == 0:
        fail(f"grad ({name}): the gradient is not finite and nonzero")
    if not out["loss_equal"]:
        fail(f"grad ({name}): the loss differs from the plain route's")
    if out["max_abs_diff"] > GRAD_BAR * gmax:
        fail(f"grad ({name}): gradients differ from the plain route's by "
             f"{out['max_abs_diff']} > {GRAD_BAR} x {gmax}")
    return out


def grad_phase(pft, frames, sim, cfg, cfg3, mods, dev, smi):
    """(a) tests/test_differentiability.py's tracking loss at 480x640 with
    1000 features (default config), (b) its dense-flow loss on the config-1
    pair, (c) a config-3 step's positions (K2 and K6's stage), (d) K9's
    window terms; each gradient against the plain route's. The plain
    routes' gathers scatter their gradients with index_put_: deterministic
    algorithms are on for the phase so both routes repeat."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch.ops import cuda_window_terms
    from pyfeaturetrack_tpu_torch.ops.flow import dense_flow_pyramids
    from pyfeaturetrack_tpu_torch.ops.interp import gather_window
    from pyfeaturetrack_tpu_torch.utils import cuda
    from pyfeaturetrack_tpu_torch.utils.io import pgm_read
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        img0, img1 = (torch.as_tensor(f, device=dev).to(torch.float32)
                      for f in frames[:2])
        _, x, y, val, _, _ = pft.select_step_device(img0, cfg, N_FEATURES)

        def track_loss(i2):
            p1 = pft.build_track_pyramids(img0, cfg)
            p2 = pft.build_track_pyramids(i2, cfg)
            nx, ny, nv = pft.track_features_pyramids(p1, p2, x, y, val, cfg)
            return torch.where(nv == 0, nx + ny, 0.0).sum()

        phase(f"grad (a): loss over {N_FEATURES} tracked positions, {H}x{W}, "
              "default config; gradient with respect to frame 2")
        out["tracking"] = grad_case("tracking", track_loss, img1, mods,
                                    {"K1": 4, "K2": 1}, cuda, smi)

        root = Path(__file__).resolve().parent
        f0, f1 = (torch.as_tensor(np.array(pgm_read(
            root / "examples" / "data" / f"img{i}.pgm")),
            device=dev).to(torch.float32) for i in (0, 1))
        fcfg = pft.create_config()

        def flow_loss(i2):
            fl = dense_flow_pyramids(pft.build_track_pyramids(f0, fcfg),
                                     pft.build_track_pyramids(i2, fcfg),
                                     fcfg)
            return torch.where(fl.status == 0, fl.u ** 2 + fl.v ** 2,
                               0.0).sum()

        phase("grad (b): dense-flow loss on the config-1 pair "
              f"({tuple(f0.shape)}), default config")
        out["dense_flow"] = grad_case("dense flow", flow_loss, f1, mods,
                                      {"K1": 4, "K8": fcfg.nPyramidLevels},
                                      cuda, smi)

        s0, s1, s2 = (torch.as_tensor(f, device=dev).to(torch.float32)
                      for f in sim[:3])
        pyr, sx, sy, sv, aff, _ = pft.select_step_device(s0, cfg3, N_FEATURES)
        pyr, sx, sy, sv, aff, _, _ = pft.sequence_step_device(
            pyr, s1, sx, sy, sv, cfg3, True, aff=aff)

        def step_loss(i2):
            _, nx, ny, nv, _, _, _ = pft.sequence_step_device(
                pyr, i2, sx, sy, sv, cfg3, True, aff=aff)
            return torch.where(nv == 0, nx + ny, 0.0).sum()

        phase("grad (c): a config-3 step (K1, K2, K6's affine stage, K4's "
              f"refill) at {H}x{W}, {N_FEATURES} features; loss over its "
              "positions")
        out["config3_step"] = grad_case("config-3 step", step_loss, s2, mods,
                                        {"K1": 2, "K2": 1, "K6": 1}, cuda,
                                        smi)

        pa = pft.build_track_pyramids(img0, cfg)
        pb = pft.build_track_pyramids(img1, cfg)
        live = val >= 0
        xa, ya = x[live], y[live]
        hw, hh = cfg.window_width // 2, cfg.window_height // 2
        w1, g1x, g1y = (gather_window(im, xa, ya, hw, hh).contiguous()
                        for im in (pa.img[0], pa.gradx[0], pa.grady[0]))
        # frame-2 positions a third of a pixel off the drift
        xb = (xa + DRIFT[0] + 0.3).contiguous()
        yb = (ya + DRIFT[1] - 0.3).contiguous()

        def k9_loss(i2):
            return cuda_window_terms.window_terms(
                i2, pb.gradx[0], pb.grady[0], w1, g1x, g1y, xb, yb, hw=hw,
                hh=hh, step_factor=cfg.step_factor).sum()

        phase(f"grad (d): K9's window terms ({int(live.sum())} features, "
              "a third of a pixel off the drift); loss over all five terms")
        out["k9"] = grad_case("K9", k9_loss, pb.img[0], mods, {"K9": 1},
                              cuda, smi)

        phase("grad (e): the captured chain given a frame that requires grad")
        pyr, cx, cy, cv, _, _ = pft.select_step_device(img0, cfg, N_FEATURES)
        try:
            pft.sequence_chain_device(
                pyr, [img1.clone().requires_grad_(True), img1], cx, cy, cv,
                cfg)
            fail("the captured chain took a frame that requires grad")
        except ValueError as e:
            print(f"sequence_chain_device refused it: {e}")
            out["chain_refuses_grad"] = True
    finally:
        torch.use_deterministic_algorithms(False)
    return out


# ---- phase 12: windowed BA (BASELINE configs 5b, 5c) and run_sfm_windowed ----

WBA = {"5b": dict(C=60, L=6000, kw=12, iters=8, solver="dense", g=1,
                  ratio_bar=1e-3),
       "5c": dict(C=500, L=20000, kw=8, iters=6, solver="cg", g=16,
                  ratio_bar=1e-2)}
E2E_FRAMES, E2E_H, E2E_W = 8, 240, 320


def windowed_problem(C, L, kw, dev):
    """bench.py's bench_sfm_windowed problem, draw for draw: C cameras on a
    lateral track, L landmarks 5-12 units deep, each seen from a window of
    kw cameras starting at a random camera, exact poses, landmarks
    perturbed by 0.05 units."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.sfm.ba_windowed import make_windowed_problem
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Rs = sfm.so3_exp(torch.as_tensor(0.01 * rng.standard_normal((C, 3)),
                                     dtype=torch.float32, device=dev))
    ts = torch.as_tensor(np.stack([[-0.15 * i, 0.0, 0.0] for i in range(C)]),
                         dtype=torch.float32, device=dev)
    X = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                  rng.uniform(5, 12, L)], -1).astype(np.float32)
    c0 = rng.integers(0, C - kw + 1, L).astype(np.int32)
    cidx = torch.as_tensor(c0[:, None] + np.arange(kw)[None, :], device=dev)
    uv, _ = sfm.project(K, Rs[cidx], ts[cidx],
                        torch.as_tensor(X, device=dev)[:, None])
    problem = make_windowed_problem(K, c0, uv, np.ones((L, kw), np.float32),
                                    device=dev)
    X0 = X + 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    return problem, Rs, ts, torch.as_tensor(X0, device=dev)


def windowed_ba(tag, prof_dir, dev, smi):
    """(f) / (g): one configuration of WBA: costs, a second run bit-equal,
    iterations/s by CUDA events, the device's busy share and kernels per
    iteration from a trace, host reads per GN step
    (torch.cuda.set_sync_debug_mode), CG iterations per GN step."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    c = WBA[tag]
    problem, Rs, ts, X0 = windowed_problem(c["C"], c["L"], c["kw"], dev)

    def run():
        return sfm.bundle_adjust_windowed(
            problem, Rs, ts, X0, n_iters=c["iters"], point_only_iters=0,
            solver=c["solver"], precond_block=c["g"], return_info=True)

    torch.cuda.reset_peak_memory_stats()
    first, syncs = count_syncs(run)
    second = run()
    torch.cuda.synchronize()
    same = (all(torch.equal(a, b) for a, b in zip(first[:4], second[:4]))
            and torch.equal(first[4]["cg_iters"], second[4]["cg_iters"]))
    costs = first[3].cpu().numpy()
    cg = first[4]["cg_iters"].cpu().numpy().tolist()
    ratio = float(costs[-1] / max(costs[0], 1e-30))
    times = sorted(with_event_ms(run)[1] for _ in range(3))
    ms = times[1]
    busy, kernels = device_ms(run, [""], prof_dir, reps=1)
    top = top_kernels(prof_dir / "kernel_times.json", c["iters"])
    out = {"cameras": c["C"], "landmarks": c["L"], "window": c["kw"],
           "iters": c["iters"], "solver": c["solver"],
           "precond_block": c["g"], "costs": costs.tolist(),
           "cost_ratio": ratio, "bit_equal_rerun": same,
           "ms_per_call": ms, "iters_per_s": c["iters"] / (ms / 1e3),
           "device_busy_ms": busy, "busy_share": busy / ms,
           "kernels_per_iter": kernels / c["iters"],
           "host_reads": syncs, "host_reads_per_step": syncs / c["iters"],
           "cg_iters": cg, "top_kernels": top,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"windowed BA, config {tag}: {c['C']} cameras x {c['L']} landmarks "
          f"x {c['kw']}-frame windows, {c['iters']} iterations, solver "
          f"{c['solver']} (groups of {c['g']}): costs {costs[0]:.6g} -> "
          f"{costs[-1]:.6g} (ratio {ratio:.3e}), CG iterations per step {cg}; "
          f"second run bit-equal {same}; {out['iters_per_s']:.2f} "
          f"iterations/s by CUDA events ({ms:.3f} ms per call, median of 3, "
          f"host reads included), device busy {busy:.3f} ms = share "
          f"{out['busy_share']:.3f}, {out['kernels_per_iter']:.1f} kernels "
          f"per iteration, {syncs} host reads = "
          f"{out['host_reads_per_step']:.2f} per GN step, peak memory "
          f"{out['peak_mem_gb']:.2f} GB; card {smi}")
    for name, us, n in top:
        print(f"  {us:9.1f} us/iteration  {n:6.1f} launches/iteration  {name}")
    if not same:
        fail(f"two windowed BA runs (config {tag}) on the card differ")
    if not ratio < c["ratio_bar"]:
        fail(f"windowed BA (config {tag}) final/initial cost {ratio} is not "
             f"below {c['ratio_bar']}")
    if c["solver"] == "cg" and not syncs < sum(cg):
        fail(f"windowed BA (config {tag}) read the host {syncs} times for "
             f"{sum(cg)} CG iterations")
    if not np.isfinite(costs).all():
        fail(f"windowed BA (config {tag}) costs are not finite")
    # the mesh layout's padding (the sharded path itself is not ported)
    pp, Xp, n_pad = sfm.pad_windowed_for_mesh(problem, X0, 7)
    padded = (n_pad == (-c["L"]) % 7 and Xp.shape[0] == c["L"] + n_pad
              and bool((pp.w[c["L"]:] == 0).all())
              and torch.equal(pp.uv[:c["L"]], problem.uv)
              and torch.equal(Xp[:c["L"]], X0))
    print(f"pad_windowed_for_mesh(7 devices): {n_pad} zero-weight landmarks "
          f"added, the rest unchanged {padded}")
    if not padded:
        fail(f"pad_windowed_for_mesh (config {tag}) padded wrongly")
    out["mesh_pad"] = n_pad
    return out


def top_kernels(trace_path, per, n=8):
    """The n kernels of a Chrome trace with the most device time: (name,
    us per ``per``, launches per ``per``)."""
    events = json.loads(Path(trace_path).read_text())
    agg: dict = {}
    for e in events.get("traceEvents", events):
        if e.get("cat") == "kernel":
            name = e.get("name", "").removeprefix("void ")[:80]
            t, c = agg.get(name, (0.0, 0))
            agg[name] = (t + e["dur"], c + 1)
    return [(k, t / per, c / per) for k, (t, c) in
            sorted(agg.items(), key=lambda kv: -kv[1][0])[:n]]


def e2e_texture(nrows, ncols, seed):
    """tests/conftest.py's make_textured_image: uniform noise, binomial
    smoothing along each axis, stretched to 0..255 and floored."""
    import numpy as np
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, size=(nrows, ncols))
    k = np.array([1, 4, 6, 4, 1], dtype=np.float64)
    k /= k.sum()
    for axis in (0, 1):
        img = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, img)
    lo, hi = img.min(), img.max()
    return np.floor((img - lo) / (hi - lo) * 255.0)


def e2e_scene():
    """tests/test_sfm_e2e.py's scene: a textured plane seen by 8 cameras on
    a lateral track with slight rotation, rendered through the plane
    homographies at 240x320. Returns (K, Rs, ts, frames)."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    K = np.array([[300.0, 0, E2E_W / 2], [0, 300.0, E2E_H / 2], [0, 0, 1]])
    Rs, ts = [], []
    for i in range(E2E_FRAMES):
        w = np.array([0.004 * i, -0.006 * i, 0.002 * i], np.float32)
        Rs.append(sfm.so3_exp(torch.as_tensor(w[None]))[0].numpy())
        ts.append(np.array([-0.12 * i, 0.06 * i, 5.0], np.float32))
    Rs, ts = np.stack(Rs), np.stack(ts)
    tex = e2e_texture(720, 960, 77)
    sx, sy = 960 / 4.8, 720 / 3.6
    ys, xs = np.mgrid[0:E2E_H, 0:E2E_W].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    frames = []
    for Rk, tk in zip(Rs, ts):
        Hk = K @ np.stack([Rk[:, 0], Rk[:, 1], tk], axis=1)
        plane = pix @ np.linalg.inv(Hk).T
        X = plane[..., 0] / plane[..., 2]
        Y = plane[..., 1] / plane[..., 2]
        u = np.clip((X + 2.4) * sx, 0, 960 - 1.001)
        v = np.clip((Y + 1.8) * sy, 0, 720 - 1.001)
        u0, v0 = u.astype(np.int64), v.astype(np.int64)
        au, av = u - u0, v - v0
        frames.append((1 - au) * (1 - av) * tex[v0, u0]
                      + au * (1 - av) * tex[v0, u0 + 1]
                      + (1 - au) * av * tex[v0 + 1, u0]
                      + au * av * tex[v0 + 1, u0 + 1])
    return K, Rs, ts, frames


def sfm_windowed_e2e(dev, smi):
    """(h): run_sfm_windowed on e2e_scene's frames tracked by the port on
    the card (80 features, replace-lost), poses perturbed as
    tests/test_sfm_e2e.py:112-118 does; both solvers, each twice."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.models.sequence import track_sequence
    K, Rs, ts, frames = e2e_scene()
    ft, _ = track_sequence(frames, n_features=80, replace_lost=True,
                           device=dev)
    rng = np.random.default_rng(3)
    dw = 0.004 * rng.standard_normal((E2E_FRAMES, 3)).astype(np.float32)
    dw[0] = 0
    R0 = (sfm.so3_exp(torch.as_tensor(dw)).numpy() @ Rs).astype(np.float32)
    t0 = ts + 0.02 * rng.standard_normal(ts.shape).astype(np.float32)
    t0[0] = ts[0]
    ate0 = sfm.ate_rmse_aligned(t0, ts)
    out = {}
    for solver in ("dense", "cg"):
        runs = [sfm.run_sfm_windowed(ft, K.astype(np.float32), R0, t0,
                                     n_iters=15, solver=solver, device=dev)
                for _ in range(2)]
        torch.cuda.synchronize()
        a, b = runs
        same = all(torch.equal(a[k], b[k]) for k in ("R", "t", "X", "costs"))
        costs = a["costs"].cpu().numpy()
        ate = sfm.ate_rmse_aligned(a["t"], ts)
        out[solver] = {"runs": len(a["runs"]),
                       "n_observations": a["n_observations"],
                       "first_cost": float(costs[0]),
                       "final_cost": float(costs[-1]), "ate_init": ate0,
                       "ate_final": ate, "bit_equal_rerun": same}
        print(f"run_sfm_windowed ({solver}) on the tracked {E2E_FRAMES}-frame "
              f"scene: {len(a['runs'])} runs, {a['n_observations']} "
              f"observations, cost {costs[0]:.6g} -> {costs[-1]:.6g}, "
              f"aligned ATE {ate0:.5f} -> {ate:.5f} units, rerun bit-equal "
              f"{same}; card {smi}")
        if not costs[-1] < 0.5 * costs[0]:
            fail(f"run_sfm_windowed ({solver}): the final cost is not below "
                 "half the first")
        if not ate < ate0:
            fail(f"run_sfm_windowed ({solver}): the aligned ATE did not fall")
        if not same:
            fail(f"two run_sfm_windowed ({solver}) runs on the card differ")
    return out


# ---- phase 13: checkpoint resume, the CLI and profiling on the card ----

TOOLS_FRAMES = 25          # 1 + 3 chains of 8
TOOLS_CUT = 9              # after the selection and one chain


def resume_checks(pft, frames, dev, tmp, smi):
    """A SequenceTracker, a StreamingTracker(chain=8) and the corridor
    VisualOdometry (both routes) checkpointed mid-stream through files and
    resumed into fresh objects: each continues bit-equal to the
    uninterrupted run."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.models.sequence import SequenceTracker
    from pyfeaturetrack_tpu_torch.serving import StreamingTracker
    from pyfeaturetrack_tpu_torch.utils import checkpoint as ck
    from pyfeaturetrack_tpu_torch.utils import synthscene
    out = {}
    fs = frames[:TOOLS_FRAMES]

    def seq(fr, tracker=None):
        t = tracker or SequenceTracker(n_features=N_FEATURES, device=dev)
        for f in fr:
            t.step(f)
        return t

    full = seq(fs[:12])
    part = seq(fs[:6])
    ck.save_checkpoint(tmp / "seq.pt", ck.sequence_state(part))
    fresh = SequenceTracker(n_features=N_FEATURES, device=dev)
    ck.resume_sequence(fresh, ck.restore_checkpoint(tmp / "seq.pt",
                                                    map_location=dev))
    seq(fs[6:12], fresh)
    out["sequence"] = all(torch.equal(a, b)
                          for a, b in zip(full.fl[:3], fresh.fl[:3]))

    def stream(fr, tracker=None):
        t = tracker or StreamingTracker(n_features=N_FEATURES, chain=CHAIN,
                                        device=dev)
        for f in fr:
            t.feed(f)
        return t

    sfull = stream(fs)
    spart = stream(fs[:TOOLS_CUT])
    ck.save_checkpoint(tmp / "stream.pt", ck.streaming_state(spart))
    sfresh = StreamingTracker(n_features=N_FEATURES, chain=CHAIN, device=dev)
    ck.resume_streaming(sfresh, ck.restore_checkpoint(tmp / "stream.pt"))
    stream(fs[TOOLS_CUT:], sfresh)
    a, b = sfull.drain(), sfresh.drain()
    out["streaming"] = (all(np.array_equal(u[-1], v[-1])
                            for u, v in zip(a, b))
                        and all(torch.equal(u, v) for u, v in zip(
                            sfull._lanes[0][1:4], sfresh._lanes[0][1:4])))

    K, Rs, ts, _, pts = synthscene.corridor_scene(VO_CHECK_FRAMES, VO_H, VO_W)
    imgs = synthscene.render_blobs(K, Rs, ts, pts, VO_H, VO_W)
    for route, dl in (("host", False), ("device_loop", True)):
        kw = dict(n_features=VO_FEATURES, kf_every=VO_KF_EVERY,
                  device_loop=dl, device=dev)
        vfull = sfm.VisualOdometry(K, **kw)
        for f in imgs:
            vfull.feed(f)
        vpart = sfm.VisualOdometry(K, **kw)
        for f in imgs[:VO_CHECK_FRAMES // 2]:
            vpart.feed(f)
        ck.save_checkpoint(tmp / f"vo_{route}.pt", ck.vo_state(vpart))
        vfresh = sfm.VisualOdometry(K, **kw)
        ck.resume_vo(vfresh, ck.restore_checkpoint(tmp / f"vo_{route}.pt"))
        for f in imgs[vfresh.n_frames:]:
            vfresh.feed(f)
        ta, tb = vfull.trajectory(), vfresh.trajectory()
        out[f"vo_{route}"] = (
            vfull.initialized and all(np.array_equal(u, v)
                                      for u, v in zip(ta, tb))
            and set(vfull.landmarks) == set(vfresh.landmarks)
            and all(np.array_equal(vfull.landmarks[k], vfresh.landmarks[k])
                    for k in vfull.landmarks))
    print(f"checkpoint resume on the card, bit-equal to the uninterrupted "
          f"runs: SequenceTracker ({N_FEATURES} features, cut at frame 6 of "
          f"12) {out['sequence']}, StreamingTracker(chain={CHAIN}) (cut at "
          f"{TOOLS_CUT} of {TOOLS_FRAMES}) {out['streaming']}, corridor VO "
          f"({VO_CHECK_FRAMES} frames, cut at {VO_CHECK_FRAMES // 2}) host "
          f"{out['vo_host']}, device_loop {out['vo_device_loop']}; card {smi}")
    for k, ok in out.items():
        if not ok:
            fail(f"checkpoint resume ({k}) does not continue bit-equal")
    return out


def cli_checks(pft, frames, dev, tmp, smi):
    """``python -m pyfeaturetrack_tpu_torch`` on PGM files in its default,
    --device-loop, --stream --chain 8, --flow and --vo modes, each output
    file against the API calls the mode wraps on the same frames."""
    import numpy as np
    import torch
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.features import FeatureTable
    from pyfeaturetrack_tpu_torch.models.device_sequence import (
        track_sequence_device)
    from pyfeaturetrack_tpu_torch.models.sequence import track_sequence
    from pyfeaturetrack_tpu_torch.ops.flow import dense_flow_pyramids
    from pyfeaturetrack_tpu_torch.serving import serve_stream
    from pyfeaturetrack_tpu_torch.utils import synthscene
    from pyfeaturetrack_tpu_torch.utils.io import pgm_write, write_feature_table
    from pyfeaturetrack_tpu_torch.utils.loader import FrameLoader, load_frames
    from pyfeaturetrack_tpu_torch.utils.staging import stage_f32
    root = Path(__file__).resolve().parent
    fdir, vdir = tmp / "frames", tmp / "corridor"
    fdir.mkdir(parents=True, exist_ok=True)
    vdir.mkdir(parents=True, exist_ok=True)
    paths = [str(fdir / f"img{i}.pgm") for i in range(TOOLS_CUT + 1)]
    for p, f in zip(paths, frames):
        pgm_write(p, f)
    K, Rs, ts, _, pts = synthscene.corridor_scene(VO_CHECK_FRAMES, VO_H, VO_W)
    vpaths = [str(vdir / f"f{i:02d}.pgm") for i in range(VO_CHECK_FRAMES)]
    for p, f in zip(vpaths, synthscene.render_blobs(K, Rs, ts, pts, VO_H,
                                                    VO_W)):
        pgm_write(p, np.clip(np.floor(f), 0, 255))
    # the config the CLI builds from its default flags
    cfg = pft.create_config(search_range=15, mindist=10, window_width=7,
                            window_height=7, affineConsistencyCheck=-1,
                            lighting_insensitive=False, sequentialMode=True)
    loaded = load_frames(paths)

    def cli(mode, args, inputs):
        out = tmp / f"cli_{mode}"
        res = subprocess.run(
            [sys.executable, "-m", "pyfeaturetrack_tpu_torch", *inputs,
             "--out", str(out), "--device", torch.device(dev).type, *args],
            cwd=root,
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-4000:])
            fail(f"python -m pyfeaturetrack_tpu_torch ({mode}) exited "
                 f"{res.returncode}")
        return out, json.loads(res.stdout.strip().splitlines()[-1])

    def table_file(x, y, v, name):
        p = tmp / f"api_{name}.ft"
        write_feature_table(FeatureTable(x=torch.as_tensor(x),
                                         y=torch.as_tensor(y),
                                         val=torch.as_tensor(v)), p)
        return p.read_bytes()

    results = {}
    out, summ = cli("default", [], paths)
    ft, _ = track_sequence(loaded, cfg=cfg, n_features=150, device=dev)
    write_feature_table(ft, tmp / "api_default.ft")
    results["default"] = ((out / "features.ft").read_bytes()
                          == (tmp / "api_default.ft").read_bytes())
    out, _ = cli("device_loop", ["--device-loop"], paths)
    want = table_file(*track_sequence_device(loaded, cfg=cfg, n_features=150,
                                             device=dev), "device_loop")
    results["device_loop"] = (out / "features.ft").read_bytes() == want
    out, _ = cli("stream", ["--stream", "--chain", str(CHAIN)], paths)
    want = table_file(*serve_stream(FrameLoader(paths), cfg=cfg,
                                    n_features=150, chain=CHAIN,
                                    stage_uint8=True, device=dev), "stream")
    results["stream"] = (out / "features.ft").read_bytes() == want
    out, _ = cli("flow", ["--flow"], paths[:3])
    fcfg = cfg.validated_window()
    pyrs = [pft.build_track_pyramids(stage_f32(f, dev), fcfg)
            for f in loaded[:3]]
    fl = [dense_flow_pyramids(a, b, fcfg) for a, b in zip(pyrs, pyrs[1:])]
    with np.load(out / "flow.npz") as z:
        results["flow"] = all(
            np.array_equal(z[k], np.stack([getattr(f, k).cpu().numpy()
                                           for f in fl]))
            for k in ("u", "v", "status"))
    fx, cx, cy = float(K[0, 0]), float(K[0, 2]), float(K[1, 2])
    out, summ = cli("vo", ["--vo", "--fx", repr(fx), "--cx", repr(cx),
                           "--cy", repr(cy), "--kf-every", str(VO_KF_EVERY),
                           "--features", str(VO_FEATURES)], vpaths)
    vo = sfm.VisualOdometry(np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]]),
                            cfg=cfg, n_features=VO_FEATURES,
                            kf_every=VO_KF_EVERY, device=dev)
    for f in load_frames(vpaths):
        vo.feed(f)
    fi, R, t, c = vo.trajectory()
    with np.load(out / "trajectory.npz") as z:
        results["vo"] = (all(np.array_equal(z[k], v) for k, v in (
            ("keyframe_frames", fi), ("R", R), ("t", t), ("centers", c),
            ("landmarks", vo.map_points())))
            and summ["keyframes"] == len(fi))
    print(f"python -m pyfeaturetrack_tpu_torch --device cuda on PGM files, "
          f"outputs equal to the API calls: {results}; VO summary {summ}; "
          f"card {smi}")
    for k, ok in results.items():
        if not ok:
            fail(f"the CLI's {k} mode differs from the API calls it wraps")
    return results


def profiling_checks(pft, frames, cfg, dev, tmp, smi):
    """utils/profiling: a trace of a pyramid build and a track call names
    K1's and K2's kernels; device time per track call from a trace."""
    import torch
    from pyfeaturetrack_tpu_torch.utils import profiling
    img0, img1 = (torch.as_tensor(f, device=dev).to(torch.float32)
                  for f in frames[:2])
    _, x, y, val, _, _ = pft.select_step_device(img0, cfg, N_FEATURES)
    p1 = pft.build_track_pyramids(img0, cfg)

    def step():
        p2 = pft.build_track_pyramids(img1, cfg)
        return pft.track_features_pyramids(p1, p2, x, y, val, cfg)

    step()
    # the profiler can lose a session's first kernel records on this card
    # (see device_ms): 8 steps a trace, up to three traces
    for attempt in range(3):
        with profiling.trace(str(tmp / "trace")):
            for _ in range(8):
                with profiling.named_scope("pft_track_step"):
                    step()
        events = json.loads((tmp / "trace" / "trace.json").read_text())
        events = events.get("traceEvents", events)
        kern = [e.get("name", "") for e in events
                if e.get("cat") == "kernel"]
        if kern:
            break
        print(f"profiling.trace recorded no kernel (attempt {attempt + 1})")
    names = {k: any(n in e for e in kern for n in ns) for k, ns in (
        ("K1", ("level0_kernel", "coarse_kernel")),
        ("K2", ("lk_pyramid_kernel",)))}
    scoped = any(e.get("name") == "pft_track_step" for e in events)
    s_dev = profiling.device_time_per_call(step, iters=8)
    s_ev = profiling.time_jitted(step, iters=20)
    print(f"profiling.trace: {len(kern)} kernels traced, names K1 "
          f"{names['K1']}, K2 {names['K2']}, named scope {scoped}; "
          f"device_time_per_call {s_dev * 1e3:.4f} ms, time_jitted "
          f"{s_ev * 1e3:.4f} ms (CUDA events) per build + track call; "
          f"card {smi}")
    if not all(names.values()) or not scoped:
        fail("profiling.trace did not name K1's and K2's kernels and the "
             "named scope")
    return {"names": names, "scope": scoped, "device_ms": s_dev * 1e3,
            "events_ms": s_ev * 1e3}


# ---- the sharded paths on torch.distributed (parallel/) ----

SPLIT = 4                 # ranks of the split run one after another here
PAR_PAIRS = 4             # frame pairs of the sharded sparse steps


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ba_within(got, want, windowed: bool, n_res: int, what: str) -> dict:
    """The JAX package's landmark-mesh bars (tests/_mp_worker.py: dense t
    1e-3, X 1e-2, costs rtol 1e-3; windowed R, t 1e-4, X 1e-3, costs rtol
    1e-3), against the unsharded run; a cost once converged within the
    float32 resolution of the n_res residuals it sums instead
    (tests/test_torch_sfm.costs_close: 2 sqrt(c n_res) ulp(640)), since a
    cost of 1e-9 of the first one is rounding. Returns the largest gaps."""
    import numpy as np
    g = [a.cpu().numpy().astype(np.float64) for a in got[:4]]
    w = [a.cpu().numpy().astype(np.float64) for a in want[:4]]
    gaps = {k: float(np.abs(a - b).max()) for k, a, b in
            zip("RtX", g[:3], w[:3])}
    ulp = float(np.spacing(np.float32(640.0)))
    tol = np.maximum(1e-3 * np.abs(w[3]), 2 * np.sqrt(w[3] * n_res) * ulp)
    gaps["cost_over_bar"] = float((np.abs(g[3] - w[3]) / tol).max())
    rel = np.abs(g[3] - w[3]) / np.abs(w[3])
    gaps["cost_rel"] = float(rel.max())
    gaps["cost_rel_per_iteration"] = rel.tolist()
    gaps["cost_ratio"] = float(w[3][-1] / w[3][0])
    bars = {"R": 1e-4 if windowed else math.inf,
            "t": 1e-4 if windowed else 1e-3,
            "X": 1e-3 if windowed else 1e-2, "cost_over_bar": 1.0,
            "cost_rel": math.inf}
    bad = {k: v for k, v in gaps.items() if k in bars and not v <= bars[k]}
    if bad:
        fail(f"{what}: beyond the mesh bars: {bad}; costs {g[3].tolist()} "
             f"against {w[3].tolist()}")
    return gaps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per fn() call (ms): reps calls captured in one CUDA
    graph (after a warm-up call on the capture's side stream), then its
    replays timed by CUDA events, so no host launch time sits between the
    kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * replays)


def k8_band_checks(pft, frames, cfg, dev, smi):
    """parallel (b), K8: each level of the default 480x640 flow pair (and
    of the stereo pair's 1-D levels) cut into SPLIT bands; every band launch
    bit-equal to those rows of the whole-level launch and to the plain
    version of the band; the level-0 band timed beside the whole level."""
    import torch
    from pyfeaturetrack_tpu_torch.ops import cuda_lk_dense
    from pyfeaturetrack_tpu_torch.ops.disparity import _hypothesis_init
    from pyfeaturetrack_tpu_torch.ops.flow import level_images
    from pyfeaturetrack_tpu_torch.utils import cuda
    s = float(cfg.subsampling)
    p1, p2 = (pft.build_track_pyramids(torch.as_tensor(
        f, device=dev).to(torch.float32), cfg) for f in frames[:2])
    left, right, _ = make_stereo_pair()
    pl, pr = (pft.build_track_pyramids(torch.as_tensor(f, device=dev), cfg)
              for f in (left, right))
    lv2 = [level_images(p1, p2, r) for r in (0, 1)]
    lv1 = [level_images(pl, pr, r) for r in (0, 1)]
    hw = cfg.window_width // 2
    seed = _hypothesis_init(lv1[1][0], lv1[1][3], tuple(range(
        0, int(64.0 / s) + 1, hw + 1)), hw, cfg.window_height // 2)
    u1, v1, _, _ = cuda_lk_dense.dense_level_up(*lv2[1], None, None, s, cfg)
    d1, _, _ = cuda_lk_dense.dense_level_1d(*lv1[1], seed, cfg)
    calls = {
        "2-D level 1 (zero start)": lambda band: cuda_lk_dense.dense_level_up(
            *lv2[1], None, None, s, cfg, band=band),
        "2-D level 0 (upsampled start)": lambda band:
            cuda_lk_dense.dense_level_up(*lv2[0], u1, v1, s, cfg, band=band),
        "1-D level 1 (seed map start)": lambda band:
            cuda_lk_dense.dense_level_1d(*lv1[1], seed, cfg, band=band),
        "1-D level 0 (upsampled start)": lambda band:
            cuda_lk_dense.dense_level_1d_up(*lv1[0], d1, s, cfg, band=band)}
    n0 = cuda_lk_dense.band_launches
    checked = {}
    for name, call in calls.items():
        whole = call(None)
        rows = whole[0].shape[0]
        per = rows // SPLIT
        for b in range(SPLIT):
            band = (b * per, per)
            got = call(band)
            maps_equal(got, [t[b * per:(b + 1) * per] for t in whole],
                       f"K8 {name} band {band} vs the whole level")
            with cuda.reference_path():
                maps_equal(got, call(band), f"K8 {name} band {band} vs plain")
        checked[name] = f"{SPLIT} bands of {per} rows"
        print(f"K8 {name}: {SPLIT} bands of {per} rows, each bit-equal to "
              "the whole-level launch's rows and to the plain band")
    per = H // SPLIT
    band0 = (0, per)
    call = calls["2-D level 0 (upsampled start)"]
    got = call(band0)
    band_ms = time_ms(lambda: call(band0))
    whole_ms = time_ms(lambda: call(None))
    # device time of each band and of the whole level: 20 calls captured in
    # one CUDA graph, its replays timed (the profiler lost most of these
    # launches' records in a trace of 10 calls on this card)
    band_dev = [graph_ms(lambda b=b: call((b * per, per)))
                for b in range(SPLIT)]
    whole_dev = graph_ms(lambda: call(None))
    with cuda.reference_path():
        band_plain = time_ms(lambda: call(band0), reps=2)
    work = k8_work(cfg, got[2], got[3], False,
                   coarse=(u1.shape[0] // SPLIT, u1.shape[1]))
    b_ms, b_by = bound_ms(*work)
    # how many waves a band's and the level's blocks make on the card: the
    # occupancy calculator's blocks an SM for this launch, times the SMs
    per_sm = cuda_lk_dense.blocks_per_sm(cfg)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    th, tw = cuda_lk_dense.TILE
    blocks = {"band": math.ceil(W / tw) * math.ceil(per / th),
              "whole": math.ceil(W / tw) * math.ceil(H / th)}
    waves = {k: n / (per_sm * sms) for k, n in blocks.items()}
    share = [d / whole_dev for d in band_dev]
    print(f"K8 2-D level 0 band {band0} ({per} x {W} pixels, "
          f"{iteration_line(got[3])}): {band_ms:.4f} ms by events against "
          f"{whole_ms:.4f} ms for the whole level (back to back, host "
          "launches included); from a captured graph of 20 launches, bands "
          "0-3 " + ", ".join(f"{d:.4f}" for d in band_dev)
          + f" ms, the whole level {whole_dev:.4f} ms (each band "
          + ", ".join(f"{x:.3f}" for x in share) + " of the level; all four "
          f"{sum(share):.3f}); {per_sm} blocks of {th * tw} threads an SM "
          f"(occupancy calculator) on {sms} SMs: a band's {blocks['band']} "
          f"blocks {waves['band']:.3f} waves, the level's {blocks['whole']} "
          f"{waves['whole']:.3f}; plain {band_plain:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}); card {smi}")
    return {"checked": checked, "band_ms": band_ms,
            "band_device_ms": band_dev[0], "bands_device_ms": band_dev,
            "whole_ms": whole_ms, "whole_device_ms": whole_dev,
            "band_share_of_level": share, "blocks_per_sm": per_sm,
            "sms": sms, "band_blocks": blocks["band"],
            "whole_blocks": blocks["whole"], "band_waves": waves["band"],
            "whole_waves": waves["whole"],
            "band_plain_ms": band_plain, "band_bound_ms": b_ms,
            "band_bound_by": b_by,
            "check_band_launches": cuda_lk_dense.band_launches - n0}


def parallel_phase(pft, mods, frames, sim, cfg, cfg3, tables, report, dev,
                   smi):
    """parallel (a)-(d): every sharded entry in a one-rank NCCL group and
    as a SPLIT-way split on the one card, each against the unsharded
    route; K8's band launches; the one-rank overhead; the census. The
    group is destroyed however the phase ends."""
    import torch.distributed as dist
    from pyfeaturetrack_tpu_torch.parallel import initialize_cluster

    phase("parallel (a): a one-rank NCCL group through initialize_cluster; "
          "its meshes")
    info = initialize_cluster(coordinator_address=f"127.0.0.1:{free_port()}",
                              num_processes=1, process_id=0)
    try:
        return _parallel_runs(pft, mods, frames, sim, cfg, cfg3, tables,
                              report, dev, smi, info)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _parallel_runs(pft, mods, frames, sim, cfg, cfg3, tables, report, dev,
                   smi, info):
    import numpy as np
    import torch
    import torch.distributed as dist
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.models.chunked import (
        chunk_bounds, chunk_stack, track_chunks_batched)
    from pyfeaturetrack_tpu_torch.ops import cuda_lk_dense
    from pyfeaturetrack_tpu_torch.parallel import (
        collective_census, sharding, split_mesh, track_sequence_multiprocess)
    from pyfeaturetrack_tpu_torch.sfm.ba import pad_problem_for_mesh
    print(f"initialize_cluster: {info}")
    if info["backend"] != "nccl" or info["process_count"] != 1:
        fail(f"initialize_cluster did not bring up one NCCL rank: {info}")
    grid = sharding.make_mesh(1, 1)
    pix = sharding.make_axis_mesh("pixrow")
    lmk = sharding.make_axis_mesh("landmark")
    # the combine layer skips an axis of one rank; each group's NCCL
    # all-gather is exercised here directly
    for mesh in (grid, pix, lmk):
        for axis in mesh.mesh_dim_names:
            t = torch.arange(6, dtype=torch.float32, device=dev) + 0.5
            parts = [torch.empty_like(t)]
            dist.all_gather(parts, t, group=mesh.get_group(axis))
            torch.cuda.synchronize()
            if not torch.equal(parts[0], t):
                fail(f"NCCL all_gather over {axis} changed its input")
    print(f"meshes {grid.mesh_dim_names} {tuple(grid.shape)}, "
          f"{pix.mesh_dim_names}, {lmk.mesh_dim_names} on "
          f"{grid.device_type}; an NCCL all_gather over each axis's group "
          "returns its input")
    splits = {"grid": [split_mesh(sh, ("frame", "feature"), dev)
                       for sh in ((2, 2), (SPLIT, 1), (1, SPLIT))],
              "pix": [split_mesh((SPLIT,), ("pixrow",), dev)],
              "lmk": [split_mesh((SPLIT,), ("landmark",), dev)],
              "frame": [split_mesh((SPLIT, 1), ("frame", "feature"), dev)]}
    one = {"grid": grid, "pix": pix, "lmk": lmk, "frame": grid}

    def pair_inputs(fr, table):
        xs, ys, vs = (np.asarray(a[:PAR_PAIRS]) for a in table)
        return (np.stack(fr[:PAR_PAIRS]), np.stack(fr[1:PAR_PAIRS + 1]),
                xs, ys, vs)

    def unsharded_pairs(inp, c, full=False):
        # per pair: the two-frame track, or the device sequence's step
        # (track, affine check, refill) from frame 1's pyramids
        outs = []
        for b in range(PAR_PAIRS):
            args = [torch.as_tensor(np.asarray(a[b]), device=dev)
                    for a in inp]
            args = [a.to(torch.float32) for a in args[:4]] + [
                args[4].to(torch.int32)]
            pyr1 = pft.build_track_pyramids(args[0], c)
            if full:
                outs.append(pft.sequence_step_device(
                    pyr1, args[1], *args[2:], c, replace_lost=True,
                    aff=pft.make_affine_state(args[2].shape[0], c, dev))[1:4])
            else:
                outs.append(pft.track_features_pyramids(
                    pyr1, pft.build_track_pyramids(args[1], c), *args[2:],
                    c))
        return tuple(torch.stack(o) for o in zip(*outs))

    dcfg = pft.create_config()
    full_cfg = pft.create_config(affineConsistencyCheck=2,
                                 lighting_insensitive=True).validated_window()
    t_in = pair_inputs(frames, tables["default"])
    t3_in = pair_inputs(sim, tables["config 3"])
    left, right, _ = make_stereo_pair()
    streams = [make_frames(STREAM_TICKS, seed=SEED + 10 + b)
               for b in range(N_STREAMS)]
    batches = [np.stack([st[i] for st in streams])
               for i in range(STREAM_TICKS)]
    stack, inits = chunk_stack(frames, chunk_bounds(N_FRAMES, SPLIT),
                               N_FEATURES, cfg)
    c_in = (stack, inits[..., 0], inits[..., 1],
            inits[..., 2].astype(np.int64))

    def serve_unsharded():
        tr = pft.BatchedStreamingTracker(cfg, n_streams=N_STREAMS,
                                         n_features=N_FEATURES, chain=CHAIN)
        for b in batches:
            tr.feed(b)
        return tr.table()

    # the landmark layouts are made once per rank count (host work that a
    # deployment does once per problem), outside the timed calls
    ba_p, ba_R, ba_t, ba_X = ba_problem(dev)
    ba_pads = {d: pad_problem_for_mesh(ba_p, BA_POINTS, d)[0]
               for d in (1, SPLIT)}

    def ba_sharded(mesh):
        return sfm.bundle_adjust(
            ba_pads[sharding.mesh_sizes(mesh)["landmark"]], ba_R, ba_t, ba_X,
            n_iters=BA_ITERS, mesh=mesh)

    def wba(tag):
        c = WBA[tag]
        p, R, t, X0 = windowed_problem(c["C"], c["L"], c["kw"], dev)
        kw = dict(n_iters=c["iters"], point_only_iters=0,
                  solver=c["solver"], precond_block=c["g"])
        pads = {d: sfm.pad_windowed_for_mesh(p, X0, d)[:2]
                for d in (1, SPLIT)}

        def sharded(mesh):
            pp, Xp = pads[sharding.mesh_sizes(mesh)["landmark"]]
            out = sfm.bundle_adjust_windowed(pp, R, t, Xp, **kw, mesh=mesh)
            return out[:2] + (out[2][:c["L"]], out[3])
        return (sharded,
                lambda: sfm.bundle_adjust_windowed(p, R, t, X0, **kw))

    wba_5b, wba_5c = wba("5b"), wba("5c")
    n_res = {"dense BA": 2 * BA_CAMS * BA_POINTS,
             "windowed BA 5b": 2 * WBA["5b"]["L"] * WBA["5b"]["kw"],
             "windowed BA 5c": 2 * WBA["5c"]["L"] * WBA["5c"]["kw"]}
    sh = sharding
    # name: (sharded(mesh), unsharded(), mesh kind, comparison, kernels
    # the sharded run must launch)
    cases = {
        "track (default)": (
            lambda m: sh.track_batch_sharded(*t_in, dcfg, m),
            lambda: unsharded_pairs(t_in, dcfg), "grid", "exact",
            ("K1", "K2")),
        "track (config 3)": (
            lambda m: sh.track_batch_sharded(*t3_in, cfg3, m),
            lambda: unsharded_pairs(t3_in, cfg3), "grid", "exact",
            ("K1", "K2")),
        "full step": (
            lambda m: sh.full_pair_batch_sharded(*t_in, full_cfg, m),
            lambda: unsharded_pairs(t_in, full_cfg, full=True),
            "grid", "exact", ("K1", "K2", "K3", "K4", "K6")),
        "dense flow": (
            lambda m: sh.dense_flow_sharded(frames[0], frames[1], dcfg, m),
            lambda: pft.compute_dense_flow(frames[0], frames[1], dcfg),
            "pix", "exact", ("K1", "K8")),
        "dense disparity": (
            lambda m: sh.dense_disparity_sharded(left, right, dcfg, m, 64.0),
            lambda: pft.dense_disparity(left, right, dcfg,
                                        max_disparity=64.0),
            "pix", "exact", ("K1", "K8")),
        "serving": (
            lambda m: sh.batched_serving_sharded(batches, cfg, N_FEATURES, m,
                                                 chain=CHAIN),
            serve_unsharded, "frame", "exact", ("K1", "K2", "K3", "K4")),
        "chunks": (
            lambda m: sh.track_chunks_sharded(*c_in, cfg, m,
                                              replace_lost=True,
                                              chain=CHAIN)[:3],
            lambda: track_chunks_batched(*c_in, cfg, replace_lost=True,
                                         chain=CHAIN)[:3],
            "frame", "exact", ("K1", "K2", "K3", "K4")),
        "dense BA": (ba_sharded,
                     lambda: sfm.bundle_adjust(ba_p, ba_R, ba_t, ba_X,
                                               n_iters=BA_ITERS),
                     "lmk", "ba", ()),
        "windowed BA 5b": (wba_5b[0], wba_5b[1], "lmk", "wba", ()),
        "windowed BA 5c": (wba_5c[0], wba_5c[1], "lmk", "wba", ())}

    def counted_run(fn):
        for m in mods.values():
            m.launches = 0
        cuda_lk_dense.band_launches = 0
        res, census = collective_census(fn)
        torch.cuda.synchronize()
        counts = {k: m.launches for k, m in mods.items()}
        counts["K8 band"] = cuda_lk_dense.band_launches
        return res, census, counts

    def flat(res):
        if isinstance(res, dict):
            return [res[k] for k in ("x", "y", "val")]
        return list(res)

    out = {}
    band_launches = 0
    phase(f"parallel (a), (b): each sharded entry on the one-rank meshes "
          f"and as a {SPLIT}-way split on the card (ranks' bodies in turn) "
          "against the unsharded route")
    for name, (sharded, unsharded, kind, how, need) in cases.items():
        want = unsharded()
        got1, census1, counts1 = counted_run(lambda: sharded(one[kind]))
        for k in need:
            if counts1[k] <= 0:
                fail(f"{name}, one rank: {k} was never launched ({counts1})")
        if how == "exact":
            maps_equal(flat(got1), flat(want), f"{name}, one rank")
        else:
            maps_equal(flat(got1)[:4], flat(want)[:4], f"{name}, one rank")
        rec = {"one_rank": "bit-equal", "one_rank_launches": counts1,
               "one_rank_collectives": len(census1["records"])}
        for mesh in splits[kind]:
            tag = "x".join(map(str, mesh.shape))
            got, census, counts = counted_run(lambda: sharded(mesh))
            for k in need:
                if counts[k] <= 0:
                    fail(f"{name}, split {tag}: {k} was never launched")
            if how == "exact":
                maps_equal(flat(got), flat(want), f"{name}, split {tag}")
                rec[f"split_{tag}"] = "bit-equal"
            else:
                rec[f"split_{tag}"] = ba_within(got, want, how == "wba",
                                                n_res[name],
                                                f"{name}, split {tag}")
            band_launches += counts["K8 band"]
            rec[f"split_{tag}_launches"] = counts
            rec[f"split_{tag}_census"] = {
                k: v for k, v in census.items() if k != "records"}
        print(f"{name}: one rank {rec['one_rank']} (launches {counts1}); "
              + "; ".join(f"split {k[6:]} {v}" for k, v in rec.items()
                          if k.startswith("split_") and "_l" not in k
                          and "_c" not in k))
        out[name] = rec

    phase("parallel (b), K8's row band: each level cut into "
          f"{SPLIT} bands")
    out["K8 band"] = k8_band_checks(pft, frames, dcfg, dev, smi)

    phase("parallel (a): track_sequence_multiprocess on the one-rank group "
          f"against track_sequence_chunked ({N_FRAMES} frames, {SPLIT} "
          "chunks)")
    for m in mods.values():
        m.launches = 0
    table, ids = track_sequence_multiprocess(frames, n_features=N_FEATURES,
                                             n_chunks=SPLIT)
    counts = {k: m.launches for k, m in mods.items()}
    ref, ref_ids, _ = pft.track_sequence_chunked(frames,
                                                 n_features=N_FEATURES,
                                                 n_chunks=SPLIT)
    same = (all(np.array_equal(table[k], ref[k]) for k in ("x", "y", "val"))
            and all(np.array_equal(a, b) for a, b in zip(ids, ref_ids)))
    print(f"track_sequence_multiprocess table {table['x'].shape} equal to "
          f"track_sequence_chunked's: {same}; launches {counts}")
    if not same:
        fail("track_sequence_multiprocess differs from "
             "track_sequence_chunked")
    for k in ("K1", "K2", "K5"):
        if counts[k] <= 0:
            fail(f"track_sequence_multiprocess never launched {k}")
    out["track_sequence_multiprocess"] = {"equal": same, "launches": counts}

    phase("parallel (c): the one-rank overhead, sharded entry against the "
          "unsharded route, CUDA events (medians of 5, in turns)")
    overhead = {}
    for name, (sharded, unsharded, kind, how, _) in cases.items():
        # in turns (sharded, unsharded, unsharded, sharded): each figure
        # is the mean of its two medians of 5
        turns = [event_ms(fn, reps=5, warmup=1)[0] for fn in (
            lambda: sharded(one[kind]), unsharded, unsharded,
            lambda: sharded(one[kind]))]
        ms_sh, ms_un = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        row = {"sharded_ms": ms_sh, "unsharded_ms": ms_un,
               "ratio": ms_sh / ms_un, "turns_ms": turns}
        if how != "exact":
            iters = BA_ITERS if how == "ba" else WBA[name[-2:]]["iters"]
            row.update(iters_per_s_mesh=iters / (ms_sh / 1e3),
                       iters_per_s=iters / (ms_un / 1e3))
        overhead[name] = row
        print(f"{name}: sharded (one rank) {ms_sh:.4f} ms, unsharded "
              f"{ms_un:.4f} ms, ratio {row['ratio']:.4f}"
              + (f", iterations/s {row['iters_per_s_mesh']:.2f} with mesh= "
                 f"against {row['iters_per_s']:.2f}" if how != "exact"
                 else ""))
    print(f"card {smi}")
    out["overhead"] = overhead

    phase("parallel (d): destroy the group")
    dist.destroy_process_group()
    if dist.is_initialized():
        fail("the process group outlived destroy_process_group")
    report["K8"]["band_launches"] = band_launches
    for k in ("band_ms", "band_device_ms", "band_plain_ms", "band_bound_ms",
              "band_bound_by"):
        report["K8"][k] = out["K8 band"][k]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="after the smoke, time the step three ways and "
                        "trace it with torch.profiler")
    profile = parser.parse_args(argv).profile
    t_start = time.perf_counter()

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
    from pyfeaturetrack_tpu_torch.ops import (cuda_affine, cuda_eig, cuda_lk,
                                              cuda_lk_dense, cuda_pyramid,
                                              cuda_select, cuda_suppress,
                                              cuda_window_terms)
    from pyfeaturetrack_tpu_torch.ops.affine import affine_consistency_check
    from pyfeaturetrack_tpu_torch.ops.interp import gather_window
    from pyfeaturetrack_tpu_torch.ops import select as select_mod
    from pyfeaturetrack_tpu_torch.ops.select import select_features_from_eig
    from pyfeaturetrack_tpu_torch.ops.select_device import (
        _candidate_grid, premask_radius, select_features_from_eig_device)
    from pyfeaturetrack_tpu_torch.utils import cuda
    from pyfeaturetrack_tpu_torch.utils.io import pgm_read
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
    prof_dir = root / "build" / "profile"

    # ---- phase 3: every kernel against its plain version on the card ----
    phase("kernels vs plain versions (480x640, 1000 features)")
    img0 = torch.as_tensor(frames[0], device=dev).to(torch.float32)
    img1 = torch.as_tensor(frames[1], device=dev).to(torch.float32)
    taps = cuda_pyramid.level_taps(cfg)

    # K1, each level on its own (pyramid_level, one launch), then whole
    # pyramids (pyramid_build, at most two launches), all bit for bit
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
            same = torch.equal(a, b)
            print(f"K1 level {level} {name} {tuple(a.shape)}: bit-equal {same}")
            if not same:
                fail(f"K1 level {level} {name} differs from its plain version")
        lvl_in = got[3]
    rng7 = np.random.default_rng(SEED + 7)
    k1_frames = {"480x640": img0,
                 "481x643": torch.as_tensor(np.floor(smooth_texture(
                     rng7, 481, 643)), dtype=torch.float32, device=dev),
                 "480x70 (narrow levels)": img0[:, :70].contiguous()}
    for fname, frame in k1_frames.items():
        for levels, sub in ((1, 4), (2, 4), (3, 4), (4, 4), (1, 2), (2, 2),
                            (3, 2), (4, 2)):
            for sname, over in (("default sigmas", {}),
                                ("13x13 window sigmas",
                                 {"window_width": 13, "window_height": 13})):
                kcfg = pft.create_config(nPyramidLevels=levels,
                                         subsampling=sub, **over)
                k1_build_check(pft, cuda_pyramid, cuda, frame, kcfg,
                               f"{fname}, {sname}")

    def build_frame(img):
        return pft.build_track_pyramids(img, cfg)

    k1_ms = time_ms(lambda: build_frame(img0))
    with cuda.reference_path():
        k1_plain = time_ms(lambda: build_frame(img0))
    k1_names = ["::level0_kernel", "::coarse_kernel"]
    k1_dev, k1_n = device_ms(lambda: build_frame(img0), k1_names, prof_dir)
    k1_split = [device_ms(lambda: build_frame(img0), [k], prof_dir)[0]
                for k in k1_names]
    print(f"K1 full pyramid build ({cfg.nPyramidLevels} levels): kernel "
          f"{k1_ms:.4f} ms by events, {k1_dev:.4f} ms device ({k1_n:.0f} "
          f"launches: level 0 {k1_split[0]:.4f}, coarser levels "
          f"{k1_split[1]:.4f}), plain {k1_plain:.4f} ms")
    report["K1"] = dict(max_abs_err=0.0, ms=k1_ms, plain_ms=k1_plain,
                        device_ms=k1_dev, work=k1_work(cfg, H, W))

    # K3: the standalone entry on the level-0 gradients, then K3 inside K1's
    # level-0 launch (the build with the map, the eig-only entry), all bit
    # for bit
    ww, wh = cfg.window_width, cfg.window_height
    pyr0 = build_frame(img0)
    gx0, gy0 = pyr0.gradx[0], pyr0.grady[0]
    eig_k = cuda_eig.min_eig_map(gx0, gy0, ww, wh)
    with cuda.reference_path():
        eig_p = cuda_eig.min_eig_map(gx0, gy0, ww, wh)
    torch.cuda.synchronize()
    same = torch.equal(eig_k, eig_p)
    print(f"K3 standalone eig map: bit-equal {same}")
    if not same:
        fail("K3 (standalone) differs from its plain version")
    for fname, frame in k1_frames.items():
        for over in ({}, {"window_width": 51, "window_height": 51},
                     {"window_width": 97, "window_height": 97},
                     {"window_width": 13, "window_height": 13,
                      "nPyramidLevels": 3, "subsampling": 2}):
            k3_fused_check(pft, cuda_pyramid, cuda_eig, cuda, frame,
                           pft.create_config(**over), fname)
    k3_ms = time_ms(lambda: cuda_eig.min_eig_map(gx0, gy0, ww, wh))
    with cuda.reference_path():
        k3_plain = time_ms(lambda: cuda_eig.min_eig_map(gx0, gy0, ww, wh))
    k3_dev, _ = device_ms(lambda: cuda_eig.min_eig_map(gx0, gy0, ww, wh),
                          ["::eig_kernel"], prof_dir)
    print(f"K3 standalone: kernel {k3_ms:.4f} ms by events, {k3_dev:.4f} ms "
          f"device, plain {k3_plain:.4f} ms")
    report["K3 standalone"] = dict(max_abs_err=0.0, ms=k3_ms,
                                   plain_ms=k3_plain, device_ms=k3_dev,
                                   work=k3_work(cfg, H, W))

    def eig_only():
        return cuda_pyramid.level0_eig(img0, taps, True, ww, wh)

    def build_with_map():
        return pft.build_track_pyramids(img0, cfg, with_eig=True)

    k3f_ms = time_ms(eig_only)
    with cuda.reference_path():
        k3f_plain = time_ms(eig_only)
    k3f_dev, _ = device_ms(eig_only, ["::level0_kernel"], prof_dir)
    k1f_ms = time_ms(build_with_map)
    k1f_dev, _ = device_ms(build_with_map, k1_names, prof_dir)
    k1f_l0, _ = device_ms(build_with_map, ["::level0_kernel"], prof_dir)
    k1f_w = k1_work(cfg, H, W, with_eig=True)
    print(f"K3 in K1 level 0: eig-only launch {k3f_ms:.4f} ms by events, "
          f"{k3f_dev:.4f} ms device, plain {k3f_plain:.4f} ms; the build "
          f"with the map {k1f_ms:.4f} ms by events, {k1f_dev:.4f} ms device "
          f"(level 0 {k1f_l0:.4f} against {k1_split[0]:.4f} without the "
          f"map), bound {bound_ms(*k1f_w)[0]:.6f} ms ({bound_ms(*k1f_w)[1]})")
    report["K3"] = dict(max_abs_err=0.0, ms=k3f_ms, plain_ms=k3f_plain,
                        device_ms=k3f_dev, work=k3_in_k1_work(cfg, H, W))
    report["K1"].update(fused_ms=k1f_ms, fused_device_ms=k1f_dev,
                        fused_level0_device_ms=k1f_l0,
                        level0_device_ms=k1_split[0],
                        fused_bound_ms=bound_ms(*k1f_w)[0])

    # K4, both stages: the initial selection (1000 of 255,744 candidates),
    # a refill (40 free slots), both at mindist 0 too, and a 1080x1920
    # initial selection
    n = N_FEATURES
    x0 = torch.full((n,), -1.0, device=dev)
    v0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    geom = _candidate_grid(cfg, eig_k.shape)
    sel = pft.select_step_device(img0, cfg, n)
    x_sel, y_sel, v_sel = sel[1], sel[2], sel[3]
    lost = torch.zeros(n, dtype=torch.bool, device=dev)
    lost[torch.arange(0, n, 25, device=dev)] = True   # 40 lost slots
    v_lost = torch.where(lost, -4, v_sel)
    k4_cases = {}
    for name, kcfg, (x, y, v), replacing in (
            ("initial", cfg, (x0, x0, v0), False),
            ("refill", cfg, (x_sel, y_sel, v_lost), True),
            ("initial, mindist 0", cfg.replace(mindist=0), (x0, x0, v0),
             False),
            ("refill, mindist 0", cfg.replace(mindist=0),
             (x_sel, y_sel, v_lost), True)):
        k4_cases[name] = k4_check(cuda_select, cuda, eig_k, x, y, v, geom,
                                  kcfg, replacing, name, prof_dir,
                                  timed="mindist 0" not in name)
    rng5 = np.random.default_rng(SEED + 5)
    hd = torch.as_tensor(np.floor(smooth_texture(rng5, 1080, 1920)),
                         dtype=torch.float32, device=dev)
    hd_pyr = pft.build_track_pyramids(hd, cfg)
    eig_hd = cuda_eig.min_eig_map(hd_pyr.gradx[0], hd_pyr.grady[0],
                                  cfg.window_width, cfg.window_height)
    geom_hd = _candidate_grid(cfg, eig_hd.shape)
    k4_hd = k4_check(cuda_select, cuda, eig_hd, x0, x0, v0, geom_hd, cfg,
                     False, "initial, 1080x1920", prof_dir, timed="events")
    # the wider segment widths: 768x1280 (64 columns), 1440x2560 (256),
    # 2160x3840 (512: initial selection, then a refill of 40 slots with the
    # pre-mask, the box bitmap in device memory), 2880x5120 (1024) and
    # 4320x7680 (2048, the width read at run time)
    rng6 = np.random.default_rng(SEED + 6)
    k4_uhd = None
    for fh, fw in ((768, 1280), (1440, 2560), (2160, 3840), (2880, 5120),
                   (4320, 7680)):
        frame = torch.as_tensor(np.floor(smooth_texture(rng6, fh, fw)),
                                dtype=torch.float32, device=dev)
        fpyr = pft.build_track_pyramids(frame, cfg)
        eig_f = cuda_eig.min_eig_map(fpyr.gradx[0], fpyr.grady[0],
                                     cfg.window_width, cfg.window_height)
        geom_f = _candidate_grid(cfg, eig_f.shape)
        big = fh == 2160
        out = k4_check(cuda_select, cuda, eig_f, x0, x0, v0, geom_f, cfg,
                       False, f"initial, {fh}x{fw}", prof_dir, timed=big)
        if big:
            k4_uhd = out
            sel_f = cuda_select.select_from_eig(
                eig_f, x0, x0, v0, geom_f, min_eig=int(cfg.min_eigenvalue),
                radius=-1, dg=(cfg.mindist - 1) // geom_f[2],
                replacing=False)
            k4_check(cuda_select, cuda, eig_f, sel_f[0], sel_f[1],
                     torch.where(lost, -4, sel_f[2]), geom_f, cfg, True,
                     f"refill, {fh}x{fw}", prof_dir, timed=False)
        del frame, fpyr, eig_f
    # beyond the earlier caps: a lattice wider than 40,960 columns (stage
    # A's pre-mask in device memory) and one taller than 27,803 rows (stage
    # B's row maxima in device memory), initial selection and refill
    for fh, fw in ((64, 41100), (27900, 64)):
        frame = torch.as_tensor(np.floor(smooth_texture(rng6, fh, fw)),
                                dtype=torch.float32, device=dev)
        fpyr = pft.build_track_pyramids(frame, cfg)
        eig_f = cuda_eig.min_eig_map(fpyr.gradx[0], fpyr.grady[0],
                                     cfg.window_width, cfg.window_height)
        geom_f = _candidate_grid(cfg, eig_f.shape)
        k4_check(cuda_select, cuda, eig_f, x0, x0, v0, geom_f, cfg, False,
                 f"initial, {fh}x{fw}", prof_dir, timed=False)
        sel_f = cuda_select.select_from_eig(
            eig_f, x0, x0, v0, geom_f, min_eig=int(cfg.min_eigenvalue),
            radius=-1, dg=(cfg.mindist - 1) // geom_f[2], replacing=False)
        k4_check(cuda_select, cuda, eig_f, sel_f[0], sel_f[1],
                 torch.where(lost, -4, sel_f[2]), geom_f, cfg, True,
                 f"refill, {fh}x{fw}", prof_dir, timed=False)
        del frame, fpyr, eig_f, sel_f
    ref_case = k4_cases["refill"]
    report["K4"] = dict(max_abs_err=0.0, ms=ref_case["ms"],
                        plain_ms=ref_case["plain_ms"],
                        device_ms=ref_case["device_ms"],
                        work=ref_case["work"],
                        initial_ms=k4_cases["initial"]["ms"],
                        initial_device_ms=k4_cases["initial"]["device_ms"],
                        initial_1080p_ms=k4_hd["ms"],
                        initial_2160p_ms=k4_uhd["ms"])
    cand_init = cuda_select.candidate_lattice(
        eig_k, x0, x0, v0, geom, min_eig=int(cfg.min_eigenvalue),
        radius=-1).cells[:, :geom[4]]
    cand_ref = cuda_select.candidate_lattice(
        eig_k, x_sel, y_sel, v_lost, geom, min_eig=int(cfg.min_eigenvalue),
        radius=premask_radius(cfg, True)).cells[:, :geom[4]]
    free_ref = v_lost < 0

    # K5 on the host API's sorted candidate lists: (a) the real frame's
    # initial selection, (b) a refill, (c) a synthetic mix, (d) a 1080x1920
    # frame; each through the list entry (greedy_suppress, flags and index
    # list) and the fused entry (suppress_and_fill: decode, budget, scan and
    # slot fill in one launch, the host API's route)
    min_eig = max(int(cfg.min_eigenvalue), 1)

    def sorted_list(cand, shape):
        """The host API's sort of a lattice map and the candidate list it
        decodes to (as ops/select.select_features_from_eig sorts it)."""
        neg, order = torch.sort(-cand.reshape(-1), stable=True)
        g = _candidate_grid(cfg, shape)
        cx, cy, _, valid = cuda_suppress.decode_candidates(neg, order, g,
                                                           min_eig)
        return (neg, order, g), (cx, cy, valid)

    def k5_case(name, cx, cy, valid, shape, mindist, budget, max_out):
        b = torch.full((1,), budget, dtype=torch.int32, device=dev)
        kw = dict(shape=shape, mindist=mindist, budget=b, max_out=max_out)
        grid = "shared" if cuda_suppress.grid_bytes(shape) <= \
            cuda_suppress.SMEM_GRID_BYTES else "global"
        got = cuda_suppress.greedy_suppress(cx, cy, valid, **kw)
        with cuda.reference_path():
            want = cuda_suppress.greedy_suppress(cx, cy, valid, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(got, want))
        print(f"K5 list entry {name}: {cx.shape[0]} candidates, mindist "
              f"{mindist}, budget {budget}, grid {grid}: accepted "
              f"{int(got[2].item())} (plain {int(want[2].item())}), exact "
              f"{same}")
        if not same:
            fail(f"K5 ({name}) differs from its plain version")
        return got, kw

    def k5_fill_case(name, sort, shape, mindist, x, y, v, replacing,
                     bar=min_eig):
        neg, order, g = sort
        kw = dict(geom=g, min_eig=bar, shape=shape, mindist=mindist, x=x, y=y,
                  val=v, replacing=replacing)
        before = cuda_suppress.launches
        got = cuda_suppress.suppress_and_fill(neg, order, **kw)
        n_launch = cuda_suppress.launches - before
        with cuda.reference_path():
            want = cuda_suppress.suppress_and_fill(neg, order, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(got, want))
        free = int((v < 0).sum().item()) if replacing else v.shape[0]
        grid = "shared" if cuda_suppress.grid_bytes(shape) <= \
            cuda_suppress.SMEM_GRID_BYTES else "global"
        filled = int((got[2] >= 0).sum().item()) - (v.shape[0] - free)
        print(f"K5 fused entry {name}: {neg.shape[0]} sorted candidates, "
              f"mindist {mindist}, {free} free slots, grid {grid}: filled "
              f"{filled}, {n_launch} launch, exact {same}")
        if not same or n_launch != 1:
            fail(f"K5's fused entry ({name}) differs from its plain version")
        return (neg, order), kw

    sort_i, (cx, cy, cvalid) = sorted_list(cand_init, (H, W))
    if cx.shape[0] != 255744:
        fail(f"the 480x640 candidate list has {cx.shape[0]} entries")
    k5_init, k5_kw = k5_case("initial (a)", cx, cy, cvalid, (H, W),
                             cfg.mindist, n, n)
    k5_fill_init = k5_fill_case("initial (a)", sort_i, (H, W), cfg.mindist,
                                x0, x0, v0, False)
    sort_r, (rx, ry, rvalid) = sorted_list(cand_ref, (H, W))
    _, k5_ref_kw = k5_case("refill (b)", rx, ry, rvalid, (H, W), cfg.mindist,
                           int(free_ref.sum().item()), n)
    k5_fill_ref = k5_fill_case("refill (b)", sort_r, (H, W), cfg.mindist,
                               x_sel, y_sel, v_lost, True)
    # (c): pixel lists with candidates at every edge and 10 % invalid (list
    # entry); a full-frame lattice of tied values, 10 % below the bar, with
    # 2000 slots at budgets 0, 7 and all (fused entry)
    mix_vals = torch.as_tensor(rng5.integers(0, 50, (H, W)), dtype=torch.int32,
                               device=dev)
    mix_sort = (*torch.sort(-mix_vals.reshape(-1), stable=True),
                (0, 0, 1, H, W))
    mix_n = 2000
    slot_x = torch.as_tensor(rng5.uniform(0, W, mix_n), dtype=torch.float32,
                             device=dev)
    slot_y = torch.as_tensor(rng5.uniform(0, H, mix_n), dtype=torch.float32,
                             device=dev)
    slot_kept = torch.as_tensor(rng5.integers(0, 5000, mix_n),
                                dtype=torch.int32, device=dev)
    for mindist in (0, 1, 10, 25, 60):
        k = 20000
        dd = max(mindist - 1, 1)
        mx = np.where(rng5.uniform(size=k) < 0.3,
                      rng5.choice([0, dd, W - 1 - dd, W - 1], k),
                      rng5.integers(0, W, k))
        my = np.where(rng5.uniform(size=k) < 0.3,
                      rng5.choice([0, dd, H - 1 - dd, H - 1], k),
                      rng5.integers(0, H, k))
        margs = (torch.as_tensor(mx, dtype=torch.int32, device=dev),
                 torch.as_tensor(my, dtype=torch.int32, device=dev),
                 torch.as_tensor(rng5.uniform(size=k) > 0.1, device=dev))
        for budget in (0, 7, k):
            k5_case("mix (c)", *margs, (H, W), mindist, budget, k)
        for budget in (0, 7, mix_n):
            v = slot_kept.clone()
            v[:budget] = -1
            k5_fill_case("mix (c)", mix_sort, (H, W), mindist, slot_x, slot_y,
                         v, budget < mix_n, bar=5)
    cand_hd = cuda_select.candidate_lattice(
        eig_hd, x0, x0, v0, geom_hd, min_eig=int(cfg.min_eigenvalue),
        radius=-1).cells[:, :geom_hd[4]]
    sort_hd, hd_list = sorted_list(cand_hd, (1080, 1920))
    k5_case("1080x1920 (d)", *hd_list, (1080, 1920), cfg.mindist, n, n)
    k5_fill_case("1080x1920 (d)", sort_hd, (1080, 1920), cfg.mindist, x0, x0,
                 v0, False)
    del hd, hd_pyr, eig_hd, cand_hd, sort_hd, hd_list, mix_vals, mix_sort

    # times on the real frame: the sort, the fused entry and the list entry
    # on the initial selection (a) and the refill (b), and K4's selection of
    # the same 1000 features from the same map
    flat_init = cand_init.reshape(-1)
    sort_ms = time_ms(lambda: torch.sort(-flat_init, stable=True))

    def fill_call(case):
        (neg, order), kw = case
        return lambda: cuda_suppress.suppress_and_fill(neg, order, **kw)

    def list_call(lists, kw):
        return lambda: cuda_suppress.greedy_suppress(*lists, **kw)

    k5_ms = time_ms(fill_call(k5_fill_init))
    k5_dev, _ = device_ms(fill_call(k5_fill_init), ["::fill_kernel"], prof_dir)
    with cuda.reference_path():
        k5_plain = time_ms(fill_call(k5_fill_init), reps=2)
    k5_ref_ms = time_ms(fill_call(k5_fill_ref))
    k5_ref_dev, _ = device_ms(fill_call(k5_fill_ref), ["::fill_kernel"],
                              prof_dir)
    k5_list_ms = time_ms(list_call((cx, cy, cvalid), k5_kw))
    k5_list_dev, _ = device_ms(list_call((cx, cy, cvalid), k5_kw),
                               ["::suppress_kernel"], prof_dir)
    k5_list_ref_dev, _ = device_ms(list_call((rx, ry, rvalid), k5_ref_kw),
                                   ["::suppress_kernel"], prof_dir)
    print(f"K5 fused entry, refill (b), {rx.shape[0]} candidates, budget "
          f"{int(free_ref.sum().item())}: {k5_ref_ms:.4f} ms by events, "
          f"{k5_ref_dev:.4f} ms device; list entry {k5_list_ref_dev:.4f} ms "
          "device")
    k4_init_ms = k4_cases["initial"]["ms"]
    k5_route = select_features_from_eig(eig_k, x0, x0, v0, cfg,
                                        replacing=False)
    k4_route = select_features_from_eig_device(eig_k, x0, x0, v0, cfg,
                                               replacing=False)[:3]
    torch.cuda.synchronize()
    routes_same = all(torch.equal(a, b) for a, b in zip(k5_route, k4_route))
    scanned = k5_scanned(cx.shape[0], k5_init[2], k5_init[1], n)
    print(f"initial selection, 480x640, 1000 features: torch.sort "
          f"{sort_ms:.4f} ms + K5 fused entry {k5_ms:.4f} ms (device "
          f"{k5_dev:.4f} ms; plain {k5_plain:.4f} ms; the scan read {scanned}"
          f" of {cx.shape[0]} candidates; list entry {k5_list_ms:.4f} ms, "
          f"device {k5_list_dev:.4f} ms) vs K4 {k4_init_ms:.4f} ms (device "
          f"{k4_cases['initial']['device_ms']:.4f} ms); the two "
          f"routes select the same features: {routes_same}; card {smi}")
    if not routes_same:
        fail("sort + K5 and K4 select different features")
    report["K5"] = dict(max_abs_err=0.0, ms=k5_ms, plain_ms=k5_plain,
                        device_ms=k5_dev, refill_ms=k5_ref_ms,
                        refill_device_ms=k5_ref_dev, list_ms=k5_list_ms,
                        list_device_ms=k5_list_dev,
                        list_refill_device_ms=k5_list_ref_dev,
                        work=k5_fill_work(cx.shape[0], k5_init[2], k5_init[1],
                                          n, cfg.mindist, n))

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
                       ("status mix, max_iterations 3", {"max_iterations": 3}),
                       ("status mix, 13x13 window",
                        {"window_width": 13, "window_height": 13}),
                       *((f"status mix, {k}x{k} window",
                          {"window_width": k, "window_height": k})
                         for k in (17, 25, 31, 51))):
        gain = 0.8 if over.get("lighting_insensitive") else 1.0
        bias = 20.0 if over.get("lighting_insensitive") else 0.0
        # a window size goes through create_config: it sets the borders
        kcfg = (pft.create_config(**over).replace(sequentialMode=True)
                if "window_width" in over else cfg.replace(**over))
        k2_cases.append((name, kcfg, mix0, mix1 * gain + bias, mix_x, mix_y,
                         all_live))
    k2_call_work = [0, 0]
    for name, kcfg, fa, fb, x, y, live in k2_cases:
        pa, pb = pft.build_track_pyramids(fa, kcfg), pft.build_track_pyramids(
            fb, kcfg)
        k2_call_check(pa, pb, x, y, live, kcfg, cuda_lk, cuda.reference_path,
                      name)
        if name == "tracked pair":
            k2_pair = (pa, pb, x, y, v_sel, kcfg)
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
            if name == "tracked pair":
                lw = k2_work(kcfg, args[-1], got[3])
                k2_call_work = [k2_call_work[0] + lw[0], k2_call_work[1] + lw[1]]
            if name == "tracked pair" and r == 0:
                k2_in = args
                # K9's inputs: frame-1 windows at the features, frame-2
                # positions at the tracked positions
                k9_feats = (pa, pb, args[0], args[1], got[0], got[1])
            if name == "status mix" and r == 0:
                k9_mix = (pa, pb, mix_x, mix_y, mix_x, mix_y)
    k2_codes = {KLT_TRACKED, KLT_SMALL_DET, KLT_MAX_ITERATIONS, KLT_OOB,
                KLT_LARGE_RESIDUE}
    if not k2_codes <= k2_seen:
        fail(f"the K2 cases never produced statuses {sorted(k2_codes - k2_seen)}")
    k2_ms = time_ms(lambda: cuda_lk.track_pyramid(*k2_pair))
    k2_dev, _ = device_ms(lambda: cuda_lk.track_pyramid(*k2_pair),
                          ["::lk_pyramid_kernel"], prof_dir)
    with cuda.reference_path():
        k2_plain = time_ms(lambda: cuda_lk.track_pyramid(*k2_pair), reps=5)
    k2_old_ms = time_ms(lambda: earlier_k2(cuda_lk, *k2_pair))
    k2_old_dev, k2_old_n = device_ms(lambda: earlier_k2(cuda_lk, *k2_pair),
                                     ["::lk_level_kernel"], prof_dir)
    k2_lvl_ms = time_ms(lambda: cuda_lk.lk_level(*k2_in))
    print(f"K2 per track call (tracked pair, {cfg.nPyramidLevels} levels): "
          f"one launch {k2_ms:.4f} ms by events, {k2_dev:.4f} ms device; "
          f"plain {k2_plain:.4f} ms; earlier design (level loop around "
          f"{k2_old_n:.0f} per-level launches) {k2_old_ms:.4f} ms by events, "
          f"{k2_old_dev:.4f} ms device; one per-level launch (level 0) "
          f"{k2_lvl_ms:.4f} ms by events; card {smi}")
    # K2 on deep pyramids: 9 levels of the status mix, 12 levels of a
    # 2048x4096 frame (subsampling 2; K1 builds them, bit-equal too)
    rng8 = np.random.default_rng(SEED + 8)
    for levels, (fh, fw) in ((9, (H, W)), (12, (2048, 4096))):
        kcfg = pft.create_config(nPyramidLevels=levels, subsampling=2).replace(
            sequentialMode=True)
        if fh == H:
            fa, fb = mix0, mix1
        else:
            big = np.floor(smooth_texture(rng8, fh + 4, fw + 4))
            fa, fb = (torch.as_tensor(np.ascontiguousarray(f), dtype=torch.float32,
                                      device=dev)
                      for f in (big[:fh, :fw], big[1:fh + 1, 2:fw + 2]))
        pa, pb = (k1_build_check(pft, cuda_pyramid, cuda, f, kcfg,
                                 f"{fh}x{fw}") for f in (fa, fb))
        dx = torch.as_tensor(rng8.uniform(0, fw, n), dtype=torch.float32,
                             device=dev)
        dy = torch.as_tensor(rng8.uniform(0, fh, n), dtype=torch.float32,
                             device=dev)
        k2_call_check(pa, pb, dx, dy, all_live, kcfg, cuda_lk,
                      cuda.reference_path, f"{fh}x{fw}")
        del pa, pb, fa, fb
    report["K2"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                        device_ms=k2_dev, earlier_ms=k2_old_ms,
                        earlier_device_ms=k2_old_dev,
                        work=tuple(k2_call_work),
                        windows_checked=["7x7", "13x13", "17x17", "25x25",
                                         "31x31", "51x51"],
                        levels_checked=[2, 3, 9, 12])
    report["K9_inputs"] = (k9_feats, k9_mix)
    torch.cuda.synchronize()

    # ---- phase 3, config 3: K1 and K2 at 3 levels / subsampling 2, K6 ----
    cfg3 = config3()
    phase(f"kernels vs plain versions, config 3 (affine mode 2, "
          f"{cfg3.nPyramidLevels} levels, subsampling {cfg3.subsampling}, "
          f"border {cfg3.borderx}, {cfg3.affine_window_width}x"
          f"{cfg3.affine_window_height} affine window)")
    sim = make_similarity_frames(N_FRAMES)
    s0 = torch.as_tensor(sim[0], device=dev).to(torch.float32)
    s1 = torch.as_tensor(sim[1], device=dev).to(torch.float32)
    taps3 = cuda_pyramid.level_taps(cfg3)
    lvl_in = s0
    for level in range(cfg3.nPyramidLevels):
        smooth, with_pyr = level == 0, level < cfg3.nPyramidLevels - 1
        got = cuda_pyramid.pyramid_level(lvl_in, taps3, smooth, with_pyr)
        with cuda.reference_path():
            want = cuda_pyramid.pyramid_level(lvl_in, taps3, smooth, with_pyr)
        torch.cuda.synchronize()
        for name, a, b in zip(("base", "gradx", "grady", "next"), got, want):
            if a is None:
                continue
            same = torch.equal(a, b)
            print(f"K1 config 3, level {level} {name} {tuple(a.shape)}: "
                  f"bit-equal {same}")
            if not same:
                fail(f"K1 config 3, level {level} {name} differs from its "
                     "plain version")
        lvl_in = got[3]
    k1_build_check(pft, cuda_pyramid, cuda, s0, cfg3, "config 3")
    k1_ms3 = time_ms(lambda: pft.build_track_pyramids(s0, cfg3))
    k1_dev3, k1_n3 = device_ms(lambda: pft.build_track_pyramids(s0, cfg3),
                               k1_names, prof_dir)
    print(f"K1 config-3 build ({cfg3.nPyramidLevels} levels): {k1_ms3:.4f} "
          f"ms by events, {k1_dev3:.4f} ms device ({k1_n3:.0f} launches)")
    report["K1"].update(config3_ms=k1_ms3, config3_device_ms=k1_dev3)

    sel3 = pft.select_step_device(s0, cfg3, n)
    pyr_s0 = sel3[0]
    x3, y3, v3 = sel3[1], sel3[2], sel3[3]
    pyr_s1 = pft.build_track_pyramids(s1, cfg3)
    k2_cases3 = [("similarity pair", cfg3, s0, s1, x3, y3, v3 >= 0),
                 ("status mix", cfg3, mix0, mix1, mix_x, mix_y, all_live)]
    for name, kcfg, fa, fb, x, y, live in k2_cases3:
        pa, pb = (pft.build_track_pyramids(f, kcfg) for f in (fa, fb))
        k2_call_check(pa, pb, x, y, live, kcfg, cuda_lk, cuda.reference_path,
                      f"config 3, {name}")
        for r, args, got, want in k2_levels(pa, pb, x, y, live, kcfg, cuda_lk,
                                             cuda.reference_path):
            active = args[-1]
            codes = got[2][active].cpu().numpy()
            err = max((a - b).abs().max().item() for a, b in zip(got[:2],
                                                                   want[:2]))
            k2_err = max(k2_err, err)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"K2 config 3, {name}, level {r}: {int(active.sum().item())} "
                  f"active, statuses (0,-1..-5) "
                  f"{np.bincount(-codes, minlength=6).tolist()}, bit-equal "
                  f"{same}")
            if not same:
                fail(f"K2 (config 3, {name}, level {r}) differs from its plain "
                     "version")
    report["K2"]["max_abs_err"] = k2_err

    # K6: a real pair (frame 0 -> 1 of the similarity motion, templates at
    # the selected features, starts at the known motion, every lane
    # checked) and the affine status mix, in modes 0, 1 and 2
    hw3, hh3 = cfg3.affine_window_width // 2, cfg3.affine_window_height // 2
    tmpl3 = gather_window(pyr_s0.img[0], x3, y3, hw3, hh3).contiguous()
    px_, py_ = predicted(x3.cpu().numpy().astype(np.float64),
                         y3.cpu().numpy().astype(np.float64))
    real_args = (tmpl3, pyr_s1.img[0], pyr_s1.gradx[0], pyr_s1.grady[0],
                 torch.as_tensor(px_, dtype=torch.float32, device=dev),
                 torch.as_tensor(py_, dtype=torch.float32, device=dev),
                 torch.eye(2, device=dev).repeat(n, 1, 1).contiguous(),
                 torch.ones(n, dtype=torch.bool, device=dev))
    mix_args, groups, mix_pyrs = make_affine_mix(cfg3, dev)
    k6_err = 0.0
    built_for = {"tracked": KLT_TRACKED, "flat": KLT_SMALL_DET,
                 "noise": KLT_LARGE_RESIDUE, "edge": KLT_OOB, "drift": KLT_OOB}
    for mode in (0, 1, 2):
        mcfg = cfg3.replace(affineConsistencyCheck=mode)
        for name, args in (("real pair", real_args), ("status mix", mix_args)):
            got = cuda_affine.affine_track_batch(*args, mcfg)
            with cuda.reference_path():
                want = cuda_affine.affine_track_batch(*args, mcfg)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item()
                      for a, b in zip(got[:3], want[:3]))
            k6_err = max(k6_err, err)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            codes = got[3].cpu().numpy()
            nit = got[4].cpu().numpy()
            print(f"K6 mode {mode}, {name}: statuses (0,-1..-5) "
                  f"{np.bincount(-codes, minlength=6).tolist()}, iterations "
                  f"{np.bincount(nit).tolist()}, bit-equal {same}")
            if not same:
                bad = torch.nonzero((got[0] != want[0]) | (got[1] != want[1])
                                    | (got[3] != want[3])
                                    | (got[4] != want[4])).flatten()[:20]
                for i in bad.tolist():
                    print(f"  lane {i}: kernel ({got[0][i].item()}, "
                          f"{got[1][i].item()}, {got[3][i].item()}, it "
                          f"{got[4][i].item()}) plain ({want[0][i].item()}, "
                          f"{want[1][i].item()}, {want[3][i].item()}, it "
                          f"{want[4][i].item()})")
                fail(f"K6 (mode {mode}, {name}) differs from its plain version")
            if name == "status mix":
                per = {g: np.bincount(-codes[groups == g], minlength=6).tolist()
                       for g in built_for.keys() | {"unchecked"}}
                print(f"  status mix by group (0,-1..-5): {per}")
                for g, code in built_for.items():
                    if not (codes[groups == g] == code).any():
                        fail(f"K6 mode {mode}: the {g} lanes never ended in "
                             f"status {code}")
                un = torch.as_tensor(groups == "unchecked", device=dev)
                if not (torch.equal(got[0][un], args[4][un])
                        and torch.equal(got[2][un], args[6][un])
                        and bool((got[3][un] == KLT_TRACKED).all())
                        and bool((got[4][un] == 0).all())):
                    fail(f"K6 mode {mode}: unchecked lanes did not pass "
                         "through")
    # windows above 256 samples (walked sample by sample), modes 0, 1, 2
    for k in (17, 25, 31, 51):
        wargs, _, _ = make_affine_mix(cfg3.replace(affine_window_width=k,
                                                   affine_window_height=k), dev)
        for mode in (0, 1, 2):
            mcfg = cfg3.replace(affineConsistencyCheck=mode,
                                affine_window_width=k, affine_window_height=k)
            got = cuda_affine.affine_track_batch(*wargs, mcfg)
            with cuda.reference_path():
                want = cuda_affine.affine_track_batch(*wargs, mcfg)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            codes = got[3].cpu().numpy()
            print(f"K6 mode {mode}, status mix, {k}x{k} window: statuses "
                  f"(0,-1..-5) {np.bincount(-codes, minlength=6).tolist()}, "
                  f"bit-equal {same}")
            if not same:
                fail(f"K6 (mode {mode}, {k}x{k} window) differs from its plain "
                     "version")
    k6_out = cuda_affine.affine_track_batch(*real_args, cfg3)
    k6_ms = time_ms(lambda: cuda_affine.affine_track_batch(*real_args, cfg3))
    with cuda.reference_path():
        k6_plain = time_ms(lambda: cuda_affine.affine_track_batch(
            *real_args, cfg3), reps=3)
    k6_dev, _ = device_ms(lambda: cuda_affine.affine_track_batch(
        *real_args, cfg3), ["::affine_kernel"], prof_dir)
    print(f"K6 batch (affine_track_batch) mode 2, real pair, {n} lanes: "
          f"kernel {k6_ms:.4f} ms by events, {k6_dev:.4f} ms device, plain "
          f"{k6_plain:.4f} ms")
    report["K6"] = dict(max_abs_err=k6_err, batch_ms=k6_ms,
                        batch_plain_ms=k6_plain, batch_device_ms=k6_dev,
                        batch_work=k6_work(cfg3, real_args[7], k6_out[4]),
                        windows_checked=["15x15", "17x17", "25x25", "31x31",
                                         "51x51"])

    # the whole affine stage (one K6 launch) on the affine status mix:
    # checked lanes of every status, template captures, lanes lost by
    # translational tracking, dead lanes; modes 0, 1, 2
    stage_args, stage_groups = make_stage_mix(cfg3, mix_args, groups,
                                              mix_pyrs, dev)
    for mode in (0, 1, 2):
        mcfg = cfg3.replace(affineConsistencyCheck=mode)
        stage_check(affine_consistency_check, cuda_affine, cuda,
                    stage_args + (mcfg,), f"mode {mode}, stage mix",
                    stage_groups)
    torch.cuda.synchronize()

    # ---- phase 4: the main path ----
    phase(f"main path: track_sequence_device, {N_FRAMES} frames, "
          f"{N_FEATURES} features, replace-lost")
    mods = {"K1": cuda_pyramid, "K2": cuda_lk, "K3": K3InK1(cuda_pyramid),
            K3_STANDALONE: cuda_eig, "K4": cuda_select}
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    xs, ys, vs = pft.track_sequence_device(frames, cfg=cfg,
                                           n_features=N_FEATURES,
                                           replace_lost=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts(mods, "main path")
    print(f"launches in the main-path run: {counts} ({wall:.2f} s wall, "
          "first calls included)")
    # two K1 launches per frame's build, the first of them with K3's map;
    # one K2 launch per track call, two K4 stages per selection
    expect_launches(counts, {"K1": 2 * N_FRAMES, "K2": N_FRAMES - 1,
                             "K3": N_FRAMES, "K4": 2 * N_FRAMES}, "main path")
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
    xs_main, ys_main, vs_main = xs, ys, vs
    report["K1"]["launches"] = counts["K1"]
    report["K2"]["launches"] = counts["K2"]
    report["K3"]["launches"] = counts["K3"]
    report[K3_STANDALONE]["launches"] = counts[K3_STANDALONE]
    report["K4"]["launches"] = counts["K4"]
    k3_paths = {"default": (counts["K3"], counts[K3_STANDALONE])}

    staged = [torch.as_tensor(fr, device=dev).to(torch.float32)
              for fr in frames]
    ms = step_times(pft, cfg, staged)
    print(f"main path per-frame step (track + refill), median of "
          f"{len(ms)}: {np.median(ms):.4f} ms (min {min(ms):.4f}, max "
          f"{max(ms):.4f})")
    del staged

    # ---- phase 5: the config-3 path (affine-consistency check) ----
    phase(f"affine path: track_sequence_device, config 3, {N_FRAMES} frames "
          f"under a similarity motion, {N_FEATURES} features, replace-lost")
    mods3 = dict(mods, K6=cuda_affine)
    for m in mods3.values():
        m.launches = 0
    t0 = time.perf_counter()
    xs, ys, vs = pft.track_sequence_device(sim, cfg=cfg3, n_features=N_FEATURES,
                                           replace_lost=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table3 = (xs, ys, vs)
    counts3 = path_counts(mods3, "config-3 path")
    print(f"launches in the config-3 run: {counts3} ({wall:.2f} s wall, first "
          "calls included)")
    # one K6 launch per step: the whole affine stage
    expect_launches(counts3, {"K1": 2 * N_FRAMES, "K2": N_FRAMES - 1,
                              "K3": N_FRAMES, "K4": 2 * N_FRAMES,
                              "K6": N_FRAMES - 1}, "config-3 path")
    if not (np.isfinite(xs).all() and np.isfinite(ys).all()):
        fail("non-finite positions (config 3)")
    if xs.shape != (N_FRAMES, N_FEATURES):
        fail(f"config-3 feature table shape {xs.shape}")
    pair = (vs[1:] == KLT_TRACKED) & (vs[:-1] >= 0)
    px_, py_ = predicted(xs[:-1][pair].astype(np.float64),
                         ys[:-1][pair].astype(np.float64))
    ex, ey = xs[1:][pair] - px_, ys[1:][pair] - py_
    refills = int((vs[1:] > 0).sum())
    print(f"tracked pairs {int(pair.sum())}; error against the known motion: "
          f"median ({np.median(ex):.4f}, {np.median(ey):.4f}) px, median abs "
          f"({np.median(np.abs(ex)):.4f}, {np.median(np.abs(ey)):.4f}) px, "
          f"99th percentile abs ({np.percentile(np.abs(ex), 99):.4f}, "
          f"{np.percentile(np.abs(ey), 99):.4f}) px; refilled slots {refills}; "
          f"live in last frame {int((vs[-1] >= 0).sum())}")
    if max(abs(np.median(ex)), abs(np.median(ey)), np.median(np.abs(ex)),
           np.median(np.abs(ey))) > DRIFT_TOL:
        fail("the config-3 tracks do not follow the known motion")
    if refills == 0:
        fail("no refill fired (config 3)")

    # the affine stage on its own, step by step over the whole sequence
    # (kernels, outside the counted run): templates held and lanes the
    # stage rejects after K2 tracked them
    staged3 = [torch.as_tensor(fr, device=dev).to(torch.float32) for fr in sim]

    stage_inputs = {}

    def affine_steps(n_frames, check_stage=False):
        """The config-3 steps one by one; with ``check_stage`` each step's
        affine stage (one K6 launch) is also held to its plain version on
        the same inputs (x, y, val, all eight AffineState fields)."""
        pyr, x, y, v, aff, _ = pft.select_step_device(staged3[0], cfg3,
                                                      N_FEATURES)
        hist, held, rejected = [(x, y, v)], [], []
        for i, img in enumerate(staged3[1:n_frames], start=1):
            pyr_new = pft.build_track_pyramids(img, cfg3)
            tx, ty, tv = pft.track_features_pyramids(pyr, pyr_new, x, y, v, cfg3)
            args = (pyr, pyr_new, pft.FeatureState(x, y, v, aff),
                    pft.FeatureState(tx, ty, tv, aff), cfg3)
            if check_stage:
                after = stage_check(affine_consistency_check, cuda_affine, cuda,
                                    args, f"config-3 step {i}")
                if i == N_FRAMES // 2:
                    stage_inputs["args"] = args
            else:
                after = affine_consistency_check(*args)
            rejected.append(((tv == KLT_TRACKED)
                             & (after.val != KLT_TRACKED)).sum())
            pyr, x, y, v, aff, _, _ = pft.sequence_step_device(
                pyr, img, x, y, v, cfg3, True, aff=aff)
            hist.append((x, y, v))
            held.append(aff.valid.sum())
        table = tuple(torch.stack([h[j] for h in hist]).cpu().numpy()
                      for j in range(3))
        return table, aff, torch.stack(held).cpu().numpy(), \
            torch.stack(rejected).cpu().numpy()

    table, aff_k, held, rejected = affine_steps(N_FRAMES, check_stage=True)
    print(f"K6 stage: every one of the {N_FRAMES - 1} config-3 steps bit-equal "
          "to its plain version (x, y, val and all eight AffineState fields)")
    sargs = stage_inputs["args"]
    st_ms = time_ms(lambda: affine_consistency_check(*sargs))
    st_dev, st_n = device_ms(lambda: affine_consistency_check(*sargs),
                             ["::stage_kernel"], prof_dir)
    with cuda.reference_path():
        st_plain = time_ms(lambda: affine_consistency_check(*sargs), reps=3)
        st_plain_dev, st_plain_n = device_ms(
            lambda: affine_consistency_check(*sargs), [""], prof_dir, reps=3)
    st_out = affine_consistency_check(*sargs)
    print(f"K6 affine stage, config-3 step {N_FRAMES // 2} ({N_FEATURES} "
          f"lanes): one launch {st_ms:.4f} ms by events, {st_dev:.4f} ms "
          f"device ({st_n:.0f} launches); the eager stage (plain) "
          f"{st_plain:.4f} ms by events, {st_plain_dev:.4f} ms device over "
          f"{st_plain_n:.0f} kernels; card {smi}")
    report["K6"].update(ms=st_ms, device_ms=st_dev, plain_ms=st_plain,
                        plain_device_ms=st_plain_dev,
                        work=k6_stage_work(cfg3, sargs, st_out))
    print(f"templates held per frame: min {held.min()}, median "
          f"{int(np.median(held))}, last {held[-1]}; lanes the affine stage "
          f"rejected: {int(rejected.sum())} over {N_FRAMES - 1} steps "
          f"(max {rejected.max()} in one step)")
    if not all(np.array_equal(a, b) for a, b in zip(table, (xs, ys, vs))):
        fail("the step-by-step config-3 run differs from track_sequence_device")
    if held[-1] < N_FEATURES // 2:
        fail("the affine stage holds templates for under half the features")
    if rejected.sum() == 0:
        fail("the affine stage rejected no lane")

    (kx, ky, kv), aff_k, _, _ = affine_steps(N_PLAIN_FRAMES)
    with cuda.reference_path():
        (px, py, pv), aff_p, _, _ = affine_steps(N_PLAIN_FRAMES)
    diff = np.argwhere((pv != kv) | (px != kx) | (py != ky))
    aff_same = {f: torch.equal(getattr(aff_k, f), getattr(aff_p, f))
                for f in aff_k._fields}
    print(f"plain-version run, config 3, {N_PLAIN_FRAMES} frames: {len(diff)} "
          f"(frame, lane) entries differ from the kernel run; AffineState "
          f"fields equal: {aff_same}")
    for f, i in diff[:20]:
        print(f"  frame {f} lane {i}: kernel ({kx[f, i]}, {ky[f, i]}, "
              f"{kv[f, i]}) plain ({px[f, i]}, {py[f, i]}, {pv[f, i]})")
    if len(diff) or not (aff_same["A"] and aff_same["valid"]):
        fail("the plain versions' config-3 table or warps differ from the "
             "kernels'")
    report["K6"]["launches"] = counts3["K6"]
    k3_paths["config 3"] = (counts3["K3"], counts3[K3_STANDALONE])

    ms3 = step_times(pft, cfg3, staged3)
    print(f"config-3 per-frame step (track + affine check + refill), median "
          f"of {len(ms3)}: {np.median(ms3):.4f} ms (min {min(ms3):.4f}, max "
          f"{max(ms3):.4f}); card {smi}")

    # ---- phase 6: BASELINE config 1, example 1 through the facade ----
    phase("config 1: example 1 through the KLT* facade, "
          "examples/data/img0.pgm -> img1.pgm, 100 features")
    data = root / "examples" / "data"
    ex0, ex1 = (pgm_read(data / f"img{i}.pgm") for i in (0, 1))
    mods1 = {"K1": cuda_pyramid, "K2": cuda_lk, "K3": K3InK1(cuda_pyramid),
             K3_STANDALONE: cuda_eig, "K4": cuda_select, "K5": cuda_suppress}
    tc = pft.KLTCreateTrackingContext()

    def example1():
        fl = pft.KLTSelectGoodFeatures(tc, ex0, 100)
        fl2, _ = pft.KLTTrackFeatures(tc, ex0, ex1, fl)
        return fl, fl2

    for m in mods1.values():
        m.launches = 0
    with counted([select_mod], "select_features_from_eig") as selections:
        sel1, trk1 = example1()
    counts1 = path_counts(mods1, "config-1 path")
    print(f"launches in the config-1 run: {counts1}; host-API selections "
          f"{len(selections)}")
    # one track call (two K1 builds of two launches each); the host API's
    # selection runs K1's eig-only level 0 (one launch: K3's map), K4's
    # stage A, then K5 (one launch: decode, budget, scan, slot fill)
    expect_launches(counts1, {"K1": 5, "K2": 1, "K3": len(selections),
                              "K4": 1, "K5": len(selections)},
                    "config-1 path")
    if len(selections) != 1:
        fail(f"the config-1 path made {len(selections)} selections")
    k3_paths["config 1"] = (counts1["K3"], counts1[K3_STANDALONE])
    with cuda.reference_path():
        psel1, ptrk1 = example1()
    same1 = all(torch.equal(a, b) for a, b in zip(sel1[:3] + trk1[:3],
                                                  psel1[:3] + ptrk1[:3]))
    if sel1.x.device.type != "cuda" or sel1.x.shape != (100,):
        fail("the facade did not return 100 features on the card")
    print("first features: " + ", ".join(
        f"({x:.3f},{y:.3f})={v}" for x, y, v in zip(
            trk1.x[:4].tolist(), trk1.y[:4].tolist(), trk1.val[:4].tolist())))
    print(f"selected and tracked lists equal to the plain versions': {same1}")
    if not same1:
        fail("the config-1 lists differ from the plain versions'")
    print(f"Remaining: {pft.KLTCountRemainingFeatures(trk1)} / 100")

    # ---- phase 7: BASELINE config 2, the host-API loop ----
    phase(f"config 2: track_sequence (host-API loop, sort + K5 refills), "
          f"{N_FRAMES} frames, {N_FEATURES} features, replace-lost")
    mods2 = dict(mods1)
    for m in mods2.values():
        m.launches = 0
    t0 = time.perf_counter()
    with counted([select_mod], "select_features_from_eig") as selections:
        ft2, metrics2 = pft.track_sequence(frames, cfg=cfg,
                                           n_features=N_FEATURES,
                                           replace_lost=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts2 = path_counts(mods2, "config-2 path")
    hx2, hy2, hv2 = (t.cpu().numpy() for t in ft2)
    refill_frames = int((hv2[1:] > 0).any(axis=1).sum())
    n_sel = len(selections)
    print(f"launches in the config-2 run: {counts2} ({wall:.2f} s wall); "
          f"host-API selections {n_sel}; frames with refilled slots "
          f"{refill_frames}")
    if not 1 + refill_frames <= n_sel <= N_FRAMES:
        fail("no selection on the first frame and on every refill")
    # two K1 launches per frame's build; per selection one eig-only level-0
    # launch (K3's map), K4's stage A and one K5 launch
    expect_launches(counts2, {"K1": 2 * N_FRAMES + n_sel, "K2": N_FRAMES - 1,
                              "K3": n_sel, "K4": n_sel, "K5": n_sel},
                    "config-2 path")
    if hx2.shape != (N_FRAMES, N_FEATURES) or not np.isfinite(hx2).all():
        fail(f"config-2 feature table shape {hx2.shape} or non-finite")
    diff = np.argwhere((hv2 != vs_main) | (hx2 != xs_main) | (hy2 != ys_main))
    print(f"table vs track_sequence_device: {len(diff)} (frame, lane) "
          f"entries differ; live in last frame {metrics2[-1]['n_live']}")
    for f, i in diff[:20]:
        print(f"  frame {f} lane {i}: host loop ({hx2[f, i]}, {hy2[f, i]}, "
              f"{hv2[f, i]}) device route ({xs_main[f, i]}, {ys_main[f, i]}, "
              f"{vs_main[f, i]})")
    if len(diff):
        fail("track_sequence differs from track_sequence_device")

    last = {}
    ft3, _ = pft.track_sequence(sim[:N_PLAIN_FRAMES], cfg=cfg3,
                                n_features=N_FEATURES, replace_lost=True,
                                device="cuda",
                                on_frame=lambda i, fl: last.update(fl=fl))
    (dx3, dy3, dv3), aff_d, _, _ = affine_steps(N_PLAIN_FRAMES)
    same3 = all(np.array_equal(t.cpu().numpy(), d)
                for t, d in zip(ft3, (dx3, dy3, dv3)))
    aff_same3 = {f: torch.equal(getattr(last["fl"].aff, f), getattr(aff_d, f))
                 for f in ("A", "valid")}
    print(f"config 3, {N_PLAIN_FRAMES} frames: track_sequence table equal to "
          f"the device route's: {same3}; AffineState equal: {aff_same3}")
    if not (same3 and all(aff_same3.values())):
        fail("the config-3 host loop differs from the device route")

    staged = [torch.as_tensor(fr, device=dev).to(torch.float32)
              for fr in frames]
    ms2 = host_loop_times(pft, cfg, staged)
    print(f"config-2 SequenceTracker.step (track + any(lost) + sort + K5 "
          f"refill + metrics), median of {len(ms2)}: {np.median(ms2):.4f} ms "
          f"(min {min(ms2):.4f}, max {max(ms2):.4f}); device-route step "
          f"median {np.median(ms):.4f} ms; card {smi}")
    report["K5"]["launches"] = counts2["K5"]
    k3_paths["config 2"] = (counts2["K3"], counts2[K3_STANDALONE])
    print("K3 launches per 100-frame path run (in K1's level-0 launch, "
          "standalone): " + ", ".join(f"{k} {a}, {b}"
                                      for k, (a, b) in k3_paths.items()))
    report["K3"]["launches_per_path"] = {
        k: a for k, (a, _) in k3_paths.items()}
    report[K3_STANDALONE]["launches_per_path"] = {
        k: b for k, (_, b) in k3_paths.items()}

    # ---- phase 8: dense flow, dense depth, refine; K8 and K9 ----
    dense_mods = {"K1": cuda_pyramid, "K2": cuda_lk,
                  "K3": K3InK1(cuda_pyramid), K3_STANDALONE: cuda_eig,
                  "K4": cuda_select, "K5": cuda_suppress, "K6": cuda_affine,
                  "K8": cuda_lk_dense, "K9": cuda_window_terms}
    dense_phase(pft, frames, (ex0, ex1), (sel1, trk1), dense_mods, report,
                dev, smi, prof_dir)

    # ---- phase 9: the serving and long-video path ----
    serving = serving_phase(
        pft, mods, cuda_affine, frames, sim,
        {"default": (xs_main, ys_main, vs_main), "config 3": table3}, cfg,
        cfg3, staged, staged3, smi, root)
    print(json.dumps({"serving": serving}))

    # ---- phase 10: the SfM back end and monocular VO ----
    sfm_mods = {"K1": cuda_pyramid, "K2": cuda_lk, "K3": K3InK1(cuda_pyramid),
                K3_STANDALONE: cuda_eig, "K4": cuda_select,
                "K5": cuda_suppress}
    sfm_out = sfm_phase(pft, sfm_mods, frames, cfg, cfg3, report, dev, smi,
                        prof_dir)
    print(json.dumps({"sfm": sfm_out}))

    # ---- phase 11: gradients through the kernels ----
    grad_mods = {"K1": cuda_pyramid, "K2": cuda_lk, "K3": K3InK1(cuda_pyramid),
                 K3_STANDALONE: cuda_eig, "K4": cuda_select,
                 "K5": cuda_suppress, "K6": cuda_affine, "K8": cuda_lk_dense,
                 "K9": cuda_window_terms}
    guided0 = cuda_lk.guided_launches
    grads = grad_phase(pft, frames, sim, cfg, cfg3, grad_mods, dev, smi)
    for k in grad_mods:
        report[k]["grad_launches"] = sum(
            g["launches"][k] for g in grads.values() if isinstance(g, dict))
    report["K2 guided"]["grad_launches"] = cuda_lk.guided_launches - guided0
    print(json.dumps({"grad": grads}))

    # ---- phase 12: the windowed BA and run_sfm_windowed ----
    windowed = {}
    for tag in WBA:
        c = WBA[tag]
        phase(f"sfm ({'f' if tag == '5b' else 'g'}): windowed BA, config "
              f"{tag}: {c['C']} cameras x {c['L']} landmarks x {c['kw']}-frame "
              f"windows, {c['iters']} iterations, solver {c['solver']}")
        windowed[tag] = windowed_ba(tag, prof_dir, dev, smi)
    phase(f"sfm (h): run_sfm_windowed on tests/test_sfm_e2e.py's scene "
          f"({E2E_FRAMES} frames, {E2E_H}x{E2E_W}, 80 features) tracked on "
          "the card; dense and CG")
    windowed["e2e"] = sfm_windowed_e2e(dev, smi)
    print(json.dumps({"sfm_windowed": windowed}))

    # ---- phase 13: checkpoint resume, the CLI and profiling ----
    tools_dir = root / "build" / "smoke_tools"
    tools_dir.mkdir(parents=True, exist_ok=True)
    phase("tools: checkpoint resume of SequenceTracker, StreamingTracker "
          f"(chain {CHAIN}) and the corridor VO on the card")
    tools = {"resume": resume_checks(pft, frames, dev, tools_dir, smi)}
    phase("tools: python -m pyfeaturetrack_tpu_torch (default, --device-loop, "
          f"--stream --chain {CHAIN}, --flow, --vo) against the API")
    tools["cli"] = cli_checks(pft, frames, dev, tools_dir, smi)
    phase("tools: utils/profiling on the card")
    tools["profiling"] = profiling_checks(pft, frames, cfg, dev, tools_dir,
                                          smi)
    print(json.dumps({"tools": tools}))

    # ---- phase 14: the sharded paths (parallel/) ----
    par_mods = {"K1": cuda_pyramid, "K2": cuda_lk, "K3": K3InK1(cuda_pyramid),
                "K4": cuda_select, "K5": cuda_suppress, "K6": cuda_affine,
                "K8": cuda_lk_dense}
    par = parallel_phase(pft, par_mods, frames, sim, cfg, cfg3,
                         {"default": (xs_main, ys_main, vs_main),
                          "config 3": table3}, report, dev, smi)
    print(json.dumps({"parallel": par}))

    if profile:
        profile_host_loop(pft, cfg, staged, root)
        profile_phase(pft, cfg3, sim, staged3, root, "config3")
        profile_phase(pft, cfg, frames, staged, root, "default")
        profile_dense(pft, frames, root)
    del staged, staged3

    names = {"K1": ("pyramid", "pyfeaturetrack_tpu_torch/csrc/pyramid.cu",
                    "pyfeaturetrack_tpu/ops/pallas_pyramid.py:132"),
             "K2": ("lk_pyramid", "pyfeaturetrack_tpu_torch/csrc/lk.cu",
                    "pyfeaturetrack_tpu/ops/pallas_lk_vec.py:663"),
             "K2 guided": ("lk_pyramid (guided starts)",
                           "pyfeaturetrack_tpu_torch/csrc/lk.cu",
                           "pyfeaturetrack_tpu/ops/pallas_lk_vec.py:663"),
             "K3": ("min_eig_map in K1 level 0",
                    "pyfeaturetrack_tpu_torch/csrc/pyramid.cu",
                    "pyfeaturetrack_tpu/ops/pallas_eig.py:100"),
             K3_STANDALONE: ("min_eig_map",
                             "pyfeaturetrack_tpu_torch/csrc/eig.cu",
                             "pyfeaturetrack_tpu/ops/pallas_eig.py:100"),
             "K4": ("select_from_eig", "pyfeaturetrack_tpu_torch/csrc/extract.cu",
                    "pyfeaturetrack_tpu/ops/pallas_select.py:251"),
             "K5": ("suppress_and_fill",
                    "pyfeaturetrack_tpu_torch/csrc/suppress.cu",
                    "pyfeaturetrack_tpu/ops/pallas_select.py:136"),
             "K6": ("affine_stage", "pyfeaturetrack_tpu_torch/csrc/affine.cu",
                    "pyfeaturetrack_tpu/ops/pallas_affine_vec.py:407 and "
                    "pyfeaturetrack_tpu/ops/pallas_affine_fused.py:330"),
             "K8": ("lk_dense_level", "pyfeaturetrack_tpu_torch/csrc/lk_dense.cu",
                    "pyfeaturetrack_tpu/ops/pallas_lk_fused.py:258"),
             "K9": ("window_terms",
                    "pyfeaturetrack_tpu_torch/csrc/window_terms.cu",
                    "pyfeaturetrack_tpu/ops/pallas_lk.py:140")}
    kernels = []
    for k in ("K1", "K2", "K2 guided", "K3", K3_STANDALONE, "K4", "K5", "K6",
              "K8", "K9"):
        name, source, replaces = names[k]
        r = report[k]
        b_ms, b_by = bound_ms(*r["work"])
        entry = {"name": f"{k.split()[0]} {name}", "route": "cuda",
                 "source": source, "replaces": replaces,
                 "launches": r["launches"],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": None,
                 "device_ms": r["device_ms"],
                 "grad_launches": r["grad_launches"]}
        if k == "K1":
            entry.update({f: r[f] for f in (
                "config3_ms", "config3_device_ms", "fused_ms",
                "fused_device_ms", "fused_level0_device_ms",
                "level0_device_ms", "fused_bound_ms")})
        if k in ("K3", K3_STANDALONE):
            entry.update(launches_per_path=r["launches_per_path"])
        if k == "K2 guided":
            entry.update({f: r[f] for f in (
                "start_free_ms", "start_free_device_ms",
                "launches_per_path")})
        if k == "K9":
            entry.update({f: r[f] for f in (
                "floor_device_ms", "n65536_ms", "n65536_device_ms",
                "n65536_cold_device_ms",
                "n65536_plain_ms", "n65536_bound_ms", "n65536_bound_by")})
        if k == "K2":
            entry.update(windows_checked=r["windows_checked"],
                         levels_checked=r["levels_checked"],
                         earlier_ms=r["earlier_ms"],
                         earlier_device_ms=r["earlier_device_ms"])
        if k == "K6":
            bb_ms, bb_by = bound_ms(*r["batch_work"])
            entry.update(windows_checked=r["windows_checked"],
                         plain_device_ms=r["plain_device_ms"],
                         batch_ms=r["batch_ms"],
                         batch_device_ms=r["batch_device_ms"],
                         batch_plain_ms=r["batch_plain_ms"],
                         batch_bound_ms=bb_ms, batch_bound_by=bb_by)
        if k == "K4":
            entry.update({f: r[f] for f in ("initial_ms", "initial_device_ms",
                                            "initial_1080p_ms",
                                            "initial_2160p_ms")})
        if k == "K5":
            entry.update({f: r[f] for f in (
                "refill_ms", "refill_device_ms", "list_ms", "list_device_ms",
                "list_refill_device_ms")})
        if k == "K8":
            b1_ms, b1_by = bound_ms(*r["work_1d"])
            entry.update(ms_1d=r["ms_1d"], device_ms_1d=r["device_ms_1d"],
                         plain_ms_1d=r["plain_ms_1d"],
                         bound_ms_1d=b1_ms, bound_by_1d=b1_by,
                         **{f: r[f] for f in (
                             "band_launches", "band_ms", "band_device_ms",
                             "band_plain_ms", "band_bound_ms",
                             "band_bound_by")})
        # device times the profiler lost (device_ms) go out as null, named
        lost = [f for f, v in entry.items() if isinstance(v, float)
                and math.isnan(v)]
        entry.update({f: None for f in lost})
        if lost:
            entry["device_ms_lost"] = lost
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
