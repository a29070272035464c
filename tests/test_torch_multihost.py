"""The port's multi-process paths (``parallel/multihost.py``) on real gloo
process groups on the CPU, and the gloo worker the parallel tests spawn.

Run as a script, this file is one rank of a gloo world (``worker``): it
joins the group through ``initialize_cluster`` with a ``file://`` init,
runs every sharded entry of its world's cases once on the same global
inputs as every other rank, and saves its results; it imports neither
jax nor the JAX package. The cases and their inputs (numpy, seeded) live
here so that the worker and the tests build them alike. On a machine with
four cards, ``torchrun --nproc_per_node 4 tests/test_torch_multihost.py
--torchrun <out dir>`` runs the same cases in an NCCL group
(``torchrun_worker``).

Here: ``initialize_cluster`` with no cluster in the environment (the
one-process summary) and with a named cluster that cannot be reached (it
raises); ``host_chunk_assignment`` and ``allgather_boundary_states`` on 3
ranks with 7 chunks; ``track_sequence_multiprocess`` on 4 ranks equal to
``track_sequence_chunked`` bit for bit (the mirror of
tests/test_multiprocess.py's four-process test), and on one rank that
joins from torchrun's variables.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# Inputs (numpy, seeded; the shapes of the JAX package's parallel tests)
# ---------------------------------------------------------------------------


def textured(nrows, ncols, seed):
    """tests/conftest.make_textured_image, in numpy alone."""
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, size=(nrows, ncols))
    k = np.array([1, 4, 6, 4, 1], dtype=np.float64)
    k /= k.sum()
    for axis in (0, 1):
        img = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, img)
    lo, hi = img.min(), img.max()
    return np.floor((img - lo) / (hi - lo) * 255.0)


def shifted(img, dx, dy):
    """tests/conftest.shift_image_bilinear, in numpy alone."""
    nrows, ncols = img.shape
    ys, xs = np.mgrid[0:nrows, 0:ncols].astype(np.float64)
    xs = np.clip(xs - dx, 0, ncols - 1)
    ys = np.clip(ys - dy, 0, nrows - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, ncols - 2)
    y0 = np.clip(np.floor(ys).astype(int), 0, nrows - 2)
    ax, ay = xs - x0, ys - y0
    return ((1 - ax) * (1 - ay) * img[y0, x0] + ax * (1 - ay) * img[y0, x0 + 1]
            + (1 - ax) * ay * img[y0 + 1, x0] + ax * ay * img[y0 + 1, x0 + 1])


def pairs(cfg, b, n, seed, dx, dy, h=96, w=128):
    """B frame pairs (textured, shifted by (dx, dy)) and N features each."""
    rng = np.random.default_rng(seed)
    imgs1 = np.stack([textured(h, w, seed=100 + seed + i) for i in range(b)])
    imgs2 = np.stack([shifted(im, dx, dy) for im in imgs1])
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, (b, n))
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, (b, n))
    return imgs1, imgs2, xs, ys, np.ones((b, n), np.int32)


def track_cfg():
    from pyfeaturetrack_tpu_torch.config import create_config
    return create_config()


def full_cfg():
    from pyfeaturetrack_tpu_torch.config import create_config
    return create_config(affineConsistencyCheck=2,
                         lighting_insensitive=True).validated_window()


def seq_cfg():
    from pyfeaturetrack_tpu_torch.config import create_config
    return create_config().replace(sequentialMode=True).validated_window()


def track_inputs():
    return pairs(track_cfg(), 8, 32, 17, 0.9, -0.4)


def full_inputs():
    return pairs(full_cfg(), 4, 32, 23, 1.1, 0.6)


def flow_inputs():
    img = textured(64, 128, seed=11)
    return img, shifted(img, 1.0, -0.5)


def disparity_inputs():
    base = textured(64, 160, seed=13)
    return base[:, :128], base[:, 24:152]       # constant d = +24


def serving_inputs(b=8, h=64, w=96, steps=3):
    """tests/test_sharding.py's serving ticks: the first selects."""
    rng = np.random.default_rng(9)
    base = rng.uniform(0, 255, size=(b, h, w)).astype(np.float32)
    ticks = [np.roll(base, 2 * i, axis=-1) for i in range(steps)]
    return [ticks[0]] + ticks


def chunk_inputs(c=8, h=64, w=96, n_frames=4, n=16):
    """The JAX package's multichip_chunked_sequence inputs for c chunks."""
    cfg = seq_cfg()
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, size=(c, h, w)).astype(np.float32)
    frames = np.stack([np.roll(base, 2 * i, axis=-1)
                       for i in range(n_frames)], axis=1)
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, (c, n))
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, (c, n))
    return frames, xs, ys, np.ones((c, n), np.int32)


BA_K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)


def ba_inputs(C=4, L=64, kw=3):
    """tests/_mp_worker.py's scene: C cameras x L landmarks, every landmark
    seen by every camera (dense) and by a window of kw cameras
    (windowed); returns (R, t, X0, dense arrays, windowed arrays)."""
    from pyfeaturetrack_tpu_torch.sfm.geometry import project, so3_exp
    rng = np.random.default_rng(0)
    w_axis = 0.01 * rng.standard_normal((C, 3)).astype(np.float32)
    Rs = so3_exp(torch.as_tensor(w_axis)).numpy()
    ts = np.stack([[-0.1 * i, 0.0, 0.0] for i in range(C)]).astype(np.float32)
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(4, 8, L)], -1).astype(np.float32)
    uv_all = np.stack([project(BA_K, torch.as_tensor(Rs[c]),
                               torch.as_tensor(ts[c]),
                               torch.as_tensor(X))[0].numpy()
                       for c in range(C)])                  # [C, L, 2]
    dense = (np.repeat(np.arange(C), L), np.tile(np.arange(L), C),
             uv_all.reshape(-1, 2), np.ones((C * L,), np.float32))
    X0 = (X + 0.03 * rng.standard_normal(X.shape)).astype(np.float32)
    c0 = rng.integers(0, C - kw + 1, L)
    cidx = c0[:, None] + np.arange(kw)[None, :]
    windowed = (c0, uv_all[cidx, np.arange(L)[:, None]],
                np.ones((L, kw), np.float32))
    return Rs, ts, X0, dense, windowed


# ---------------------------------------------------------------------------
# The sharded cases: each takes a mesh, returns numpy arrays
# ---------------------------------------------------------------------------

def _np(ts):
    return tuple(t.cpu().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t) for t in ts)


def case_track(mesh):
    from pyfeaturetrack_tpu_torch.parallel import sharding
    return _np(sharding.track_batch_sharded(*track_inputs(), track_cfg(),
                                            mesh))


def case_full(mesh):
    from pyfeaturetrack_tpu_torch.parallel import sharding
    return _np(sharding.full_pair_batch_sharded(*full_inputs(), full_cfg(),
                                                mesh))


def case_flow(mesh):
    from pyfeaturetrack_tpu_torch.parallel import sharding
    return _np(sharding.dense_flow_sharded(*flow_inputs(), track_cfg(), mesh))


def case_disparity(mesh):
    from pyfeaturetrack_tpu_torch.parallel import sharding
    return _np(sharding.dense_disparity_sharded(
        *disparity_inputs(), track_cfg(), mesh, max_disparity=32.0))


def case_serving(mesh):
    from pyfeaturetrack_tpu_torch.parallel import sharding
    return _np(sharding.batched_serving_sharded(
        serving_inputs(), seq_cfg(), 16, mesh, chain=3, top_k=64))


def case_chunks(mesh):
    from pyfeaturetrack_tpu_torch.parallel import sharding
    return _np(sharding.track_chunks_sharded(
        *chunk_inputs(), seq_cfg(), mesh, replace_lost=True, chain=2)[:3])


def _device(mesh, dev):
    from pyfeaturetrack_tpu_torch.parallel.sharding import mesh_device
    return dev if mesh is None else mesh_device(mesh)


def case_ba(mesh, dev="cpu"):
    """Dense BA, 3 iterations, landmarks over the mesh's landmark axis (no
    mesh: the unsharded run on ``dev``)."""
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.parallel.sharding import mesh_sizes
    from pyfeaturetrack_tpu_torch.sfm.ba import (make_problem,
                                                 pad_problem_for_mesh)
    Rs, ts, X0, dense, _ = ba_inputs()
    problem = make_problem(BA_K, *dense, device=_device(mesh, dev))
    if mesh is not None:
        problem, l_pad, _ = pad_problem_for_mesh(
            problem, X0.shape[0], mesh_sizes(mesh)["landmark"])
        assert l_pad == 0
    return _np(sfm.bundle_adjust(problem, Rs, ts, X0, n_iters=3, mesh=mesh))


def _windowed(mesh, solver, dev):
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.parallel.sharding import mesh_sizes
    from pyfeaturetrack_tpu_torch.sfm.ba_windowed import make_windowed_problem
    Rs, ts, X0, _, windowed = ba_inputs()
    problem = make_windowed_problem(BA_K, *windowed,
                                    device=_device(mesh, dev))
    if mesh is not None:
        problem, X0, n_pad = sfm.pad_windowed_for_mesh(
            problem, X0, mesh_sizes(mesh)["landmark"])
        assert n_pad == 0
    return _np(sfm.bundle_adjust_windowed(problem, Rs, ts, X0, n_iters=3,
                                          point_only_iters=1, solver=solver,
                                          mesh=mesh))


def case_windowed_dense(mesh, dev="cpu"):
    return _windowed(mesh, "dense", dev)


def case_windowed_cg(mesh, dev="cpu"):
    return _windowed(mesh, "cg", dev)


CASES = {"track": (case_track, ("frame", "feature")),
         "full": (case_full, ("frame", "feature")),
         "flow": (case_flow, ("pixrow",)),
         "disparity": (case_disparity, ("pixrow",)),
         "serving": (case_serving, ("frame", "feature")),
         "chunks": (case_chunks, ("frame", "feature")),
         "ba": (case_ba, ("landmark",)),
         "windowed_dense": (case_windowed_dense, ("landmark",)),
         "windowed_cg": (case_windowed_cg, ("landmark",))}

# (case, mesh shape) run by each gloo world of tests/test_torch_parallel.py
WORLD_CASES = {
    2: [("track", (2, 1)), ("track", (1, 2)), ("full", (2, 1)),
        ("full", (1, 2)), ("flow", (2,)), ("disparity", (2,)),
        ("serving", (2, 1)), ("chunks", (2, 1)), ("ba", (2,)),
        ("windowed_dense", (2,)), ("windowed_cg", (2,))],
    4: [("track", (2, 2)), ("track", (4, 1)), ("track", (1, 4)),
        ("full", (2, 2)), ("full", (1, 4)), ("flow", (4,)),
        ("disparity", (4,)), ("serving", (4, 1)), ("chunks", (4, 1)),
        ("ba", (4,)), ("windowed_dense", (4,)), ("windowed_cg", (4,))],
}


def key(case, shape) -> str:
    return f"{case}@{'x'.join(map(str, shape))}"


BA_CASES = ("ba", "windowed_dense", "windowed_cg")


def _t(a, dtype, dev):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dev).to(dtype)


def unsharded(case, dev="cpu"):
    """The case through the port's one-device entry points on ``dev``."""
    from pyfeaturetrack_tpu_torch.models.device_sequence import (
        sequence_step_device)
    from pyfeaturetrack_tpu_torch.ops.affine import make_affine_state
    from pyfeaturetrack_tpu_torch.ops.track import (build_track_pyramids,
                                                    track_features_pyramids)
    f32, i32 = torch.float32, torch.int32
    if case in ("track", "full"):
        cfg = track_cfg() if case == "track" else full_cfg()
        imgs1, imgs2, xs, ys, vals = (track_inputs() if case == "track"
                                      else full_inputs())
        outs = []
        for b in range(len(imgs1)):
            args = (_t(imgs1[b], f32, dev), _t(imgs2[b], f32, dev),
                    _t(xs[b], f32, dev), _t(ys[b], f32, dev),
                    _t(vals[b], i32, dev))
            pyr1 = build_track_pyramids(args[0], cfg)
            if case == "full":
                # the device sequence's step: track, affine check, refill
                outs.append(sequence_step_device(
                    pyr1, args[1], *args[2:], cfg, replace_lost=True,
                    aff=make_affine_state(len(xs[b]), cfg, dev))[1:4])
            else:
                outs.append(track_features_pyramids(
                    pyr1, build_track_pyramids(args[1], cfg), *args[2:],
                    cfg))
        return _np(torch.stack(c) for c in zip(*outs))
    if case == "flow":
        from pyfeaturetrack_tpu_torch.ops.flow import compute_dense_flow
        return _np(compute_dense_flow(*flow_inputs(), track_cfg(),
                                      device=dev))
    if case == "disparity":
        from pyfeaturetrack_tpu_torch.ops.disparity import dense_disparity
        return _np(dense_disparity(*disparity_inputs(), track_cfg(),
                                   max_disparity=32.0, device=dev))
    if case == "serving":
        from pyfeaturetrack_tpu_torch.serving import BatchedStreamingTracker
        ticks = serving_inputs()
        tr = BatchedStreamingTracker(seq_cfg(), n_streams=len(ticks[0]),
                                     n_features=16, chain=3, top_k=64,
                                     device=dev)
        for tick in ticks:
            tr.feed(tick)
        return tr.table()
    if case == "chunks":
        from pyfeaturetrack_tpu_torch.models.chunked import \
            track_chunks_batched
        return _np(track_chunks_batched(
            *chunk_inputs(), seq_cfg(), replace_lost=True, chain=2,
            device=dev)[:3])
    return CASES[case][0](None, dev)


def ba_gaps(got, want, windowed: bool):
    """(within the JAX package's landmark-mesh bars, the gaps): dense t
    1e-3, X 1e-2, costs rtol 1e-3; windowed R, t 1e-4, X 1e-3, costs rtol
    1e-3 (tests/_mp_worker.py). The sharded BA sums the camera system in
    another order than the unsharded one."""
    R, t, X, costs = (np.asarray(a, np.float64) for a in got)
    wR, wt, wX, wc = (np.asarray(a, np.float64) for a in want)
    gaps = {"R": float(np.abs(R - wR).max()), "t": float(np.abs(t - wt).max()),
            "X": float(np.abs(X - wX).max()),
            "cost_rel": float((np.abs(costs - wc) / np.abs(wc)).max())}
    bars = {"R": 1e-4 if windowed else np.inf,
            "t": 1e-4 if windowed else 1e-3,
            "X": 1e-3 if windowed else 1e-2, "cost_rel": 1e-3}
    return all(gaps[k] <= bars[k] for k in bars), gaps


def sequence_frames(n_frames=9, h=64, w=96):
    """tests/_mp_worker_e2e.py's sequence: blobs rolled 1 px a frame."""
    rng = np.random.default_rng(5)
    base = np.zeros((h + 16, w + 16))
    yy, xx = np.mgrid[0:h + 16, 0:w + 16]
    for _ in range(60):
        cx, cy = rng.uniform(4, w + 12), rng.uniform(4, h + 12)
        base += rng.uniform(30, 80) * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / rng.uniform(3, 12))
    base = np.clip(base, 0, 255)[:h, :w]
    return [np.floor(np.roll(base, i, axis=1)) for i in range(n_frames)]


# ---------------------------------------------------------------------------
# The worker (one rank of a gloo world)
# ---------------------------------------------------------------------------

def _mesh_for(names, shape):
    from pyfeaturetrack_tpu_torch.parallel import sharding
    if names == ("frame", "feature"):
        return sharding.make_mesh(*shape)
    return sharding.make_axis_mesh(names[0])


def worker(init_file: str, rank: str, world: str, out: str,
           job: str) -> int:
    """One gloo rank: ``init_file`` "env" joins from torchrun's environment
    (``out`` is then a directory), else through a file:// init as rank
    ``rank`` of ``world``; runs ``job`` and saves its results."""
    torch.set_num_threads(1)
    from pyfeaturetrack_tpu_torch.parallel import (
        allgather_boundary_states, host_chunk_assignment, initialize_cluster,
        track_sequence_multiprocess)
    if init_file == "env":
        info = initialize_cluster(device="cpu", timeout=240)
        world = info["process_count"]
        out = str(Path(out) / f"{job}_{world}_rank{info['process_index']}"
                  ".npz")
    else:
        world = int(world)
        info = initialize_cluster(f"file://{init_file}", world, int(rank),
                                  device="cpu", timeout=240)
    assert info["process_count"] == world and info["backend"] == "gloo", info
    results = {}
    if job == "cases":
        for case, shape in WORLD_CASES[world]:
            fn, names = CASES[case]
            for i, a in enumerate(fn(_mesh_for(names, shape))):
                results[f"{key(case, shape)}:{i}"] = a
    elif job == "chunks":
        mine = host_chunk_assignment(7)
        local = np.stack([np.full((5, 3), c, np.float32) for c in mine])
        results["mine"] = np.asarray(mine)
        results["gathered"] = allgather_boundary_states(local, n_chunks=7)
        ints = np.asarray(mine, np.int64)[:, None] * np.arange(4)
        results["gathered_int"] = allgather_boundary_states(ints, n_chunks=7)
        from pyfeaturetrack_tpu_torch.parallel import measure_scaling
        per_step = measure_scaling([1, 3], image_shape=(64, 96),
                                   n_features=16, iters=1)["seconds_per_step"]
        results["scaling_counts"] = np.asarray(sorted(per_step))
        results["scaling_seconds"] = np.asarray(
            [per_step[d] for d in sorted(per_step)])
    elif job == "sequence":
        from pyfeaturetrack_tpu_torch.config import create_config
        table, col_ids = track_sequence_multiprocess(
            sequence_frames(), cfg=create_config(mindist=5), n_features=20,
            n_chunks=5, device="cpu")
        results.update({f"table_{k}": v for k, v in table.items()})
        results.update({f"ids_{i}": c for i, c in enumerate(col_ids)})
    np.savez(out, **results)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def torchrun_worker(out_dir: str) -> int:
    """One rank of ``torchrun --nproc_per_node 4 tests/test_torch_multihost.py
    --torchrun <out dir>`` on four cards: joins the NCCL group through
    ``initialize_cluster()`` (torchrun's environment, card LOCAL_RANK),
    runs the 4-rank world's cases on the group's meshes and holds each
    against the in-process split on this rank's card (bit for bit) and the
    unsharded route there (bit for bit; the BAs within JAX's mesh bars).
    Writes <out dir>/rank<r>.json; returns 1 on a mismatch."""
    import json
    import torch.distributed as dist
    from pyfeaturetrack_tpu_torch.parallel import initialize_cluster
    from pyfeaturetrack_tpu_torch.parallel.sharding import split_mesh
    torch.set_num_threads(1)
    info = initialize_cluster()
    dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = info["process_index"], info["process_count"]
    report, ok = {"info": info, "card": torch.cuda.get_device_name(dev)}, True
    for case, shape in WORLD_CASES[world]:
        fn, names = CASES[case]
        got = fn(_mesh_for(names, shape))
        split = fn(split_mesh(shape, names, dev))
        same = all(np.array_equal(a, b) for a, b in zip(got, split))
        want = unsharded(case, dev)
        if case in BA_CASES:
            held, gaps = ba_gaps(got, want, case != "ba")
        else:
            held, gaps = all(np.array_equal(a, b)
                             for a, b in zip(got, want)), None
        report[key(case, shape)] = {"equal_to_split": same,
                                    "held_to_unsharded": held, "gaps": gaps}
        ok = ok and same and held
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))
    print(f"rank {rank}: {'all held' if ok else 'MISMATCH'}: {report}",
          flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


def _child_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        env.pop(k, None)
    return env


def _wait(procs, timeout: float) -> None:
    """Wait for every process; kill them all if one hangs or fails."""
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


def spawn_worlds(jobs, tmp_path: Path, timeout: float = 400):
    """Start one gloo world of n ranks for each (n, job) of ``jobs``, all at
    once (file:// inits under ``tmp_path``), and wait for them; every rank
    is killed if one hangs. Returns each world's ranks' saved results."""
    procs, outs = [], []
    for n, job in jobs:
        init = tmp_path / f"init_{job}_{n}"
        outs.append([tmp_path / f"{job}_{n}_rank{r}.npz" for r in range(n)])
        procs += [subprocess.Popen(
            [sys.executable, __file__, str(init), str(r), str(n),
             str(outs[-1][r]), job], env=_child_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]
    _wait(procs, timeout)
    return [[dict(np.load(o)) for o in world] for world in outs]


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_cluster_without_a_cluster(monkeypatch):
    """No cluster in the environment: the one-process summary, no group."""
    import torch.distributed as dist
    from pyfeaturetrack_tpu_torch.parallel import (host_chunk_assignment,
                                                   initialize_cluster)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    info = initialize_cluster(device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1,
                    "backend": None}
    assert not dist.is_initialized()
    assert host_chunk_assignment(3) == [0, 1, 2]
    with pytest.raises(ValueError):
        initialize_cluster("127.0.0.1:1", num_processes=2, device="cpu")


def test_initialize_cluster_raises_on_an_unreachable_cluster(tmp_path):
    """A named cluster whose coordinator port is closed: the join times
    out and raises (no silent fall-back to one process). Run in a child
    process so the group cannot outlive the test."""
    code = ("import os, sys\n"
            "from pyfeaturetrack_tpu_torch.parallel import initialize_cluster\n"
            "try:\n"
            "    initialize_cluster(device='cpu', timeout=1)\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__); sys.exit(0)\n"
            "print('joined'); sys.exit(1)\n")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), RANK="1", WORLD_SIZE="2",
               PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "raised" in res.stdout


def test_initialize_cluster_never_falls_back_to_gloo():
    """Asked for the card without one, the NCCL join raises: no swap to
    gloo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pyfeaturetrack_tpu_torch.parallel import initialize_cluster
    with pytest.raises(RuntimeError, match="NCCL"):
        initialize_cluster("127.0.0.1:1", num_processes=1, process_id=0)


def test_chunk_assignment_and_gather_uneven(tmp_path):
    """3 ranks, 7 chunks: blocks of 3, 2, 2, gathered back in order with
    the pad rows dropped (float32 and int64). The same world runs
    measure_scaling over 1 and 3 ranks: rank 0 times both, the others
    only the 3-rank mesh they are in."""
    (ranks,) = spawn_worlds([(3, "chunks")], tmp_path)
    assert [r["scaling_counts"].tolist() for r in ranks] == [[1, 3], [3],
                                                             [3]]
    assert all((r["scaling_seconds"] > 0).all() for r in ranks)
    assert [r["mine"].tolist() for r in ranks] == [[0, 1, 2], [3, 4], [5, 6]]
    want = np.stack([np.full((5, 3), c, np.float32) for c in range(7)])
    want_int = np.arange(7, dtype=np.int64)[:, None] * np.arange(4)
    for r in ranks:
        np.testing.assert_array_equal(r["gathered"], want)
        assert r["gathered"].dtype == np.float32
        np.testing.assert_array_equal(r["gathered_int"], want_int)


def _sequence_reference():
    from pyfeaturetrack_tpu_torch.config import create_config
    from pyfeaturetrack_tpu_torch.models.chunked import track_sequence_chunked
    return track_sequence_chunked(
        sequence_frames(), cfg=create_config(mindist=5), n_features=20,
        n_chunks=5, device="cpu")[:2]


def _assert_tables_equal(ranks, ref, ref_ids):
    for r in ranks:
        for k in ("x", "y", "val"):
            np.testing.assert_array_equal(r[f"table_{k}"], ref[k])
            assert r[f"table_{k}"].dtype == ref[k].dtype
        for i, ids in enumerate(ref_ids):
            np.testing.assert_array_equal(r[f"ids_{i}"], ids)


def test_initialize_cluster_joins_from_the_torchrun_environment(tmp_path):
    """A process given torchrun's variables (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK) joins through
    initialize_cluster() with no arguments: a one-rank gloo world whose
    store takes a port the system picks (MASTER_PORT 0), so no two runs
    can collide. Its track_sequence_multiprocess over 5 chunks equals
    track_sequence_chunked bit for bit."""
    env = dict(_child_env(), RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT="0", LOCAL_RANK="0")
    proc = subprocess.Popen(
        [sys.executable, __file__, "env", "-", "-", str(tmp_path),
         "sequence"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    _wait([proc], 400)
    _assert_tables_equal([dict(np.load(tmp_path / "sequence_1_rank0.npz"))],
                         *_sequence_reference())


def test_four_process_chunked_sequence_equals_chunked(tmp_path):
    """4 gloo ranks (file:// init) track 5 chunks of a real sequence (the
    uneven pad path), gather and stitch: every rank's table equals the
    one-process track_sequence_chunked bit for bit."""
    (ranks,) = spawn_worlds([(4, "sequence")], tmp_path)
    ref, ref_ids = _sequence_reference()
    _assert_tables_equal(ranks, ref, ref_ids)
    assert ref["val"].shape[1] >= 15
    assert int((ref["val"][-1] >= 0).sum()) >= 10


if __name__ == "__main__":
    if sys.argv[1] == "--torchrun":
        sys.exit(torchrun_worker(sys.argv[2]))
    sys.exit(worker(*sys.argv[1:6]))
