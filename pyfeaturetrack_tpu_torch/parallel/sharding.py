"""Multi-GPU sharding for the tracker and the dense paths, on
``torch.distributed``.

Port of ``pyfeaturetrack_tpu/parallel/sharding.py``. The parallel axes of
the KLT problem are those of the JAX package:

* ``frame``: independent frame pairs (and serving streams, video chunks);
* ``feature``: features within a frame, independent but for the refill,
  which needs every feature of its frame;
* ``pixrow``: the dense paths' pixel rows (pixels are features);
* ``landmark``: the bundle adjustments' landmarks (``sfm/ba.py``,
  ``sfm/ba_windowed.py``).

SPMD, as JAX's multi-controller mode: one process per card, every rank
calls the same entry with the same global host inputs, computes its block
and returns the GLOBAL result, gathered onto every rank. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with JAX's axis names
(``make_mesh``, ``make_axis_mesh``), or a :class:`SplitMesh`: the same
entries with the ranks' bodies run one after another in one process on
one device (``split_mesh``), which is how a D-way split is checked on one
card or CPU.

Every sharded entry is a LOCAL BODY: a generator that takes the rank's
mesh coordinates and the global inputs, computes this rank's block and
yields each collective it needs (:class:`Gather`, :class:`SumParts`) to
the combine layer (``run_sharded``), which answers with the combined
tensor. Under a process group that is one ``all_gather`` over the axis's
group (gloo on the CPU, NCCL on the card); under a split it is the same
concatenation or rank-order sum of the bodies' tensors. A sum is an
all-gather of the partials summed in rank order on every rank, not an
all-reduce, so its bits do not depend on the backend: a gloo group, an
NCCL group and a split give the same result. Collectives over an axis of
size 1 are skipped. Each collective that runs is recorded in ``census``
(kind, axis, label, ranks, bytes: the ranks' float32 buffers), which
``parallel/scaling.collective_census`` reads.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..features import FeatureState
from ..ops.affine import affine_consistency_check, make_affine_state
from ..ops.disparity import DenseDisparity, disparity_level_steps
from ..ops.flow import DenseFlow, flow_level_steps
from ..ops.select_device import (DEFAULT_TOP_K,
                                 select_features_from_eig_device)
from ..ops.track import build_track_pyramids, track_features_pyramids

FRAME_AXIS = "frame"
FEATURE_AXIS = "feature"
PIXROW_AXIS = "pixrow"
LANDMARK_AXIS = "landmark"

# One record per collective run (the census of parallel/scaling.py).
census: list[dict] = []


def reset_census() -> None:
    census.clear()


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

class SplitMesh(NamedTuple):
    """A mesh whose ranks' bodies run one after another in this process on
    ``device``: the D-way split of an entry on one card (or CPU)."""
    shape: tuple
    mesh_dim_names: tuple
    device: torch.device


def split_mesh(shape, names, device="cuda") -> SplitMesh:
    """An in-process split of ``shape`` (ints) with axis ``names``."""
    shape, names = tuple(int(n) for n in shape), tuple(names)
    if len(shape) != len(names) or min(shape) < 1:
        raise ValueError(f"split_mesh: shape {shape} for axes {names}")
    return SplitMesh(shape, names, torch.device(device))


def _backend_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _require_group(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} needs a process group: call "
                           "parallel.initialize_cluster() first, or use "
                           "split_mesh for an in-process split")


def make_mesh(n_frame: int | None = None, n_feature: int = 1, devices=None):
    """A (frame, feature) DeviceMesh over the world's ranks (``devices``: a
    list of ranks, default all), row-major as JAX's ``make_mesh``. Every
    rank of the world calls it."""
    _require_group("make_mesh")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    if n_frame is None:
        n_frame = len(ranks) // n_feature
    if n_frame * n_feature > len(ranks) or n_frame < 1:
        raise ValueError(f"make_mesh: {n_frame} x {n_feature} ranks, "
                         f"{len(ranks)} given")
    from torch.distributed.device_mesh import DeviceMesh
    mesh = torch.tensor(ranks[:n_frame * n_feature]).reshape(n_frame,
                                                            n_feature)
    return DeviceMesh(_backend_device_type(), mesh,
                      mesh_dim_names=(FRAME_AXIS, FEATURE_AXIS))


def make_axis_mesh(axis: str, devices=None):
    """A one-axis DeviceMesh named ``axis`` (``pixrow``, ``landmark``)
    over ``devices`` (ranks, default all)."""
    _require_group("make_axis_mesh")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_backend_device_type(), torch.tensor(ranks),
                      mesh_dim_names=(axis,))


def mesh_sizes(mesh) -> dict:
    """{axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on: the split's device, or
    this process's card (NCCL) or the CPU (gloo)."""
    if isinstance(mesh, SplitMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def flat_mesh(mesh, axis: str):
    """``mesh`` as one axis named ``axis`` over all its ranks (row-major),
    as the JAX package flattens a mesh for the dense paths."""
    if list(mesh.mesh_dim_names) == [axis]:
        return mesh
    if isinstance(mesh, SplitMesh):
        return split_mesh((int(np.prod(mesh.shape)),), (axis,), mesh.device)
    return make_axis_mesh(axis, mesh.mesh.reshape(-1).tolist())


def _default_mesh(axis: str, device):
    """The world's ranks along ``axis`` under a process group, else a
    one-rank split on ``device`` (default the card)."""
    if dist.is_available() and dist.is_initialized():
        return make_axis_mesh(axis)
    return split_mesh((1,), (axis,), device or "cuda")


def _world_mesh(device):
    """JAX's multichip mesh: (world / f, f) with f = 2 for an even world,
    else 1; one rank (1, 1) with no process group."""
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        nf = 2 if n % 2 == 0 else 1
        return make_mesh(n // nf, nf)
    return split_mesh((1, 1), (FRAME_AXIS, FEATURE_AXIS), device or "cuda")


# ---------------------------------------------------------------------------
# The combine layer
# ---------------------------------------------------------------------------

class Gather(NamedTuple):
    """All-gather each of this rank's ``tensors`` over ``axis``: the ranks'
    blocks concatenated along its ``dims`` entry in the axis's rank order
    (a 0-d tensor comes back stacked, [ranks]). One collective for all of
    them. The body receives the tuple of gathered tensors."""
    tensors: tuple
    dims: tuple
    axis: str
    label: str


class SumParts(NamedTuple):
    """The rank-order sums of each rank's float32 ``tensors`` over
    ``axis``, in one collective. The body receives the tuple of sums."""
    tensors: tuple
    axis: str
    label: str


def _combine(req, parts):
    """The answer to ``req`` from every rank's tensors (``parts``, one
    tuple per rank in rank order)."""
    if isinstance(req, Gather):
        return tuple(torch.stack(ts) if ts[0].dim() == 0
                     else torch.cat(ts, dim=d)
                     for ts, d in zip(zip(*parts), req.dims))
    out = []
    for ts in zip(*parts):
        acc = ts[0]
        for t in ts[1:]:
            acc = acc + t
        out.append(acc)
    return tuple(out)


def _alone(req):
    """The answer over an axis of one rank: the tensors themselves."""
    if isinstance(req, Gather):
        return tuple(t[None] if t.dim() == 0 else t for t in req.tensors)
    return tuple(req.tensors)


def _record(req, n: int) -> None:
    """Census: the bytes the collective moves (n ranks' float32 buffers)."""
    census.append({"kind": "gather" if isinstance(req, Gather) else "sum",
                   "axis": req.axis, "label": req.label, "ranks": n,
                   "bytes": n * 4 * sum(t.numel() for t in req.tensors)})


def _as_float_bits(t: torch.Tensor) -> torch.Tensor:
    """float32 as it is, int32 reinterpreted as float32 bits, bool as 0.0 /
    1.0: one flat float32 buffer carries a request's tensors."""
    if t.dtype == torch.float32:
        return t.reshape(-1)
    if t.dtype == torch.int32:
        return t.reshape(-1).view(torch.float32)
    if t.dtype == torch.bool:
        return t.reshape(-1).to(torch.float32)
    raise TypeError(f"the combine layer carries float32, int32 and bool, "
                    f"not {t.dtype}")


def _from_float_bits(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.int32:
        flat = flat.view(torch.int32)
    elif like.dtype == torch.bool:
        flat = flat != 0
    return flat.reshape(like.shape)


def _group_collective(mesh, req):
    n = mesh_sizes(mesh)[req.axis]
    if n == 1:
        return _alone(req)
    tensors = [t.contiguous() for t in req.tensors]
    flat = torch.cat([_as_float_bits(t) for t in tensors])
    bufs = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(bufs, flat, group=mesh.get_group(req.axis))
    _record(req, n)
    parts = []
    for buf in bufs:
        k, ts = 0, []
        for t in tensors:
            ts.append(_from_float_bits(buf[k:k + t.numel()], t))
            k += t.numel()
        parts.append(ts)
    return _combine(req, parts)


def _run_group(mesh, body, args):
    coord = mesh.get_coordinate()
    if coord is None:           # this rank is not in the mesh
        return None
    gen = body(dict(zip(mesh.mesh_dim_names, coord)), *args)
    val = None
    while True:
        try:
            req = gen.send(val)
        except StopIteration as done:
            return done.value
        val = _group_collective(mesh, req)


def _run_split(mesh: SplitMesh, body, args):
    names, shape = mesh.mesh_dim_names, mesh.shape
    coords = list(itertools.product(*(range(n) for n in shape)))
    gens = [body(dict(zip(names, c)), *args) for c in coords]
    vals = [None] * len(gens)
    while True:
        reqs, results = [], []
        for gen, val in zip(gens, vals):        # the bodies, in rank order
            try:
                reqs.append(gen.send(val))
            except StopIteration as done:
                results.append(done.value)
        if results:
            if reqs:
                raise RuntimeError("the ranks' bodies ended at different "
                                   "collectives")
            return results[0]
        kinds = {(type(r), r.axis, r.label) for r in reqs}
        if len(kinds) != 1:
            raise RuntimeError(f"the ranks' bodies asked for different "
                               f"collectives: {sorted(map(str, kinds))}")
        ax = names.index(reqs[0].axis)
        n = shape[ax]
        if n == 1:
            vals = [_alone(r) for r in reqs]
            continue
        _record(reqs[0], n)
        groups: dict = {}
        for i, c in enumerate(coords):
            groups.setdefault(c[:ax] + c[ax + 1:], []).append(i)
        vals = [None] * len(gens)
        for members in groups.values():     # coords are row-major: in order
            out = _combine(reqs[members[0]],
                           [reqs[i].tensors for i in members])
            for i in members:
                vals[i] = out


def run_sharded(mesh, body, *args):
    """Run the local body ``body(coord, *args)`` (a generator yielding
    Gather / SumParts) on this rank of a DeviceMesh, or every rank's body
    in turn on a SplitMesh; returns the body's result (None on a rank
    outside the mesh)."""
    if isinstance(mesh, SplitMesh):
        return _run_split(mesh, body, args)
    return _run_group(mesh, body, args)


def block(index: int, n_ranks: int, total: int, what: str) -> slice:
    """Rank ``index``'s contiguous block of ``total`` items."""
    if total % n_ranks:
        raise ValueError(f"{what}: {total} does not split over {n_ranks} "
                         "ranks")
    per = total // n_ranks
    return slice(index * per, (index + 1) * per)


def _on(a, dtype, dev) -> torch.Tensor:
    """A block of a global host input (array or tensor) on ``dev``, moved in
    its own type and converted there (uint8 frames move a quarter of the
    bytes; a float64 array rounds to float32 as on the host)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.ascontiguousarray(a))
    return a.to(device=dev).to(dtype).contiguous()


# ---------------------------------------------------------------------------
# Sparse tracking: frame pairs over ``frame``, features over ``feature``
# ---------------------------------------------------------------------------

def shard_feature_state(fl: FeatureState, mesh, index: int | None = None
                        ) -> FeatureState:
    """Feature block ``index`` of ``fl`` over the mesh's ``feature`` axis
    (default: this rank's; required for a SplitMesh): x, y, val and the
    AffineState's per-feature arrays sliced alike."""
    sizes = mesh_sizes(mesh)
    if index is None:
        if isinstance(mesh, SplitMesh):
            raise ValueError("shard_feature_state: a split has no own rank; "
                             "pass index")
        index = mesh.get_local_rank(FEATURE_AXIS)
    kb = block(int(index), sizes[FEATURE_AXIS], fl.nFeatures, "features")
    aff = None if fl.aff is None else type(fl.aff)(
        *(None if a is None else a[kb] for a in fl.aff))
    return FeatureState(x=fl.x[kb], y=fl.y[kb], val=fl.val[kb], aff=aff)


def _pair_blocks(coord, sizes, b, n):
    return (block(coord[FRAME_AXIS], sizes[FRAME_AXIS], b, "frame pairs"),
            block(coord[FEATURE_AXIS], sizes[FEATURE_AXIS], n, "features"))


def _track_slice(imgs1, imgs2, x, y, val, fb, kb, cfg, dev, with_eig):
    """This rank's frame pairs: K1 builds of the replicated images, K2 on
    its feature slice. Per pair: (pyr1, pyr2, frame 2's eig map (None
    without ``with_eig``), the slice's (x, y, val) in and out)."""
    pairs = []
    for b in range(fb.start, fb.stop):
        p1 = build_track_pyramids(_on(imgs1[b], torch.float32, dev), cfg)
        built = build_track_pyramids(_on(imgs2[b], torch.float32, dev), cfg,
                                     with_eig=with_eig)
        p2, eig = built if with_eig else (built, None)
        before = (_on(x[b, kb], torch.float32, dev),
                  _on(y[b, kb], torch.float32, dev),
                  _on(val[b, kb], torch.int32, dev))
        pairs.append((p1, p2, eig, before,
                      track_features_pyramids(p1, p2, *before, cfg)))
    return pairs


def _stacked(rows):
    """[(x, y, val) per pair] -> [x, y, val] stacked [B_loc, ...]."""
    return [torch.stack(c) for c in zip(*rows)]


def _output(xyv, over):
    """Gather (x, y, val) blocks [B_loc, N_loc] over the axes in ``over``
    (feature along dim 1, frame along dim 0)."""
    for axis, dim in over:
        xyv = yield Gather(tuple(xyv), (dim,) * 3, axis, "output")
    return tuple(xyv)


def _track_body(coord, sizes, imgs1, imgs2, x, y, val, cfg, dev):
    fb, kb = _pair_blocks(coord, sizes, len(imgs1), x.shape[1])
    pairs = _track_slice(imgs1, imgs2, x, y, val, fb, kb, cfg, dev, False)
    return (yield from _output(_stacked(p[4] for p in pairs),
                               ((FEATURE_AXIS, 1), (FRAME_AXIS, 0))))


def track_batch_sharded(imgs1, imgs2, x, y, val, cfg, mesh):
    """Track B frame pairs x N features over the (frame, feature) mesh:
    (x, y, val) [B, N] on every rank.

    Pairs shard over ``frame``, features over ``feature``; every rank
    builds its pairs' pyramids from the replicated images (K1) and tracks
    its feature slice (K2). The only collectives are the output gathers."""
    return run_sharded(mesh, _track_body, mesh_sizes(mesh), imgs1, imgs2,
                       x, y, val, cfg, mesh_device(mesh))


def _full_body(coord, sizes, imgs1, imgs2, x, y, val, cfg, dev):
    fb, kb = _pair_blocks(coord, sizes, len(imgs1), x.shape[1])
    pairs = _track_slice(imgs1, imgs2, x, y, val, fb, kb, cfg, dev, True)
    checked = []
    for p1, p2, _, before, tracked in pairs:
        aff = make_affine_state(before[0].shape[0], cfg, dev)
        after = affine_consistency_check(p1, p2, FeatureState(*before, aff),
                                         FeatureState(*tracked, aff), cfg)
        checked.append((after.x, after.y, after.val))
    # the refill pre-masks around EVERY kept feature of the frame: gather
    # the frame's features within the feature group, refill redundantly
    full = yield Gather(tuple(_stacked(checked)), (1, 1, 1), FEATURE_AXIS,
                        "refill")
    refilled = [select_features_from_eig_device(
        pairs[i][2], full[0][i], full[1][i], full[2][i], cfg,
        replacing=True)[:3] for i in range(len(pairs))]
    # every rank of a feature group now holds its frames' whole rows
    return (yield from _output(_stacked(refilled), ((FRAME_AXIS, 0),)))


def full_pair_batch_sharded(imgs1, imgs2, x, y, val, cfg, mesh):
    """The full pair body over the (frame, feature) mesh: translational LK
    (K2) and the affine check (K6) on each rank's feature slice, then the
    refill (K3's map from K1's level-0 launch, K4) on the frame's features
    gathered within the ``feature`` group (the one collective besides the
    output gather). (x, y, val) [B, N] on every rank."""
    dev = mesh_device(mesh)
    return run_sharded(mesh, _full_body, mesh_sizes(mesh), imgs1, imgs2,
                       x, y, val, cfg, dev)


# ---------------------------------------------------------------------------
# Dense paths: pixel rows over ``pixrow``
# ---------------------------------------------------------------------------

def _row_bands(coord, sizes):
    r, n = coord[PIXROW_AXIS], sizes[PIXROW_AXIS]

    def rows(height: int):
        sl = block(r, n, height, f"a level of {height} rows")
        return sl.start, sl.stop - sl.start
    return rows


def _dense_body(coord, sizes, img1, img2, cfg, dev, steps_fn):
    p1 = build_track_pyramids(_on(img1, torch.float32, dev), cfg)
    p2 = build_track_pyramids(_on(img2, torch.float32, dev), cfg)
    steps = steps_fn(p1, p2, _row_bands(coord, sizes))
    band = next(steps)
    while True:
        # each level's bands, gathered before the next finer level starts
        full = yield Gather(tuple(band), (0,) * len(band), PIXROW_AXIS,
                            "level")
        try:
            band = steps.send(tuple(full))
        except StopIteration as done:
            return done.value


def dense_flow_sharded(img1, img2, cfg, mesh=None, *,
                       device=None) -> DenseFlow:
    """Dense flow for ONE pair with the pixel rows sharded over the mesh
    (flattened to ``pixrow``): every rank builds both pyramids from the
    replicated images (K1), solves its band of each level (K8's band
    launch, started from the whole coarser map), and the bands are
    gathered before the next finer level. The rank count must divide
    every level's height. Whole maps on every rank. ``mesh`` None: the
    world's ranks, or one rank on ``device`` with no process group."""
    mesh = flat_mesh(mesh if mesh is not None
                     else _default_mesh(PIXROW_AXIS, device), PIXROW_AXIS)

    def steps(p1, p2, rows):
        return flow_level_steps(p1, p2, cfg, rows)
    return run_sharded(mesh, _dense_body, mesh_sizes(mesh), img1, img2, cfg,
                       mesh_device(mesh), steps)


def dense_disparity_sharded(left, right, cfg, mesh=None,
                            max_disparity: float = 64.0, *,
                            device=None) -> DenseDisparity:
    """Dense rectified-stereo disparity for ONE pair with the pixel rows
    sharded as in ``dense_flow_sharded`` (K8's 1-D band launches). The SSD
    seed of the coarsest level is computed whole on every rank from the
    replicated images (``ops/disparity.disparity_level_steps``)."""
    mesh = flat_mesh(mesh if mesh is not None
                     else _default_mesh(PIXROW_AXIS, device), PIXROW_AXIS)

    def steps(p1, p2, rows):
        return disparity_level_steps(p1, p2, cfg, float(max_disparity),
                                     rows=rows)
    return run_sharded(mesh, _dense_body, mesh_sizes(mesh), left, right,
                       cfg, mesh_device(mesh), steps)


# ---------------------------------------------------------------------------
# Streams and chunks over ``frame``
# ---------------------------------------------------------------------------

def _serving_body(coord, sizes, ticks, cfg, n_features, chain, replace_lost,
                  top_k, dev):
    from ..serving import BatchedStreamingTracker
    sb = block(coord[FRAME_AXIS], sizes[FRAME_AXIS], len(ticks[0]),
               "streams")
    tr = BatchedStreamingTracker(cfg, n_streams=sb.stop - sb.start,
                                 n_features=n_features,
                                 replace_lost=replace_lost, top_k=top_k,
                                 chain=chain, device=dev)
    for tick in ticks:
        tr.feed(tick[sb])
    hist = [_on(h, dt, dev) for h, dt in zip(
        tr.table(), (torch.float32, torch.float32, torch.int32))]
    # the chain's graph holds no collective: one gather after the replays
    out = yield Gather(tuple(hist), (1, 1, 1), FRAME_AXIS, "output")
    return tuple(t.cpu().numpy() for t in out)


def batched_serving_sharded(ticks, cfg, n_features: int, mesh,
                            chain: int = 1, replace_lost: bool = True,
                            top_k: int = DEFAULT_TOP_K):
    """Stream-sharded batched serving: ``ticks`` is a list of [B, H, W]
    frame batches (the first selects). Each rank runs a
    ``BatchedStreamingTracker`` on its block of the streams (its refills
    are its streams' own), then ONE gather of the [ticks, B, N] history.
    Returns (x, y, val) numpy [ticks, B, N] on every rank, the layout of
    ``BatchedStreamingTracker.table``."""
    return run_sharded(mesh, _serving_body, mesh_sizes(mesh), list(ticks),
                       cfg, n_features, chain, replace_lost, top_k,
                       mesh_device(mesh))


def _chunks_body(coord, sizes, chunk_frames, init_x, init_y, init_val, cfg,
                 replace_lost, chain, dev):
    from ..models.chunked import track_chunks_batched
    cb = block(coord[FRAME_AXIS], sizes[FRAME_AXIS], len(chunk_frames),
               "chunks")
    xs, ys, vs, ex = track_chunks_batched(
        np.asarray(chunk_frames[cb]), np.asarray(init_x)[cb],
        np.asarray(init_y)[cb], np.asarray(init_val)[cb], cfg,
        replace_lost=replace_lost, chain=chain, device=dev)
    xs, ys, vs, ex = yield Gather((xs, ys, vs, ex), (0, 0, 0, 0), FRAME_AXIS,
                                  "output")
    return xs, ys, vs, ex.any()


def track_chunks_sharded(chunk_frames, init_x, init_y, init_val, cfg, mesh,
                         replace_lost: bool = False, chain: int = 1):
    """``models/chunked.track_chunks_batched`` with the C chunks sharded
    over ``frame``: each rank advances its chunks in lockstep (on the card
    each chain is one replay of a captured graph with no collective in
    it), then one gather. Returns (xs, ys, vals, exhausted) as
    ``track_chunks_batched``, [C, F, N], on every rank."""
    return run_sharded(mesh, _chunks_body, mesh_sizes(mesh),
                       np.asarray(chunk_frames, np.float32), init_x, init_y,
                       init_val, cfg, replace_lost, chain, mesh_device(mesh))


# ---------------------------------------------------------------------------
# The multichip entries of the JAX package (small random inputs)
# ---------------------------------------------------------------------------

def _random_pairs(cfg, b, image_shape, n_features, shift):
    h, w = image_shape
    rng = np.random.default_rng(0)
    imgs1 = rng.uniform(0, 255, size=(b, h, w))
    imgs2 = np.roll(imgs1, shift, axis=-1)
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, (b, n_features))
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, (b, n_features))
    return imgs1, imgs2, xs, ys, np.ones((b, n_features), np.int32)


def multichip_track_step(mesh=None, cfg=None, image_shape=(64, 96),
                         n_features: int = 64, *, device=None):
    """One sharded tracking step on small random shapes over ``mesh`` (a
    (frame, feature) mesh; None: the world, ``make_mesh(world / f, f)``
    with f = 2 for an even world). Returns the tracked (x, y, val)."""
    from ..config import create_config
    cfg = cfg if cfg is not None else create_config()
    mesh = mesh if mesh is not None else _world_mesh(device)
    b = mesh_sizes(mesh)[FRAME_AXIS]
    return track_batch_sharded(*_random_pairs(cfg, b, image_shape,
                                              n_features, 1), cfg, mesh)


def multichip_full_step(mesh=None, image_shape=(64, 96),
                        n_features: int = 64, *, device=None):
    """One sharded FULL step (translational LK with lighting-insensitive
    residuals, the affine check, the refill) on small random shapes."""
    from ..config import create_config
    cfg = create_config(affineConsistencyCheck=2,
                        lighting_insensitive=True).validated_window()
    mesh = mesh if mesh is not None else _world_mesh(device)
    b = mesh_sizes(mesh)[FRAME_AXIS]
    return full_pair_batch_sharded(*_random_pairs(cfg, b, image_shape,
                                                  n_features, 2), cfg, mesh)


def multichip_chunked_sequence(mesh=None, image_shape=(64, 96),
                               n_frames: int = 4, n_features: int = 16,
                               chain: int = 2, *, device=None):
    """The chunk-sharded lockstep sequence (replace-lost on, chained) with
    one chunk per ``frame`` rank, on rolled random frames. Returns the
    [C, F, N] (x, y, val) history."""
    from ..config import create_config
    cfg = create_config().replace(sequentialMode=True).validated_window()
    mesh = mesh if mesh is not None else _world_mesh(device)
    c = mesh_sizes(mesh)[FRAME_AXIS]
    h, w = image_shape
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, size=(c, h, w)).astype(np.float32)
    frames = np.stack([np.roll(base, 2 * i, axis=-1)
                       for i in range(n_frames)], axis=1)
    xs = rng.uniform(cfg.borderx + 1, w - cfg.borderx - 2, (c, n_features))
    ys = rng.uniform(cfg.bordery + 1, h - cfg.bordery - 2, (c, n_features))
    vals = np.ones((c, n_features), np.int32)
    return track_chunks_sharded(frames, xs, ys, vals, cfg, mesh,
                                replace_lost=True, chain=chain)[:3]


def multichip_batched_serving(mesh=None, image_shape=(64, 96),
                              n_features: int = 16, n_steps: int = 3, *,
                              device=None):
    """The stream-sharded batched serving tick, one stream per ``frame``
    rank: a selection on the first frame batch, then ``n_steps`` frames in
    one chain. Returns the (x, y, val) history [1 + n_steps, B, N]."""
    from ..config import create_config
    cfg = create_config().replace(sequentialMode=True).validated_window()
    mesh = mesh if mesh is not None else _world_mesh(device)
    b = mesh_sizes(mesh)[FRAME_AXIS]
    h, w = image_shape
    rng = np.random.default_rng(9)
    base = rng.uniform(0, 255, size=(b, h, w)).astype(np.float32)
    ticks = [np.roll(base, 2 * i, axis=-1) for i in range(n_steps)]
    return batched_serving_sharded([ticks[0]] + ticks, cfg, n_features,
                                   mesh, chain=n_steps, top_k=64)
