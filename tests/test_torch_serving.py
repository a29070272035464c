"""The port's serving path (``serving.py``) on the CPU: the scenarios of
tests/test_serving.py, each held against the JAX package's function on
the same seeded frames (val tables equal, positions within 1e-4 px, as in
tests/test_torch_sequence.py) and against the port's own device loop (bit
for bit: the same steps)."""

import threading
import time

import numpy as np
import pytest
import torch

from conftest import make_textured_image

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.models.device_sequence import (
    track_sequence_device as jax_track_sequence_device)
from pyfeaturetrack_tpu.serving import (
    BatchedStreamingTracker as JaxBatchedStreamingTracker,
    serve_stream as jax_serve_stream)

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.errors import KLTError
from pyfeaturetrack_tpu_torch.serving import (BatchedStreamingTracker,
                                              StreamingTracker,
                                              prefetch_to_device,
                                              serve_stream)
from pyfeaturetrack_tpu_torch.utils.convert import config_from_jax

torch.set_num_threads(2)

POS_TOL = 1e-4


def _rolling_frames(n_frames=6, shift=4, seed=13):
    base = make_textured_image(120, 160, seed=seed)
    return [np.roll(base, shift * i, axis=1) for i in range(n_frames)]


def _assert_tables(got, want, exact=False):
    for g, w, is_val in zip(got, want, (False, False, True)):
        assert g.shape == w.shape
        if exact or is_val:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=POS_TOL)


@pytest.mark.parametrize("chain,prefetch", [(1, 2), (3, 2), (4, 0)])
def test_serve_stream_matches_device_loop(chain, prefetch):
    """serve_stream (prefetch thread on or off, chained or per step) ==
    JAX's track_sequence_device, and == the port's, bit for bit."""
    frames = _rolling_frames(n_frames=7)
    jcfg = create_config(mindist=8)
    cfg = config_from_jax(jcfg)
    want = jax_track_sequence_device(frames, cfg=jcfg, n_features=40,
                                     replace_lost=True, chain=chain)
    got = serve_stream(iter(frames), cfg=cfg, n_features=40,
                       replace_lost=True, chain=chain, prefetch=prefetch,
                       device="cpu")
    _assert_tables(got, want)
    loop = tpft.track_sequence_device(frames, cfg=cfg, n_features=40,
                                      chain=chain, device="cpu")
    _assert_tables(got, loop, exact=True)


def test_serve_stream_uint8_staging_exact():
    """8-bit staged frames track exactly like float32 staging when the
    source is uint8, and like JAX's 8-bit staging."""
    frames = [f.astype(np.uint8) for f in _rolling_frames(n_frames=6)]
    jcfg = create_config(mindist=8)
    cfg = config_from_jax(jcfg)
    f32 = serve_stream(iter(frames), cfg=cfg, n_features=30, chain=2,
                       stage_uint8=False, device="cpu")
    u8 = serve_stream(iter(frames), cfg=cfg, n_features=30, chain=2,
                      stage_uint8=True, prefetch=2, device="cpu")
    _assert_tables(u8, f32, exact=True)
    _assert_tables(u8, jax_serve_stream(iter(frames), cfg=jcfg,
                                        n_features=30, chain=2,
                                        stage_uint8=True))


def test_streaming_tracker_incremental_partial_chain():
    """One frame at a time with chain=4 and a stream that leaves a partial
    chain (the flush path) == JAX's per-step loop."""
    frames = _rolling_frames(n_frames=6)  # 5 tracked frames: 4 + partial 1
    jcfg = create_config(mindist=8)
    want = jax_track_sequence_device(frames, cfg=jcfg, n_features=30)
    tr = StreamingTracker(config_from_jax(jcfg), n_features=30, chain=4,
                          device="cpu")
    for f in frames:
        assert tr.feed(f) is None
    _assert_tables(tr.table(), want)


def test_streaming_tracker_emit_every():
    frames = _rolling_frames(n_frames=5)
    tr = StreamingTracker(tpft.create_config(mindist=8), n_features=20,
                          emit_every=2, device="cpu")
    emitted = [tr.feed(f) for f in frames]
    # fires on frames 2 and 4 (1-based), None otherwise
    assert [e is not None for e in emitted] == [False, True, False, True,
                                               False]
    x2, _, _ = emitted[1]
    assert x2.shape == (2, 20)
    x4, _, v4 = emitted[3]
    assert x4.shape == (4, 20)
    # emitted prefixes are consistent with the final table
    fx, _, fv = tr.table()
    assert fx.shape == (5, 20)
    np.testing.assert_array_equal(fx[:4], x4)
    np.testing.assert_array_equal(fv[:4], v4)


def test_streaming_tracker_drain_releases_history():
    """drain() returns only rows since the previous drain and releases
    them (bounded memory for unbounded streams)."""
    frames = _rolling_frames(n_frames=7)
    cfg = tpft.create_config(mindist=8)
    full = serve_stream(iter(frames), cfg=cfg, n_features=20, device="cpu")
    tr = StreamingTracker(cfg, n_features=20, chain=3, device="cpu")
    for f in frames[:4]:
        tr.feed(f)
    x1, y1, v1 = tr.drain()
    assert x1.shape == (4, 20)
    for f in frames[4:]:
        tr.feed(f)
    x2, y2, v2 = tr.drain()
    assert x2.shape == (3, 20)
    _assert_tables((np.concatenate([x1, x2]), np.concatenate([y1, y2]),
                    np.concatenate([v1, v2])), full, exact=True)
    # empty interval: empty arrays, not an error
    x3, _, _ = tr.drain()
    assert x3.shape == (0, 20)


@pytest.mark.parametrize("how,dtype", [
    ("reused_buffer", np.uint8), ("mid_chain_flush", np.float32),
    ("off_boundary_drain", np.uint8), ("emit_every", np.float32),
    ("tensor_mid_chain", np.uint8)])
def test_chained_host_frames_through_host_blocks(how, dtype):
    """A chained stream's host frames are written into the tracker's host
    blocks at feed (two, one a chain in turn): with one numpy buffer
    rewritten after every feed as a decoder does, a flush in the middle of
    a chain, drains off a chain boundary, ``emit_every`` 5, and a tensor on
    the device fed in the middle of a chain (staged on its own), the table
    == track_sequence_device on the same frames, bit for bit."""
    frames = [f.astype(dtype) for f in _rolling_frames(n_frames=12)]
    cfg = tpft.create_config(mindist=8)
    want = tpft.track_sequence_device(frames, cfg=cfg, n_features=20,
                                      device="cpu")
    tr = StreamingTracker(cfg, n_features=20, chain=3,
                          emit_every=5 if how == "emit_every" else 0,
                          device="cpu")
    buf = np.empty_like(frames[0])
    parts = []
    for i, f in enumerate(frames):
        if how == "reused_buffer":
            buf[...] = f
            tr.feed(buf)
            buf[...] = 255 - f           # the decoder's next frame lands
        elif how == "tensor_mid_chain" and i == 5:
            tr.feed(torch.tensor(f))
        else:
            emitted = tr.feed(f)
            if emitted is not None:
                assert emitted[0].shape == (i + 1, 20)
        if how == "mid_chain_flush" and i == 5:
            tr.flush()
        if how == "off_boundary_drain" and i in (4, 8):
            parts.append(tr.drain())
    parts.append(tr.drain())
    got = tuple(np.concatenate([p[j] for p in parts]) for j in range(3))
    _assert_tables(got, want, exact=True)
    assert all(b is not None and b.tensor.dtype == torch.from_numpy(
        frames[0]).dtype for b in tr._ring.blocks)


@pytest.mark.parametrize("batched", [False, True])
def test_affine_state_is_what_the_chain_handed_out(batched):
    """``affine_state(stream)``: None before the first frame and with the
    affine check off; with it on, stream b's AffineState as the last chain
    handed it out (the tracker's own lane state, no copy), which later
    feeds, chained and flushed, leave unchanged; both trackers."""
    frames = [f.astype(np.uint8) for f in _rolling_frames(n_frames=9,
                                                          shift=2)]
    on = tpft.create_config(mindist=8, affineConsistencyCheck=2)

    def tracker(cfg):
        if batched:
            return BatchedStreamingTracker(cfg, n_streams=2, n_features=20,
                                           chain=2, device="cpu")
        return StreamingTracker(cfg, n_features=20, chain=2, device="cpu")

    def item(f):
        return np.stack([f, f[:, ::-1].copy()]) if batched else f

    streams = range(2 if batched else 1)
    off = tracker(tpft.create_config(mindist=8))
    tr = tracker(on)
    assert tr.affine_state() is None
    for f in frames[:5]:
        off.feed(item(f))
        tr.feed(item(f))
    assert all(off.affine_state(b) is None for b in streams)
    held = [tr.affine_state(b) for b in streams]
    assert all(h is tr._lanes[b][4] for b, h in zip(streams, held))
    assert all(bool(h.valid.any()) for h in held)
    kept = [[t.clone() for t in h] for h in held]
    for f in frames[5:8]:
        tr.feed(item(f))
    tr.flush()
    for h, k in zip(held, kept):
        for a, b in zip(h, k):
            assert torch.equal(a, b)
    assert not torch.equal(tr.affine_state(0).A, held[0].A)


def test_prefetch_abandoned_consumer_stops_worker():
    """Breaking out of a prefetch iterator unblocks and stops the
    staging thread (no leak of the source or staged frames)."""
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield np.zeros((4, 4), np.float32)

    before = threading.active_count()
    it = prefetch_to_device(source(), depth=2, device="cpu")
    next(it)
    it.close()  # abandon (same path as break / GC)
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(pulled) < 100  # source was not fully consumed


def test_streaming_tracker_table_before_feed_raises():
    with pytest.raises(KLTError):
        StreamingTracker(tpft.create_config(), device="cpu").table()
    with pytest.raises(KLTError):
        StreamingTracker(tpft.create_config(), chain=0, device="cpu")


@pytest.mark.parametrize("replace_lost,affine,chain", [
    (True, -1, 1), (False, -1, 2), (True, 2, 2)])
def test_batched_streaming_matches_independent_streams(replace_lost,
                                                       affine, chain):
    """B lockstep streams == B independent StreamingTrackers, frame for
    frame, bit for bit (incl. replace-lost, affine mode 2 and a real
    partial-chain flush: 7 tracked frames with chain=2 leave a 1-tick
    tail)."""
    B, n = 3, 25
    cfg = tpft.create_config(mindist=8, affineConsistencyCheck=affine)
    streams = [_rolling_frames(n_frames=8, shift=3 + b, seed=20 + b)
               for b in range(B)]
    singles = []
    for b in range(B):
        tr = StreamingTracker(cfg, n_features=n, replace_lost=replace_lost,
                              chain=chain, device="cpu")
        for f in streams[b]:
            tr.feed(f)
        singles.append(tr.table())
    bt = BatchedStreamingTracker(cfg, n_streams=B, n_features=n,
                                 replace_lost=replace_lost, chain=chain,
                                 device="cpu")
    for i in range(8):
        bt.feed(np.stack([streams[b][i] for b in range(B)]))
    bx, by, bv = bt.table()
    assert bx.shape == (8, B, n)
    for b in range(B):
        _assert_tables((bx[:, b], by[:, b], bv[:, b]), singles[b],
                       exact=True)


# (frame, stream, lane) entries allowed to differ from JAX, each listed:
# frame 0's selected corner whose quantized min eigenvalue lies one integer
# step apart in the two packages' eig maps (port 10657, JAX 10656; the
# same corner at the same position).
LISTED_BATCHED = [(0, 0, 0)]


def test_batched_streaming_matches_jax():
    """The port's batched tracker == JAX's (vmapped ticks), chain 2 with a
    one-tick tail, replace-lost on; the listed lanes differ by one
    eigenvalue step."""
    B, n = 2, 20
    jcfg = create_config(mindist=8)
    streams = [_rolling_frames(n_frames=6, shift=3 + b, seed=40 + b)
               for b in range(B)]
    trackers = (JaxBatchedStreamingTracker(jcfg, n_streams=B, n_features=n,
                                           chain=2),
                BatchedStreamingTracker(config_from_jax(jcfg), n_streams=B,
                                        n_features=n, chain=2,
                                        device="cpu"))
    for i in range(6):
        for tr in trackers:
            tr.feed(np.stack([streams[b][i] for b in range(B)]))
    (wx, wy, wv), (gx, gy, gv) = (tr.table() for tr in trackers)
    assert [tuple(int(i) for i in d)
            for d in np.argwhere(gv != wv)] == LISTED_BATCHED
    for f, b, i in LISTED_BATCHED:
        assert abs(int(gv[f, b, i]) - int(wv[f, b, i])) == 1
    assert gv.shape == wv.shape
    np.testing.assert_allclose(gx, wx, atol=POS_TOL)
    np.testing.assert_allclose(gy, wy, atol=POS_TOL)


def test_batched_streaming_drain_and_validation():
    cfg = tpft.create_config(mindist=8)
    bt = BatchedStreamingTracker(cfg, n_streams=2, n_features=10,
                                 device="cpu")
    with pytest.raises(KLTError):
        bt.feed(np.zeros((3, 32, 32)))  # wrong stream count
    frames = _rolling_frames(n_frames=3)
    for i in range(3):
        bt.feed(np.stack([frames[i], frames[i]]))
    x1, _, _ = bt.drain()
    assert x1.shape == (3, 2, 10)
    x2, _, _ = bt.drain()
    assert x2.shape == (0, 2, 10)


@pytest.mark.parametrize("stage_dtype", [np.float32, np.uint8])
def test_prefetch_to_device_order_and_residency(stage_dtype):
    frames = [np.full((8, 8), i, np.float32) for i in range(5)]
    out = list(prefetch_to_device(iter(frames), depth=2, device="cpu",
                                  stage_dtype=stage_dtype))
    assert len(out) == 5
    for i, a in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.dtype == (torch.uint8 if stage_dtype is np.uint8
                           else torch.float32)
        np.testing.assert_array_equal(a.numpy(), frames[i])


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_yields_frames_in_order_unaliased(depth):
    """prefetch_to_device ``depth`` frames ahead, fed one source buffer
    rewritten for every frame as a decoder does: every frame in order, each
    in memory of its own (neither the source's nor another frame's)."""
    buf = np.empty((6, 7), np.uint8)

    def source():
        for i in range(8):
            buf[...] = i
            yield buf

    out = list(prefetch_to_device(source(), depth=depth, device="cpu",
                                  stage_dtype=np.uint8))
    assert [int(a.min()) for a in out] == list(range(8))
    assert all(int(a.max()) == i for i, a in enumerate(out))
    ptrs = {a.data_ptr() for a in out}
    assert len(ptrs) == 8 and buf.ctypes.data not in ptrs


def test_prefetch_to_device_relays_source_exception():
    def bad_source():
        yield np.zeros((4, 4), np.float32)
        raise RuntimeError("decoder died")

    it = prefetch_to_device(bad_source(), depth=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decoder died"):
        list(it)


def test_prefetch_depth_validation():
    with pytest.raises(KLTError):
        list(prefetch_to_device([], depth=0, device="cpu"))


def test_serve_stream_takes_tensors_on_the_device():
    """Frames already on the tracker's device pass through untouched."""
    frames = _rolling_frames(n_frames=5)
    cfg = tpft.create_config(mindist=8)
    a = serve_stream([torch.tensor(f) for f in frames], cfg=cfg,
                     n_features=20, chain=2, device="cpu")
    b = serve_stream(frames, cfg=cfg, n_features=20, chain=2, device="cpu")
    _assert_tables(a, b, exact=True)
