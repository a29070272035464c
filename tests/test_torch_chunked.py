"""The port's chunked tracking (``models/chunked.py``) on the CPU: the
scenarios of tests/test_chunked.py, each against the JAX package's
``track_sequence_chunked`` on the same seeded frames (the stitched tables'
val equal, positions within 1e-4 px, as in tests/test_torch_sequence.py),
and the port's lockstep (``batched=True``, chained or not) against its
serial chunks."""

import numpy as np
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.models.chunked import (
    _stitch_ids as jax_stitch_ids,
    chunk_bounds as jax_chunk_bounds,
    track_sequence_chunked as jax_chunked)

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.models.chunked import (_stitch_ids,
                                                     chunk_bounds,
                                                     stitch_chunk_tables,
                                                     track_chunks_batched,
                                                     track_sequence_chunked)

torch.set_num_threads(2)

POS_TOL = 1e-4


def _frames(n=9, dx=0.8, dy=-0.5, shape=(96, 128), seed=41):
    base = make_textured_image(*shape, seed=seed)
    return [shift_image_bilinear(base, dx * i, dy * i) for i in range(n)]


def _scrolling(n=9, seed=47, shift=4):
    base = make_textured_image(96, 128, seed=seed)
    return [np.roll(base, shift * i, axis=1) for i in range(n)]


def _assert_tables(got, want, tol=POS_TOL):
    assert got["x"].shape == want["x"].shape
    np.testing.assert_array_equal(got["val"], want["val"])
    live = want["val"] >= 0
    np.testing.assert_allclose(got["x"][live], want["x"][live], atol=tol)
    np.testing.assert_allclose(got["y"][live], want["y"][live], atol=tol)


@pytest.mark.parametrize("n,k", [(10, 2), (9, 3), (7, 2), (5, 1), (4, 9)])
def test_chunk_bounds_match_jax(n, k):
    b = chunk_bounds(n, k)
    assert b == jax_chunk_bounds(n, k)
    assert b[0][0] == 0 and b[-1][1] == n
    for (s0, e0), (s1, e1) in zip(b, b[1:]):
        assert s1 == e0 - 1


def test_stitch_ids_match_jax():
    rng = np.random.default_rng(3)
    prev = rng.uniform(0, 50, (12, 2))
    nxt = np.concatenate([prev[:6] + rng.uniform(-0.4, 0.4, (6, 2)),
                          rng.uniform(0, 50, (5, 2)), prev[2:3] + 0.1])
    ids = np.arange(100, 112)
    got = _stitch_ids(prev, ids, nxt, 1.0)
    np.testing.assert_array_equal(got, jax_stitch_ids(prev, ids, nxt, 1.0))
    assert (got[:6] >= 0).sum() >= 5 and len(set(got[got >= 0])) == \
        (got >= 0).sum()


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_serial_chunked_matches_jax(n_chunks):
    """Chunk after chunk through the host API, stitched, == JAX's; every
    frame has live tracks and stitched tracks move with the flow."""
    frames = _frames()
    got, ids, metrics = track_sequence_chunked(frames, n_features=30,
                                               n_chunks=n_chunks,
                                               device="cpu")
    want, jids, _ = jax_chunked(frames, n_features=30, n_chunks=n_chunks)
    _assert_tables(got, want)
    for a, b in zip(ids, jids):
        np.testing.assert_array_equal(a, b)
    assert len(metrics) == n_chunks
    assert ((got["val"] >= 0).sum(axis=1) > 10).all()
    full = (got["val"] >= 0).all(axis=0)
    assert full.sum() >= 5
    steps = np.diff(got["x"][:, full], axis=0)
    assert abs(np.median(steps[np.abs(steps) < 3]) - 0.8) < 0.15


@pytest.mark.parametrize("replace_lost,scene", [(False, "flow"),
                                                (True, "scroll")])
def test_batched_matches_serial_and_jax(replace_lost, scene):
    """Lockstep chunks == serial chunks in the port, bit for bit, and ==
    JAX's lockstep (with and without the device refill)."""
    frames = _frames(n=7) if scene == "flow" else _scrolling()
    kw = dict(n_features=25, n_chunks=2, replace_lost=replace_lost)
    serial, _, _ = track_sequence_chunked(frames, **kw, device="cpu")
    batch, _, _ = track_sequence_chunked(frames, **kw, batched=True,
                                         device="cpu")
    _assert_tables(batch, serial, tol=0.0)
    want, _, _ = jax_chunked(frames, **kw, batched=True)
    _assert_tables(batch, want)
    if replace_lost:
        assert (batch["val"][1:] > 0).any()   # refills happened


def test_batched_chain_matches_per_step_and_jax():
    """chain > 1 (k lockstep steps per call) is bit-identical to the
    per-step lockstep, with a sub-chain tail and the refill, and matches
    JAX's chained lockstep."""
    base = make_textured_image(96, 128, seed=53)
    frames = [np.roll(base, 3 * i, axis=1) for i in range(10)]
    kw = dict(n_features=20, n_chunks=2, batched=True, replace_lost=True)
    t1, _, _ = track_sequence_chunked(frames, **kw, device="cpu")
    # chunk length 6 incl. boundary -> 5 steps: chain=3 leaves a 2-step
    # tail on the per-step route
    t3, _, _ = track_sequence_chunked(frames, **kw, chain=3, device="cpu")
    _assert_tables(t3, t1, tol=0.0)
    want, _, _ = jax_chunked(frames, **kw, chain=3)
    _assert_tables(t3, want)


def test_track_chunks_batched_layout():
    """[C, F, N] device tables and an exhausted flag; a list of staged
    [C, H, W] steps tracks like the packed array."""
    frames = _scrolling(n=5)
    stack = np.stack([frames, frames[::-1]]).astype(np.float32)
    cfg = tpft.create_config(mindist=8)
    inits = [tpft.select_step_device(torch.tensor(c[0]), cfg, 15)[1:4]
             for c in stack]
    init = [np.stack([i[j].numpy() for i in inits]) for j in range(3)]
    xs, ys, vs, ex = track_chunks_batched(stack, *init, cfg,
                                          replace_lost=True, chain=2,
                                          device="cpu")
    assert xs.shape == (2, 5, 15) and vs.dtype == torch.int32
    assert not bool(ex)
    steps = [torch.tensor(stack[:, i]) for i in range(5)]
    xs2, _, vs2, _ = track_chunks_batched(steps, *init, cfg,
                                          replace_lost=True, device="cpu")
    assert torch.equal(xs, xs2) and torch.equal(vs, vs2)


def test_stitch_chunk_tables_single_chunk_is_identity():
    x = np.array([[1.0, -1.0], [2.0, -1.0]])
    v = np.array([[5, -1], [0, -1]])
    table, ids = stitch_chunk_tables([(0, 2, x, x + 1, v)], 2, 2)
    assert table["x"].shape == (2, 1)
    np.testing.assert_array_equal(ids[0], [0, -1])
    np.testing.assert_array_equal(table["val"][:, 0], v[:, 0])
