"""Chained steps (``sequence_chain_device``, ``track_sequence_device(...,
chain=k)``) and frame staging: the port's plain versions on the CPU
against the JAX package's chained program on the same seeded frames, and
against the port's own steps.

Bars: val tables equal and positions within 1e-4 px against JAX (as in
tests/test_torch_sequence.py); chained == per-step bit for bit within the
port (the same steps in the same order)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_textured_image

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.models.device_sequence import (
    select_step_device as jax_select_step,
    sequence_chain_device as jax_chain,
    track_sequence_device as jax_track_sequence_device)

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.errors import KLTWarningCategory
from pyfeaturetrack_tpu_torch.features import Lane
from pyfeaturetrack_tpu_torch.models.device_sequence import (
    chain_lanes, sequence_chain_device, stack_history_chunks,
    warn_selection_exhausted)
from pyfeaturetrack_tpu_torch.ops.cuda_lk import empty_track_carry
from pyfeaturetrack_tpu_torch.utils.convert import config_from_jax
from pyfeaturetrack_tpu_torch.utils.staging import (BlockRing, stage_f32,
                                                    stage_raw)

torch.set_num_threads(2)

POS_TOL = 1e-4


def _rolling_frames(n_frames=9, shift=4, seed=29, shape=(120, 160)):
    base = make_textured_image(*shape, seed=seed)
    return [np.roll(base, shift * i, axis=1) for i in range(n_frames)]


def _assert_tables(got, want, tol=POS_TOL):
    gx, gy, gv = got
    wx, wy, wv = want
    assert gv.shape == wv.shape
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gx, wx, atol=tol)
    np.testing.assert_allclose(gy, wy, atol=tol)


@pytest.mark.parametrize("chain,affine,replace_lost", [
    (3, -1, True), (4, -1, True), (4, -1, False), (3, 2, True)])
def test_chained_matches_jax_and_steps(chain, affine, replace_lost):
    """The port's chained loop == JAX's chained loop (9 frames: full
    chains and a tail) and == the port's own per-step loop, bit for bit."""
    frames = _rolling_frames()
    jcfg = create_config(mindist=8, affineConsistencyCheck=affine)
    cfg = config_from_jax(jcfg)
    want = jax_track_sequence_device(frames, cfg=jcfg, n_features=30,
                                     replace_lost=replace_lost, chain=chain)
    got = tpft.track_sequence_device(frames, cfg=cfg, n_features=30,
                                     replace_lost=replace_lost, chain=chain,
                                     device="cpu")
    steps = tpft.track_sequence_device(frames, cfg=cfg, n_features=30,
                                       replace_lost=replace_lost,
                                       device="cpu")
    _assert_tables(got, want)
    for a, b in zip(got, steps):
        np.testing.assert_array_equal(a, b)
    if replace_lost:
        assert (got[2][1:] > 0).any()      # refills happened


def test_sequence_chain_device_layout_matches_jax():
    """One call of k frames: (pyr, hist [k, N] x3, final, aff, exhausted,
    carry), hist and final against JAX's from the same first frame."""
    frames = _rolling_frames(n_frames=5, shift=3, seed=17)
    jcfg = create_config(mindist=8, affineConsistencyCheck=2).replace(
        sequentialMode=True)
    cfg = config_from_jax(jcfg)
    jpyr, jx, jy, jv, jaff, _ = jax_select_step(jnp.asarray(frames[0]), jcfg,
                                                30)
    _, jhist, jfinal, _, jex, _ = jax_chain(
        jpyr, tuple(jnp.asarray(f) for f in frames[1:]), jx, jy, jv, jcfg,
        True, aff=jaff)
    pyr, x, y, v, aff, _ = tpft.select_step_device(
        torch.tensor(frames[0]), cfg, 30)
    carry = empty_track_carry(30, cfg, device="cpu")
    out = sequence_chain_device(pyr, frames[1:], x, y, v, cfg, True,
                                aff=aff, carry=carry)
    tpyr, hist, final, taff, ex, tcarry = out
    assert len(out) == 6
    assert all(h.shape == (4, 30) for h in hist)
    assert hist[2].dtype == torch.int32 and not bool(ex) and not bool(jex)
    _assert_tables(tuple(h.numpy() for h in hist),
                   tuple(np.asarray(h) for h in jhist))
    for f, h in zip(final, hist):
        assert torch.equal(f, h[-1])
    _assert_tables(tuple(f.numpy() for f in final),
                   tuple(np.asarray(f) for f in jfinal))
    assert isinstance(tpyr, tpft.TrackPyramids)
    assert taff.valid.any() and not tcarry.ok.any()


def test_chain_outputs_are_the_callers():
    """A second call leaves the first call's outputs as they were."""
    frames = _rolling_frames(n_frames=7)
    cfg = tpft.create_config(mindist=8).replace(sequentialMode=True)
    pyr, x, y, v, aff, _ = tpft.select_step_device(
        torch.tensor(frames[0]), cfg, 30)
    first = sequence_chain_device(pyr, frames[1:4], x, y, v, cfg)
    kept = [t.clone() for t in (*first[1], *first[2], first[0].img[0])]
    sequence_chain_device(first[0], frames[4:7], *first[2], cfg)
    for a, b in zip((*first[1], *first[2], first[0].img[0]), kept):
        assert torch.equal(a, b)


def test_chain_lanes_are_independent_streams():
    """B lanes in one chain == each lane's own chain."""
    cfg = tpft.create_config(mindist=8).replace(sequentialMode=True)
    streams = [_rolling_frames(n_frames=4, shift=3 + b, seed=20 + b)
               for b in range(3)]
    lanes = []
    for s in streams:
        pyr, x, y, v, aff, _ = tpft.select_step_device(torch.tensor(s[0]),
                                                       cfg, 25)
        lanes.append(Lane(pyr, x, y, v, aff))
    ticks = [[s[i] for s in streams] for i in range(1, 4)]
    out, hist, ex = chain_lanes(lanes, ticks, cfg)
    assert hist[0].shape == (3, 3, 25) and ex.shape == (3,)
    for b, s in enumerate(streams):
        pyr, _, final, _, _, _ = sequence_chain_device(
            *lanes[b][:1], s[1:], *lanes[b][1:4], cfg)
        for j in range(3):
            assert torch.equal(hist[j][b][-1], final[j])
            assert torch.equal(out[b][1 + j], final[j])


def test_port_selection_never_exhausts():
    """JAX's test_exhausted_selection_warns does not carry over: the
    port's K4 scans the whole candidate pool, so top_k=4 still fills all
    40 slots on the first frame and no warning fires; the warning itself
    exists for the callers that surface it."""
    frames = _rolling_frames(n_frames=3, shift=4, seed=31)
    with warnings.catch_warnings():
        warnings.simplefilter("error", KLTWarningCategory)
        _, _, v = tpft.track_sequence_device(
            frames, cfg=tpft.create_config(mindist=8), n_features=40,
            top_k=4, chain=2, device="cpu")
    assert (v[0] >= 0).all()
    with pytest.warns(KLTWarningCategory, match="ran out of candidates"):
        warn_selection_exhausted("here", 4)


def test_stack_history_chunks_mixes_rows_and_blocks():
    rows = (torch.arange(3.0), torch.arange(3.0) + 1, torch.arange(3))
    block = tuple(torch.stack([r, r]) for r in rows)
    x, y, v = stack_history_chunks([rows, block, tuple(
        r.numpy() for r in rows)])
    assert x.shape == (4, 3) and v.dtype == np.int64
    np.testing.assert_array_equal(y[2], [1.0, 2.0, 3.0])


def test_staging_contract():
    """stage_raw keeps uint8, converts other dtypes to float32 on the host;
    stage_f32 always stages float32; tensors on the target pass through."""
    u8 = np.arange(12, dtype=np.uint8).reshape(3, 4)
    i16 = u8.astype(np.int16)
    a = stage_raw(u8, device="cpu")
    assert a.dtype == torch.uint8 and torch.equal(a, torch.from_numpy(u8))
    assert stage_raw(i16, device="cpu").dtype == torch.float32
    assert stage_f32(u8, device="cpu").dtype == torch.float32
    t = torch.zeros(2, 2, dtype=torch.uint8)
    assert stage_raw(t, device="cpu") is t and stage_f32(t, device="cpu") is t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            stage_raw(u8)                   # the card is the default


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_block_ring_hands_out_blocks_in_turn(depth):
    """A BlockRing of ``depth`` hands its blocks out in turn, remakes the
    block in turn where a new shape or dtype is asked for, and on the CPU,
    where a copy has run when it returns, never waits."""
    from pyfeaturetrack_tpu_torch.utils.profiling import counters
    ring = BlockRing(depth, "cpu")
    shape = (3, 2, 4, 5)
    waits = counters().get("sync.stage_block", 0)
    first = [ring.next(shape, torch.uint8) for _ in range(depth)]
    assert len({id(b) for b in first}) == depth
    assert all(len(b) == shape[0] for b in first)
    for b in first:
        b.copy_to(torch.empty(shape, dtype=torch.uint8))
    assert [ring.next(shape, torch.uint8) for _ in range(depth)] == first
    wide = ring.next((3, 2, 4, 6), torch.uint8)
    assert wide is not first[0] and wide.holds((3, 2, 4, 6), torch.uint8)
    assert wide.array.shape == (3, 2, 4, 6) and ring.blocks[0] is wide
    f32 = ring.next(shape, torch.float32)
    assert f32.tensor.dtype == torch.float32 and f32 not in first
    assert ring.blocks[1 % depth] is f32
    assert counters().get("sync.stage_block", 0) == waits


@pytest.mark.parametrize("affine", [False, True])
def test_lane_state_lists_what_the_steps_carry(affine):
    """``Lane.state`` lists x, y, val and the AffineState's fields (a None
    ``nit`` as zeros), ``Lane.tensors`` the pyramid's levels before them,
    and ``Lane.from_state`` rebuilds the lane from them; the window carry
    is in none of them."""
    from pyfeaturetrack_tpu_torch.features import empty_affine_state
    from pyfeaturetrack_tpu_torch.ops.track import TrackPyramids
    levels = [torch.rand(8 >> i, 10 >> i) for i in range(2)]
    pyr = TrackPyramids(tuple(levels), tuple(2 * t for t in levels),
                        tuple(3 * t for t in levels))
    x, y = torch.rand(5), torch.rand(5)
    val = torch.arange(5, dtype=torch.int32)
    aff = (empty_affine_state(5, 3, 3, "cpu")._replace(nit=None)
           if affine else None)
    lane = Lane(pyr, x, y, val, aff, carry=object())
    state = lane.state()
    assert state[0] is x and state[1] is y and state[2] is val
    assert len(state) == (3 + len(aff) if affine else 3)
    if affine:
        assert all(a is b for a, b in zip(state[3:-1], aff[:-1]))
        assert torch.equal(state[-1], torch.zeros(5, dtype=torch.int32))
    tensors = lane.tensors()
    assert len(tensors) == 6 + len(state)
    assert all(a is b for a, b in zip(tensors, (*pyr.img, *pyr.gradx,
                                                *pyr.grady)))
    back = Lane.from_state(pyr, state)
    assert back.pyr is pyr and back.carry is None
    assert all(a is b for a, b in zip(back.state(), state))
    assert (back.aff is None) == (not affine)


def test_track_sequence_device_signature():
    """JAX's positional order (frames, cfg, n_features, replace_lost,
    top_k, chain); the device is keyword-only and defaults to the card."""
    import inspect

    from pyfeaturetrack_tpu.models.device_sequence import (
        track_sequence_device as jax_fn)
    sig = inspect.signature(tpft.track_sequence_device).parameters
    positional = [n for n, p in sig.items()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert positional == list(inspect.signature(jax_fn).parameters)
    assert sig["device"].kind is sig["device"].KEYWORD_ONLY
    assert sig["device"].default == "cuda"
