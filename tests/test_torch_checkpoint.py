"""The port's checkpoint / resume (``utils/checkpoint.py``) on the CPU:
tests/test_checkpoint.py's scenarios and tests/test_vo.py's VO resume
through ``torch.save`` files, each resumed run bit-equal to the
uninterrupted one; and resume from the JAX package's own ``*_state``
dicts, continued by the port and held to JAX's uninterrupted run at the
tracking bars (statuses equal, positions within 1e-4 px)."""

import numpy as np
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear
import test_vo

from pyfeaturetrack_tpu.config import create_config as jax_create_config
from pyfeaturetrack_tpu.models.sequence import SequenceTracker as JaxSeq
from pyfeaturetrack_tpu.serving import StreamingTracker as JaxStream
from pyfeaturetrack_tpu.utils import checkpoint as jckpt

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.errors import KLTWarningCategory
from pyfeaturetrack_tpu_torch.features import (create_feature_table,
                                               feature_state_from_numpy,
                                               store_feature_list)
from pyfeaturetrack_tpu_torch.models.sequence import SequenceTracker
from pyfeaturetrack_tpu_torch.serving import (BatchedStreamingTracker,
                                              StreamingTracker)
from pyfeaturetrack_tpu_torch.sfm.vo import VisualOdometry
from pyfeaturetrack_tpu_torch.utils.checkpoint import (
    restore_checkpoint, resume_sequence, resume_streaming, resume_vo,
    save_checkpoint, sequence_state, streaming_state, vo_state)

torch.set_num_threads(2)

CPU = "cpu"
POS_TOL = 1e-4


def frames_of(seed, n, step=(0.7, 0.4)):
    base = make_textured_image(96, 128, seed=seed)
    return [shift_image_bilinear(base, step[0] * i, step[1] * i)
            for i in range(n)]


def test_feature_table_checkpoint_roundtrip(tmp_path):
    ft = create_feature_table(3, 5, device=CPU)
    arr = np.random.default_rng(0).uniform(0, 50, (5, 3))
    ft = store_feature_list(feature_state_from_numpy(arr, device=CPU), ft, 1)
    p = tmp_path / "ckpt"
    save_checkpoint(p, ft)
    back = restore_checkpoint(p)
    assert set(back) == {"x", "y", "val"}
    for k in ("x", "y", "val"):
        assert torch.equal(back[k], getattr(ft, k))
    again = restore_checkpoint(p, template=ft)
    assert type(again) is type(ft)
    assert all(torch.equal(a, b) for a, b in zip(again, ft))


def test_numpy_leaves_load_with_weights_only(tmp_path):
    """numpy arrays and scalars are stored as tensors and Python scalars:
    the weights-only load takes them, and a numpy template gives them
    back as arrays."""
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
            "b": np.float32(2.5), "c": [np.ones(2, bool), 3, None]}
    save_checkpoint(tmp_path / "t", tree)
    back = restore_checkpoint(tmp_path / "t")
    assert torch.equal(back["a"], torch.arange(6).reshape(2, 3))
    assert back["b"] == 2.5 and back["c"][1] == 3 and back["c"][2] is None
    arrs = restore_checkpoint(tmp_path / "t", template=tree)
    np.testing.assert_array_equal(arrs["a"], tree["a"])
    assert arrs["c"][0].dtype == bool


def test_sequence_resume_continues_identically(tmp_path):
    frames = frames_of(51, 6)
    t1 = SequenceTracker(n_features=25, device=CPU)
    for f in frames:
        t1.step(f)
    t2a = SequenceTracker(n_features=25, device=CPU)
    for f in frames[:3]:
        t2a.step(f)
    save_checkpoint(tmp_path / "seq", sequence_state(t2a))
    t2b = SequenceTracker(n_features=25, device=CPU)
    resume_sequence(t2b, restore_checkpoint(tmp_path / "seq"))
    assert t2b.n_frames_seen == 3
    for f in frames[3:]:
        t2b.step(f)
    for a, b in zip(t1.fl[:3], t2b.fl[:3]):
        assert torch.equal(a, b)


def _stream(cls, cfg, ticks, cut, tmp_path, **kw):
    """An uninterrupted run and one checkpointed after ``cut`` ticks and
    resumed into a fresh tracker; both drained."""
    t1 = cls(cfg, **kw, device=CPU)
    for t in ticks:
        t1.feed(t)
    t2a = cls(cfg, **kw, device=CPU)
    for t in ticks[:cut]:
        t2a.feed(t)
    save_checkpoint(tmp_path / "stream", streaming_state(t2a))
    t2b = cls(cfg, **kw, device=CPU)
    resume_streaming(t2b, restore_checkpoint(tmp_path / "stream"))
    for t in ticks[cut:]:
        t2b.feed(t)
    return t1, t1.drain(), t2b.drain()


def test_streaming_resume_continues_identically(tmp_path):
    cfg = tpft.create_config(mindist=8, affineConsistencyCheck=2)
    t1, (x1, y1, v1), (x2, y2, v2) = _stream(
        StreamingTracker, cfg, frames_of(52, 6), 3, tmp_path,
        n_features=20, chain=2)
    np.testing.assert_array_equal(v2[-1], v1[-1])
    np.testing.assert_array_equal(x2[-1], x1[-1])
    np.testing.assert_array_equal(y2[-1], y1[-1])


def test_batched_streaming_resume(tmp_path):
    base = make_textured_image(96, 128, seed=53)
    ticks = [np.stack([shift_image_bilinear(base, 0.6 * i, 0.3 * i),
                       shift_image_bilinear(base, -0.5 * i, 0.4 * i)])
             for i in range(5)]
    _, (x1, _, v1), (x2, _, v2) = _stream(
        BatchedStreamingTracker, tpft.create_config(mindist=8), ticks, 2,
        tmp_path, n_streams=2, n_features=15)
    np.testing.assert_array_equal(v2[-1], v1[-1])
    np.testing.assert_array_equal(x2[-1], x1[-1])


def test_streaming_resume_preserves_exhaustion_flag():
    base = make_textured_image(96, 128, seed=54)
    cfg = tpft.create_config(mindist=8)
    t = StreamingTracker(cfg, n_features=10, device=CPU)
    t.feed(base)
    t.feed(shift_image_bilinear(base, 0.5, 0.2))
    t._exhausted = torch.tensor(True)   # as a refill that ran out would
    state = streaming_state(t)
    t2 = StreamingTracker(cfg, n_features=10, device=CPU)
    t2.feed(base)            # a frame from an abandoned timeline
    t2.table()               # ... migrated to host history
    resume_streaming(t2, state)
    assert t2._host_chunks == []
    t2.feed(shift_image_bilinear(base, 1.0, 0.4))
    with pytest.warns(KLTWarningCategory):
        t2.drain()


@pytest.fixture(scope="module")
def vo_scene():
    Rs, ts, cs, pts = test_vo._gt_scene()
    return test_vo._render(Rs, ts, pts)


VO_KW = dict(n_features=120, kf_every=2, window=6, min_parallax_px=10.0)


def _vo_run(frames, **kw):
    vo = VisualOdometry(test_vo.K, **VO_KW, **kw, device=CPU)
    for f in frames:
        vo.feed(f)
    return vo


def _same_vo(a, b):
    fa, Ra, ta, ca = a.trajectory()
    fb, Rb, tb, cb = b.trajectory()
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(Ra, Rb)
    np.testing.assert_array_equal(ca, cb)
    assert set(a.landmarks) == set(b.landmarks)
    assert all(np.array_equal(a.landmarks[k], b.landmarks[k])
               for k in a.landmarks)


@pytest.mark.parametrize("device_loop", [False, True])
def test_vo_checkpoint_resume_matches_uninterrupted(vo_scene, tmp_path,
                                                    device_loop):
    full = _vo_run(vo_scene, device_loop=device_loop)
    # device_loop: the cut falls inside a keyframe interval
    cut = 10 if device_loop else 9
    first = _vo_run(vo_scene[:cut], device_loop=device_loop)
    save_checkpoint(tmp_path / "vo", vo_state(first))
    resumed = VisualOdometry(test_vo.K, **VO_KW, device_loop=device_loop,
                             device=CPU)
    resume_vo(resumed, restore_checkpoint(tmp_path / "vo"))
    # device_loop rewinds to the start of the unfinished interval
    assert resumed.n_frames == (cut - 1 if device_loop else cut)
    for f in vo_scene[resumed.n_frames:]:
        resumed.feed(f)
    _same_vo(full, resumed)


# ---------------------------------------------------------------------------
# resume from the JAX package's state dicts
# ---------------------------------------------------------------------------

def _close_to_jax(x, v, jx, jv):
    np.testing.assert_array_equal(np.asarray(v), np.asarray(jv))
    np.testing.assert_allclose(np.asarray(x), np.asarray(jx), rtol=0,
                               atol=POS_TOL)


def test_sequence_resumes_from_jax_state():
    frames = frames_of(55, 6)
    jt = JaxSeq(n_features=25)
    for f in frames[:3]:
        jt.step(f)
    state = jckpt.sequence_state(jt)
    port = SequenceTracker(n_features=25, device=CPU)
    resume_sequence(port, state)
    for f in frames[3:]:
        jt.step(f)
        port.step(f)
        _close_to_jax(port.fl.x, port.fl.val, jt.fl.x, jt.fl.val)
        _close_to_jax(port.fl.y, port.fl.val, jt.fl.y, jt.fl.val)


def test_streaming_resumes_from_jax_state(tmp_path):
    """JAX's state dict, also through an Orbax round trip (numpy dicts)."""
    frames = frames_of(56, 6)
    jcfg = jax_create_config(mindist=8, affineConsistencyCheck=2)
    jt = JaxStream(jcfg, n_features=20, chain=2)
    for f in frames[:3]:
        jt.feed(f)
    state = jckpt.streaming_state(jt)
    jckpt.save_checkpoint(tmp_path / "jax", state)
    for f in frames[3:]:
        jt.feed(f)
    jx, _, jv = jt.drain()
    for st in (state, jckpt.restore_checkpoint(tmp_path / "jax")):
        port = StreamingTracker(tpft.create_config(mindist=8,
                                                   affineConsistencyCheck=2),
                                n_features=20, chain=2, device=CPU)
        resume_streaming(port, st)
        for f in frames[3:]:
            port.feed(f)
        x, _, v = port.drain()
        assert port.n_frames == 6 and x.shape[0] == 3
        _close_to_jax(x, v, jx[-3:], jv[-3:])


def test_vo_resumes_from_jax_state(vo_scene):
    """A JAX VO's state after 9 frames, resumed by the port: the run takes
    the uninterrupted port run's decisions, centres within 1e-3 (the bar
    of tests/test_torch_vo.py)."""
    from pyfeaturetrack_tpu.sfm.vo import VisualOdometry as JaxVO
    jvo = JaxVO(test_vo.K, **VO_KW)
    for f in vo_scene[:9]:
        jvo.feed(f)
    port = VisualOdometry(test_vo.K, **VO_KW, device=CPU)
    resume_vo(port, jckpt.vo_state(jvo))
    assert port.n_frames == 9 and port.initialized == jvo.initialized
    for f in vo_scene[9:]:
        port.feed(f)
    full = _vo_run(vo_scene)
    fa, Ra, _, ca = port.trajectory()
    fb, Rb, _, cb = full.trajectory()
    np.testing.assert_array_equal(fa, fb)
    assert set(port.landmarks) == set(full.landmarks)
    np.testing.assert_allclose(ca, cb, atol=1e-3)
    np.testing.assert_allclose(Ra, Rb, atol=1e-3)
