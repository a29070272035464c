"""The bfloat16 storage lane (``cfg.image_dtype="bfloat16"``) of the port
against the JAX package's, on the CPU (the kernels' plain versions):
every pyramid level and gradient built in float32 and stored rounded to
nearest even, every consumer upcasting each stored value at the tap.

Bars: the stored levels bit-equal to the float32 build rounded (each
framework's convert rounds the other's float32 levels to the same bits);
the refill map equal to K3's map of the stored gradients, upcast, and
within one quantization step of JAX's (tests/test_torch_select.py's bar);
tracking on the same stored levels: statuses exact, positions within 1e-4
px (tests/test_track.py:53); the bfloat16-against-float32 status flips
equal to JAX's exclusion list (tests/test_track.py:271: none). Dense flow
and depth: statuses exact and every pixel over 1e-4 px listed by class
(ROADMAP.md Queue 3, "dense lanes that never converge")."""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.models.device_sequence import (
    select_step_device as jax_select_step,
    sequence_step_device as jax_sequence_step,
    track_sequence_device as jax_track_sequence_device)
from pyfeaturetrack_tpu.models.sequence import SequenceTracker as JaxSeq
from pyfeaturetrack_tpu.ops import disparity as jdisp
from pyfeaturetrack_tpu.ops import flow as jflow
from pyfeaturetrack_tpu.ops.track import build_track_pyramids as jax_build
from pyfeaturetrack_tpu.ops.track import (
    track_features_pyramids as jax_track)
from pyfeaturetrack_tpu.utils import checkpoint as jckpt

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.models.sequence import SequenceTracker
from pyfeaturetrack_tpu_torch.ops import disparity as tdisp
from pyfeaturetrack_tpu_torch.ops import flow as tflow
from pyfeaturetrack_tpu_torch.ops.cuda_eig import min_eig_reference
from pyfeaturetrack_tpu_torch.utils.checkpoint import resume_sequence
from pyfeaturetrack_tpu_torch.utils.convert import (affine_state_from_numpy,
                                                    config_from_jax,
                                                    features_from_numpy,
                                                    pyramids_from_numpy)

torch.set_num_threads(2)

POS_TOL = 1e-4
DENSE_TOL = 2e-3   # tests/test_torch_flow.py, tests/test_torch_disparity.py
BF16 = "bfloat16"
_build = jax.jit(jax_build, static_argnames=("cfg",))


def _bits(a) -> np.ndarray:
    """The uint16 bits of a bfloat16 JAX array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _to_port(jp):
    """A JAX TrackPyramids as the port's, on the CPU, in its dtype."""
    return pyramids_from_numpy(*(tuple(np.asarray(a) for a in lv)
                                 for lv in jp), device="cpu")


def _planes(p):
    return [t for part in p for t in part]


CONFIGS = {"default": {}, "config 4": dict(nPyramidLevels=4, subsampling=2)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stored_levels_are_the_float32_build_rounded(name):
    """Each framework's bfloat16 levels are its float32 levels rounded to
    nearest even, which the other framework's convert reproduces bit for
    bit. The port's and JAX's stored levels differ only where their float32
    builds differ (XLA's CPU convolution rounds differently, at most 4.6e-5
    on the 0..255 scale: tests/test_torch_pyramid.py), and there by one
    bfloat16 step."""
    jcfg = create_config(**CONFIGS[name]).replace(image_dtype=BF16)
    img = jnp.asarray(make_textured_image(120, 160, seed=31), jnp.float32)
    j16, j32 = _build(img, jcfg), _build(img, jcfg.replace(
        image_dtype="float32"))
    cfg = config_from_jax(jcfg)
    t = torch.tensor(np.asarray(img))
    t16 = tpft.build_track_pyramids(t, cfg)
    t32 = tpft.build_track_pyramids(t, cfg.replace(image_dtype="float32"))
    off = 0
    for a16, a32, b16, b32 in zip(_planes(j16), _planes(j32), _planes(t16),
                                  _planes(t32)):
        assert a16.dtype == jnp.bfloat16 and b16.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bits(b16), _bits(jnp.asarray(b32.numpy()).astype(jnp.bfloat16)))
        np.testing.assert_array_equal(
            _bits(a16), _bits(torch.as_tensor(np.asarray(a32)).to(
                torch.bfloat16)))
        diff = _bits(a16) != _bits(b16)
        off += int(diff.sum())
        fa, fb = np.asarray(a32)[diff], b32.numpy()[diff]
        assert (fa != fb).all()
        # each is its float32 rounded: apart by at most the float32 gap
        # plus one bfloat16 step at that magnitude
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(fa),
                                                   np.abs(fb)))) - 7)
        gap = np.abs(np.asarray(a16.astype(jnp.float32))[diff]
                     - b16.to(torch.float32).numpy()[diff])
        assert (gap <= np.abs(fa - fb) + step).all()
    assert off < 100


_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")
_XLA_EIG = """
import sys
import numpy as np
import jax.numpy as jnp
from pyfeaturetrack_tpu.ops.select import quantized_min_eig_map
d = np.load(sys.argv[1])
gx = jnp.asarray(d["gx"]).astype(jnp.bfloat16)
gy = jnp.asarray(d["gy"]).astype(jnp.bfloat16)
np.save(sys.argv[2], np.asarray(quantized_min_eig_map(gx, gy, 7, 7)))
"""


def _xla_eig_pinned(gx, gy):
    """JAX's refill map (``quantized_min_eig_map`` of bfloat16 gradients,
    models/device_sequence.py:45) of the port's stored gradients, in a
    subprocess with XLA's CPU threading pinned to one thread
    (tests/test_torch_select.py)."""
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(repo), os.environ.get("PYTHONPATH", "")]),
               XLA_FLAGS=" ".join([os.environ.get("XLA_FLAGS", ""),
                                   _XLA_FLAGS]).strip())
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "g.npz", Path(tmp) / "eig.npy"
        # bfloat16 values are exact in float32: the child rounds nothing
        np.savez(src, gx=gx.to(torch.float32).numpy(),
                 gy=gy.to(torch.float32).numpy())
        subprocess.run([sys.executable, "-c", _XLA_EIG, str(src), str(dst)],
                       env=env, check=True, timeout=600)
        return np.load(dst).astype(np.int64)


def test_refill_map_is_the_stored_gradients_map():
    """The device route's refill map (K3's, computed in K1's level-0 build)
    is K3's map of the stored bfloat16 gradients, upcast: equal to it, and
    within one step of JAX's map of the same gradients (the bar of
    tests/test_torch_select.py: one step, under 1e-3 of the pixels)."""
    cfg = config_from_jax(create_config()).replace(image_dtype=BF16)
    img = torch.tensor(make_textured_image(120, 160, seed=31),
                       dtype=torch.float32)
    pyr, eig = tpft.build_track_pyramids(img, cfg, with_eig=True)
    assert pyr.gradx[0].dtype == torch.bfloat16
    assert torch.equal(eig, min_eig_reference(pyr.gradx[0], pyr.grady[0],
                                              7, 7))
    ref = _xla_eig_pinned(pyr.gradx[0], pyr.grady[0])
    diff = np.abs(eig.numpy().astype(np.int64) - ref)
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, np.argwhere(diff)


def _track_scene():
    """tests/test_track.py:240's scene: 120x160, a (1.3, -0.8) px shift,
    64 seeded features."""
    img1 = make_textured_image(120, 160, seed=31)
    img2 = shift_image_bilinear(img1, 1.3, -0.8)
    rng = np.random.default_rng(0)
    jcfg = create_config()
    x = rng.uniform(jcfg.borderx + 2, 160 - jcfg.borderx - 3,
                    64).astype(np.float32)
    y = rng.uniform(jcfg.bordery + 2, 120 - jcfg.bordery - 3,
                    64).astype(np.float32)
    return img1, img2, x, y, np.ones(64, np.int32)


@pytest.mark.parametrize("guided", [False, True])
def test_track_features_pyramids_matches_jax(guided, monkeypatch):
    """K2's plain version on JAX's stored bfloat16 levels (carried over
    bit for bit) against JAX's XLA route and its Pallas K2 lane (interpret
    mode), with and without guided starts: statuses exact, positions
    within 1e-4 px."""
    img1, img2, x, y, val = _track_scene()
    jcfg = create_config().replace(image_dtype=BF16)
    jp1, jp2 = (_build(jnp.asarray(f, jnp.float32), jcfg)
                for f in (img1, img2))
    tp1, tp2 = _to_port(jp1), _to_port(jp2)
    for a, b in zip(_planes(jp1), _planes(tp1)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b))
    kw, tkw = {}, {}
    if guided:
        xi, yi = x + 1.0, y - 1.0
        kw = dict(x_init=jnp.asarray(xi), y_init=jnp.asarray(yi))
        tkw = dict(x_init=torch.as_tensor(xi), y_init=torch.as_tensor(yi))
    monkeypatch.delenv("PFT_PALLAS_LK", raising=False)
    want = [np.asarray(a) for a in jax_track(
        jp1, jp2, jnp.asarray(x), jnp.asarray(y), jnp.asarray(val), jcfg,
        **kw)]
    got = [a.numpy() for a in tpft.track_features_pyramids(
        tp1, tp2, torch.as_tensor(x), torch.as_tensor(y),
        torch.as_tensor(val), config_from_jax(jcfg), **tkw)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=POS_TOL)
    np.testing.assert_allclose(got[1], want[1], atol=POS_TOL)
    if not guided:
        monkeypatch.setenv("PFT_PALLAS_LK", "vec")
        vec = [np.asarray(a) for a in jax_track.__wrapped__(
            jp1, jp2, jnp.asarray(x), jnp.asarray(y), jnp.asarray(val),
            jcfg)]
        np.testing.assert_array_equal(got[2], vec[2])
        np.testing.assert_allclose(got[0], vec[0], atol=POS_TOL)
        np.testing.assert_allclose(got[1], vec[1], atol=POS_TOL)


def test_bf16_status_flips_equal_jax_exclusions():
    """tests/test_track.py:228's comparison on the port's own builds:
    bfloat16 against float32 storage flips no status (JAX's exclusion list
    is empty), positions of lanes tracked in both within 0.1 px."""
    img1, img2, x, y, val = _track_scene()
    out = {}
    for dt in ("float32", BF16):
        cfg = tpft.create_config(image_dtype=dt)
        p1, p2 = (tpft.build_track_pyramids(torch.as_tensor(f, dtype=
                                                            torch.float32),
                                            cfg) for f in (img1, img2))
        out[dt] = [a.numpy() for a in tpft.track_features_pyramids(
            p1, p2, torch.as_tensor(x), torch.as_tensor(y),
            torch.as_tensor(val), cfg)]
    v32, v16 = out["float32"][2], out[BF16][2]
    assert np.where(v32 != v16)[0].tolist() == []
    both = (v32 == 0) & (v16 == 0)
    assert both.sum() >= 32
    for k in (0, 1):
        np.testing.assert_allclose(out[BF16][k][both],
                                   out["float32"][k][both], atol=0.1)


def test_track_sequence_device_matches_jax():
    """The device route with refill, bfloat16 storage (the map from K1's
    level-0 build of the stored gradients): 9 rolling 120x160 frames, 64
    features: vals equal and positions within 1e-4 px of JAX's; the chain
    of 3 equal to the steps bit for bit."""
    base = make_textured_image(120, 160, seed=29)
    frames = [np.roll(base, 4 * i, axis=1) for i in range(9)]
    jcfg = create_config(mindist=8).replace(image_dtype=BF16)
    cfg = config_from_jax(jcfg)
    want = [np.asarray(a) for a in jax_track_sequence_device(
        frames, cfg=jcfg, n_features=64)]
    got = tpft.track_sequence_device(frames, cfg=cfg, n_features=64,
                                     device="cpu")
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=POS_TOL)
    np.testing.assert_allclose(got[1], want[1], atol=POS_TOL)
    assert (got[2][1:] > 0).any()          # refills fired
    chained = tpft.track_sequence_device(frames, cfg=cfg, n_features=64,
                                         chain=3, device="cpu")
    for a, b in zip(chained, got):
        np.testing.assert_array_equal(a, b)


# (step, lane) of the config-3 steps over 1e-4 px: "new-frame rounding". The
# step builds the new frame's pyramid itself, and its stored levels differ
# from JAX's by one bfloat16 step at 100-148 elements a frame (where the two
# float32 builds round apart: test_stored_levels_are_the_float32_build_
# rounded); a tap one step apart (0.5 at 128) moves the lane by 1.2e-4 px.
# Held within 1e-3 px.
LISTED_CONFIG3 = {(4, 84)}


def test_config3_steps_from_jax_state():
    """Config 3 (affine mode 2, 3 levels, subsampling 2) with bfloat16
    storage: every port step started from JAX's own state (its stored
    bfloat16 pyramids carried over bit for bit, features, AffineState)
    gives JAX's step: vals equal, positions and warps within 1e-4 px (the
    bar of tests/test_torch_tracker.py's float32 test) but the listed
    lanes."""
    from test_torch_tracker import _frames
    frames = _frames(6)
    jcfg = create_config(affineConsistencyCheck=2, nPyramidLevels=3,
                         subsampling=2).replace(sequentialMode=True,
                                                image_dtype=BF16)
    cfg = config_from_jax(jcfg)
    pyr, x, y, v, aff, _ = jax_select_step(jnp.asarray(frames[0]), jcfg, 100)
    for step, f in enumerate(frames[1:], start=1):
        tpyr = _to_port(pyr)
        assert tpyr.img[0].dtype == torch.bfloat16
        taff = affine_state_from_numpy(*(np.asarray(a) for a in aff),
                                       device="cpu")
        _, tx, ty, tv, taff, _, _ = tpft.sequence_step_device(
            tpyr, f, *features_from_numpy(x, y, v, device="cpu"), cfg, True,
            aff=taff)
        pyr, x, y, v, aff, _, _ = jax_sequence_step(
            pyr, jnp.asarray(f), x, y, v, jcfg, True, aff=aff)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
        d = np.maximum(np.abs(tx.numpy() - np.asarray(x)),
                       np.abs(ty.numpy() - np.asarray(y)))
        over = {(step, int(k)) for k in np.where(d > POS_TOL)[0]}
        assert over <= LISTED_CONFIG3, sorted(over - LISTED_CONFIG3)
        assert d.max() <= 1e-3
        np.testing.assert_allclose(taff.A.numpy(), np.asarray(aff.A),
                                   atol=POS_TOL)


def _flow_pair(h=64, w=96, seed=14):
    from test_torch_flow import _pair
    return _pair(h, w, seed)


# Pixels over 1e-4 px against JAX, (row, col): status. All are lanes that
# never converge (LARGE_RESIDUE -5, MAX_ITERATIONS -3): XLA's CPU FMAs
# against the port's separately rounded products drift over their
# iterations (ROADMAP.md Queue 3), within 2e-3 px.
LISTED_FLOW = {(13, 4): -5, (57, 34): -3, (59, 90): -5}
LISTED_DISPARITY = {(32, 4): -5, (37, 3): -5, (43, 154): -5, (77, 5): -5}


def _check_listed(diff, status, listed):
    over = {(int(r), int(c)) for r, c in np.argwhere(diff > POS_TOL)}
    assert over == set(listed), sorted(over)
    for p, st in listed.items():
        assert int(status[p]) == st and diff[p] <= DENSE_TOL, (p, diff[p])


def test_dense_flow_and_depth_match_jax():
    """compute_dense_flow's levels and dense_depth's (each level read
    from bfloat16 storage, upcast at the tap) on JAX's stored pyramids:
    statuses exact, u, v and d within 1e-4 px but the listed pixels; the
    whole entries from images: statuses and the depth's valid mask
    exact."""
    jcfg = create_config().replace(image_dtype=BF16).validated_window()
    cfg = config_from_jax(jcfg)
    a, b = _flow_pair()
    jp = (_build(jnp.asarray(a), jcfg), _build(jnp.asarray(b), jcfg))
    jf = jax.jit(jflow.dense_flow_pyramids, static_argnames=("cfg",))(
        *jp, jcfg)
    tf = tflow.dense_flow_pyramids(*(_to_port(p) for p in jp), cfg)
    st = tf.status.numpy()
    np.testing.assert_array_equal(st, np.asarray(jf.status))
    diff = np.maximum(np.abs(tf.u.numpy() - np.asarray(jf.u)),
                      np.abs(tf.v.numpy() - np.asarray(jf.v)))
    _check_listed(diff, st, LISTED_FLOW)
    jf2 = jflow.compute_dense_flow(a, b, jcfg)
    tf2 = tflow.compute_dense_flow(a, b, cfg, device="cpu")
    np.testing.assert_array_equal(tf2.status.numpy(), np.asarray(jf2.status))

    tex = make_textured_image(96, 180, seed=9)
    left, right = tex[:, :160], tex[:, 8:168]
    jpl = (_build(jnp.asarray(left, jnp.float32), jcfg),
           _build(jnp.asarray(right, jnp.float32), jcfg))
    jd = jax.jit(jdisp.dense_disparity_pyramids,
                 static_argnames=("cfg", "max_disparity"))(
        *jpl, jcfg, max_disparity=16.0)
    td = tdisp.dense_disparity_pyramids(*(_to_port(p) for p in jpl), cfg,
                                        max_disparity=16.0)
    st = td.status.numpy()
    np.testing.assert_array_equal(st, np.asarray(jd.status))
    _check_listed(np.abs(td.d.numpy() - np.asarray(jd.d)), st,
                  LISTED_DISPARITY)
    K = np.array([[100.0, 0, 80], [0, 100.0, 48], [0, 0, 1]])
    _, _, jv = jdisp.dense_depth(left, right, K, baseline=0.5, cfg=jcfg,
                                 max_disparity=16.0)
    dep, _, tv = tdisp.dense_depth(left, right, K, baseline=0.5, cfg=cfg,
                                   max_disparity=16.0, device="cpu")
    np.testing.assert_array_equal(tv, np.asarray(jv))
    assert abs(np.median(dep[tv]) - 100.0 * 0.5 / 8.0) < 0.1


def test_sequence_resumes_from_jax_bf16_state():
    """A JAX SequenceTracker with bfloat16 storage after 3 frames, resumed
    by the port from JAX's state dict (its bfloat16 pyramid cache carried
    over bit for bit: ml_dtypes' bfloat16 through a uint16 view) and run on:
    vals equal, positions within 1e-4 px of JAX's uninterrupted run."""
    base = make_textured_image(96, 128, seed=55)
    frames = [shift_image_bilinear(base, 0.7 * i, 0.4 * i) for i in range(6)]
    jcfg = create_config().replace(image_dtype=BF16)
    jt = JaxSeq(cfg=jcfg, n_features=25)
    for f in frames[:3]:
        jt.step(f)
    state = jckpt.sequence_state(jt)
    port = SequenceTracker(cfg=config_from_jax(jcfg), n_features=25,
                           device="cpu")
    resume_sequence(port, state)
    for a, b in zip(_planes(state["cache"]), _planes(port._cache)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for f in frames[3:]:
        jt.step(f)
        port.step(f)
        np.testing.assert_array_equal(port.fl.val.numpy(),
                                      np.asarray(jt.fl.val))
        live = np.asarray(jt.fl.val) >= 0
        for t, j in ((port.fl.x, jt.fl.x), (port.fl.y, jt.fl.y)):
            np.testing.assert_allclose(t.numpy()[live], np.asarray(j)[live],
                                       atol=POS_TOL)


def test_window_terms_refuse_bf16_levels():
    """K9 stays float32: its entry refuses bfloat16 levels on either
    device with NotImplementedError (no path runs it; ROADMAP.md lists
    the port of bfloat16 to K9 as left)."""
    from pyfeaturetrack_tpu_torch.ops.cuda_window_terms import window_terms
    img = torch.zeros((32, 32), dtype=torch.bfloat16)
    win = torch.zeros((2, 7, 7))
    pos = torch.full((2,), 10.0)
    with pytest.raises(NotImplementedError, match="K9"):
        window_terms(img, img, img, win, win, win, pos, pos, hw=3, hh=3,
                     step_factor=1.0)


@pytest.mark.parametrize("refine", [False, True])
def test_host_loop_matches_jax(refine):
    """track_sequence (the KLT facade's SequenceTracker, K5 selections)
    with bfloat16 storage on 6 bundled frames, 100 features, with and
    without sub-pixel refinement (float32 gradients of its own, as
    JAX's): vals exact; positions within 1e-4 px, or, refined, within
    1e-3 px with every entry over 1e-4 px on a lane that already differed
    by over 5e-5 px at its last (re)selection (the refinement's class,
    tests/test_torch_refine.py)."""
    from pyfeaturetrack_tpu.models.sequence import track_sequence as jseq
    from test_torch_tracker import _frames
    frames = _frames(6)
    jcfg = create_config().replace(image_dtype=BF16)
    jft, _ = jseq(frames, cfg=jcfg, n_features=100, subpixel_refine=refine)
    tft, _ = tpft.track_sequence(frames, cfg=config_from_jax(jcfg),
                                 n_features=100, subpixel_refine=refine,
                                 device="cpu")
    jx, jy, jv = (np.asarray(a) for a in jft)
    tx, ty, tv = (a.numpy() for a in tft)
    np.testing.assert_array_equal(tv, jv)
    d = np.maximum(np.abs(tx - jx), np.abs(ty - jy))
    assert d.max() <= (1e-3 if refine else POS_TOL)
    selected = jv > 0
    selected[0] = jv[0] >= 0
    for f, i in np.argwhere(d > POS_TOL):
        s = max(k for k in range(f + 1) if selected[k, i])
        assert d[s, i] > 5e-5, (f, i, s, d[s, i], d[f, i])


def test_serving_and_chunks_carry_the_storage():
    """serve_stream (chain 2, uint8 staging) and the lockstep chunks run
    the bfloat16 step: equal to track_sequence_device's chain, and the
    chained lockstep chunks to the step-by-step ones, bit for bit."""
    from pyfeaturetrack_tpu_torch.models.chunked import (
        track_sequence_chunked)
    cfg = tpft.create_config(image_dtype=BF16)
    base = make_textured_image(64, 96, seed=7)
    frames = [np.clip(np.roll(base, (i, -i), axis=(0, 1)), 0, 255).astype(
        np.uint8) for i in range(5)]
    served = tpft.serve_stream(frames, cfg=cfg, n_features=20, chain=2,
                               stage_uint8=True, device="cpu")
    device = tpft.track_sequence_device(frames, cfg=cfg, n_features=20,
                                        chain=2, device="cpu")
    for a, b in zip(served, device):
        np.testing.assert_array_equal(a, b)
    lock = track_sequence_chunked(frames, cfg=cfg, n_features=20,
                                  n_chunks=2, batched=True, chain=2,
                                  device="cpu")
    serial = track_sequence_chunked(frames, cfg=cfg, n_features=20,
                                    n_chunks=2, batched=True, device="cpu")
    for k in ("x", "y", "val"):
        np.testing.assert_array_equal(np.asarray(lock[0][k]),
                                      np.asarray(serial[0][k]))
