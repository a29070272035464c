"""The port's op-level names against the JAX package's, on the CPU (each
name's plain version): ``ops.pyramid`` (compute_pyramid,
compute_gradient_pyramids), ``ops.track.track_feature_level`` (K2's
per-level launch), ``ops.select`` (quantized_min_eig_map: K3's standalone
launch; selection_eig_map_core: K1's eig-only level 0),
``ops.select_device`` (select_features_device / replace_lost_device: K4;
suppress_and_fill: K5; fill_slots) and ``ops.interp`` (gather_patch,
gather_window_fast). Inputs are made from seeds with numpy."""

import json
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

from conftest import make_textured_image
from test_torch_pyramid import TOL
from test_torch_track import POS_TOL, SCENARIOS, _setup

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops import interp as jinterp
from pyfeaturetrack_tpu.ops import pyramid as jpyramid
from pyfeaturetrack_tpu.ops import select_device as jsd
from pyfeaturetrack_tpu.ops import track as jtrack

import pyfeaturetrack_tpu_torch.ops as tops
from pyfeaturetrack_tpu_torch.ops import (cuda_eig, cuda_lk, cuda_pyramid,
                                          cuda_select, cuda_suppress)
from pyfeaturetrack_tpu_torch.ops import select as tselect
from pyfeaturetrack_tpu_torch.ops import select_device as tsd
from pyfeaturetrack_tpu_torch.ops.convolve import (compute_gradients,
                                                   compute_smoothed_image)
from pyfeaturetrack_tpu_torch.ops.interp import (gather_patch, gather_window,
                                                 gather_window_fast,
                                                 gather_windows)
from pyfeaturetrack_tpu_torch.ops.pyramid import (Pyramid,
                                                  compute_gradient_pyramids,
                                                  compute_pyramid, decimate)
from pyfeaturetrack_tpu_torch.ops.track import track_feature_level
from pyfeaturetrack_tpu_torch.utils.convert import config_from_jax
from pyfeaturetrack_tpu_torch.utils.io import pgm_read

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _launches():
    return (cuda_pyramid.launches, cuda_lk.launches, cuda_eig.launches,
            cuda_select.launches, cuda_suppress.launches)


# ---- ops.pyramid ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(120, 160), (97, 130)])
@pytest.mark.parametrize("sub,nlevels", [(2, 1), (2, 4), (4, 2), (4, 3)])
def test_pyramid_matches_jax(shape, sub, nlevels):
    """compute_pyramid and compute_gradient_pyramids against the JAX
    package's (XLA convolutions): every level within test_torch_pyramid's
    TOL (1e-3 on the 0..255 scale); level 0 is the input itself."""
    img = make_textured_image(*shape, seed=sub + nlevels).astype(np.float32)
    jp = jpyramid.compute_pyramid(jnp.asarray(img), sub, nlevels, 0.9)
    jgx, jgy = jpyramid.compute_gradient_pyramids(jp, 1.0)
    t = torch.tensor(img)
    before = _launches()
    tp = compute_pyramid(t, sub, nlevels, 0.9)
    tgx, tgy = compute_gradient_pyramids(tp, 1.0)
    assert _launches() == before          # CPU tensors: the plain versions
    assert tp.levels[0] is t and tp.nLevels == nlevels
    assert tp.subsampling == sub and tgx.subsampling == sub
    for want, got in ((jp, tp), (jgx, tgx), (jgy, tgy)):
        assert len(got.levels) == nlevels
        for lv, (a, b) in enumerate(zip(want.levels, got.levels)):
            a = np.asarray(a, np.float32)
            assert a.shape == tuple(b.shape), lv
            assert np.abs(a - b.numpy()).max() <= TOL, lv


def test_pyramid_is_the_plain_composition():
    """On the CPU each level is compute_smoothed_image + decimate of the
    level above and each gradient pair compute_gradients, bit for bit."""
    img = torch.tensor(make_textured_image(90, 124, seed=3),
                       dtype=torch.float32)
    pyr = compute_pyramid(img, 2, 3, 0.9)
    gx, gy = compute_gradient_pyramids(pyr, 1.3)
    cur = img
    for lv in range(3):
        assert torch.equal(pyr.levels[lv], cur)
        a, b = compute_gradients(cur, 1.3)
        assert torch.equal(gx.levels[lv], a) and torch.equal(gy.levels[lv], b)
        cur = decimate(compute_smoothed_image(cur, 2 * 0.9), 2)
    assert isinstance(pyr, Pyramid) and isinstance(tops.Pyramid(
        pyr.levels, 2), tuple)


# ---- ops.track.track_feature_level ----------------------------------------

def _bf16_setup(name):
    """A scenario on bfloat16-stored levels (cfg.image_dtype): JAX's
    build casts its levels; the port takes the same values as bfloat16."""
    jcfg, cfg, jp1, jp2, tp1, tp2, feats = _setup(name)
    jcfg = jcfg.replace(image_dtype="bfloat16")
    cast = lambda p: type(p)(*(tuple(a.astype(jnp.bfloat16) for a in lv)  # noqa: E731
                               for lv in p))
    jp1, jp2 = cast(jp1), cast(jp2)
    tcast = lambda p: type(p)(*(tuple(torch.tensor(  # noqa: E731
        np.asarray(a, np.float32)).to(torch.bfloat16) for a in lv)
        for lv in p))
    return jcfg, config_from_jax(jcfg), jp1, jp2, tcast(jp1), tcast(jp2), \
        feats


CASES = SCENARIOS + ["edge", "shift@bf16", "gain_bias_li@bf16",
                     "noisy_shift@bf16"]
# "edge": the shifted pair with windows that leave the image (OOB at once,
# and after a step toward the edge)
EDGE = np.array([[2.0, 50.0, 1.0], [126.5, 40.0, 1.0], [60.0, 1.5, 1.0],
                 [4.2, 93.0, 1.0], [123.2, 4.1, 1.0]])


def _levels(name):
    """Every level of the coarse-to-fine walk from the same inputs, run
    through JAX's track_feature_level and the port's: per level the
    (jax, port) outputs."""
    setup = _bf16_setup if name.endswith("@bf16") else _setup
    jcfg, cfg, jp1, jp2, tp1, tp2, feats = setup(
        "shift" if name == "edge" else name.split("@")[0])
    if name == "edge":
        feats = EDGE
    s = np.float32(jcfg.subsampling)
    x = np.asarray(feats[:, 0], np.float32)
    y = np.asarray(feats[:, 1], np.float32)
    active = feats[:, 2] >= 0
    scale = np.float32(float(jcfg.subsampling) ** jcfg.nPyramidLevels)
    xloc, yloc = x / scale, y / scale
    out = []
    for r in range(jcfg.nPyramidLevels - 1, -1, -1):
        xloc, yloc = xloc * s, yloc * s
        want = jax.jit(jtrack.track_feature_level, static_argnames=("cfg",))(
            *(jnp.asarray(a) for a in (xloc, yloc, xloc, yloc)),
            jp1.img[r], jp1.gradx[r], jp1.grady[r],
            jp2.img[r], jp2.gradx[r], jp2.grady[r], jcfg,
            jnp.asarray(active))
        got = track_feature_level(
            *(torch.tensor(a) for a in (xloc, yloc, xloc, yloc)),
            tp1.img[r], tp1.gradx[r], tp1.grady[r],
            tp2.img[r], tp2.gradx[r], tp2.grady[r], cfg,
            torch.tensor(active))
        out.append(([np.asarray(a) for a in want],
                    [a.numpy() for a in got]))
    return out


@pytest.mark.parametrize("name", CASES)
def test_track_feature_level_matches_jax(name):
    """Statuses and iteration counts bit-equal, positions within 1e-4 px
    (tests/test_track.py:53's bar), at every level, on the default,
    lighting-insensitive and bfloat16-level configs."""
    before = _launches()
    for (jx, jy, js, ji), (tx, ty, ts, ti) in _levels(name):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tx, jx, atol=POS_TOL, rtol=0)
        np.testing.assert_allclose(ty, jy, atol=POS_TOL, rtol=0)
    assert _launches() == before


def test_track_feature_level_reaches_every_status():
    """The cases above return every status track_feature_level can give."""
    seen = set()
    for name in CASES:
        for _, (_, _, ts, _) in _levels(name):
            seen.update(int(v) for v in ts)
    assert seen == {0, -2, -3, -4, -5}, seen


def test_track_feature_level_is_k2_level_and_jit_alias():
    assert tops.track_feature_level is track_feature_level
    from pyfeaturetrack_tpu_torch.ops.track import (build_track_pyramids,
                                                    build_track_pyramids_jit)
    cfg = config_from_jax(create_config())
    img = torch.tensor(make_textured_image(64, 80, seed=2),
                       dtype=torch.float32)
    for a, b in zip(build_track_pyramids_jit(img, cfg),
                    build_track_pyramids(img, cfg)):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


# ---- ops.select: the eig maps, held to JAX in a pinned subprocess ---------

# JAX's maps and device selections of every case below, computed once in a
# subprocess with XLA's CPU threading pinned to one thread (as
# tests/test_torch_select.py does: under load the multi-threaded XLA
# reference rounded some rows differently from run to run).
_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")
_JAX_SCRIPT = """
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops.select import (quantized_min_eig_map,
                                           selection_eig_map_core)
from pyfeaturetrack_tpu.ops.select_device import (replace_lost_device,
                                                  select_features_device)
data = np.load(sys.argv[1])
spec = json.loads(open(sys.argv[2]).read())
eig = jax.jit(quantized_min_eig_map, static_argnums=(2, 3))
core = jax.jit(selection_eig_map_core, static_argnames=(
    "window_width", "window_height", "smooth_before", "smooth_sigma",
    "grad_sigma"))
initial = jax.jit(select_features_device, static_argnames=(
    "cfg", "replacing", "top_k"))
out = {}
for name, c in spec.items():
    if c["kind"] == "eig":
        out[name] = np.asarray(eig(jnp.asarray(data[name + "_gx"]),
                                   jnp.asarray(data[name + "_gy"]),
                                   *c["win"]))
    elif c["kind"] == "core":
        out[name] = np.asarray(core(jnp.asarray(data[name + "_img"]),
                                    **c["args"]))
    else:
        cfg = create_config(**c["cfg"])
        fn = replace_lost_device if c["replacing"] else initial
        res = fn(jnp.asarray(data[name + "_img"]),
                 *(jnp.asarray(data[name + k]) for k in ("_x", "_y", "_v")),
                 cfg, replacing=c["replacing"])
        for k, a in zip(("x", "y", "val", "filled", "exhausted"), res):
            out[name + "_" + k] = np.asarray(a)
np.savez(sys.argv[3], **out)
"""

EIG_CASES = [((120, 160), (7, 7)), ((120, 160), (5, 9)),
             ((97, 130), (7, 7)), ((97, 130), (3, 3))]
CORE_CASES = [((120, 160), (7, 7), True), ((120, 160), (7, 7), False),
              ((97, 130), (5, 9), True), ((97, 130), (3, 3), False)]


def _eig_name(shape, win):
    return f"eig_{shape[0]}_{shape[1]}_{win[0]}_{win[1]}"


def _core_name(shape, win, smooth):
    return f"core_{shape[0]}_{shape[1]}_{win[0]}_{win[1]}_{int(smooth)}"


def _eig_gradients(shape, win):
    """The case's gradients, made by the port's plain passes (numpy-made
    image): both sides read the same float32 arrays."""
    img = torch.tensor(make_textured_image(*shape, seed=shape[0] + win[1]),
                       dtype=torch.float32)
    return compute_gradients(img, 1.0)


def _core_image(shape, win, smooth):
    return make_textured_image(*shape, seed=shape[1] + win[0]
                               + int(smooth)).astype(np.float32)


def _core_args(win, smooth):
    jcfg = create_config(window_width=win[0], window_height=win[1])
    return dict(window_width=win[0], window_height=win[1],
                smooth_before=smooth, smooth_sigma=float(jcfg.smooth_sigma),
                grad_sigma=float(jcfg.grad_sigma))


def _frame(i):
    return pgm_read(REPO / "examples" / "data" / f"img{i}.pgm").astype(
        np.float32)


def _crowded():
    """A small, crowded frame: more slots than the lattice can seat."""
    return make_textured_image(56, 72, seed=17).astype(np.float32)


# (name, image, cfg overrides, replacing, n): the bundled frames (initial
# and a refill with lanes lost), the crowded frame (initial and refill)
def _select_cases():
    cases = []
    for tag, img, over, n in (("bundled", _frame(0), {}, 100),
                              ("bundled7", _frame(7), {"mindist": 6}, 150),
                              ("crowded", _crowded(), {"mindist": 3}, 120)):
        cases.append((f"sel_{tag}_init", img, over, False, n, None))
        cases.append((f"sel_{tag}_refill", img, over, True, n, tag))
    return cases


def _select_inputs(img, over, replacing, n, tag):
    """The (x, y, val) slots a case selects into: all free, or the port's
    initial selection on the next frame with every fourth lane lost."""
    if not replacing:
        return (np.full(n, -1.0, np.float32), np.full(n, -1.0, np.float32),
                np.full(n, -1, np.int32))
    cfg = config_from_jax(create_config(**over))
    prev = _frame(1) if tag.startswith("bundled") else np.roll(img, 3, 1)
    x, y, v, _, _ = tsd.select_features_device(
        torch.tensor(prev), torch.full((n,), -1.0), torch.full((n,), -1.0),
        torch.full((n,), -1, dtype=torch.int32), cfg, replacing=False)
    v = v.clone()
    v[::4] = -1
    return x.numpy(), y.numpy(), v.numpy()


_jax_refs: dict = {}


def _jax_ref(name):
    if not _jax_refs:
        arrays, spec = {}, {}
        for shape, win in EIG_CASES:
            gx, gy = _eig_gradients(shape, win)
            arrays[_eig_name(shape, win) + "_gx"] = gx.numpy()
            arrays[_eig_name(shape, win) + "_gy"] = gy.numpy()
            spec[_eig_name(shape, win)] = {"kind": "eig", "win": list(win)}
        for shape, win, smooth in CORE_CASES:
            key = _core_name(shape, win, smooth)
            arrays[key + "_img"] = _core_image(shape, win, smooth)
            spec[key] = {"kind": "core", "args": _core_args(win, smooth)}
        for key, img, over, replacing, n, tag in _select_cases():
            arrays[key + "_img"] = img
            for k, a in zip(("_x", "_y", "_v"),
                            _select_inputs(img, over, replacing, n, tag)):
                arrays[key + k] = a
            spec[key] = {"kind": "select", "cfg": over,
                         "replacing": replacing}
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO), os.environ.get("PYTHONPATH", "")]),
                   XLA_FLAGS=" ".join(
                       [os.environ.get("XLA_FLAGS", ""), _XLA_FLAGS]).strip())
        with tempfile.TemporaryDirectory() as tmp:
            src, dst = Path(tmp) / "in.npz", Path(tmp) / "out.npz"
            sp = Path(tmp) / "spec.json"
            np.savez(src, **arrays)
            sp.write_text(json.dumps(spec))
            subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(src),
                            str(sp), str(dst)], env=env, check=True,
                           timeout=900)
            with np.load(dst) as out:
                _jax_refs.update({k: out[k] for k in out.files})
    return _jax_refs[name]


# Pixels where the port's quantized map and JAX's (XLA) differ, each by one
# int step, port minus JAX (measured; ROADMAP Queue 3, "Eig-map
# quantization"): the window sums of the same float32 products round
# differently in XLA's convolution than in the port's (and K3's) ascending
# shift-and-add; selection_eig_map_core's maps also start from XLA's
# gradient convolutions against the port's (within 4.6e-5, TOL's note).
LISTED_EIG = {
    "eig_120_160_7_7": {},
    "eig_120_160_5_9": {(7, 26): 1, (74, 30): -1, (99, 97): -1},
    "eig_97_130_7_7": {(89, 37): 1},
    "eig_97_130_3_3": {},
    "core_120_160_7_7_1": {(5, 78): -1, (11, 61): -1, (15, 21): -1,
                           (19, 122): -1, (25, 134): 1, (27, 32): -1,
                           (29, 126): 1, (49, 91): 1, (61, 56): 1,
                           (74, 155): -1, (84, 8): -1},
    "core_120_160_7_7_0": {(5, 84): -1, (16, 56): -1, (46, 35): 1,
                           (59, 55): 1, (91, 45): 1, (111, 107): -1,
                           (111, 113): 1},
    "core_97_130_5_9_1": {(40, 113): 1},
    "core_97_130_3_3_0": {(83, 47): 1},
}


def _held_to_listed(name, got, want):
    """Equal but at listed pixels, each off by its listed step."""
    diff = got.astype(np.int64) - want.astype(np.int64)
    off = {tuple(int(v) for v in p): int(diff[tuple(p)])
           for p in np.argwhere(diff != 0)}
    assert off.items() <= LISTED_EIG[name].items(), (name, off)


@pytest.mark.parametrize("shape,win", EIG_CASES)
def test_quantized_min_eig_map_matches_jax(shape, win):
    """K3's standalone entry (plain version here) == JAX's
    quantized_min_eig_map of the same gradients, but for the listed
    pixels; bfloat16 gradients are upcast as JAX's are."""
    gx, gy = _eig_gradients(shape, win)
    before = _launches()
    got = tselect.quantized_min_eig_map(gx, gy, *win)
    assert _launches() == before and got.dtype == torch.int32
    name = _eig_name(shape, win)
    _held_to_listed(name, got.numpy(), _jax_ref(name))
    bf = tselect.quantized_min_eig_map(gx.to(torch.bfloat16),
                                       gy.to(torch.bfloat16), *win)
    assert torch.equal(bf, cuda_eig.min_eig_reference(
        gx.to(torch.bfloat16).float(), gy.to(torch.bfloat16).float(), *win))


@pytest.mark.parametrize("shape,win,smooth", CORE_CASES)
def test_selection_eig_map_core_matches_jax(shape, win, smooth):
    """K1's eig-only level 0 (plain version here) == JAX's
    selection_eig_map_core of the same image, but for the listed pixels;
    and == the port's own map through its pyramid (selection_eig_map)."""
    img = _core_image(shape, win, smooth)
    before = _launches()
    got = tselect.selection_eig_map_core(torch.tensor(img),
                                         **_core_args(win, smooth))
    assert _launches() == before
    name = _core_name(shape, win, smooth)
    _held_to_listed(name, got.numpy(), _jax_ref(name))
    cfg = config_from_jax(create_config(window_width=win[0],
                                        window_height=win[1],
                                        smoothBeforeSelecting=smooth))
    assert torch.equal(got, tselect.selection_eig_map(torch.tensor(img),
                                                      cfg))


# ---- ops.select_device ----------------------------------------------------

@pytest.mark.parametrize("case", [c[0] for c in _select_cases()])
def test_select_features_device_matches_jax(case):
    """(x, y, val, filled) bit-equal to JAX's select_features_device /
    replace_lost_device on the bundled frames and a crowded small frame;
    the port's ``exhausted`` is always False (its extraction scans every
    candidate)."""
    name, img, over, replacing, n, tag = next(
        c for c in _select_cases() if c[0] == case)
    cfg = config_from_jax(create_config(**over))
    fn = tsd.replace_lost_device if replacing else tsd.select_features_device
    slots = [torch.tensor(a) for a in _select_inputs(img, over, replacing, n,
                                                     tag)]
    before = _launches()
    got = fn(torch.tensor(img), *slots, cfg, replacing=replacing)
    assert _launches() == before
    for k, g in zip(("x", "y", "val", "filled"), got[:4]):
        np.testing.assert_array_equal(g.numpy(), _jax_ref(f"{name}_{k}"))
    assert not bool(got[4])
    filled = got[3].numpy()
    if case.startswith("sel_crowded"):
        assert not filled[slots[2].numpy() < 0].all()   # the pool ran dry
    else:
        assert filled[slots[2].numpy() < 0].all() or not replacing


def test_replace_lost_device_is_select_features_device():
    assert tsd.replace_lost_device is tsd.select_features_device


def _candidates(seed, k, shape, valid_frac=0.8):
    rng = np.random.default_rng(seed)
    h, w = shape
    cx = rng.integers(0, w, k).astype(np.int32)
    cy = rng.integers(0, h, k).astype(np.int32)
    cval = np.sort(rng.integers(1, 1 << 20, k))[::-1].astype(np.int32)
    valid = rng.uniform(size=k) < valid_frac
    return cx, cy, cval, valid


def _slots(seed, n, shape, free_frac):
    rng = np.random.default_rng(seed + 1)
    h, w = shape
    x = rng.uniform(0, w, n).astype(np.float32)
    y = rng.uniform(0, h, n).astype(np.float32)
    val = np.where(rng.uniform(size=n) < free_frac, -1,
                   rng.integers(0, 999, n)).astype(np.int32)
    return x, y, val, val < 0


# (seed, K, slots, mindist, valid fraction, free fraction): budgets met,
# every candidate masked, pools that run dry (exhausted), mindist 0 and 1
SUPPRESS_CASES = [(0, 300, 80, 10, 0.8, 0.6), (1, 500, 40, 5, 0.5, 1.0),
                  (2, 60, 120, 8, 0.9, 0.9), (3, 200, 50, 0, 0.7, 0.5),
                  (4, 200, 50, 1, 0.7, 0.5), (5, 100, 30, 12, 0.0, 1.0),
                  (6, 400, 64, 25, 1.0, 1.0)]


@pytest.mark.parametrize("seed,k,n,mindist,vfrac,ffrac", SUPPRESS_CASES)
def test_suppress_and_fill_matches_jax(seed, k, n, mindist, vfrac, ffrac):
    """K5's scan (plain version here) + the fill == JAX's MIS fixpoint +
    fill, all five outputs bit-equal: valid-masked candidates, exhausted
    pools, budgets met early, mindist 0 and 1."""
    shape = (160, 256)
    cx, cy, cval, valid = _candidates(seed, k, shape, vfrac)
    x, y, val, free = _slots(seed, n, shape, ffrac)
    want = jsd.suppress_and_fill(*(jnp.asarray(a) for a in (
        cx, cy, cval, valid, free, x, y, val)), mindist)
    args = [torch.tensor(a) for a in (cx, cy, cval, valid, free, x, y, val)]
    before = _launches()
    got = tsd.suppress_and_fill(*args, mindist)
    assert _launches() == before
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_suppress_and_fill_candidates_off_the_origin():
    """The valid candidates' bounding box is K5's frame, so negative and
    far coordinates are accepted as JAX's fixpoint accepts them."""
    cx = np.array([-40, -38, 5000, 5003, -40, 7], np.int32)
    cy = np.array([-9, -9, 20, 24, -2, 7], np.int32)
    cval = np.arange(6, 0, -1).astype(np.int32)
    valid = np.array([True, True, True, True, True, False])
    x = np.zeros(5, np.float32)
    val = np.full(5, -1, np.int32)
    want = jsd.suppress_and_fill(*(jnp.asarray(a) for a in (
        cx, cy, cval, valid, val < 0, x, x, val)), 4)
    got = tsd.suppress_and_fill(*(torch.tensor(a) for a in (
        cx, cy, cval, valid, val < 0, x, x, val)), 4)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[2].tolist() == [6, 4, 3, 2, -1] and bool(got[4])


@pytest.mark.parametrize("seed,k,n", [(0, 50, 20), (1, 10, 30), (2, 64, 64),
                                      (3, 1, 5)])
def test_fill_slots_matches_jax(seed, k, n):
    rng = np.random.default_rng(seed)
    cx, cy, cval, _ = _candidates(seed, k, (100, 120))
    accepted = rng.uniform(size=k) < 0.4
    x, y, val, free = _slots(seed, n, (100, 120), 0.7)
    want = jsd.fill_slots(*(jnp.asarray(a) for a in (
        accepted, cx, cy, cval, free, x, y, val)))
    got = tsd.fill_slots(*(torch.tensor(a) for a in (
        accepted, cx, cy, cval, free, x, y, val)))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_empty_candidate_lists():
    x = torch.zeros(3)
    val = torch.tensor([-1, 5, -1], dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    for out in (tsd.suppress_and_fill(empty, empty, empty,
                                      torch.zeros(0, dtype=torch.bool),
                                      val < 0, x, x, val, 4),
                tsd.fill_slots(torch.zeros(0, dtype=torch.bool), empty,
                               empty, empty, val < 0, x, x, val)):
        assert out[2].tolist() == [-1, 5, -1] and not out[3].any()
        assert out[0].tolist() == [-1.0, 0.0, -1.0] and bool(out[4])


# ---- ops.interp -----------------------------------------------------------

def _crosses_binade(v, h):
    """Lanes whose window [v - h, v + h] spans a power of two: there the
    per-tap fraction of (v + i) rounds differently from v's own."""
    lo, hi = np.floor(np.log2(v - h)), np.floor(np.log2(v + h))
    return lo != hi


@pytest.mark.parametrize("hw,hh", [(3, 3), (2, 4), (6, 6)])
def test_gather_window_fast(hw, hh):
    """gather_window_fast == gather_patch + window_from_patch == the patch
    route K2's plain version takes (gather_windows), bit for bit; == the
    per-tap gather_window bit for bit on every lane whose window stays
    within one binade (elsewhere the fraction of x + i rounds once more,
    one float32 ulp of the position); within 1e-5 of JAX's (0..255)."""
    rng = np.random.default_rng(hw * 10 + hh)
    img = make_textured_image(200, 300, seed=hw).astype(np.float32)
    n = 1000
    x = rng.uniform(hw + 1.0, 300 - hw - 2.0, n).astype(np.float32)
    y = rng.uniform(hh + 1.0, 200 - hh - 2.0, n).astype(np.float32)
    ti, tx, ty = torch.tensor(img), torch.tensor(x), torch.tensor(y)
    got = gather_window_fast(ti, tx, ty, hw, hh)
    patch, ax, ay = gather_patch(ti, tx, ty, hw, hh)
    assert patch.shape == (n, 2 * hh + 2, 2 * hw + 2)
    assert torch.equal(got, gather_windows((ti,), tx, ty, hw, hh)[0])
    per_tap = gather_window(ti, tx, ty, hw, hh)
    differ = (got != per_tap).flatten(1).any(1).numpy()
    crossing = _crosses_binade(x, hw) | _crosses_binade(y, hh)
    assert not (differ & ~crossing).any()
    ulp = np.spacing(np.float32(512.0))          # largest coordinate ulp
    assert (got - per_tap).abs().max() <= 2 * 255 * ulp
    want = np.asarray(jinterp.gather_window_fast(
        jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), hw, hh))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    jp, jax_, jay = jinterp.gather_patch(jnp.asarray(img), jnp.asarray(x),
                                         jnp.asarray(y), hw, hh)
    np.testing.assert_array_equal(patch.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ax.numpy(), np.asarray(jax_))
    np.testing.assert_array_equal(ay.numpy(), np.asarray(jay))
