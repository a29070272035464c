"""Port selection vs the JAX package: the eig map (K3's plain version,
ops/cuda_eig.py) and the greedy extraction (K4's plain version,
ops/cuda_select.py) against the XLA path and the Pallas kernels (interpret
mode), and the port's one selection route (ops/select_device.py) against
JAX's select_features_from_eig_device fed the same int32 eig map."""

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

from pyfeaturetrack_tpu.config import create_config
from pyfeaturetrack_tpu.ops.convolve import compute_gradients
from pyfeaturetrack_tpu.ops.pallas_eig import min_eig_map_pallas
from pyfeaturetrack_tpu.ops.pallas_select import greedy_extract_pallas
from pyfeaturetrack_tpu.ops.select import (select_good_features_arrays,
                                           selection_eig_map_core)
from pyfeaturetrack_tpu.ops.select_device import (
    select_features_from_eig_device as jax_select)

from pyfeaturetrack_tpu_torch.ops.convolve import (
    compute_gradients as torch_gradients)
from pyfeaturetrack_tpu_torch.ops.cuda_eig import min_eig_map
from pyfeaturetrack_tpu_torch.ops.cuda_pyramid import (
    level0_eig, level_taps, pyramid_level_reference)
from pyfeaturetrack_tpu_torch.ops.cuda_select import greedy_extract
from pyfeaturetrack_tpu_torch.ops.select_device import (
    select_features_from_eig_device)
from pyfeaturetrack_tpu_torch.ops.track import \
    build_track_pyramids as torch_build_pyramids
from pyfeaturetrack_tpu_torch.utils.convert import (config_from_jax,
                                                    features_from_numpy)

torch.set_num_threads(2)

SHAPES = [(120, 160), (97, 130)]
WINDOWS = [(7, 7), (5, 9), (3, 3)]


def _eigs(shape, win):
    img = make_textured_image(*shape, seed=shape[0] + win[0])
    gx, gy = compute_gradients(jnp.asarray(img, jnp.float32), 1.0)
    port = min_eig_map(torch.tensor(np.asarray(gx)),
                       torch.tensor(np.asarray(gy)), *win)
    return gx, gy, port.numpy().astype(np.int64)


# JAX's XLA eig maps of every (shape, window) case, computed once in a
# subprocess with XLA's CPU threading pinned to one thread: under load the
# multi-threaded XLA reference rounded some rows of the lower half
# differently from run to run, and the test followed it.
_XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1")
_XLA_EIG_SCRIPT = """
import sys
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
from pyfeaturetrack_tpu.ops.select import quantized_min_eig_map
data = np.load(sys.argv[1])
fn = jax.jit(quantized_min_eig_map, static_argnums=(2, 3))
out = {}
for key in data.files:
    if key.startswith("gx"):
        name = key[2:]
        ww, wh = (int(v) for v in name.split("_")[-2:])
        out[name] = np.asarray(fn(jnp.asarray(data["gx" + name]),
                                  jnp.asarray(data["gy" + name]), ww, wh),
                               np.int64)
np.savez(sys.argv[2], **out)
"""
_xla_refs: dict = {}


def _case_name(shape, win):
    return f"_{shape[0]}_{shape[1]}_{win[0]}_{win[1]}"


def _port_gradients(shape, win, smooth=False):
    """The case's gradients as the port's plain passes make them; smooth:
    of the frame pre-smoothed for the window, as K1's level 0 makes them."""
    img = torch.tensor(make_textured_image(*shape, seed=shape[0] + win[0]),
                       dtype=torch.float32)
    if not smooth:
        return torch_gradients(img, 1.0)
    _, gx, gy, _ = pyramid_level_reference(img, level_taps(_torch_cfg(win)),
                                           True, False)
    return gx, gy


def _torch_cfg(win):
    return config_from_jax(create_config()).replace(window_width=win[0],
                                                    window_height=win[1])


def _xla_eig_pinned(shape, win, smooth=False):
    """JAX's XLA eig map of the case's port-made gradients (smooth: of the
    pre-smoothed frame), from the pinned single-thread subprocess (all
    cases in one run, cached)."""
    if not _xla_refs:
        arrays = {}
        for sh in SHAPES:
            for wn in WINDOWS:
                for tag, pre in (("", False), ("S", True)):
                    gx, gy = _port_gradients(sh, wn, pre)
                    arrays["gx" + tag + _case_name(sh, wn)] = gx.numpy()
                    arrays["gy" + tag + _case_name(sh, wn)] = gy.numpy()
        repo = Path(__file__).resolve().parent.parent
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [str(repo), os.environ.get("PYTHONPATH", "")]),
                   XLA_FLAGS=" ".join(
                       [os.environ.get("XLA_FLAGS", ""), _XLA_FLAGS]).strip())
        with tempfile.TemporaryDirectory() as tmp:
            src, dst = Path(tmp) / "grads.npz", Path(tmp) / "eig.npz"
            np.savez(src, **arrays)
            subprocess.run([sys.executable, "-c", _XLA_EIG_SCRIPT, str(src),
                            str(dst)], env=env, check=True, timeout=600)
            with np.load(dst) as out:
                _xla_refs.update({k: out[k] for k in out.files})
    return _xla_refs[("S" if smooth else "") + _case_name(shape, win)]


# The gradients both sides read come from the port's plain shift-and-add
# passes (numpy-made image, no XLA executable), so run-to-run variation in
# how the reference's gradient convolution was compiled cannot move them.
# Measured pixels off by one int step (of 19200 / 12610):
#   vs XLA:    (7,7) 0 / 1, (5,9) 4 / 4, (3,3) 1 / 0
#   vs Pallas (JAX-made gradients, _eigs): (7,7) 1 / 1, (5,9) 0 / 0,
#              (3,3) 0 / 0  (bit-equal in 4 of 6)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("win", WINDOWS)
def test_eig_matches_jax_xla_within_one_step(shape, win, monkeypatch):
    monkeypatch.delenv("PFT_PALLAS_SELECT", raising=False)  # XLA route
    tgx, tgy = _port_gradients(shape, win)
    got = min_eig_map(tgx, tgy, *win).numpy().astype(np.int64)
    ref = _xla_eig_pinned(shape, win)
    diff = np.abs(got - ref)
    off = np.argwhere(diff != 0)
    info = (f"max {diff.max()}, {len(off)} of {diff.size} pixels off: "
            + ", ".join(f"{tuple(map(int, p))} port {got[tuple(p)]} xla "
                        f"{ref[tuple(p)]}" for p in off[:12]))
    assert diff.max() <= 1, info
    assert (diff != 0).mean() < 1e-3, info


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("win", WINDOWS)
def test_eig_matches_pallas_within_one_step(shape, win):
    gx, gy, got = _eigs(shape, win)
    ref = np.asarray(min_eig_map_pallas(gx, gy, *win, interpret=True),
                     np.int64)
    diff = np.abs(got - ref)
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).sum() <= (1 if win == (7, 7) else 0)


def _k1_maps(shape, win, smooth):
    """K3's map from K1's level-0 launch, both entries (plain versions):
    the eig-only entry and, with the pre-smooth, the pyramid build's."""
    cfg = _torch_cfg(win)
    img = torch.tensor(make_textured_image(*shape, seed=shape[0] + win[0]),
                       dtype=torch.float32)
    maps = [level0_eig(img, level_taps(cfg), smooth, *win)]
    if smooth:
        maps.append(torch_build_pyramids(img, cfg, with_eig=True)[1])
    return [m.numpy().astype(np.int64) for m in maps]


def _within_one_step(got, ref):
    diff = np.abs(got - ref)
    off = np.argwhere(diff != 0)
    info = (f"max {diff.max()}, {len(off)} of {diff.size} pixels off: "
            + ", ".join(f"{tuple(map(int, p))} port {got[tuple(p)]} jax "
                        f"{ref[tuple(p)]}" for p in off[:12]))
    assert diff.max() <= 1, info
    assert (diff != 0).mean() < 1e-3, info


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("smooth", [False, True])
def test_k1_level0_eig_matches_jax_xla_within_one_step(shape, win, smooth):
    """K3 inside K1's level-0 launch at the standalone map's XLA bar: equal
    to the standalone map of the same gradients, within one int step of
    JAX's XLA map of them at under 1e-3 of pixels."""
    tgx, tgy = _port_gradients(shape, win, smooth)
    standalone = min_eig_map(tgx, tgy, *win).numpy().astype(np.int64)
    ref = _xla_eig_pinned(shape, win, smooth)
    for got in _k1_maps(shape, win, smooth):
        np.testing.assert_array_equal(got, standalone)
        _within_one_step(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("smooth", [False, True])
def test_k1_level0_eig_matches_pallas_within_one_step(shape, win, smooth):
    """The same maps against the Pallas eig kernel (interpret mode) fed the
    same gradients."""
    tgx, tgy = _port_gradients(shape, win, smooth)
    ref = np.asarray(min_eig_map_pallas(jnp.asarray(tgx.numpy()),
                                        jnp.asarray(tgy.numpy()), *win,
                                        interpret=True), np.int64)
    for got in _k1_maps(shape, win, smooth):
        _within_one_step(got, ref)


def test_eig_border_zeroed_and_dtype():
    _, _, got = _eigs((64, 96), (7, 7))
    assert (got[:3] == 0).all() and (got[-3:] == 0).all()
    assert (got[:, :3] == 0).all() and (got[:, -3:] == 0).all()
    assert (got[10:-10, 10:-10] != 0).any()
    t = min_eig_map(torch.zeros(8, 8), torch.zeros(8, 8), 7, 7)
    assert t.dtype == torch.int32 and not t.any()


@pytest.mark.parametrize("dg,budget,min_eig,seed", [
    (3, 10, 30, 0), (0, 5, 30, 1), (9, 200, 900, 2), (1, 64, 1, 3),
    (2, 0, 1, 4),
])
def test_extract_matches_pallas(dg, budget, min_eig, seed):
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, 1000, (50, 70)).astype(np.int32)
    cand[cand < 30] = 0
    jr, jc, jv, jn = greedy_extract_pallas(
        jnp.asarray(cand), min_eig=min_eig, dg=dg, budget=jnp.int32(budget),
        max_out=256, interpret=True)
    tr, tc, tv, tn = greedy_extract(
        torch.tensor(cand), min_eig=min_eig, dg=dg,
        budget=torch.tensor([budget], dtype=torch.int32), max_out=256)
    assert int(tn[0]) == int(jn)
    for a, b in ((tr, jr), (tc, jc), (tv, jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_extract_tie_break_is_row_major_first():
    cand = np.zeros((16, 130), np.int32)
    cand[3, 100] = cand[3, 5] = cand[1, 120] = cand[9, 0] = 7
    rr, cc, _, n = greedy_extract(torch.tensor(cand), min_eig=1, dg=0,
                                  budget=torch.tensor([4], dtype=torch.int32),
                                  max_out=8)
    got = [(int(rr[i]), int(cc[i])) for i in range(int(n[0]))]
    assert got == [(1, 120), (3, 5), (3, 100), (9, 0)]


def _jax_eig(img, jcfg):
    return selection_eig_map_core(
        jnp.asarray(img, jnp.float32), window_width=jcfg.window_width,
        window_height=jcfg.window_height,
        smooth_before=jcfg.smoothBeforeSelecting,
        smooth_sigma=jcfg.smooth_sigma, grad_sigma=jcfg.grad_sigma)


_SELECT_CASES = [({}, 0), ({"mindist": 7}, 1), ({"mindist": 0}, 2),
                 ({"mindist": 1}, 3), ({"nSkippedPixels": 2}, 4),
                 ({"mindist": 5, "nSkippedPixels": 3}, 5),
                 ({"min_eigenvalue": 200000}, 6)]


@pytest.mark.parametrize("overrides,seed", _SELECT_CASES)
@pytest.mark.parametrize("replacing", [False, True])
def test_selection_matches_jax_from_same_eig(overrides, seed, replacing):
    """Initial selection and refill, bit-equal (x, y, val), from one int32
    eig map. JAX runs its top-K + MIS fixpoint with top_k = eig.size, so it
    is never exhausted and equals the full greedy."""
    jcfg = create_config(**overrides)
    img = make_textured_image(96, 128, seed=40 + seed)
    eig = np.asarray(_jax_eig(img, jcfg))
    n = 40
    if replacing:
        base = select_good_features_arrays(img, n, jcfg)
        lost = base.copy()
        for i, code in [(0, -1), (3, -2), (7, -4), (12, -5), (21, -3),
                        (33, -1), (39, -4)]:
            lost[i] = (-1.0, -1.0, code)
    else:
        lost = np.tile([(-1.0, -1.0, -1.0)], (n, 1))
    jx, jy, jv, jfilled, jex = jax.jit(
        jax_select, static_argnames=("cfg", "replacing", "top_k"))(
            jnp.asarray(eig), jnp.asarray(lost[:, 0], jnp.float32),
            jnp.asarray(lost[:, 1], jnp.float32),
            jnp.asarray(lost[:, 2].astype(np.int32)), jcfg,
            replacing=replacing, top_k=int(eig.size))
    assert not bool(jex)
    tx, ty, tv, tfilled, tex = select_features_from_eig_device(
        torch.tensor(eig), *features_from_numpy(lost[:, 0], lost[:, 1],
                                                lost[:, 2], device="cpu"),
        config_from_jax(jcfg), replacing=replacing)
    assert not bool(tex)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tfilled.numpy(), np.asarray(jfilled))


def test_selection_empty_lattice():
    """A frame with no room inside the border fills nothing."""
    cfg = config_from_jax(create_config())
    eig = torch.ones((40, 40), dtype=torch.int32)
    x, y, v = features_from_numpy(np.full(5, -1.0), np.full(5, -1.0),
                                  np.full(5, -1), device="cpu")
    nx, ny, nv, filled, ex = select_features_from_eig_device(
        eig, x, y, v, cfg, replacing=False)
    assert (nv.numpy() == -1).all() and not filled.any() and not ex
