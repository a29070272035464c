"""Gradients through the port's tracking and dense flow.

* ``tests/test_differentiability.py``'s two scenarios (a loss over tracked
  positions, a loss over dense flow, each differentiated with respect to
  the second image) through the port's CPU route against ``jax.grad`` of
  the same loss on the same numpy inputs. Bars: tracking within 1e-7
  absolute (largest gradient about 7e-3), dense flow within 1e-6 absolute
  (largest about 0.5); both zero on the same pixels.
* Each kernel wrapper's ``torch.autograd.Function`` (``utils/cuda.
  with_plain_vjp``: K1, K2, K6, K8, K9, and K4's and K5's slot fills,
  whose kept lanes pass their positions through), driven on the CPU with
  the wrapper's launch helper replaced by its plain version: the
  wrapper's gradients equal autograd's own gradients of the plain route,
  bit for bit, and the stand-in launched once. Without an input that
  requires grad the call records nothing.
* The captured chain refuses inputs that require grad.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.config import create_config as jax_create_config
from pyfeaturetrack_tpu.ops.flow import dense_flow_pyramids as jax_dense
from pyfeaturetrack_tpu.ops.track import (
    build_track_pyramids as jax_pyramids,
    track_features_pyramids as jax_track)

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.features import AffineState, FeatureState
from pyfeaturetrack_tpu_torch.models import device_sequence
from pyfeaturetrack_tpu_torch.ops import (affine, cuda_affine, cuda_lk,
                                          cuda_lk_dense, cuda_pyramid,
                                          cuda_select, cuda_suppress,
                                          cuda_window_terms)
from pyfeaturetrack_tpu_torch.ops.select_device import (_candidate_grid,
                                                        premask_radius)
from pyfeaturetrack_tpu_torch.ops.cuda_eig import min_eig_reference
from pyfeaturetrack_tpu_torch.ops.flow import dense_flow_pyramids
from pyfeaturetrack_tpu_torch.utils import cuda

torch.set_num_threads(2)

TRACK_TOL = 1e-7
FLOW_TOL = 1e-6


def _pair(h=64, w=96, seed=5):
    base = make_textured_image(h, w, seed=seed).astype(np.float32)
    return base, shift_image_bilinear(base, 1.0, -0.5).astype(np.float32)


def _features(n=12):
    rng = np.random.default_rng(0)
    return (rng.uniform(16, 80, n).astype(np.float32),
            rng.uniform(16, 48, n).astype(np.float32))


def _track_loss_port(img1, img2, x, y, cfg):
    p1 = tpft.build_track_pyramids(img1, cfg)
    p2 = tpft.build_track_pyramids(img2, cfg)
    val = torch.ones(x.shape, dtype=torch.int32)
    nx, ny, nv = tpft.track_features_pyramids(p1, p2, x, y, val, cfg)
    return torch.where(nv == 0, nx + ny, 0.0).sum()


def _flow_loss_port(img1, img2, cfg):
    fl = dense_flow_pyramids(tpft.build_track_pyramids(img1, cfg),
                             tpft.build_track_pyramids(img2, cfg), cfg)
    return torch.where(fl.status == 0, fl.u ** 2 + fl.v ** 2, 0.0).sum()


def _grad(loss, img1, img2, *args):
    i2 = torch.as_tensor(img2).clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(torch.as_tensor(img1), i2, *args), i2)
    return g.numpy()


def test_tracked_positions_grad_matches_jax():
    img1, img2 = _pair()
    xs, ys = _features()
    jcfg = jax_create_config()

    def loss(i2):
        p1 = jax_pyramids(jnp.asarray(img1), jcfg)
        p2 = jax_pyramids(i2, jcfg)
        nx, ny, nv = jax_track(p1, p2, jnp.asarray(xs), jnp.asarray(ys),
                               jnp.ones((xs.size,), jnp.int32), jcfg)
        return jnp.sum(jnp.where(nv == 0, nx + ny, 0.0))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(img2)))
    got = _grad(_track_loss_port, img1, img2, torch.as_tensor(xs),
                torch.as_tensor(ys), tpft.create_config())
    assert np.isfinite(got).all() and np.abs(got).max() > 0.0
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TRACK_TOL)


def test_dense_flow_grad_matches_jax():
    img1, img2 = _pair(seed=9)
    jcfg = jax_create_config()

    def loss(i2):
        fl = jax_dense(jax_pyramids(jnp.asarray(img1), jcfg),
                       jax_pyramids(i2, jcfg), jcfg)
        return jnp.sum(jnp.where(fl.status == 0, fl.u ** 2 + fl.v ** 2, 0.0))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(img2)))
    got = _grad(_flow_loss_port, img1, img2, tpft.create_config())
    assert np.isfinite(got).all() and np.abs(got).max() > 0.0
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL)


# ---------------------------------------------------------------------------
# each autograd.Function, with its plain version standing in for the kernel
# ---------------------------------------------------------------------------

class StandIns:
    """Replaces every launch helper with its plain version (run without
    recording, like a kernel) and counts the calls."""

    def __init__(self, monkeypatch):
        self.calls = 0
        monkeypatch.setattr(cuda, "use_kernel",
                            lambda *t: not cuda._force_reference)
        for mod, name in ((cuda_pyramid, "_launch_build"),
                          (cuda_pyramid, "_launch_level"),
                          (cuda_lk, "_launch_pyramid"),
                          (cuda_lk_dense, "_launch"),
                          (cuda_window_terms, "_launch"),
                          (cuda_affine, "_launch"),
                          (cuda_affine, "_launch_stage"),
                          (cuda_select, "_launch_chain"),
                          (cuda_suppress, "_launch_fill")):
            monkeypatch.setattr(mod, name, self.counted(
                getattr(self, f"{mod.__name__.split('.')[-1]}{name}")))

    def counted(self, fn):
        def run(*args, **kwargs):
            self.calls += 1
            with torch.no_grad():
                return fn(*args, **kwargs)
        return run

    @staticmethod
    def cuda_pyramid_launch_build(img, taps, n_levels, eig_window, out,
                                  shapes, dtype):
        levels = cuda_pyramid._stored(
            cuda_pyramid.pyramid_build_reference(img, taps, n_levels), dtype)
        buf = torch.cat([t.reshape(-1) for lv in zip(*levels) for t in lv])
        if eig_window is None:
            return (buf,)
        return buf, min_eig_reference(levels[1][0], levels[2][0],
                                      *eig_window)

    @staticmethod
    def cuda_pyramid_launch_level(img, taps, smooth, with_pyr):
        return cuda_pyramid.pyramid_level_reference(img, taps, smooth,
                                                    with_pyr)

    @staticmethod
    def cuda_lk_launch_pyramid(p1, p2, x, y, val, cfg, xi, yi, xo, yo, vo):
        for dst, src in zip((xo, yo, vo), cuda_lk.track_pyramid_reference(
                p1, p2, x, y, val, cfg, xi, yi)):
            dst.copy_(src)

    @staticmethod
    def cuda_lk_dense_launch(imgs, maps, start, coarse, scale, cfg, one_d,
                             out, band):
        u, v = maps
        lvl_scale = None if start == cuda_lk_dense.START_MAP else scale
        got = cuda_lk_dense._plain_level(imgs, u, v, cfg, one_d, lvl_scale,
                                         band)
        for dst, src in zip(out, got):
            if dst is not None:
                dst.copy_(src)

    @staticmethod
    def cuda_window_terms_launch(*ts, hw, hh, step_factor):
        return cuda_window_terms.window_terms_reference(
            *ts, hw=hw, hh=hh, step_factor=step_factor)

    @staticmethod
    def cuda_affine_launch(tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg, xo,
                           yo, Ao, st, nit):
        for dst, src in zip((xo, yo, Ao, st, nit), affine._affine_track_batch(
                tmpl, img2, gx2, gy2, x0, y0, A0, check, cfg)):
            dst.copy_(src)

    @staticmethod
    def cuda_select_launch_chain(cands, budget, min_eig, dg, max_out, lists,
                                 slots, geom, replacing, slots_out):
        x, y, val = slots
        free = (val < 0) if replacing else torch.ones_like(val,
                                                           dtype=torch.bool)
        rr, cc, vv, n_acc = cuda_select.greedy_extract_reference(
            cands.cells[:, :cands.nx], min_eig, dg,
            free.sum().to(torch.int32).reshape(1), max_out)
        bx, by, step = geom[:3]
        got = cuda_select.fill_slots(n_acc, (bx + cc * step).to(torch.int32),
                                     (by + rr * step).to(torch.int32), vv,
                                     free, x, y, val)
        for dst, src in zip(slots_out, got):
            dst.copy_(src)

    @staticmethod
    def cuda_suppress_launch_fill(neg, order, geom, min_eig, shape, d, x, y,
                                  val, replacing, grid, acc, out):
        for dst, src in zip(out, cuda_suppress.suppress_and_fill_reference(
                neg, order, geom, min_eig, shape, d + 1, x, y, val,
                replacing)):
            dst.copy_(src)

    @staticmethod
    def cuda_affine_launch_stage(ts, cfg):
        x, y, val, aff = affine.stage_reference(
            ts[:3], ts[3:6], ts[6:8], ts[10], ts[8:10], ts[11],
            AffineState(*ts[12:]), cfg)
        return (x, y, val) + tuple(aff)


def _leaves(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


def _float_outputs(out):
    flat = []
    stack = [out]
    while stack:
        o = stack.pop(0)
        if isinstance(o, torch.Tensor):
            if o.is_floating_point():
                flat.append(o)
        elif isinstance(o, (tuple, list)):
            stack[:0] = list(o)
    return flat


def _weighted_grads(fn, leaves, seed=0):
    """Gradients of sum(w_k * out_k) over fn's float outputs (random
    weights from ``seed``) with respect to ``leaves``. Forward and backward
    run on the calling thread (``utils/cuda.calling_thread_only``), as the
    plain versions do: a backward op split over the intra-op threads can
    round differently on a worker thread once JAX has run in the process,
    and these gradients are compared bit for bit."""
    with cuda.calling_thread_only():
        outs = _float_outputs(fn(*leaves))
        gen = torch.Generator().manual_seed(seed)
        loss = sum((torch.rand(o.shape, generator=gen) * o).sum()
                   for o in outs if o.requires_grad)
        return torch.autograd.grad(loss, leaves, allow_unused=True), outs


def _scene(h=48, w=64, seed=3, n=10):
    img1, img2 = _pair(h, w, seed)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(12, w - 12, n).astype(np.float32))
    y = torch.as_tensor(rng.uniform(12, h - 12, n).astype(np.float32))
    return torch.as_tensor(img1), torch.as_tensor(img2), x, y


def _pyr_fields(pyr):
    return (*pyr.img, *pyr.gradx, *pyr.grady)


def _pyr_from(fields, n_levels):
    from pyfeaturetrack_tpu_torch.ops.track import TrackPyramids
    return TrackPyramids(*(tuple(fields[k * n_levels:(k + 1) * n_levels])
                           for k in range(3)))


def _case_k1_build(eig):
    cfg = tpft.create_config()
    img = _scene()[0]
    taps = cuda_pyramid.level_taps(cfg)
    win = (7, 7) if eig else None
    return (lambda im: cuda_pyramid.pyramid_build(im, taps, 2, eig_window=win),
            (img,))


def _case_k1_level(smooth, with_pyr):
    cfg = tpft.create_config()
    taps = cuda_pyramid.level_taps(cfg)

    def fn(im):
        base, gx, gy, nxt = cuda_pyramid.pyramid_level(im, taps, smooth,
                                                       with_pyr)
        # without the pre-smooth, base is the input itself (no launch
        # writes it): the loss leaves it out, or its gradient would join
        # the launch's in another order
        assert smooth or base is im
        return ((base,) if smooth else ()) + (gx, gy, nxt)
    return fn, (_scene()[0],)


def _case_k2(guided):
    cfg = tpft.create_config()
    img1, img2, x, y = _scene()
    p1 = tpft.build_track_pyramids(img1, cfg)
    p2 = tpft.build_track_pyramids(img2, cfg)
    val = torch.zeros(x.shape, dtype=torch.int32)
    val[3] = -1
    nl = cfg.nPyramidLevels
    starts = (x + 1.0, y - 0.5) if guided else ()

    def fn(x, y, *rest):
        s, f = rest[:len(starts)], rest[len(starts):]
        return cuda_lk.track_pyramid(_pyr_from(f[:3 * nl], nl),
                                     _pyr_from(f[3 * nl:], nl), x, y, val,
                                     cfg, *s)
    return fn, (x, y, *starts, *_pyr_fields(p1), *_pyr_fields(p2))


def _case_k8(mode):
    cfg = tpft.create_config()
    img1, img2, _, _ = _scene()
    p1 = tpft.build_track_pyramids(img1, cfg)
    p2 = tpft.build_track_pyramids(img2, cfg)
    lvl = (p1.img[0], p1.gradx[0], p1.grady[0], p2.img[0], p2.gradx[0],
           p2.grady[0])
    shape = lvl[0].shape
    coarse = (shape[0] // 4, shape[1] // 4)
    rng = np.random.default_rng(4)
    m = torch.as_tensor(rng.uniform(-0.5, 0.5, (2,) + coarse)
                        .astype(np.float32))
    full = torch.as_tensor(rng.uniform(-0.5, 0.5, (2,) + shape)
                           .astype(np.float32))
    if mode == "map":
        return (lambda *t: cuda_lk_dense.dense_level(*t, cfg),
                (*lvl, full[0], full[1]))
    if mode == "up":
        return (lambda *t: cuda_lk_dense.dense_level_up(*t, 4.0, cfg),
                (*lvl, m[0], m[1]))
    if mode == "zero":
        return (lambda *t: cuda_lk_dense.dense_level_up(*t, None, None, 4.0,
                                                       cfg), lvl)
    return (lambda *t: cuda_lk_dense.dense_level_1d_up(*t, 4.0, cfg),
            (*lvl, m[0].abs()))


def _case_k9():
    img1, img2, x, y = _scene()
    g = tpft.build_track_pyramids(img2, tpft.create_config())
    rng = np.random.default_rng(5)
    n = x.shape[0]
    w1 = [torch.as_tensor(rng.uniform(0, 50, (n, 7, 7)).astype(np.float32))
          for _ in range(3)]
    return ((lambda *t: cuda_window_terms.window_terms(
        *t, hw=3, hh=3, step_factor=1.0)),
        (g.img[0], g.gradx[0], g.grady[0], *w1, x + 0.3, y - 0.2))


def _affine_inputs():
    cfg = tpft.create_config(affineConsistencyCheck=2, mindist=4)
    img1, img2, x, y = _scene(h=64, w=80, n=8)
    p1 = tpft.build_track_pyramids(img1, cfg)
    p2 = tpft.build_track_pyramids(img2, cfg)
    n = x.shape[0]
    aff = affine.make_affine_state(n, cfg, "cpu")
    return cfg, p1, p2, x, y, n, aff


def _case_k6_batch():
    cfg, p1, p2, x, y, n, _ = _affine_inputs()
    tmpl = affine.gather_window(p1.img[0], x, y, 7, 7)
    A0 = torch.eye(2).expand(n, 2, 2).contiguous()
    check = torch.ones(n, dtype=torch.bool)
    check[2] = False
    return ((lambda t, i, gx, gy, x0, y0, A: cuda_affine.affine_track_batch(
        t, i, gx, gy, x0, y0, A, check, cfg)),
        (tmpl, p2.img[0], p2.gradx[0], p2.grady[0], x + 1.0, y - 0.5, A0))


def _case_k6_stage():
    cfg, p1, p2, x, y, n, aff = _affine_inputs()
    # half the lanes hold a template (captured at x, y), half capture now
    tmpl = [affine.gather_window(im, x, y, 7, 7)
            for im in (p1.img[0], p1.gradx[0], p1.grady[0])]
    held = torch.arange(n) % 2 == 0
    aff = aff._replace(img=tmpl[0], gradx=tmpl[1], grady=tmpl[2],
                       x=x.clone(), y=y.clone(), valid=held,
                       nit=torch.zeros(n, dtype=torch.int32))
    val_b = torch.zeros(n, dtype=torch.int32)
    val_a = val_b.clone()
    val_a[5] = -3

    def fn(i1, gx1, gy1, i2, gx2, gy2, bx, by, ax, ay, ti, tgx, tgy, A):
        pyr1 = _pyr_from((i1, gx1, gy1), 1)
        pyr2 = _pyr_from((i2, gx2, gy2), 1)
        a = aff._replace(img=ti, gradx=tgx, grady=tgy, A=A)
        return cuda_affine.affine_stage(
            pyr1, pyr2, FeatureState(bx, by, val_b),
            FeatureState(ax, ay, val_a, a), a, cfg)
    return fn, (p1.img[0], p1.gradx[0], p1.grady[0], p2.img[0],
                p2.gradx[0], p2.grady[0], x, y, x + 1.0, y - 0.5, *tmpl,
                torch.eye(2).expand(n, 2, 2).contiguous())


def _refill_inputs():
    """A refill: an eig map, 30 slots of which every third is free, the
    kept ones on seeded positions."""
    cfg = tpft.create_config(mindist=6)
    img = _scene(h=64, w=80)[0]
    eig = cuda_pyramid.level0_eig(img, cuda_pyramid.level_taps(cfg), True,
                                  7, 7)
    rng = np.random.default_rng(6)
    n = 30
    x = torch.as_tensor(rng.uniform(10, 70, n).astype(np.float32))
    y = torch.as_tensor(rng.uniform(10, 54, n).astype(np.float32))
    val = torch.zeros(n, dtype=torch.int32)
    val[::3] = -1
    return cfg, eig, x, y, val, _candidate_grid(cfg, eig.shape)


def _case_k4_fill():
    cfg, eig, x, y, val, geom = _refill_inputs()
    cands = cuda_select.candidate_lattice_reference(
        eig, x, y, val, geom, min_eig=int(cfg.min_eigenvalue),
        radius=premask_radius(cfg, True))
    return ((lambda x, y: cuda_select.greedy_fill(
        cands, x, y, val, geom, min_eig=int(cfg.min_eigenvalue),
        dg=(cfg.mindist - 1) // geom[2], replacing=True)), (x, y))


def _case_k5_fill():
    cfg, eig, x, y, val, geom = _refill_inputs()
    bx, by, step, ny, nx = geom
    lattice = eig[by:by + ny * step:step, bx:bx + nx * step:step]
    neg, order = torch.sort(-lattice.reshape(-1), stable=True)
    return ((lambda x, y: cuda_suppress.suppress_and_fill(
        neg, order, geom=geom, min_eig=int(cfg.min_eigenvalue),
        shape=tuple(eig.shape), mindist=cfg.mindist, x=x, y=y, val=val,
        replacing=True)), (x, y))


CASES = {
    "K1 build": lambda: _case_k1_build(False),
    "K1 build with K3 map": lambda: _case_k1_build(True),
    "K1 level smooth+pyr": lambda: _case_k1_level(True, True),
    "K1 level plain": lambda: _case_k1_level(False, False),
    "K2": lambda: _case_k2(False),
    "K2 guided": lambda: _case_k2(True),
    "K8 map start": lambda: _case_k8("map"),
    "K8 upsampled start": lambda: _case_k8("up"),
    "K8 zero start": lambda: _case_k8("zero"),
    "K8 1-D": lambda: _case_k8("1d"),
    "K9": _case_k9,
    "K6 batch": _case_k6_batch,
    "K6 stage": _case_k6_stage,
    "K4 slot fill": _case_k4_fill,
    "K5 slot fill": _case_k5_fill,
}


@pytest.mark.parametrize("case", list(CASES))
def test_function_gives_the_plain_gradients(case, monkeypatch):
    fn, inputs = CASES[case]()
    want, want_out = _weighted_grads(fn, _leaves(*inputs))
    stand = StandIns(monkeypatch)
    got, got_out = _weighted_grads(fn, _leaves(*inputs))
    assert stand.calls == 1
    assert len(got_out) == len(want_out)
    for a, b in zip(got_out, want_out):
        assert torch.equal(a, b)
    assert any(g is not None and bool(g.ne(0).any()) for g in want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w), (g - w).abs().max()


@pytest.mark.parametrize("case", ["K1 build", "K2", "K8 upsampled start",
                                  "K6 stage"])
def test_no_recording_without_grad(case, monkeypatch):
    fn, inputs = CASES[case]()
    stand = StandIns(monkeypatch)
    outs = _float_outputs(fn(*inputs))
    assert stand.calls == 1
    assert all(o.grad_fn is None for o in outs)
    with torch.no_grad():
        outs = _float_outputs(fn(*_leaves(*inputs)))
    assert stand.calls == 2
    assert all(o.grad_fn is None for o in outs)


def test_pyramid_out_buffer_refuses_grad(monkeypatch):
    StandIns(monkeypatch)
    cfg = tpft.create_config()
    img = _scene()[0].requires_grad_(True)
    shapes = cuda_pyramid.level_shapes(*img.shape, cfg.subsampling, 2)
    out = torch.empty(cuda_pyramid.pyramid_numel(shapes))
    with pytest.raises(ValueError, match="no gradients"):
        cuda_pyramid.pyramid_build(img, cuda_pyramid.level_taps(cfg), 2,
                                   out=out)


def test_chain_refuses_inputs_that_require_grad(monkeypatch):
    """On the card the chain replays a captured graph (no autograd
    history): a frame or a state that requires grad raises."""
    cfg = tpft.create_config().replace(sequentialMode=True)
    img1, img2, _, _ = _scene()
    pyr, x, y, v, _, _ = tpft.select_step_device(img1, cfg, 6)
    monkeypatch.setattr(cuda, "use_kernel", lambda *t: True)
    with pytest.raises(ValueError, match="records no gradients"):
        device_sequence.sequence_chain_device(
            pyr, [img2.clone().requires_grad_(True)] * 2, x, y, v, cfg)
    with pytest.raises(ValueError, match="records no gradients"):
        device_sequence.sequence_chain_device(
            pyr, [img2] * 2, x.clone().requires_grad_(True), y, v, cfg)
