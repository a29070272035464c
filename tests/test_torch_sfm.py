"""The port's SfM back end (``pyfeaturetrack_tpu_torch/sfm``) against the
JAX package on the CPU, on the same seeded numpy inputs: geometry,
triangulation, epipolar RANSAC and the two-view bootstrap, PnP, the lens
models, the H/E model selection, the pose graph, dense bundle adjustment
on the JAX package's own problems, and the feature-table pipeline.

Bars: rotations, translations and points within 1e-4; BA and pose-graph
costs within rtol 1e-4 per iteration; RANSAC inlier masks, cheirality
masks, chosen models and candidates equal. The JAX side runs through XLA
on the CPU as its own tests run it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyfeaturetrack_tpu import sfm as jsfm
from pyfeaturetrack_tpu.features import FeatureTable as JaxFeatureTable
from pyfeaturetrack_tpu.sfm import camera as jcam
from pyfeaturetrack_tpu.sfm import epipolar as jepi
from pyfeaturetrack_tpu.sfm import homography as jhom
from pyfeaturetrack_tpu.sfm import pnp as jpnp
from pyfeaturetrack_tpu.sfm import posegraph as jpg

from pyfeaturetrack_tpu_torch import sfm
from pyfeaturetrack_tpu_torch.features import FeatureTable
from pyfeaturetrack_tpu_torch.sfm import ba, camera, epipolar, geometry
from pyfeaturetrack_tpu_torch.sfm import homography, pnp, posegraph
from pyfeaturetrack_tpu_torch.utils.convert import (ba_problem_from_numpy,
                                                    pose_graph_from_numpy,
                                                    poses_from_numpy)

torch.set_num_threads(2)

CPU = "cpu"
K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def t32(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def close(a, b, atol=1e-4, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def costs_close(got, want, n_obs, px_scale=640.0):
    """Per-iteration costs within rtol 1e-4, or within the float32
    resolution of the residuals they sum once a step has converged: a
    cost c over M residuals moves by up to 2 sqrt(c M) ulp(px_scale)
    when each residual rounds differently (XLA contracts the products
    into FMAs on the CPU, the port rounds each)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = float(np.spacing(np.float32(px_scale)))
    tol = np.maximum(1e-4 * np.abs(want), 2 * np.sqrt(want * n_obs) * ulp)
    assert (np.abs(got - want) <= tol).all(), (got, want, tol)


# ---------------------------------------------------------------------------
# scenes (the JAX package's test scenes, rebuilt from their seeds)
# ---------------------------------------------------------------------------

def make_scene(n_cams=6, n_pts=64, seed=0):
    r = np.random.default_rng(seed)
    ws = 0.02 * r.standard_normal((n_cams, 3))
    ws[0] = 0
    Rs = np.stack([np.asarray(jsfm.so3_exp(jnp.asarray(w, jnp.float32)))
                   for w in ws])
    ts = np.stack([np.array([-0.3 * i, 0.02 * i, 0.0])
                   for i in range(n_cams)]).astype(np.float32)
    X = np.stack([r.uniform(-2.5, 2.5, n_pts), r.uniform(-1.8, 1.8, n_pts),
                  r.uniform(5.0, 9.0, n_pts)], axis=-1).astype(np.float32)
    return Rs.astype(np.float32), ts, X


def project_scene(Rs, ts, X, noise=0.0, seed=1):
    Y = np.einsum("cij,nj->cni", Rs.astype(np.float64), X) + ts[:, None]
    uv = (K[None, None, :2, :2].diagonal(axis1=-2, axis2=-1)
          * Y[..., :2] / Y[..., 2:] + K[:2, 2]).astype(np.float32)
    if noise:
        uv += noise * np.random.default_rng(seed).standard_normal(
            uv.shape).astype(np.float32)
    return uv


def obs_arrays(uv):
    n_cams, n_pts, _ = uv.shape
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    return cam_idx, pt_idx, uv.reshape(-1, 2), np.ones(n_cams * n_pts,
                                                       np.float32)


def perturbed_init(Rs, ts, X, seed=3, pose_noise=0.01, pt_noise=0.05):
    r = np.random.default_rng(seed)
    dw = pose_noise * r.standard_normal((Rs.shape[0], 3)).astype(np.float32)
    dw[0] = 0
    R0 = np.asarray(jsfm.so3_exp(jnp.asarray(dw))) @ Rs
    t0 = ts + pose_noise * r.standard_normal(ts.shape).astype(np.float32)
    t0[0] = ts[0]
    X0 = X + pt_noise * r.standard_normal(X.shape).astype(np.float32)
    return R0.astype(np.float32), t0.astype(np.float32), X0


def plane_view(n=120, seed=0, rot=(0.03, -0.06, 0.02), t=(0.8, 0.1, 0.25),
               normal=(0.1, -0.2, 1.0), d=6.0, noise_px=0.3, n_outliers=15):
    """tests/test_homography.py's planar scene: points on normal . X = d
    seen by two cameras, pixel noise, outliers anywhere in the image."""
    rng = np.random.default_rng(seed)
    nrm = np.asarray(normal, np.float64)
    nrm = nrm / np.linalg.norm(nrm)
    a = np.cross(nrm, [1.0, 0.0, 0.0])
    a = a / np.linalg.norm(a)
    b = np.cross(nrm, a)
    X = (nrm[None] * d + rng.uniform(-4, 4, (n, 1)) * a[None]
         + rng.uniform(-3, 3, (n, 1)) * b[None])
    R = np.asarray(jsfm.so3_exp(jnp.asarray(rot, jnp.float32)), np.float64)

    def proj(R_, t_, X_):
        Y = X_ @ R_.T + t_
        return Y[:, :2] / Y[:, 2:] * 500.0 + [320, 240]

    uv1 = proj(np.eye(3), np.zeros(3), X)
    uv2 = proj(R, np.asarray(t), X)
    uv1 = uv1 + rng.normal(0, noise_px, uv1.shape)
    uv2 = uv2 + rng.normal(0, noise_px, uv2.shape)
    bad = rng.choice(n, n_outliers, replace=False)
    uv2[bad] = np.stack([rng.uniform(0, 640, n_outliers),
                         rng.uniform(0, 480, n_outliers)], -1)
    return uv1.astype(np.float32), uv2.astype(np.float32)


def two_view(n=120, seed=0, rot=(0.02, -0.05, 0.01), t=(1.0, 0.15, 0.3),
             noise_px=0.3, n_outliers=20):
    """Matches between two views of a general 3-D scene
    (tests/test_epipolar.py's shape): inliers with pixel noise plus gross
    outliers."""
    r = np.random.default_rng(seed)
    X = np.stack([r.uniform(-3, 3, n), r.uniform(-2, 2, n),
                  r.uniform(4, 12, n)], -1)
    R = np.asarray(jsfm.so3_exp(jnp.asarray(rot, jnp.float32)), np.float64)
    tt = np.asarray(t, np.float64)
    uv1 = X[:, :2] / X[:, 2:] * 500.0 + [320, 240]
    Y = X @ R.T + tt
    uv2 = Y[:, :2] / Y[:, 2:] * 500.0 + [320, 240]
    uv1 = uv1 + noise_px * r.standard_normal(uv1.shape)
    uv2 = uv2 + noise_px * r.standard_normal(uv2.shape)
    bad = r.choice(n, n_outliers, replace=False)
    uv2[bad] += r.uniform(-60, 60, (n_outliers, 2))
    return uv1.astype(np.float32), uv2.astype(np.float32)


# ---------------------------------------------------------------------------
# geometry and triangulation
# ---------------------------------------------------------------------------

def test_geometry_matches_jax():
    r = np.random.default_rng(2)
    w = r.uniform(-1.5, 1.5, (20, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-9
    R = geometry.so3_exp(t32(w))
    close(R, jsfm.so3_exp(jnp.asarray(w)), atol=1e-6)
    close(geometry.so3_log(R), jsfm.so3_log(jsfm.so3_exp(jnp.asarray(w))),
          atol=1e-5)
    X = r.uniform(-3, 3, (20, 3)).astype(np.float32)
    t = r.uniform(-1, 1, (20, 3)).astype(np.float32)
    Rj = jsfm.so3_exp(jnp.asarray(w))
    close(geometry.se3_apply(R, t32(t), t32(X)),
          jsfm.se3_apply(Rj, jnp.asarray(t), jnp.asarray(X)), atol=1e-5)
    for got, want in zip(geometry.se3_compose(R, t32(t), R.flip(0),
                                              t32(t[::-1])),
                         jsfm.se3_compose(Rj, jnp.asarray(t), Rj[::-1],
                                          jnp.asarray(t[::-1]))):
        close(got, want, atol=1e-5)
    for got, want in zip(geometry.se3_inverse(R, t32(t)),
                         jsfm.geometry.se3_inverse(Rj, jnp.asarray(t))):
        close(got, want, atol=1e-6)
    X[:, 2] += 6.0
    uv, z = geometry.project(K, R[3], t32(t[3]), t32(X))
    juv, jz = jsfm.project(jnp.asarray(K), Rj[3], jnp.asarray(t[3]),
                           jnp.asarray(X))
    close(uv, juv, atol=1e-3, rtol=1e-6)
    close(z, jz, atol=1e-5)


def test_triangulate_matches_jax():
    Rs, ts, X = make_scene()
    uvs = project_scene(Rs, ts, X, noise=0.3).transpose(1, 0, 2)
    mask = np.random.default_rng(4).random(uvs.shape[:2]) > 0.3
    got = sfm.triangulate_dlt(K, Rs, ts, uvs, mask, device=CPU)
    want = jsfm.triangulate_dlt(jnp.asarray(K), jnp.asarray(Rs),
                                jnp.asarray(ts), jnp.asarray(uvs),
                                jnp.asarray(mask))
    close(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# epipolar: eigenvectors, RANSAC, bootstrap
# ---------------------------------------------------------------------------

def test_smallest_eigvec_matches_jax():
    r = np.random.default_rng(0)
    A = r.standard_normal((64, 12, 9)).astype(np.float32)
    M = np.einsum("sni,snj->sij", A, A)
    M[:, :, 0] *= 1e-3
    M[:, 0, :] *= 1e-3
    got = epipolar.smallest_eigvec(t32(M))
    want = jepi.smallest_eigvec(jnp.asarray(M))
    close(got, want, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_essential_matches_jax(seed):
    uv1, uv2 = two_view(seed=seed)
    Kd = K.astype(np.float64)
    x1 = epipolar.normalize_points(Kd, uv1, device=CPU)
    x2 = epipolar.normalize_points(Kd, uv2, device=CPU)
    jx1 = jepi.normalize_points(Kd, jnp.asarray(uv1))
    jx2 = jepi.normalize_points(Kd, jnp.asarray(uv2))
    close(x1, jx1, atol=1e-7)
    E, inl, cnt = epipolar.ransac_essential(x1, x2, n_hypotheses=128,
                                            thresh=2.0 / 500.0, seed=seed)
    jE, jinl, jcnt = jepi.ransac_essential(jx1, jx2, n_hypotheses=128,
                                           thresh=2.0 / 500.0, seed=seed)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(cnt) == int(jcnt)
    close(E, jE, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_two_view_bootstrap_matches_jax(seed):
    uv1, uv2 = two_view(seed=seed)
    got = sfm.two_view_bootstrap(K, uv1, uv2, n_hypotheses=256, seed=seed,
                                 device=CPU)
    want = jsfm.two_view_bootstrap(K, uv1, uv2, n_hypotheses=256, seed=seed)
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    np.testing.assert_array_equal(got["good"], want["good"])
    assert got["n_best_hypothesis"] == want["n_best_hypothesis"]
    close(got["R"], want["R"])
    close(got["t"], want["t"])
    # landmarks at unit baseline, 4-12 units deep: the DLT normal
    # equations scale E's rounding by depth^2 / baseline
    g = got["good"]
    close(got["X"][g], want["X"][g], atol=1e-4, rtol=5e-4)


def test_ransac_needs_eight():
    uv1, uv2 = two_view(n=10, n_outliers=0)
    valid = np.zeros(10, bool)
    valid[:7] = True
    with pytest.raises(ValueError):
        sfm.ransac_essential(t32(uv1), t32(uv2), valid=valid)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def pnp_scene(n=80, seed=0, rot=(0.1, -0.2, 0.15), t=(0.4, -0.2, 0.6),
              noise_px=0.3, n_outliers=12):
    r = np.random.default_rng(seed)
    X = np.stack([r.uniform(-3, 3, n), r.uniform(-2, 2, n),
                  r.uniform(4, 10, n)], -1).astype(np.float32)
    R = np.asarray(jsfm.so3_exp(jnp.asarray(rot, jnp.float32)))
    Y = X @ R.T + np.asarray(t, np.float32)
    uv = (Y[:, :2] / Y[:, 2:] * 500.0 + [320, 240]).astype(np.float32)
    uv += noise_px * r.standard_normal(uv.shape).astype(np.float32)
    bad = r.choice(n, n_outliers, replace=False)
    uv[bad] += r.uniform(-50, 50, (n_outliers, 2)).astype(np.float32)
    return R, np.asarray(t, np.float32), X, uv


@pytest.mark.parametrize("huber", [None, 2.0])
def test_refine_pose_matches_jax(huber):
    R, t, X, uv = pnp_scene()
    R0 = np.asarray(jsfm.so3_exp(jnp.asarray([0.02, 0.01, -0.02],
                                             jnp.float32))) @ R
    t0 = t + np.float32(0.05)
    w = np.ones(len(X), np.float32)
    w[::7] = 0.0
    got = pnp.refine_pose(K, R0, t0, X, uv, w, n_iters=10,
                          huber_delta=huber, device=CPU)
    want = jpnp.refine_pose(jnp.asarray(K), jnp.asarray(R0),
                            jnp.asarray(t0), jnp.asarray(X),
                            jnp.asarray(uv), jnp.asarray(w), n_iters=10,
                            huber_delta=huber)
    close(got[0], want[0])
    close(got[1], want[1])
    close(got[2], want[2], atol=0, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_matches_jax(seed):
    _, _, X, uv = pnp_scene(seed=seed)
    R, t, inl = sfm.pnp_ransac(K, X, uv, seed=seed, device=CPU)
    jR, jt, jinl = jsfm.pnp_ransac(K, X, uv, seed=seed)
    np.testing.assert_array_equal(inl, jinl)
    close(R, jR)
    close(t, jt)


def test_polar_orthogonalize_matches_jax():
    r = np.random.default_rng(3)
    M = (np.eye(3) + 0.05 * r.standard_normal((16, 3, 3))).astype(np.float32)
    close(pnp._polar_orthogonalize(t32(M)),
          jpnp._polar_orthogonalize(jnp.asarray(M)), atol=1e-6)


# ---------------------------------------------------------------------------
# lens models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,dist", [
    ("radtan", [-0.28, 0.07, 1e-3, -5e-4, 0.01]),
    ("radtan", [0.1, -0.02]),
    ("fisheye", [0.05, -0.01, 0.002, -1e-4])])
def test_camera_models_match_jax(model, dist):
    yy, xx = np.mgrid[0:480:24, 0:640:32]
    uv = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)
    d = camera.distort_pixels(K, dist, uv, model, device=CPU)
    close(d, jcam.distort_pixels(K, dist, uv, model), atol=1e-3, rtol=1e-6)
    u = camera.undistort_pixels(K, dist, d, model)
    close(u, jcam.undistort_pixels(K, dist, np.asarray(d), model),
          atol=1e-3, rtol=1e-6)
    close(u, uv, atol=1e-2)                         # round trip
    Rs, ts, X = make_scene()
    got = camera.project_distorted(K, dist, Rs[2], ts[2], X, model,
                                   device=CPU)
    want = jcam.project_distorted(K, dist, Rs[2], ts[2], X, model)
    close(got[0], want[0], atol=1e-3, rtol=1e-6)
    close(got[1], want[1], atol=1e-5)


def test_camera_unknown_model_raises():
    with pytest.raises(ValueError):
        camera.undistort_pixels(K, [0.1], np.zeros((1, 2)), "pinhole",
                                device=CPU)


# ---------------------------------------------------------------------------
# homography and H/E model selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planar,seed", [(True, 0), (True, 1), (False, 0)])
def test_bootstrap_auto_matches_jax(planar, seed):
    uv1, uv2 = plane_view(seed=seed) if planar else two_view(seed=seed)
    got = homography.two_view_bootstrap_auto(K, uv1, uv2, n_hypotheses=256,
                                             seed=seed, device=CPU)
    want = jhom.two_view_bootstrap_auto(K, uv1, uv2, n_hypotheses=256,
                                        seed=seed)
    assert got["model"] == want["model"]
    assert got["degenerate"] == want["degenerate"]
    close(got["score_ratio"], want["score_ratio"], atol=1e-4)
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    np.testing.assert_array_equal(got["good"], want["good"])
    close(got["R"], want["R"])
    close(got["t"], want["t"])


def test_ransac_homography_and_decomposition_match_jax():
    uv1, uv2 = plane_view(seed=3)
    x1 = epipolar.normalize_points(K, uv1, device=CPU)
    x2 = epipolar.normalize_points(K, uv2, device=CPU)
    H, inl, cnt = homography.ransac_homography(x1, x2, n_hypotheses=128,
                                               thresh=4e-3, seed=3)
    jH, jinl, jcnt = jhom.ransac_homography(jnp.asarray(x1.numpy()),
                                            jnp.asarray(x2.numpy()),
                                            n_hypotheses=128, thresh=4e-3,
                                            seed=3)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(cnt) == int(jcnt)
    close(H, jH)
    got = homography.decompose_homography(np.asarray(jH), x1.numpy(),
                                          x2.numpy(), np.asarray(jinl))
    want = jhom.decompose_homography(np.asarray(jH), x1.numpy(),
                                     x2.numpy(), np.asarray(jinl))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def chain_graph(n=8, seed=5):
    Rs, ts, _ = make_scene(n_cams=n)
    r = np.random.default_rng(seed)
    R_rel, t_rel = [], []
    for i in range(n - 1):
        Rij = Rs[i + 1] @ Rs[i].T
        t_rel.append(ts[i + 1] - Rij @ ts[i])
        R_rel.append(Rij)
    R0n = Rs[n - 1] @ Rs[0].T
    t0n = ts[n - 1] - R0n @ ts[0]
    dw = 0.03 * r.standard_normal((n, 3)).astype(np.float32)
    dw[0] = 0
    R0 = (np.asarray(jsfm.so3_exp(jnp.asarray(dw))) @ Rs).astype(np.float32)
    t0 = (ts + 0.05 * r.standard_normal(ts.shape)).astype(np.float32)
    t0[0] = ts[0]
    graph = jpg.odometry_graph(np.stack(R_rel), np.stack(t_rel),
                               loop_edges=[(0, n - 1, R0n, t0n)])
    graph = graph._replace(w_rot=graph.w_rot.at[-1].set(4.0))
    return graph, R0, t0, ts


def test_pose_graph_jacobian_matches_jax():
    graph, R0, t0, _ = chain_graph()
    g = pose_graph_from_numpy(*[np.asarray(a) for a in graph], device=CPU)
    xi = np.random.default_rng(1).standard_normal((8, 6)).astype(
        np.float32) * 0.01
    xi[0] = 0.0
    for at in (np.zeros_like(xi), xi):
        got = torch.func.jacfwd(posegraph._edge_residuals)(
            t32(at), t32(R0), t32(t0), g)
        want = jax.jacfwd(jpg._edge_residuals)(
            jnp.asarray(at), jnp.asarray(R0), jnp.asarray(t0), graph)
        close(got, want, atol=1e-4, rtol=1e-4)


def test_pose_graph_matches_jax():
    graph, R0, t0, ts = chain_graph()
    g = pose_graph_from_numpy(*[np.asarray(a) for a in graph], device=CPU)
    R, t, costs = sfm.optimize_pose_graph(g, R0, t0, n_iters=6)
    jR, jt, jcosts = jsfm.optimize_pose_graph(graph, R0, t0, n_iters=6)
    close(R, jR)
    close(t, jt)
    # the residuals are radians and units of order 1
    costs_close(costs, jcosts, 6 * len(g.edge_i), px_scale=1.0)
    assert float(costs[-1]) < 1e-3 * float(costs[0])


def test_close_loop_poses_matches_jax():
    from pyfeaturetrack_tpu.sfm.loop import close_loop_poses as jclp
    graph, R0, t0, _ = chain_graph()
    Rm, tm = np.asarray(jsfm.so3_exp(jnp.asarray([0.0, 0.02, 0.0]))) @ R0[7], \
        t0[7] + np.float32(0.1)
    got = sfm.close_loop_poses(R0, t0, 0, 7, Rm, tm, n_iters=8, device=CPU)
    want = jclp(R0, t0, 0, 7, Rm, tm, n_iters=8)
    close(got[0], want[0])
    close(got[1], want[1])


# ---------------------------------------------------------------------------
# dense bundle adjustment on the JAX package's problems
# ---------------------------------------------------------------------------

def jax_problem(noise, n_cams=6, n_pts=64, drop=0.0):
    Rs, ts, X = make_scene(n_cams, n_pts)
    uv = project_scene(Rs, ts, X, noise=noise)
    ci, pi, uvf, w = obs_arrays(uv)
    if drop:
        w = w * (np.random.default_rng(9).random(w.shape) > drop)
    problem = jsfm.BAProblem(jnp.asarray(K), jnp.asarray(ci),
                             jnp.asarray(pi), jnp.asarray(uvf),
                             jnp.asarray(w.astype(np.float32)))
    return problem, perturbed_init(Rs, ts, X)


@pytest.mark.parametrize("noise,huber,drop", [(0.0, None, 0.0),
                                               (0.3, None, 0.2),
                                               (0.3, 2.0, 0.0)])
def test_bundle_adjust_matches_jax(noise, huber, drop):
    problem, (R0, t0, X0) = jax_problem(noise, drop=drop)
    tp = ba_problem_from_numpy(*[np.asarray(a) for a in problem], device=CPU)
    R, t, X, costs = sfm.bundle_adjust(tp, R0, t0, X0, n_iters=6,
                                       huber_delta=huber)
    jR, jt, jX, jcosts = jsfm.bundle_adjust(problem, R0, t0, X0, n_iters=6,
                                            huber_delta=huber)
    costs_close(costs, jcosts, 2 * tp.w.shape[0])
    close(R, jR)
    close(t, jt)
    close(X, jX, atol=1e-4, rtol=1e-4)


def test_bundle_adjust_is_deterministic_and_matches_scatter_adds():
    """Two runs give the same bits; the segmented sums equal index_add_
    (the JAX package's scatter-add) within float32 rounding."""
    problem, (R0, t0, X0) = jax_problem(0.3, drop=0.1)
    tp = ba_problem_from_numpy(*[np.asarray(a) for a in problem], device=CPU)
    a = sfm.bundle_adjust(tp, R0, t0, X0, n_iters=3)
    b = sfm.bundle_adjust(tp, R0, t0, X0, n_iters=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    vals = torch.randn(tp.cam_idx.shape[0], 6, 3, dtype=torch.float64)
    seg = ba.segments(tp.pt_idx, 64)
    want = torch.zeros(64, 6, 3, dtype=torch.float64).index_add_(
        0, tp.pt_idx, vals)
    close(ba.segment_sum(vals, seg), want, atol=1e-12)
    assert seg.width == 6


def test_bundle_adjust_mesh_path_raises():
    problem, (R0, t0, X0) = jax_problem(0.0)
    tp = ba_problem_from_numpy(*[np.asarray(a) for a in problem], device=CPU)
    with pytest.raises(NotImplementedError):
        sfm.bundle_adjust(tp, R0, t0, X0, mesh=object())
    with pytest.raises(NotImplementedError):
        ba.pad_problem_for_mesh(tp, 64, 4)


def test_tf32_is_refused_on_the_card():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError):
            geometry.require_fp32("cuda")
        geometry.require_fp32("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    geometry.require_fp32("cuda")


# ---------------------------------------------------------------------------
# pipeline: feature table -> BA, trajectory metrics
# ---------------------------------------------------------------------------

def scene_table(noise=0.1):
    Rs, ts, X = make_scene(n_cams=6, n_pts=48)
    uv = project_scene(Rs, ts, X, noise=noise)
    val = np.zeros(uv.shape[:2], np.int32)
    val[3:, 5] = -1                         # a feature lost at frame 3
    val[4, 5] = 900                         # ... and refilled at frame 4
    uv[3, 5] = -1.0
    return Rs, ts, X, uv, val


@pytest.mark.parametrize("gate", [None, 3.0])
def test_run_sfm_matches_jax(gate):
    Rs, ts, X, uv, val = scene_table()
    R0, t0, _ = perturbed_init(Rs, ts, X, pose_noise=0.005)
    ft = FeatureTable(x=t32(uv[..., 0]), y=t32(uv[..., 1]),
                      val=torch.as_tensor(val))
    jft = JaxFeatureTable(x=jnp.asarray(uv[..., 0]),
                          y=jnp.asarray(uv[..., 1]), val=jnp.asarray(val))
    for a, b in zip(sfm.observations_from_feature_table(ft, 2),
                    jsfm.observations_from_feature_table(jft, 2)):
        np.testing.assert_array_equal(a, b)
    got = sfm.run_sfm(ft, K, R0, t0, n_iters=8, huber_delta=gate,
                      max_init_reproj_error=gate, device=CPU)
    want = jsfm.run_sfm(jft, K, R0, t0, n_iters=8, huber_delta=gate,
                        max_init_reproj_error=gate)
    assert got["n_observations"] == want["n_observations"]
    costs_close(got["costs"], want["costs"], 2 * got["n_observations"])
    close(got["R"], want["R"])
    # listed (ROADMAP Queue 3): with Huber 3 and the 3 px gate, camera
    # 2's forward translation (weakly observable at 0.1 px noise) ends
    # 1.4e-4 from JAX's after 8 IRLS steps; everything else within 1e-4
    close(got["t"], want["t"], atol=1e-4 if gate is None else 2e-4)
    assert sfm.ate_rmse(got["t"], ts) == pytest.approx(
        jsfm.ate_rmse(want["t"], ts), abs=2e-4)
    with pytest.raises(NotImplementedError):
        sfm.run_sfm_windowed(ft, K, R0, t0)


def test_trajectory_metrics_equal_jax():
    r = np.random.default_rng(8)
    gt = np.cumsum(r.standard_normal((30, 3)), 0)
    est = 0.7 * gt @ np.asarray(jsfm.so3_exp(jnp.asarray(
        [0.1, -0.3, 0.2])), np.float64).T + 2.0 + 0.01 * r.standard_normal(
        (30, 3))
    np.testing.assert_array_equal(sfm.umeyama_align(est, gt),
                                  jsfm.umeyama_align(est, gt))
    np.testing.assert_array_equal(
        sfm.umeyama_align(est, gt, with_scale=False),
        jsfm.umeyama_align(est, gt, with_scale=False))
    assert sfm.ate_rmse_aligned(est, gt) == jsfm.ate_rmse_aligned(est, gt)
    assert sfm.ate_rmse(est, gt) == jsfm.ate_rmse(est, gt)


def test_convert_functions():
    R, t = poses_from_numpy(np.eye(3)[None], np.zeros((1, 3)), device=CPU)
    assert R.dtype == torch.float32 and R.shape == (1, 3, 3)
    assert t.shape == (1, 3)
