"""The visual odometry cell's harness on the CPU.

The plain reference (``reference/vo.py``, float64) agrees with the
program's ``refine_pose``, ``triangulate_dlt`` and ``bundle_adjust`` on
seeded scenes at 240x320; a tiny drive (128x416 frames, 150 features, a
41-frame drive) runs through the whole harness, traced, correct, with the
five ``vo.*`` metrics; and the check (``checks/vo_keyframes.py``) catches
five faults planted in the program: the window BA one iteration short,
its first camera left free, Huber weights off, the mapping's filter
skipped (every DLT point joins the map), and its reprojection gate
skipped (a point in front of its cameras joins however far it lands
from its pixels). Also: a program without ``keyframe_record`` fails at once, and
the reference imports nothing of the program."""

import copy
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import run
from conftest import BENCH
from modes import vo_drive
from reference import vo as rvo
from pyfeaturetrack_tpu_torch.sfm import ba as pba
from pyfeaturetrack_tpu_torch.sfm import vo as pvo
from pyfeaturetrack_tpu_torch.sfm.geometry import so3_exp
from pyfeaturetrack_tpu_torch.sfm.pnp import refine_pose
from pyfeaturetrack_tpu_torch.sfm.triangulate import triangulate_dlt

CELL = "kitti_vo2000_drive"
SEED = 2 ** 32 + 26
K = np.array([[260.0, 0, 160.0], [0, 260.0, 120.0], [0, 0, 1]])
VO_METRICS = ("vo.keyframe_ms", "vo.ba_ms_per_keyframe",
              "vo.track_us_per_frame", "vo.ba_observations_per_keyframe",
              "vo.host_syncs_per_keyframe")


def _scene(seed: int, cams: int, points: int, outliers: float = 0.05):
    """Cameras sliding sideways past a 240x320 view of points 4-12 units
    away; pixels with 0.3 px noise, a share of them 20-40 px off."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, points), rng.uniform(-2, 2, points),
                  rng.uniform(4, 12, points)], -1)
    w = torch.tensor(0.01 * rng.standard_normal((cams, 3)))
    R = so3_exp(w).numpy()
    t = np.stack([[-0.3 * i, 0.02 * i, -0.1 * i] for i in range(cams)], 0)
    Y = np.einsum("cij,lj->lci", R, X) + t[None]
    uv = np.stack([K[0, 0] * Y[..., 0] / Y[..., 2] + K[0, 2],
                   K[1, 1] * Y[..., 1] / Y[..., 2] + K[1, 2]], -1)
    uv += 0.3 * rng.standard_normal(uv.shape)
    bad = rng.random(uv.shape[:2]) < outliers
    uv[bad] += rng.uniform(20, 40, (int(bad.sum()), 2))
    return rng, X, R, t, uv


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_refine_pose(seed):
    rng, X, R, t, uv = _scene(seed, 1, 300)
    R0 = so3_exp(torch.tensor([0.01, -0.02, 0.015])).numpy() @ R[0]
    t0 = t[0] + np.array([0.05, -0.03, 0.1])
    w = np.ones(300, np.float32)
    got = refine_pose(K, R0, t0, X, uv[:, 0], w, n_iters=12,
                      huber_delta=2.0, device="cpu")
    want = rvo.refine_pose(K, R0, t0, X, uv[:, 0], w, 12, 2.0)
    assert float(rvo.rotation_gap(rvo.t64(got[0], "cpu"), want[0])) < 1e-5
    # translations in scene units (points 4-12 away)
    assert np.abs(got[1].numpy() - want[1].numpy()).max() < 1e-5
    # and it moved: the start was off by 0.12 units
    assert np.linalg.norm(got[1].numpy() - t[0]) < 0.03


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_triangulate_dlt(seed):
    rng, X, R, t, uv = _scene(seed, 5, 400, outliers=0.0)
    mask = rng.random((400, 5)) < 0.7
    mask[:, :2] = True
    got = triangulate_dlt(K, R.astype(np.float32), t.astype(np.float32),
                          uv.astype(np.float32), mask, device="cpu").numpy()
    want = rvo.triangulate_dlt(K, R.astype(np.float32),
                               t.astype(np.float32), uv.astype(np.float32),
                               mask).numpy()
    gap = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert np.quantile(gap, 0.99) < 1e-4
    assert np.median(np.linalg.norm(want - X, axis=1)) < 0.2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_bundle_adjust(seed):
    rng, X, R, t, uv = _scene(seed, 6, 250)
    C, L = 6, 250
    cam = np.tile(np.arange(C), L)
    pt = np.repeat(np.arange(L), C)
    keep = rng.random(C * L) < 0.8
    cam, pt = cam[keep], pt[keep]
    obs = uv[pt, cam].astype(np.float32)
    w = np.ones(len(cam), np.float32)
    R0 = (so3_exp(torch.tensor(0.003 * rng.standard_normal((C, 3))))
          .numpy() @ R).astype(np.float32)
    R0[0] = R[0]
    t0 = (t + 0.02 * rng.standard_normal((C, 3))).astype(np.float32)
    t0[0] = t[0]
    X0 = (X + 0.05 * rng.standard_normal((L, 3))).astype(np.float32)
    prob = pba.make_problem(K, cam, pt, obs, w, device="cpu")
    Rg, tg, Xg, _ = pba.bundle_adjust(prob, R0, t0, X0, n_iters=8,
                                      fix_first=True, huber_delta=2.0)
    Rw, tw, Xw = rvo.bundle_adjust(K, cam, pt, obs, w, R0, t0, X0, 8, 2.0)
    assert float(rvo.rotation_gap(rvo.t64(Rg, "cpu"), Rw).max()) < 1e-5
    assert _rel(rvo.centres(rvo.t64(Rg, "cpu"), rvo.t64(tg, "cpu")),
                rvo.centres(Rw, tw)) < 1e-4
    gap = np.linalg.norm(Xg.numpy() - Xw.numpy(), axis=1) / np.linalg.norm(
        Xw.numpy(), axis=1)
    assert np.quantile(gap, 0.99) < 1e-4
    np.testing.assert_array_equal(Rg[0].numpy(), R0[0])

    # both lowered the robust reprojection cost of their start
    def cost(R_, t_, X_):
        r = rvo.observation_terms(
            rvo.t64(K, "cpu"), rvo.t64(R_, "cpu"), rvo.t64(t_, "cpu"),
            rvo.t64(X_, "cpu"), torch.as_tensor(cam), torch.as_tensor(pt),
            rvo.t64(obs, "cpu"), rvo.t64(w, "cpu"), 2.0)[0]
        return float((r * r).sum())
    assert cost(Rw, tw, Xw) < 0.5 * cost(R0, t0, X0)


def tiny_parts() -> dict:
    """The cell at 128x416 (the camera scaled with the frame), 150
    features, KLT's default 2 levels at subsampling 4, a 41-frame drive."""
    parts = copy.deepcopy(run.load_cell(CELL))
    s = 416 / 1241
    cfg = parts["config"]
    cfg["frame"] = {"height": 128, "width": 416, "dtype": "uint8"}
    cam = cfg["camera"]
    cfg["camera"] = {"fx": cam["fx"] * s, "fy": cam["fy"] * s,
                     "cx": cam["cx"] * s, "cy": cam["cy"] * 128 / 376}
    cfg["n_features"] = 150
    cfg["klt"].update(nPyramidLevels=2, subsampling=4, borderx=24,
                      bordery=24)
    cfg["vo"].update(min_parallax_px=cfg["vo"]["min_parallax_px"] * s,
                     min_tri_parallax_px=cfg["vo"]["min_tri_parallax_px"] * s)
    parts["traffic"].update(drive_frames=41, trace_frames=[21, 31])
    return parts


def tiny_run(trace: bool = False, seconds: float = 2.0) -> dict:
    torch.set_num_threads(2)
    return run.run(tiny_parts(), SEED, seconds, trace, "cpu",
                   time.perf_counter())


def test_sound_traced_run_is_correct_with_every_vo_metric():
    res = tiny_run(trace=True)
    assert res["correct"] is True, res["checks"]
    assert set(VO_METRICS) <= set(res["metrics"]), res["metrics"]
    got = res["checked"]
    assert got["keyframes_held"] >= 8 and got["drives"] >= 1
    assert got["tri_points"] > 0 and got["ba_gap_median"] >= 0.0
    m = res["metrics"]
    assert m["vo.ba_observations_per_keyframe"]["value"] > 100
    assert m["vo.host_syncs_per_keyframe"]["value"] >= 1.0


def _wrap_ba(monkeypatch, **change):
    real = pvo.bundle_adjust

    def ba(problem, R0, t0, X0, n_iters=10, **kw):
        if "n_iters" in change:
            n_iters = n_iters + change["n_iters"]
        kw.update({k: v for k, v in change.items() if k != "n_iters"})
        return real(problem, R0, t0, X0, n_iters=n_iters, **kw)
    monkeypatch.setattr(pvo, "bundle_adjust", ba)


def _huber_off(monkeypatch):
    _wrap_ba(monkeypatch, huber_delta=None)
    real = pvo.refine_pose

    def refine(*a, **kw):
        kw["huber_delta"] = None
        return real(*a, **kw)
    monkeypatch.setattr(pvo, "refine_pose", refine)


def _map_filter_skipped(monkeypatch):
    """Every DLT point joins the map: behind its cameras or far off its
    pixels."""
    monkeypatch.setattr(pvo.VisualOdometry, "_consistent",
                        lambda self, X, *a: np.ones(len(X), bool))


def _tri_gate_skipped(monkeypatch):
    """Every DLT point in front of its cameras joins the map, however far
    it lands from its pixels."""
    def consistent(self, X, Rs, ts, uvs, mask, gate_px):
        return real(self, X, Rs, ts, uvs, mask, np.inf)
    real = pvo.VisualOdometry._consistent
    monkeypatch.setattr(pvo.VisualOdometry, "_consistent", consistent)


FAULTS = {
    "ba_one_iteration_short": (
        lambda mp: _wrap_ba(mp, n_iters=-1), "ba_gap_p99"),
    "ba_first_camera_free": (
        lambda mp: _wrap_ba(mp, fix_first=False), "ba_gap_p99"),
    "huber_off": (_huber_off, "ba_gap_p99"),
    "map_filter_skipped": (_map_filter_skipped, "tri_gap_p99"),
    "tri_gate_skipped": (_tri_gate_skipped, "tri_gap_p99"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_check_catches_planted_fault(monkeypatch, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    res = tiny_run()
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > 10 * c["limit"], res["checks"]


def test_program_without_keyframe_record_fails_at_once(monkeypatch):
    monkeypatch.delattr(pvo.VisualOdometry, "keyframe_record")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="keyframe_record"):
        tiny_run()
    assert time.perf_counter() - t0 < 30.0


def test_drive_renders_the_same_frames_for_a_seed_and_other_textures():
    parts = tiny_parts()
    tr, cfg = parts["traffic"], parts["config"]
    R, t, c = vo_drive.drive_path(tr, 3)
    # 1.0 m a frame along the road's axis, the yaw on its tangent
    np.testing.assert_allclose(np.diff(c[:, 2]), 1.0)
    fwd = R[:, 2]                      # the optical axis in the world
    slope = np.diff(c[:, 0])[0] / np.diff(c[:, 2])[0]
    assert abs(fwd[0, 0] / fwd[0, 2] - slope) < 0.01
    import scene

    def frames(seed):
        tex = scene.render_streams(seed, 1, tr, 128, 416, "cpu")
        return vo_drive.render_drive(tex[0], tr, vo_drive.camera_matrix(cfg),
                                     R, t, c, 128, 416, "cpu")
    a, b, d = frames(SEED), frames(SEED), frames(SEED + 1)
    np.testing.assert_array_equal(a, b)
    assert (a != d).mean() > 0.5
    assert a[:, -1].std() > 5          # the textured road in the last row


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); from reference import vo; "
            "from checks import vo_keyframes; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'pyfeaturetrack_tpu', "
            "'pyfeaturetrack_tpu_torch')))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
