"""The port's trajectory interchange (``utils/trajectory.py``) and
synthetic KITTI-style scenes (``utils/synthscene.py``) against the JAX
package's: arrays equal, KITTI and TUM files equal byte for byte, and a
short corridor VO drive through ``run_vo_on_corridor`` with the JAX
run's keyframes and landmarks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfeaturetrack_tpu.sfm.geometry import so3_exp
from pyfeaturetrack_tpu.utils import synthscene as jscene
from pyfeaturetrack_tpu.utils import trajectory as jtraj

from pyfeaturetrack_tpu_torch.errors import KLTError
from pyfeaturetrack_tpu_torch.utils import synthscene, trajectory

torch.set_num_threads(2)


def _poses(m=12, seed=4):
    r = np.random.default_rng(seed)
    w = r.uniform(-2.5, 2.5, (m, 3)).astype(np.float32)
    w[0] = [np.pi - 1e-3, 0, 0]          # near-180-degree branches
    w[1] = [0, 0, np.pi - 1e-4]
    R = np.asarray(so3_exp(jnp.asarray(w)), np.float64)
    t = r.standard_normal((m, 3)) * 3
    return R, t


def test_quaternions_equal_jax():
    R, _ = _poses()
    q = trajectory.rotation_to_quaternion(R)
    np.testing.assert_array_equal(q, jtraj.rotation_to_quaternion(R))
    np.testing.assert_array_equal(trajectory.quaternion_to_rotation(q),
                                  jtraj.quaternion_to_rotation(q))


def test_kitti_and_tum_files_equal_jax(tmp_path):
    R, t = _poses()
    trajectory.write_kitti(tmp_path / "a.kitti", R, t)
    jtraj.write_kitti(tmp_path / "b.kitti", R, t)
    assert (tmp_path / "a.kitti").read_bytes() == \
        (tmp_path / "b.kitti").read_bytes()
    trajectory.write_tum(tmp_path / "a.tum", R, t,
                         timestamps=np.arange(12) * 0.1)
    jtraj.write_tum(tmp_path / "b.tum", R, t, timestamps=np.arange(12) * 0.1)
    assert (tmp_path / "a.tum").read_bytes() == \
        (tmp_path / "b.tum").read_bytes()
    for got, want in zip(trajectory.read_kitti(tmp_path / "a.kitti"),
                         jtraj.read_kitti(tmp_path / "b.kitti")):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(trajectory.read_tum(tmp_path / "a.tum"),
                         jtraj.read_tum(tmp_path / "b.tum")):
        np.testing.assert_array_equal(got, want)
    (tmp_path / "bad.kitti").write_text("1 2 3\n")
    with pytest.raises(KLTError):
        trajectory.read_kitti(tmp_path / "bad.kitti")
    with pytest.raises(KLTError):
        trajectory.write_tum(tmp_path / "c.tum", R, t, timestamps=[0.0])


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe_equals_jax(delta):
    R, t = _poses()
    Rg, tg = _poses(seed=5)
    for got, want in zip(trajectory.rpe(R, t, Rg, tg, delta),
                         jtraj.rpe(R, t, Rg, tg, delta)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KLTError):
        trajectory.rpe(R[:2], t[:2], Rg[:2], tg[:2], delta=2)


def test_scenes_equal_jax():
    for got, want in zip(synthscene.corridor_scene(40),
                         jscene.corridor_scene(40)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(synthscene.circuit_scene(60),
                         jscene.circuit_scene(60)):
        np.testing.assert_array_equal(got, want)
    K, Rs, ts, _, pts = synthscene.corridor_scene(6, h=120, w=160)
    frames = synthscene.render_blobs(K, Rs, ts, pts, 120, 160)
    jframes = jscene.render_blobs(K, Rs, ts, pts, 120, 160)
    for got, want in zip(frames, jframes):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(synthscene.apply_photometric_drift(frames),
                         jscene.apply_photometric_drift(jframes)):
        np.testing.assert_array_equal(got, want)


def test_corridor_drive_matches_jax():
    """run_vo_on_corridor at 36 frames on the CPU: the JAX run's keyframe
    and landmark counts, travel equal, ATE within 1e-3 units."""
    kw = dict(n_frames=36, n_features=100, kf_every=3)
    got = synthscene.run_vo_on_corridor(**kw, device="cpu")
    want = jscene.run_vo_on_corridor(**kw)
    for key in ("n_frames", "keyframes", "landmarks", "travel_units"):
        assert got[key] == want[key], key
    assert abs(got["ate_units"] - want["ate_units"]) < 1e-3
    assert got["ate_pct_travel"] < 1.0
    assert got["vo"].initialized and len(got["vo"].kf) == got["keyframes"]
