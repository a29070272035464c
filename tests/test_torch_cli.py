"""The port's command-line driver (``python -m pyfeaturetrack_tpu_torch``)
with ``--device cpu`` on tests/test_cli.py's scenarios, each output file
held to the JAX CLI's on the same PGM frames at the tracking bars:
statuses exact, positions within 1e-4 px; flow maps at the dense bars of
tests/test_torch_flow.py (statuses exact, u and v within 1e-4 px but for
at most 0.1 % of the pixels, within 1e-2); depth maps on the pixels both
call valid within 1e-3 units; VO keyframes equal and centres within 1e-3
(tests/test_torch_vo.py's bar)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_textured_image, shift_image_bilinear

from pyfeaturetrack_tpu.cli import main as jax_main

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.cli import main
from pyfeaturetrack_tpu_torch.errors import KLTError
from pyfeaturetrack_tpu_torch.utils.io import pgm_write, read_feature_table

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
POS_TOL = 1e-4
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def pgm_frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    base = make_textured_image(96, 128, seed=71)
    paths = []
    for i in range(5):
        p = d / f"img{i}.pgm"
        pgm_write(p, np.floor(shift_image_bilinear(base, 0.8 * i, -0.4 * i)))
        paths.append(str(p))
    return paths


def summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def both(args, out, capsys):
    """Run the port's CLI (on the CPU) and the JAX CLI with ``args``, into
    out/port and out/jax; return both summaries."""
    assert main(args + ["--out", str(out / "port")] + CPU) == 0
    s_port = summary(capsys)
    assert jax_main(args + ["--out", str(out / "jax")]) == 0
    return s_port, summary(capsys)


def tables_close(a, b):
    ta = read_feature_table(a, device="cpu")
    tb = read_feature_table(b, device="cpu")
    np.testing.assert_array_equal(ta.val.numpy(), tb.val.numpy())
    for u, v in ((ta.x, tb.x), (ta.y, tb.y)):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=0,
                                   atol=POS_TOL)
    return ta


def test_cli_tracks_sequence(pgm_frames, tmp_path, capsys):
    s, js = both(pgm_frames + ["--features", "25", "--overlays"], tmp_path,
                 capsys)
    assert s == js
    assert s["frames"] == 5 and s["live_last_frame"] >= 15
    ft = tables_close(tmp_path / "port" / "features.ft",
                      tmp_path / "jax" / "features.ft")
    assert ft.nFrames == 5 and ft.nFeatures == 25
    assert (tmp_path / "port" / "feat3.ppm").exists()
    assert (tmp_path / "port" / "features.txt").read_text() == \
        (tmp_path / "jax" / "features.txt").read_text()


@pytest.mark.parametrize("batched", [False, True])
def test_cli_chunked(pgm_frames, tmp_path, capsys, batched):
    s, js = both(pgm_frames + ["--features", "20", "--chunks", "2"]
                 + (["--batched"] if batched else []), tmp_path, capsys)
    assert s == js and s["chunks"] == 2
    a = np.load(tmp_path / "port" / "tracks.npz")
    b = np.load(tmp_path / "jax" / "tracks.npz")
    assert a["x"].shape[0] == 5 and sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(a["val"], b["val"])
    np.testing.assert_allclose(a["x"], b["x"], rtol=0, atol=POS_TOL)


def test_reference_named_config_functions():
    cfg = tpft.KLTCreateTrackingContext()
    cfg2 = tpft.KLTChangeTCPyramid(cfg, search_range=30)
    assert cfg2.nPyramidLevels >= cfg.nPyramidLevels
    assert tpft.KLTUpdateTCBorder(cfg2).borderx > 0
    assert "mindist" in tpft.KLTPrintTrackingContext(cfg)


def test_track_size_mismatch_raises():
    cfg = tpft.create_config()
    fl = tpft.KLTCreateFeatureList(4, device="cpu")
    with pytest.raises(KLTError, match="size mismatch"):
        tpft.KLTTrackFeatures(cfg, np.zeros((64, 96)), np.zeros((64, 128)),
                              fl)


def test_cli_lighting_flag(pgm_frames, tmp_path, capsys):
    s, js = both(pgm_frames[:3] + ["--features", "15",
                                   "--lighting-insensitive"], tmp_path,
                 capsys)
    assert s == js and s["live_last_frame"] >= 8
    tables_close(tmp_path / "port" / "features.ft",
                 tmp_path / "jax" / "features.ft")


def test_cli_device_loop_and_stream_match_host(pgm_frames, tmp_path,
                                               capsys):
    """--device-loop and --stream --chain 2 give the host loop's table
    (and JAX's)."""
    for mode in (["--device-loop"], ["--stream", "--chain", "2"]):
        out = tmp_path / mode[0].strip("-")
        s, js = both(pgm_frames + ["--features", "20"] + mode, out, capsys)
        assert s == js
        tables_close(out / "port" / "features.ft",
                     out / "jax" / "features.ft")
    assert main(pgm_frames + ["--features", "20", "--out",
                              str(tmp_path / "host")] + CPU) == 0
    host = read_feature_table(tmp_path / "host" / "features.ft",
                              device="cpu")
    for mode in ("device-loop", "stream"):
        t = read_feature_table(tmp_path / mode / "port" / "features.ft",
                               device="cpu")
        for a, b in zip(t, host):
            assert torch.equal(a, b)


def test_cli_flow_mode(pgm_frames, tmp_path, capsys):
    s, js = both(pgm_frames[:3] + ["--flow", "--overlays"], tmp_path,
                 capsys)
    assert s["flow"] is True and s["pairs"] == 2
    assert s["mean_tracked_fraction"] == js["mean_tracked_fraction"]
    with np.load(tmp_path / "port" / "flow.npz") as z, \
            np.load(tmp_path / "jax" / "flow.npz") as jz:
        u, v, st = z["u"], z["v"], z["status"]
        np.testing.assert_array_equal(st, jz["status"])
        for a, b in ((u, jz["u"]), (v, jz["v"])):
            off = np.abs(a - b) > POS_TOL
            assert off.mean() <= 1e-3
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)
    assert u.shape == (2, 96, 128) and st.dtype == np.int32
    m = st[0] == 0
    assert abs(np.median(u[0][m]) - 0.8) < 0.1
    assert abs(np.median(v[0][m]) + 0.4) < 0.1
    assert (tmp_path / "port" / "flow1.ppm").exists()


def test_cli_flag_conflicts(pgm_frames, tmp_path):
    for bad in (["--flow", "--vo"],
                ["--vo", "--fx", "260", "--right"] + pgm_frames,
                ["--right"] + pgm_frames + ["--baseline", "0.3"],
                ["--vo", "--fx", "260", "--baseline", "0.3", "--right"]
                + pgm_frames[:2],
                ["--stream", "--device-loop"], ["--batched"],
                ["--device-loop", "--chunks", "2"],
                ["--subpixel", "--chunks", "2"]):
        with pytest.raises(SystemExit):
            main(pgm_frames + bad + ["--out", str(tmp_path)] + CPU)
    for bad in (["x.pgm", "--vo"], ["x.pgm", "--traj-format", "tum"],
                ["x.pgm", "--depth", "--fx", "100"],
                ["x.pgm", "--depth", "--right", "y.pgm", "--baseline",
                 "0.5"],
                ["x.pgm", "--depth", "--vo", "--fx", "100", "--right",
                 "y.pgm", "--baseline", "0.5"]):
        with pytest.raises(SystemExit):
            main(bad + CPU)


def test_cli_vo_mode(tmp_path, capsys):
    from test_vo import K as K_vo
    from test_vo import _gt_scene, _render
    from pyfeaturetrack_tpu_torch.sfm.pipeline import ate_rmse_aligned
    from pyfeaturetrack_tpu_torch.utils.trajectory import read_tum
    Rs, ts, cs, pts = _gt_scene()
    paths = []
    for i, f in enumerate(_render(Rs, ts, pts)):
        p = tmp_path / f"f{i:02d}.pgm"
        pgm_write(p, f)
        paths.append(str(p))
    s, js = both(paths + ["--vo", "--fx", str(K_vo[0, 0]), "--kf-every",
                          "2", "--features", "120", "--traj-format", "tum"],
                 tmp_path, capsys)
    # travel is printed to 4 decimals of centres that agree within 1e-3
    assert abs(s.pop("travel_units") - js.pop("travel_units")) < 1e-3
    assert s == js
    z = np.load(tmp_path / "port" / "trajectory.npz")
    jz = np.load(tmp_path / "jax" / "trajectory.npz")
    assert z["R"].shape[0] == z["centers"].shape[0] >= 5
    assert z["landmarks"].shape[0] >= 50
    np.testing.assert_array_equal(z["keyframe_frames"], jz["keyframe_frames"])
    np.testing.assert_allclose(z["centers"], jz["centers"], atol=1e-3)
    gt = cs[z["keyframe_frames"]]
    assert ate_rmse_aligned(z["centers"], gt) < 0.05
    ts_r, R_r, _, C_r = read_tum(tmp_path / "port" / "trajectory.tum")
    np.testing.assert_array_equal(ts_r, z["keyframe_frames"])
    np.testing.assert_allclose(R_r, z["R"], atol=1e-5)
    np.testing.assert_allclose(C_r, z["centers"], atol=1e-6)


def test_cli_depth_mode(tmp_path, capsys):
    tex = make_textured_image(72, 140, seed=33)
    lefts, rights = [], []
    for i in range(2):
        lp, rp = tmp_path / f"l{i}.pgm", tmp_path / f"r{i}.pgm"
        pgm_write(lp, tex[:, :120])
        pgm_write(rp, tex[:, 6:126])
        lefts.append(str(lp))
        rights.append(str(rp))
    s, js = both(lefts + ["--depth", "--right"] + rights +
                 ["--baseline", "0.5", "--fx", "120", "--max-disparity",
                  "12", "--overlays"], tmp_path, capsys)
    assert s["depth"] is True and s["pairs"] == 2
    assert s["mean_valid_fraction"] > 0.4
    assert abs(s["median_depth"] - 120 * 0.5 / 6.0) < 0.2
    assert s == js
    z = np.load(tmp_path / "port" / "depth.npz")
    jz = np.load(tmp_path / "jax" / "depth.npz")
    assert z["depth"].shape == (2, 72, 120)
    both_valid = z["valid"] & jz["valid"]
    assert both_valid.sum() >= 0.99 * jz["valid"].sum()
    np.testing.assert_allclose(z["depth"][both_valid],
                               jz["depth"][both_valid], rtol=0, atol=1e-3)
    assert (tmp_path / "port" / "disp0.ppm").exists()


def test_cli_subpixel_flag(pgm_frames, tmp_path, capsys):
    s, js = both(pgm_frames[:3] + ["--features", "15", "--subpixel"],
                 tmp_path, capsys)
    assert s == js and s["frames"] == 3
    ft = read_feature_table(tmp_path / "port" / "features.ft", device="cpu")
    x0 = ft.x[0].numpy()
    live = ft.val[0].numpy() >= 0
    assert (np.abs(x0[live] - np.round(x0[live])) > 1e-4).any()


def test_python_m_runs_the_port(pgm_frames, tmp_path):
    """``python -m pyfeaturetrack_tpu_torch`` is the CLI, and imports no
    JAX."""
    code = ("import runpy, sys\n"
            "sys.argv = ['pft'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('pyfeaturetrack_tpu_torch', "
            "run_name='__main__')\n"
            "finally:\n"
            "    assert 'jax' not in sys.modules\n")
    res = subprocess.run(
        [sys.executable, "-c", code, *pgm_frames[:2], "--features", "10",
         "--out", str(tmp_path), *CPU], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["frames"] == 2
