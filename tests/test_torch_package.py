"""The PyTorch port's package surface: no JAX at import, kernel modules
import with no CUDA toolkit, configs and state cross over from the JAX
package, and every part outside the slice raises."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import pyfeaturetrack_tpu as jpft  # noqa: E402
from pyfeaturetrack_tpu.config import create_config as jax_create_config  # noqa: E402
from pyfeaturetrack_tpu.ops.kernels import get_kernel_widths as jax_widths  # noqa: E402

import pyfeaturetrack_tpu_torch as tpft  # noqa: E402
from pyfeaturetrack_tpu_torch.ops.kernels import get_kernel_widths  # noqa: E402
from pyfeaturetrack_tpu_torch.utils import cuda  # noqa: E402
from pyfeaturetrack_tpu_torch.utils.convert import (  # noqa: E402
    config_from_jax, features_from_numpy)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "pyfeaturetrack_tpu_torch"

_KERNEL_MODULES = ("pyfeaturetrack_tpu_torch.ops.cuda_pyramid",
                   "pyfeaturetrack_tpu_torch.ops.cuda_lk",
                   "pyfeaturetrack_tpu_torch.ops.cuda_eig",
                   "pyfeaturetrack_tpu_torch.ops.cuda_select",
                   "pyfeaturetrack_tpu_torch.ops.cuda_suppress",
                   "pyfeaturetrack_tpu_torch.ops.cuda_affine",
                   "pyfeaturetrack_tpu_torch.ops.cuda_lk_dense",
                   "pyfeaturetrack_tpu_torch.ops.cuda_window_terms")


def test_import_leaves_jax_out():
    code = ("import sys, importlib\n"
            "import pyfeaturetrack_tpu_torch\n"
            f"for m in {_KERNEL_MODULES!r} + ("
            "'pyfeaturetrack_tpu_torch.utils.convert', "
            "'pyfeaturetrack_tpu_torch.utils.io', "
            "'pyfeaturetrack_tpu_torch.utils.viz', "
            "'pyfeaturetrack_tpu_torch.models.tracker', "
            "'pyfeaturetrack_tpu_torch.models.sequence', "
            "'pyfeaturetrack_tpu_torch.ops.flow', "
            "'pyfeaturetrack_tpu_torch.ops.disparity', "
            "'pyfeaturetrack_tpu_torch.ops.refine', "
            "'pyfeaturetrack_tpu_torch.serving', "
            "'pyfeaturetrack_tpu_torch.models.chunked', "
            "'pyfeaturetrack_tpu_torch.utils.loader', "
            "'pyfeaturetrack_tpu_torch.utils.native', "
            "'pyfeaturetrack_tpu_torch.utils.staging', "
            "'pyfeaturetrack_tpu_torch.sfm', "
            "'pyfeaturetrack_tpu_torch.sfm.vo', "
            "'pyfeaturetrack_tpu_torch.utils.trajectory', "
            "'pyfeaturetrack_tpu_torch.utils.synthscene', "
            "'pyfeaturetrack_tpu_torch.sfm.ba_windowed', "
            "'pyfeaturetrack_tpu_torch.utils.checkpoint', "
            "'pyfeaturetrack_tpu_torch.utils.profiling', "
            "'pyfeaturetrack_tpu_torch.cli', "
            "'pyfeaturetrack_tpu_torch.parallel', "
            "'pyfeaturetrack_tpu_torch.parallel.scaling'):\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'pyfeaturetrack_tpu' not in sys.modules\n"
            "from pyfeaturetrack_tpu_torch.utils import cuda\n"
            "assert cuda._lib is None, 'kernel library loaded at import'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_sources():
    import re
    bad = re.compile(r"^\s*(import|from)\s+(jax|pyfeaturetrack_tpu)\b"
                     r"(?!_torch)", re.M)
    for path in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not bad.search(path.read_text()), path


def test_kernel_sources_present():
    names = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    srcs = ("pyramid.cu", "lk.cu", "eig.cu", "extract.cu", "suppress.cu",
            "affine.cu", "lk_dense.cu", "window_terms.cu")
    for want in srcs:
        assert want in names
    for src in srcs:
        head = (PKG / "csrc" / src).read_text()[:400]
        assert "Replaces pyfeaturetrack_tpu/ops/pallas_" in head, src


@pytest.mark.parametrize("module", _KERNEL_MODULES)
def test_kernel_modules_import_without_cuda(module):
    import importlib
    mod = importlib.import_module(module)
    assert mod.launches >= 0
    assert cuda.use_kernel(torch.zeros(2)) is False


def test_reference_path_context():
    assert cuda._force_reference is False
    with cuda.reference_path():
        assert cuda._force_reference is True
        assert cuda.use_kernel(torch.zeros(1)) is False
    assert cuda._force_reference is False


@pytest.mark.parametrize("search_range,overrides", [
    (15, {}), (2, {}), (25, {}), (60, {}), (120, {}),
    (15, {"window_width": 5, "window_height": 9, "mindist": 8}),
    (15, {"nPyramidLevels": 3, "subsampling": 2}),
    (15, {"lighting_insensitive": True, "min_displacement": 0.0,
          "nSkippedPixels": 2, "smoothBeforeSelecting": False}),
])
def test_config_matches_jax(search_range, overrides):
    jcfg = jax_create_config(search_range=search_range, **overrides)
    tcfg = tpft.create_config(search_range=search_range, **overrides)
    assert dataclasses.asdict(config_from_jax(jcfg)) == dataclasses.asdict(jcfg)
    assert config_from_jax(jcfg) == tcfg
    assert hash(config_from_jax(jcfg)) == hash(tcfg)
    assert tcfg.smooth_sigma == jcfg.smooth_sigma


def test_default_config_derivations():
    cfg = tpft.create_config()
    assert (cfg.borderx, cfg.bordery) == (24, 24)
    assert (cfg.nPyramidLevels, cfg.subsampling) == (2, 4)
    assert (cfg.window_width, cfg.window_height, cfg.mindist) == (7, 7, 10)
    assert cfg.replace(window_width=6).validated_window().window_width == 7


@pytest.mark.parametrize("sigma,widths", [(0.7, (5, 5)), (1.0, (7, 7)),
                                          (3.6, (21, 25)), (1.5, None),
                                          (7.2, None)])
def test_kernel_widths_match_jax(sigma, widths):
    assert get_kernel_widths(sigma) == jax_widths(sigma)
    if widths is not None:
        assert get_kernel_widths(sigma) == widths


def test_status_codes_match_jax():
    for name in ("KLT_TRACKED", "KLT_NOT_FOUND", "KLT_SMALL_DET",
                 "KLT_MAX_ITERATIONS", "KLT_OOB", "KLT_LARGE_RESIDUE",
                 "KLT_FB_INCONSISTENT"):
        assert getattr(tpft, name) == getattr(jpft, name)
    from pyfeaturetrack_tpu.features import STATUS_NAMES as jax_names
    from pyfeaturetrack_tpu_torch.features import STATUS_NAMES
    assert STATUS_NAMES == jax_names


def test_public_names_match_jax():
    """Every name of the JAX package's public surface is exported under the
    same name."""
    left_out = set()
    public = {n for n in dir(jpft) if not n.startswith("_")
              and not isinstance(getattr(jpft, n), type(sys))}
    assert public - left_out - set(dir(tpft)) == set()


# Left out of the port, with the reason: predict_scaling_efficiency is the
# HLO cost analysis against TPU v5e roofline constants (ROADMAP Queue 1
# item 9, TPU-only).
LEFT_OUT = {"parallel.scaling": {"predict_scaling_efficiency"}}


@pytest.mark.parametrize("sub", ["sfm", "utils.trajectory",
                                 "utils.synthscene", "sfm.ba_windowed",
                                 "utils.checkpoint", "utils.profiling",
                                 "cli", "parallel", "parallel.sharding",
                                 "parallel.multihost", "parallel.scaling"])
def test_subpackage_names_match_jax(sub):
    """The ``sfm`` and ``parallel`` subpackages export every name of the
    JAX package's ``__init__.py``; the trajectory, synthetic-scene,
    windowed BA, checkpoint, profiling, CLI, sharding, multihost and
    scaling modules every public function of theirs (``LEFT_OUT`` aside)."""
    import importlib
    jm = importlib.import_module(f"pyfeaturetrack_tpu.{sub}")
    tm = importlib.import_module(f"pyfeaturetrack_tpu_torch.{sub}")
    public = {n for n in dir(jm) if not n.startswith("_")
              and not isinstance(getattr(jm, n), type(sys))
              and getattr(getattr(jm, n), "__module__", "").startswith(
                  "pyfeaturetrack_tpu")}
    assert public, sub
    assert public - LEFT_OUT.get(sub, set()) - set(dir(tm)) == set()


def test_no_port_module_imports_jax():
    """No file of the port (nor chip_smoke.py) names jax or the JAX
    package in an import."""
    import ast
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "pyfeaturetrack_tpu"), (
                    f, name)


def test_feature_numpy_round_trip():
    from pyfeaturetrack_tpu_torch.features import (feature_state_from_numpy,
                                                   feature_state_to_numpy)
    arr = np.array([[1.5, 2.25, 7.0], [-1.0, -1.0, -4.0], [30.0, 40.0, 0.0]])
    fl = feature_state_from_numpy(arr, device="cpu")
    assert fl.x.dtype == torch.float32 and fl.val.dtype == torch.int32
    np.testing.assert_array_equal(feature_state_to_numpy(fl), arr)
    x, y, v = features_from_numpy(arr[:, 0], arr[:, 1], arr[:, 2], device="cpu")
    assert v.dtype == torch.int32 and v.tolist() == [7, -4, 0]


def test_feature_state_from_numpy_takes_aff_second():
    """The JAX signature ``(arr, aff=None)``: a positional second argument
    is the AffineState; the device is keyword-only and defaults to the
    card, as does ``empty_track_carry``'s."""
    import inspect

    from pyfeaturetrack_tpu.features import \
        feature_state_from_numpy as jax_from_numpy
    from pyfeaturetrack_tpu_torch.features import (empty_affine_state,
                                                   feature_state_from_numpy)
    from pyfeaturetrack_tpu_torch.ops.cuda_lk import empty_track_carry
    arr = np.array([[1.5, 2.25, 7.0], [-1.0, -1.0, -4.0]])
    aff = empty_affine_state(2, 5, 5, "cpu")
    fl = feature_state_from_numpy(arr, aff, device="cpu")
    assert fl.aff is aff and fl.x.device.type == "cpu"
    sig = inspect.signature(feature_state_from_numpy).parameters
    jsig = inspect.signature(jax_from_numpy).parameters
    positional = [n for n, p in sig.items()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert positional == list(jsig)
    assert sig["device"].kind is sig["device"].KEYWORD_ONLY
    assert sig["device"].default == "cuda"
    assert inspect.signature(empty_track_carry).parameters[
        "device"].default == "cuda"


@pytest.mark.parametrize("name,n_positional", [
    ("pyramids_from_numpy", 3), ("features_from_numpy", 3),
    ("affine_state_from_numpy", 8), ("feature_state_from_arrays", 4),
    ("feature_table_from_numpy", 3)])
def test_convert_functions_default_to_the_card(name, n_positional):
    """The state converters put their tensors on the card unless asked for
    the CPU; ``device`` is keyword-only, after the JAX fields."""
    import inspect

    from pyfeaturetrack_tpu_torch.utils import convert
    sig = inspect.signature(getattr(convert, name)).parameters
    positional = [n for n, p in sig.items()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert len(positional) == n_positional
    assert sig["device"].kind is sig["device"].KEYWORD_ONLY
    assert sig["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            features_from_numpy([1.0], [2.0], [3])


def test_pgm_round_trip(tmp_path):
    from pyfeaturetrack_tpu.utils.io import pgm_read as jax_pgm_read
    from pyfeaturetrack_tpu_torch.utils.io import pgm_read, pgm_write
    src = REPO / "examples" / "data" / "img0.pgm"
    img = pgm_read(src)
    np.testing.assert_array_equal(img, jax_pgm_read(src))
    pgm_write(tmp_path / "x.pgm", img)
    np.testing.assert_array_equal(pgm_read(tmp_path / "x.pgm"), img)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames = [np.zeros((64, 80), np.float32)] * 2
    with pytest.raises(RuntimeError):
        tpft.track_sequence_device(frames, n_features=4, device="cuda")


def test_make_affine_state_defaults_to_the_card():
    """make_affine_state, like create_feature_list, lands on the card
    unless the caller asks for the CPU: without a card the call raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tpft.create_config(affineConsistencyCheck=2)
    with pytest.raises((RuntimeError, AssertionError)):
        tpft.make_affine_state(4, cfg)
    aff = tpft.make_affine_state(4, cfg, device="cpu")
    assert aff.img.shape == (4, 15, 15) and aff.img.device.type == "cpu"


def test_out_of_slice_parts_raise():
    """bfloat16 storage raises; the chained step, guided tracking and the
    windowed bundle adjustment, with and without a landmark mesh, once out
    of the slice, run."""
    from pyfeaturetrack_tpu_torch.models.device_sequence import (
        sequence_chain_device)
    frames = [np.zeros((64, 80), np.float32)] * 2
    with pytest.raises(NotImplementedError):
        tpft.track_sequence_device(
            frames, cfg=tpft.create_config(image_dtype="bfloat16"),
            n_features=4, device="cpu")
    seq = tpft.create_config().replace(sequentialMode=True)
    pyr, x, y, v, _, _ = tpft.select_step_device(torch.zeros(64, 80), seq, 4)
    _, hist, final, _, ex, _ = sequence_chain_device(pyr, frames, x, y, v,
                                                     seq)
    assert hist[0].shape == (2, 4) and final[2].shape == (4,)
    assert not bool(ex)
    cfg = tpft.create_config()
    pyr = tpft.build_track_pyramids(torch.zeros(64, 80), cfg)
    z = torch.full((3,), 30.0)
    gx, gy, gv = tpft.track_features_pyramids(pyr, pyr, z, z, z.int(), cfg,
                                              x_init=z + 1.0, y_init=z)
    assert gx.shape == gy.shape == gv.shape == (3,)
    from pyfeaturetrack_tpu_torch import sfm
    from pyfeaturetrack_tpu_torch.sfm.ba_windowed import make_windowed_problem
    problem = make_windowed_problem(
        np.diag([100.0, 100.0, 1.0]), np.zeros(2, np.int64),
        np.full((2, 2, 2), 5.0), np.ones((2, 2)), device="cpu")
    R, t = np.stack([np.eye(3)] * 2), np.array([[0, 0, 0], [-0.1, 0, 0]])
    X = np.array([[0.0, 0.0, 5.0], [0.2, 0.1, 6.0]])
    *_, costs = sfm.bundle_adjust_windowed(problem, R, t, X, n_iters=1)
    assert costs.shape == (1,)
    from pyfeaturetrack_tpu_torch.parallel import split_mesh
    *_, mesh_costs = sfm.bundle_adjust_windowed(
        problem, R, t, X, n_iters=1,
        mesh=split_mesh((2,), ("landmark",), "cpu"))
    assert mesh_costs.shape == (1,)
