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
            "'pyfeaturetrack_tpu_torch.parallel.scaling', "
            "'pyfeaturetrack_tpu_torch.ops', "
            "'pyfeaturetrack_tpu_torch.ops.pyramid', "
            "'pyfeaturetrack_tpu_torch.ops.select_device', "
            "'pyfeaturetrack_tpu_torch.utils.traceview'):\n"
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


# Left out of the port, each with its reason:
LEFT_OUT = {
    # TPU v5e roofline constants; the port's card has utils.roofline.H100
    "utils.roofline": {"V5E"},
    # JAX's 'fast' precision selects the TPU's bf16 conv pass
    # (lax.Precision.DEFAULT, ops/convolve.py:30-63 of the JAX package),
    # which XLA ignores on the CPU. The port's convolutions are IEEE
    # float32 shift-and-add passes and K1; nothing on the H100 corresponds
    # to that pass (the port's precision trade is the bfloat16 storage
    # lane, cfg.image_dtype).
    "ops.convolve": {"set_conv_precision"},
}

JAX_PKG = REPO / "pyfeaturetrack_tpu"


def _jax_modules():
    """Every module of the JAX package but the Pallas kernels
    (``ops/pallas_*``), the oracle and ``__main__``, as dotted paths
    below the package ("" for the package itself)."""
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).with_suffix("").parts
        if rel[0] == "oracle" or path.name.startswith("pallas_") \
                or path.name == "__main__.py":
            continue
        out.append(".".join(rel[:-1] if path.name == "__init__.py"
                            else rel))
    return out


def _public_names(sub: str) -> set:
    """The public top-level names a JAX module defines (def, class,
    assignment) and, for an ``__init__.py``, the names it re-exports."""
    import ast
    rel = Path(*sub.split(".")) if sub else Path()
    init = (JAX_PKG / rel / "__init__.py").exists()
    path = JAX_PKG / rel / "__init__.py" if init else \
        JAX_PKG / rel.with_suffix(".py")
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif init and isinstance(node, ast.ImportFrom) and node.level:
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


JAX_MODULES = _jax_modules()


def _pair(sub: str):
    import importlib
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module(f"pyfeaturetrack_tpu{suffix}"),
            importlib.import_module(f"pyfeaturetrack_tpu_torch{suffix}"))


@pytest.mark.parametrize("sub", JAX_MODULES, ids=lambda s: s or "package")
def test_subpackage_names_match_jax(sub):
    """Every public name of every JAX module outside the Pallas kernels
    and the oracle (its defs, classes and assignments, and an
    ``__init__.py``'s re-exports) exists in the port under the same module
    path (an import counts), ``LEFT_OUT`` aside."""
    names = _public_names(sub)
    _, tm = _pair(sub)
    missing = {n for n in names if not hasattr(tm, n)}
    assert missing == LEFT_OUT.get(sub, set())


def test_module_list_covers_the_package():
    assert {"ops", "ops.select_device", "utils", "utils.traceview",
            "utils.native", "models.sequence", "serving", "features",
            "config", "errors", "cli", "parallel.scaling"} <= set(
                JAX_MODULES)
    assert not any(m.startswith(("oracle", "ops.pallas_"))
                   for m in JAX_MODULES)


@pytest.mark.parametrize("sub", JAX_MODULES, ids=lambda s: s or "package")
def test_functions_take_jax_parameter_names(sub):
    """A public function of a JAX module and the port's function of the
    same name take JAX's parameter names: every JAX parameter exists in
    the port, and JAX's positional parameters open the port's in the same
    order (the port adds keyword-only ones, such as ``device``)."""
    import inspect
    jm, tm = _pair(sub)
    bad = []
    for name in sorted(_public_names(sub) - LEFT_OUT.get(sub, set())):
        a, b = getattr(jm, name), getattr(tm, name)
        if isinstance(a, type) or not (callable(a) and callable(b)) \
                or isinstance(b, type):
            continue
        try:
            ja = inspect.signature(a).parameters
        except (TypeError, ValueError):
            continue
        tb = inspect.signature(b).parameters
        pos = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)
        jpos = [k for k, v in ja.items() if v.kind in pos]
        tpos = [k for k, v in tb.items() if v.kind in pos]
        missing = [k for k, v in ja.items() if k not in tb
                   and v.kind not in (v.VAR_POSITIONAL, v.VAR_KEYWORD)]
        if tpos[:len(jpos)] != jpos or missing:
            bad.append((name, list(ja), list(tb)))
    assert bad == []


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
    """bfloat16 storage, the chained step, guided tracking and the windowed
    bundle adjustment, with and without a landmark mesh, once out of the
    slice, run; an image_dtype the port does not store raises."""
    from pyfeaturetrack_tpu_torch.models.device_sequence import (
        sequence_chain_device)
    frames = [np.zeros((64, 80), np.float32)] * 2
    table = tpft.track_sequence_device(
        frames, cfg=tpft.create_config(image_dtype="bfloat16"),
        n_features=4, device="cpu")
    assert [t.shape for t in table] == [(2, 4)] * 3
    bf16 = tpft.build_track_pyramids(
        torch.zeros(64, 80), tpft.create_config(image_dtype="bfloat16"))
    assert {t.dtype for lv in bf16 for t in lv} == {torch.bfloat16}
    with pytest.raises(ValueError, match="image_dtype"):
        tpft.build_track_pyramids(
            torch.zeros(64, 80), tpft.create_config(image_dtype="float16"))
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
