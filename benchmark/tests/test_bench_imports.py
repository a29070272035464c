"""The run's import check: JAX and the JAX package refused by whole
top-level name, the port accepted."""

import subprocess
import sys
import types

import pytest

import run
from conftest import BENCH


@pytest.mark.parametrize("name,refused", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("pyfeaturetrack_tpu", True), ("pyfeaturetrack_tpu.ops", True),
    ("pyfeaturetrack_tpu_torch", False), ("pyfeaturetrack_tpu_torch.ops", False),
    ("jaxtyping", False)])
def test_forbidden_modules(monkeypatch, name, refused):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in run.forbidden_modules()) == refused


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); from reference import klt; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'pyfeaturetrack_tpu', "
            "'pyfeaturetrack_tpu_torch')))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
