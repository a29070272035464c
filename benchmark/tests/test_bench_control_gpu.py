"""The control on the card at each cell's own size: the program with its
bfloat16 level storage switched on comes out not correct against the
cell's limits, and the float32 program on the same seed correct. Run on
a card: python -m pytest benchmark/tests -m gpu"""

import pytest

import control
import run
from conftest import bench_json


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in bench_json()["workloads"]])
def test_control_fails_sound_passes(card, cell):
    run._paths()
    parts = run.load_cell(cell)
    limits = parts["limits"]
    for lane, want in (("bfloat16", False), ("float32", True)):
        got = control.readings(parts, 2 ** 31 + 101, 1.0, lane)
        correct, _ = run.verdict(got, limits)
        assert correct is want, (lane, got)
