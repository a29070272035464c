"""The reader of ``chain.block_staged_share`` on stub counters: the block
stages over the replays in video cells, None in the live cell, where
nothing replayed, and where the program keeps no such counter (a program
that stages frame by frame)."""

from types import SimpleNamespace

import pytest

import run


def read(mode):
    run._paths()
    return run.load("metrics", "chain.block_staged_share").read(
        SimpleNamespace(mode=mode))


@pytest.mark.parametrize("got,mode,want", [
    ({"chain.block_stages": 40, "chain.replays": 40}, "video", 1.0),
    ({"chain.block_stages": 30, "chain.replays": 40}, "video", 0.75),
    ({"chain.block_stages": 40, "chain.replays": 40}, "lockstep", None),
    ({"chain.block_stages": 0, "chain.replays": 0}, "video", None),
    ({"chain.replays": 40}, "video", None),
])
def test_block_staged_share(monkeypatch, got, mode, want):
    from pyfeaturetrack_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "counters", lambda: dict(got))
    assert read(mode) == want
