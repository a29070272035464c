"""The traffic generator is deterministic in the seed and keeps to the
traffic's parameters."""

import math

import numpy as np
import pytest
import torch

import scene

TRAFFIC = {"motion_px": [1, 4], "clip_frames": 8}


def test_same_seed_same_frames():
    a = scene.render_clip(2 ** 31 + 77, 0, 6, 48, 64, TRAFFIC, "cpu")
    b = scene.render_clip(2 ** 31 + 77, 0, 6, 48, 64, TRAFFIC, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (6, 48, 64)
    assert torch.equal(a, b)


@pytest.mark.parametrize("other", [(2 ** 31 + 78, 0), (2 ** 31 + 77, 1)])
def test_other_seed_or_stream_other_frames(other):
    a = scene.render_clip(2 ** 31 + 77, 0, 4, 48, 64, TRAFFIC, "cpu")
    b = scene.render_clip(other[0], other[1], 4, 48, 64, TRAFFIC, "cpu")
    assert not torch.equal(a, b)


def test_streams_layout():
    tr = dict(TRAFFIC, clip_frames=3)
    one = scene.render_streams(5, 1, tr, 32, 40, "cpu")
    many = scene.render_streams(5, 2, tr, 32, 40, "cpu")
    assert one.shape == (3, 32, 40) and many.shape == (3, 2, 32, 40)
    assert np.array_equal(many[:, 0], one)
    assert many[0].flags.c_contiguous


@pytest.mark.parametrize("heading", [0.0, 2.0])
def test_pan_speed_within_motion(heading):
    path = scene.pan_path(200, (1.0, 4.0), heading)
    speed = np.hypot(*np.diff(path, axis=0).T)
    assert speed.min() >= 1.0 - 1e-9 and speed.max() <= 4.0 + 1e-9


def test_the_seed_leaves_the_motion_alone():
    """Seeds change the texture, never the pan: a frame's work does not
    depend on the seed."""
    tr = dict(TRAFFIC, clip_frames=6)
    a = scene.render_clip(1, 0, 6, 40, 48, tr, "cpu").float()
    b = scene.render_clip(2, 0, 6, 40, 48, tr, "cpu").float()
    assert not torch.equal(a, b)
    assert np.array_equal(scene.pan_path(6, (1, 4), 0.3),
                          scene.pan_path(6, (1, 4), 0.3))


def test_pingpong():
    assert [scene.pingpong(i, 4) for i in range(9)] == [0, 1, 2, 3, 2, 1, 0,
                                                        1, 2]
    assert scene.pingpong(5, 1) == 0
    assert math.isclose(scene.smooth_texture(
        torch.Generator().manual_seed(1), (2, 16, 16), "cpu").amax(), 255.0,
        rel_tol=1e-6)
