"""The port's roofline counting model (``utils/roofline.py``) against the
JAX package's: every count equal for float32 storage, the stored image
bytes halved for bfloat16 (the float32 reads of the frame and of each
level's construction source stay), and the timers refusing the CPU."""

import pytest
import torch

from pyfeaturetrack_tpu.config import create_config as jax_config
from pyfeaturetrack_tpu.utils import roofline as jroof

from pyfeaturetrack_tpu_torch.utils import roofline
from pyfeaturetrack_tpu_torch.utils.convert import config_from_jax

CONFIGS = {"default": {}, "config 3": dict(nPyramidLevels=3, subsampling=2,
                                           affineConsistencyCheck=2),
           "config 4": dict(nPyramidLevels=4, subsampling=2),
           "13x13": dict(window_width=13, window_height=13)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_float32_counts_equal_jax(name):
    jcfg = jax_config(**CONFIGS[name])
    cfg = config_from_jax(jcfg)
    for h, w in ((480, 640), (1088, 1920)):
        assert roofline.pyramid_counts(h, w, cfg) == jroof.pyramid_counts(
            h, w, jcfg)
        assert roofline.lk_counts(h, w, 1000, cfg) == jroof.lk_counts(
            h, w, 1000, jcfg)
        assert roofline.flow_counts(h, w, cfg) == jroof.flow_counts(h, w,
                                                                    jcfg)
        assert roofline.affine_counts(1000, cfg, h, w) == \
            jroof.affine_counts(1000, jcfg, h, w)
    want = jroof.config4_counts()
    got = roofline.config4_counts()
    assert set(got) == {"bytes", "flops"}
    assert (got["bytes"], got["flops"]) == (want["bytes"], want["flops"])
    assert roofline.ba_iter_counts(60, 6000, 12) == jroof.ba_iter_counts(
        60, 6000, 12)


def test_bfloat16_halves_the_stored_image_bytes():
    """LK, dense flow and the affine channels read stored levels only, so
    their image bytes halve; the pyramid stores every plane in half the
    bytes but reads float32 sources and writes a float32 copy of each level
    past the first."""
    from pyfeaturetrack_tpu_torch.config import create_config
    c32 = create_config(nPyramidLevels=4, subsampling=2)
    c16 = c32.replace(image_dtype="bfloat16")
    h, w = 1088, 1920
    a = roofline.lk_counts(h, w, 4096, c32)
    b = roofline.lk_counts(h, w, 4096, c16)
    assert b["bytes"] * 2 == a["bytes"] and b["flops"] == a["flops"]
    a, b = roofline.flow_counts(h, w, c32), roofline.flow_counts(h, w, c16)
    assert b["bytes"] * 2 == a["bytes"] and b["flops"] == a["flops"]
    a = roofline.affine_counts(1000, c32, h, w)
    b = roofline.affine_counts(1000, c16, h, w)
    assert a["bytes"] - b["bytes"] == 3 * h * w * 2
    shapes = [(h >> k, w >> k) for k in range(4)]
    px = [hh * ww for hh, ww in shapes]
    stored = sum(3 * p for p in px)       # img, gx, gy of every level
    a = roofline.pyramid_counts(h, w, c32)
    b = roofline.pyramid_counts(h, w, c16)
    assert a["bytes"] - b["bytes"] == stored * 2 - 4 * sum(px[1:])
    assert a["flops"] == b["flops"]
    assert roofline.config4_counts(c16)["bytes"] == b["bytes"] + \
        roofline.lk_counts(h, w, 4096, c16)["bytes"]
    assert roofline.bound_s(roofline.config4_counts(c16))[0] < \
        roofline.bound_s(roofline.config4_counts(c32))[0]
    with pytest.raises(ValueError, match="image_dtype"):
        roofline.lk_counts(h, w, 10, c32.replace(image_dtype="float16"))


def test_summarize_reads_the_h100_peaks():
    out = roofline.summarize({"bytes": 3.35e9, "flops": 6.7e9}, 2e-3)
    assert out["sol_us"] == 1000.0 and out["bound"] == "memory"
    assert out["achieved_fraction"] == 0.5
    out = roofline.summarize({"bytes": 1.0, "flops": 6.7e10}, 2e-3)
    assert out["sol_us"] == 1000.0 and out["bound"] == "compute"


def test_stage_timers_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        roofline.measure_stage_times(64, 80, 10, iters=1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        roofline.measure_stage_device_times(64, 80, 10)
