"""The port's scaling prediction (parallel/scaling.predict_scaling_efficiency)
with the structure of tests/test_scaling_predict.py: the tracking steps are
free of collectives and their per-device work is flat as devices double,
the serving tick's census is collective_census of the same call, and the
rows carry JAX's keys. Per-device flops and bytes come from the port's
counting model (utils/roofline), XLA's cost analysis on the JAX side: the
two models differ by design, so their numbers are not compared."""

import numpy as np
import pytest
import torch

from pyfeaturetrack_tpu.parallel.scaling import (
    predict_scaling_efficiency as jax_predict)

from pyfeaturetrack_tpu_torch.config import create_config
from pyfeaturetrack_tpu_torch.parallel import sharding, split_mesh
from pyfeaturetrack_tpu_torch.parallel.scaling import (
    collective_census, predict_scaling_efficiency)
from pyfeaturetrack_tpu_torch.utils import roofline

torch.set_num_threads(2)

CPU = "cpu"


@pytest.mark.parametrize("workload,counts,shape,n", [
    ("track", [1, 2, 4, 8], (96, 128), 64),
    ("config4", [1, 2], None, None)])
def test_tracking_step_is_collective_free_and_balanced(workload, counts,
                                                       shape, n):
    kw = {} if shape is None else {"image_shape": shape, "n_features": n}
    r = predict_scaling_efficiency(device_counts=counts, workload=workload,
                                   device=CPU, **kw)
    rows = r["per_device"]
    assert r["workload"] == workload and r["device_counts"] == counts
    for d, row in rows.items():
        # the step itself carries no collective (the output gather that
        # hands every rank the result is in the census, not in the step)
        assert row["collectives"]["total_approx_bytes"] == 0.0, (d, row)
        labels = set(row["census"]["by_label"])
        assert labels <= {"output"}, labels
    f1, b1 = rows[1]["per_device_flops"], rows[1]["per_device_bytes"]
    assert f1 > 0 and b1 > 0
    for d in counts[1:]:
        assert rows[d]["per_device_flops"] <= 1.1 * f1
        assert rows[d]["per_device_bytes"] <= 1.1 * b1
        assert rows[d]["predicted_weak_efficiency"] >= 0.9


def test_config4_counts_are_the_roofline_model():
    r = predict_scaling_efficiency(device_counts=[1], workload="config4",
                                   device=CPU)
    row = r["per_device"][1]
    cfg = create_config().replace(nPyramidLevels=4, subsampling=2)
    pyr = roofline.pyramid_counts(1088, 1920, cfg)
    c4 = roofline.config4_counts(cfg)
    # a pair builds both frames' pyramids
    assert row["per_device_bytes"] == pytest.approx(c4["bytes"]
                                                    + pyr["bytes"])
    assert row["per_device_flops"] == pytest.approx(c4["flops"]
                                                    + pyr["flops"])
    t = max(row["per_device_flops"] / roofline.H100["f32_flops"],
            row["per_device_bytes"] / roofline.H100["hbm_bytes_per_s"])
    assert row["model_step_s"] == pytest.approx(t)


def test_serving_tick_census_is_the_calls_census():
    """The serving tick's census equals collective_census of the same
    sharded call (one stream per rank, replace-lost on), d = 1, 2, 4."""
    shape, n = (80, 96), 24
    r = predict_scaling_efficiency(device_counts=[1, 2, 4],
                                   image_shape=shape, n_features=n,
                                   workload="serving_tick", device=CPU)
    cfg = create_config().replace(sequentialMode=True).validated_window()
    for d in (1, 2, 4):
        rng = np.random.default_rng(0)
        imgs1 = rng.uniform(0, 255, (d,) + shape).astype(np.float32)
        imgs2 = np.roll(imgs1, 1, axis=-1)
        mesh = split_mesh((d, 1), ("frame", "feature"), CPU)
        _, want = collective_census(
            sharding.batched_serving_sharded, [imgs1, imgs2], cfg, n, mesh,
            chain=1, replace_lost=True, top_k=64)
        got = r["per_device"][d]["census"]
        assert got == want
        assert (got["total_bytes"] > 0) == (d > 1)
        assert r["per_device"][d]["collectives"]["total_approx_bytes"] == 0


def test_link_time_enters_the_model():
    """A step collective's bytes over the link rate add to the step time:
    the model with a given census."""
    r = predict_scaling_efficiency(device_counts=[1, 2], image_shape=(64, 80),
                                   n_features=16, device=CPU,
                                   ici_bytes_per_s=1.0)
    for row in r["per_device"].values():
        assert row["model_step_s"] == pytest.approx(max(
            row["per_device_flops"] / roofline.H100["f32_flops"],
            row["per_device_bytes"] / roofline.H100["hbm_bytes_per_s"])
            + row["collectives"]["total_approx_bytes"])
    assert roofline.NVLINK_BYTES_PER_S == 450e9
    with pytest.raises(ValueError, match="unknown workload"):
        predict_scaling_efficiency([1], workload="dense", device=CPU)


def test_rows_carry_jax_keys():
    """The result and each row have the JAX function's keys (the port's
    rows add ``census``)."""
    want = jax_predict(device_counts=[1, 2], image_shape=(64, 80),
                       n_features=16)
    got = predict_scaling_efficiency(device_counts=[1, 2],
                                     image_shape=(64, 80), n_features=16,
                                     device=CPU)
    assert set(got) == set(want)
    for d in (1, 2):
        assert set(want["per_device"][d]) <= set(got["per_device"][d])
        assert "total_approx_bytes" in got["per_device"][d]["collectives"]
