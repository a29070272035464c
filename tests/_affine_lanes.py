"""A lane mix for K6's affine stage whose counts are known, on any device
(no JAX): config 3 with ``affine_min_displacement`` 0, so that a checked
lane never converges early and one that passes takes exactly
``affine_max_iterations`` Gauss-Newton updates.

Frame 2 shows frame 1's content moved by (+2, +1) px. Lanes, by group:

* ``capture``: a fresh feature (value 5) tracked for the first time;
* ``cap``: a template of frame 1 at the lane's position, tracked to the
  exact match: checked, passes at the iteration cap;
* ``reject``: a zero template: checked and rejected;
* ``lost``: lost by the translational track;
* ``dead``: an empty slot.
"""

from __future__ import annotations

import numpy as np
import torch

import pyfeaturetrack_tpu_torch as tpft
from pyfeaturetrack_tpu_torch.features import FeatureState
from pyfeaturetrack_tpu_torch.ops.affine import make_affine_state
from pyfeaturetrack_tpu_torch.ops.interp import gather_window

GROUPS = (("capture", 4), ("cap", 6), ("reject", 3), ("lost", 2),
          ("dead", 1))
SHIFT = (2.0, 1.0)


def _texture(h: int, w: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, (h + 4, w + 4))
    k = np.array([1.0, 4, 6, 4, 1]) / 16.0
    for axis in (0, 1):
        img = sum(c * np.roll(img, s - 2, axis=axis) for s, c in enumerate(k))
    return np.floor(img[2:-2, 2:-2]).astype(np.float32)


def lane_mix(dev) -> dict:
    """{cfg, pyr1, pyr2, before, after (with the AffineState), groups: name
    -> bool [N] mask on ``dev``}."""
    cfg = tpft.create_config(affineConsistencyCheck=2, nPyramidLevels=3,
                             subsampling=2, affine_min_displacement=0.0)
    h, w = 96, 128
    tex = _texture(h + 8, w + 8, 3)
    sx, sy = (int(v) for v in SHIFT)
    a = tex[4:4 + h, 4:4 + w]
    b = tex[4 - sy:4 - sy + h, 4 - sx:4 - sx + w]
    pyr1, pyr2 = (tpft.build_track_pyramids(torch.tensor(f, device=dev), cfg)
                  for f in (a, b))
    names = [g for g, k in GROUPS for _ in range(k)]
    n = len(names)
    groups = {g: torch.tensor([m == g for m in names], device=dev)
              for g, _ in GROUPS}
    # lanes spread over the frame's interior, at sub-pixel positions
    bx = torch.tensor([24.25 + 9.0 * (i % 9) for i in range(n)],
                      dtype=torch.float32, device=dev)
    by = torch.tensor([24.5 + 14.0 * (i // 9) for i in range(n)],
                      dtype=torch.float32, device=dev)
    bval = torch.where(groups["capture"], 5, 0)
    bval = torch.where(groups["dead"], -1, bval).to(torch.int32)
    gone = groups["lost"] | groups["dead"]
    ax = torch.where(gone, -1.0, bx + SHIFT[0])
    ay = torch.where(gone, -1.0, by + SHIFT[1])
    aval = torch.where(groups["lost"], -4, 0)
    aval = torch.where(groups["dead"], -1, aval).to(torch.int32)
    bx = torch.where(groups["dead"], -1.0, bx)
    by = torch.where(groups["dead"], -1.0, by)
    hw, hh = cfg.affine_window_width // 2, cfg.affine_window_height // 2
    aff = make_affine_state(n, cfg, dev)
    held = groups["cap"] | groups["reject"]
    tmpl = gather_window(pyr1.img[0], bx, by, hw, hh)
    aff = aff._replace(
        img=torch.where(groups["cap"][:, None, None], tmpl,
                        torch.zeros_like(tmpl)).contiguous(),
        x=torch.where(held, bx, 0.0), y=torch.where(held, by, 0.0),
        valid=held)
    return {"cfg": cfg, "pyr1": pyr1, "pyr2": pyr2,
            "before": FeatureState(bx, by, bval),
            "after": FeatureState(ax, ay, aval, aff), "groups": groups}
