"""Feature overlay visualization.

Reference parity: writeFeatures.py -> KLTWriteFeatureListToPPM — overlay
live features on a greyscale image as red marks and write an RGB PPM.
Port of ``pyfeaturetrack_tpu/utils/viz.py`` (NumPy only; the feature list
comes to the host once).
"""

from __future__ import annotations

import numpy as np

from ..features import FeatureState, feature_state_to_numpy
from .io import ppm_write


def overlay_features(img: np.ndarray, fl: FeatureState,
                     mark_radius: int = 1) -> np.ndarray:
    """Greyscale image + feature list -> RGB uint8 with red feature marks:
    a (2 mark_radius + 1)-square at each live feature's rounded position,
    clipped to the image."""
    g = np.clip(np.asarray(img, np.float64), 0, 255).astype(np.uint8)
    rgb = np.stack([g, g, g], axis=-1)
    nrows, ncols = g.shape
    arr = feature_state_to_numpy(fl)
    for x, y, v in arr:
        if v < 0:
            continue
        cx, cy = int(x + 0.5), int(y + 0.5)
        y0, y1 = max(cy - mark_radius, 0), min(cy + mark_radius, nrows - 1)
        x0, x1 = max(cx - mark_radius, 0), min(cx + mark_radius, ncols - 1)
        if y1 < y0 or x1 < x0:
            continue  # mark entirely outside the image (negative coords
            # would otherwise wrap the slice and paint a whole band)
        rgb[y0:y1 + 1, x0:x1 + 1] = (255, 0, 0)
    return rgb


def write_feature_list_to_ppm(fl: FeatureState, img: np.ndarray, path) -> None:
    """Reference parity: writeFeatures.py -> KLTWriteFeatureListToPPM."""
    ppm_write(path, overlay_features(img, fl))
