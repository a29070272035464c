"""Tracker configuration.

Reference parity: klt.py -> KLT_TrackingContext / KLTCreateTrackingContext /
KLTChangeTCPyramid / KLTUpdateTCBorder / KLTPrintTrackingContext.

Verbatim port of ``pyfeaturetrack_tpu/config.py`` (pure Python): the
reference's mutable context object is an immutable, hashable dataclass;
the two derived-parameter updaters return new configs instead of
mutating. The sequential-mode pyramid cache (``pyramid_last`` & friends
in the reference) is NOT part of the config — it is explicit state
threaded through the sequence driver (models/device_sequence.py).

Field names, defaults, and derived-parameter math follow SURVEY.md section
2.3 exactly.
"""

from __future__ import annotations

import dataclasses
import math

from .errors import KLTError, KLTWarning
from .ops.kernels import get_kernel_widths


def _mini(a: int, b: int) -> int:
    return a if a < b else b


def _maxi(a: int, b: int) -> int:
    return a if a > b else b


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Immutable tracking configuration (= reference KLT_TrackingContext)."""

    # Feature selection
    mindist: int = 10
    window_width: int = 7
    window_height: int = 7
    min_eigenvalue: int = 1
    nSkippedPixels: int = 0
    smoothBeforeSelecting: bool = True

    # Tracking
    sequentialMode: bool = False
    lighting_insensitive: bool = False
    min_determinant: float = 0.01
    min_displacement: float = 0.1
    max_iterations: int = 10
    max_residue: float = 10.0
    step_factor: float = 1.0

    # Image smoothing / gradients / pyramid
    grad_sigma: float = 1.0
    smooth_sigma_fact: float = 0.1
    pyramid_sigma_fact: float = 0.9
    nPyramidLevels: int = 2
    subsampling: int = 4

    # Derived exclusion border (see update_border)
    borderx: int = 24
    bordery: int = 24

    # Affine consistency check: -1 off; 0 translation; 1 similarity; 2 affine
    affineConsistencyCheck: int = -1
    affine_window_width: int = 15
    affine_window_height: int = 15
    affine_max_iterations: int = 10
    affine_max_residue: float = 10.0
    affine_min_displacement: float = 0.02
    affine_max_displacement_differ: float = 1.5

    # Debug
    writeInternalImages: bool = False

    # Storage dtype of the cached pyramid/gradient levels (beyond the
    # reference): "float32" or "bfloat16". Every level and gradient is
    # built in float32 and stored in this dtype (bfloat16: rounded to
    # nearest even); every consumer upcasts each stored value to float32
    # at the tap, and all blending and sums stay float32.
    image_dtype: str = "float32"

    # ---- derived helpers -------------------------------------------------

    @property
    def smooth_sigma(self) -> float:
        """Reference parity: klt.py -> _KLTComputeSmoothSigma macro."""
        return self.smooth_sigma_fact * _maxi(self.window_width, self.window_height)

    def replace(self, **kw) -> "TrackerConfig":
        return dataclasses.replace(self, **kw)

    def validated_window(self) -> "TrackerConfig":
        """Force window dims odd and >= 3, with warnings.

        Reference parity: trackFeatures.py -> KLTTrackFeatures entry checks.
        """
        ww, wh = self.window_width, self.window_height
        if ww % 2 != 1:
            ww += 1
            KLTWarning(
                "Tracking context's window width must be odd; changing to %d", ww)
        if wh % 2 != 1:
            wh += 1
            KLTWarning(
                "Tracking context's window height must be odd; changing to %d", wh)
        if ww < 3:
            ww = 3
            KLTWarning(
                "Tracking context's window width must be at least three; "
                "changing to %d", ww)
        if wh < 3:
            wh = 3
            KLTWarning(
                "Tracking context's window height must be at least three; "
                "changing to %d", wh)
        if (ww, wh) == (self.window_width, self.window_height):
            return self
        return self.replace(window_width=ww, window_height=wh)


def change_pyramid(config: TrackerConfig, search_range: int = 15) -> TrackerConfig:
    """Derive (nPyramidLevels, subsampling) from a search range in pixels.

    Reference parity: klt.py -> KLTChangeTCPyramid. Thresholds follow the
    geometric-series derivation: search_range = window_halfwidth *
    (s^n - 1)/(s - 1).
    """
    if search_range < 0:
        raise KLTError("(change_pyramid) search_range must be nonnegative")
    window_halfwidth = _mini(config.window_width, config.window_height) / 2.0
    ss = float(search_range) / window_halfwidth

    if ss < 1.0:
        nlevels, sub = 1, config.subsampling
    elif ss <= 3.0:
        nlevels, sub = 2, 2
    elif ss <= 5.0:
        nlevels, sub = 2, 4
    elif ss <= 9.0:
        nlevels, sub = 2, 8
    else:
        val = math.log(7.0 * ss + 1.0) / math.log(8.0)
        nlevels, sub = int(val + 0.99), 8
    return config.replace(nPyramidLevels=nlevels, subsampling=sub)


def update_border(config: TrackerConfig) -> TrackerConfig:
    """Derive the selection/tracking exclusion border.

    Reference parity: klt.py -> KLTUpdateTCBorder. Combines the trimmed
    smoothing-kernel half-width, per-level pyramid-smoothing invalid pixels
    (rounded up when mapped down a level), and the window half-width scaled
    back to full resolution by subsampling^(nLevels-1).
    """
    cfg = config.validated_window()
    if cfg.window_width % 2 != 1 or cfg.window_height % 2 != 1:
        raise KLTError("(update_border) window widths must be odd")

    window_hw = _maxi(cfg.window_width, cfg.window_height) // 2

    gauss_w, _ = get_kernel_widths(cfg.smooth_sigma)
    smooth_gauss_hw = gauss_w // 2
    gauss_w, _ = get_kernel_widths(cfg.pyramid_sigma_fact * cfg.subsampling)
    pyramid_gauss_hw = gauss_w // 2

    n_invalid = smooth_gauss_hw
    for _ in range(1, cfg.nPyramidLevels):
        val = (float(n_invalid) + pyramid_gauss_hw) / cfg.subsampling
        n_invalid = int(val + 0.99)  # round up

    ss_power = cfg.subsampling ** (cfg.nPyramidLevels - 1)
    border = (n_invalid + window_hw) * ss_power
    return cfg.replace(borderx=border, bordery=border)


def create_config(search_range: int = 15, **overrides) -> TrackerConfig:
    """Build a config with derived params resolved.

    Reference parity: klt.py -> KLTCreateTrackingContext (which calls
    KLTChangeTCPyramid(15) then KLTUpdateTCBorder). Explicitly supplied
    ``nPyramidLevels``/``subsampling`` overrides are honored — the
    search-range derivation is skipped rather than silently clobbering
    them (pass ``search_range`` alone to get the reference derivation).
    """
    cfg = TrackerConfig(**overrides)
    if not ({"nPyramidLevels", "subsampling"} & overrides.keys()):
        cfg = change_pyramid(cfg, search_range)
    return update_border(cfg)


def print_config(config: TrackerConfig) -> str:
    """Reference parity: klt.py -> KLTPrintTrackingContext."""
    lines = ["\n\nTracking context:\n"]
    for f in dataclasses.fields(config):
        lines.append(f"\t{f.name} = {getattr(config, f.name)}")
    text = "\n".join(lines) + "\n"
    print(text)
    return text
