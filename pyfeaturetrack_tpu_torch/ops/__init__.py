"""Compute ops: kernels, convolution, pyramid, selection, LK tracking, and
the launcher modules of the hand-written CUDA kernels (``cuda_*``).

The names re-exported here are those of ``pyfeaturetrack_tpu/ops``."""

from .kernels import MAX_KERNEL_WIDTH, compute_kernels, get_kernel_widths  # noqa: F401
from .convolve import (  # noqa: F401
    compute_gradients,
    compute_smoothed_image,
    convolve_horiz,
    convolve_separate,
    convolve_vert,
    to_float_image,
)
from .pyramid import Pyramid, compute_gradient_pyramids, compute_pyramid  # noqa: F401
from .interp import bilinear, gather_window  # noqa: F401
from .select import (  # noqa: F401
    compute_min_eig_map,
    replace_lost_features,
    replace_lost_features_arrays,
    select_good_features,
    select_good_features_arrays,
)
from .track import (  # noqa: F401
    TrackPyramids,
    build_track_pyramids,
    track_feature_level,
    track_features,
    track_features_pyramids,
)
