"""pyfeaturetrack_tpu_torch — the PyTorch / CUDA port of pyfeaturetrack_tpu.

KLT feature tracking (Gaussian pyramids, Shi-Tomasi selection with
min-distance suppression, pyramidal Lucas-Kanade with the KLT status
codes, lost-feature replacement, the affine-consistency check) in
PyTorch, with a hand-written Hopper kernel for every TPU kernel on the
path it covers: K1 pyramid level (csrc/pyramid.cu), K2 LK level
(csrc/lk.cu), K3 min-eig map (csrc/eig.cu), K4 greedy extraction
(csrc/extract.cu), K6 affine Gauss-Newton (csrc/affine.cu).

The kernel is chosen by the tensor's device: CUDA tensors launch the
kernels (built with nvcc at first use), CPU tensors take each kernel's
plain PyTorch version. Imports torch and numpy only.
"""

from .config import (  # noqa: F401
    TrackerConfig,
    change_pyramid,
    create_config,
    update_border,
)
from .errors import KLTError, KLTWarning  # noqa: F401
from .features import (  # noqa: F401
    KLT_LARGE_RESIDUE,
    KLT_MAX_ITERATIONS,
    KLT_NOT_FOUND,
    KLT_OOB,
    KLT_SMALL_DET,
    KLT_TRACKED,
    AffineState,
    FeatureState,
    reset_affine,
)
from .models.device_sequence import (  # noqa: F401
    select_step_device,
    sequence_step_device,
    track_sequence_device,
)
from .ops.affine import (  # noqa: F401
    affine_consistency_check,
    make_affine_state,
)
from .ops.track import (  # noqa: F401
    TrackPyramids,
    build_track_pyramids,
    track_features_pyramids,
    track_features_pyramids_carry,
)

__version__ = "0.1.0"
