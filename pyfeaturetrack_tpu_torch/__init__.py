"""pyfeaturetrack_tpu_torch — the PyTorch / CUDA port of pyfeaturetrack_tpu.

KLT feature tracking (Gaussian pyramids, Shi-Tomasi selection with
min-distance suppression, pyramidal Lucas-Kanade with the KLT status
codes, lost-feature replacement, the affine-consistency check, sub-pixel
corner refinement, feature list/table files, dense optical flow and dense
stereo disparity / depth, streaming and chunked serving of video) in
PyTorch, with the reference's ``KLT*`` API,
and a hand-written Hopper kernel for every TPU kernel of the JAX package:
K1 pyramid level (csrc/pyramid.cu), K2 LK level (csrc/lk.cu), K3 min-eig
map (csrc/eig.cu), K4 greedy extraction (csrc/extract.cu), K5 greedy
min-distance scan (csrc/suppress.cu), K6 affine Gauss-Newton
(csrc/affine.cu), K8 dense LK level, 2-D and 1-D (csrc/lk_dense.cu), K9
LK window terms (csrc/window_terms.cu).

The kernel is chosen by the tensor's device: CUDA tensors launch the
kernels (built with nvcc at first use), CPU tensors take each kernel's
plain PyTorch version. Entry points that take a numpy image run on
"cuda" unless the caller passes ``device="cpu"``. Imports torch and
numpy only.
"""

from .config import (  # noqa: F401
    TrackerConfig,
    change_pyramid,
    create_config,
    print_config,
    update_border,
)
from .errors import KLTError, KLTSetVerbosity, KLTWarning  # noqa: F401
from .features import (  # noqa: F401
    KLT_FB_INCONSISTENT,
    KLT_LARGE_RESIDUE,
    KLT_MAX_ITERATIONS,
    KLT_NOT_FOUND,
    KLT_OOB,
    KLT_SMALL_DET,
    KLT_TRACKED,
    AffineState,
    FeatureState,
    FeatureTable,
    count_remaining_features,
    reset_affine,
)
from .models import (  # noqa: F401
    KeyframeTracker,
    KLTChangeTCPyramid,
    KLTCountRemainingFeatures,
    KLTCreateFeatureList,
    KLTCreateFeatureTable,
    KLTCreateTrackingContext,
    KLTExtractFeatureList,
    KLTPrintTrackingContext,
    KLTReplaceLostFeatures,
    KLTSelectGoodFeatures,
    KLTStoreFeatureList,
    KLTTrackFeatures,
    KLTUpdateTCBorder,
    SequenceTracker,
    Tracker,
    select_step_device,
    sequence_chain_device,
    sequence_step_device,
    track_sequence,
    track_sequence_chunked,
    track_sequence_device,
)
from .ops.disparity import (  # noqa: F401
    DenseDisparity,
    dense_depth,
    dense_disparity,
    dense_disparity_lr,
    dense_disparity_pyramids,
    disparity_lr_consistency,
)
from .ops.flow import (  # noqa: F401
    DenseFlow,
    compute_dense_flow,
    dense_flow_fb,
    dense_flow_pyramids,
    flow_consistency,
    flow_to_rgb,
    warp_image,
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
    track_features_pyramids_fb,
)

from .serving import (  # noqa: F401
    BatchedStreamingTracker,
    StreamingTracker,
    prefetch_to_device,
    serve_stream,
)
from .utils.loader import FrameLoader, load_frames  # noqa: F401

__version__ = "0.1.0"
