"""SfM back end: geometry, two-view bootstrap, PnP, dense bundle
adjustment, pose graph, loop closure, stereo and monocular visual
odometry (PyTorch port of ``pyfeaturetrack_tpu/sfm``).

Consumes the tracker's feature tracks and produces camera poses +
landmarks. The geometry runs as batched tensor programs on the caller's
device (IEEE float32, ``geometry.require_fp32``); the Schur-complement
reductions of the bundle adjustment are deterministic segmented sums.
Not in the port yet (raise NotImplementedError): the windowed BA
(``ba_windowed`` beyond ``column_runs``, ``run_sfm_windowed``; the next
slice) and the landmark-sharded ``mesh`` path (ROADMAP Queue 1 item 7).
"""

from .geometry import (se3_apply, se3_compose, se3_exp, se3_inverse,  # noqa: F401
                       so3_exp, so3_log, project)
from .triangulate import triangulate_dlt  # noqa: F401
from .ba import BAProblem, bundle_adjust  # noqa: F401
from .ba_windowed import (WindowedBAProblem, bundle_adjust_windowed,  # noqa: F401
                          pad_windowed_for_mesh, triangulate_windowed,
                          windowed_from_feature_table)
from .posegraph import PoseGraph, optimize_pose_graph  # noqa: F401
from .pipeline import (ate_rmse, ate_rmse_aligned,  # noqa: F401
                       observations_from_feature_table, run_sfm,
                       run_sfm_windowed, umeyama_align)
from .epipolar import (essential_from_matches, ransac_essential,  # noqa: F401
                       recover_pose, two_view_bootstrap)
from .homography import (decompose_homography,  # noqa: F401
                         homography_from_matches, ransac_homography,
                         recover_pose_homography, two_view_bootstrap_auto)
from .camera import (distort_pixels, project_distorted,  # noqa: F401
                     undistort_pixels)
from .pnp import pnp_ransac, refine_pose  # noqa: F401
from .loop import close_loop_poses, guided_retrack  # noqa: F401
from .stereo import (  # noqa: F401
    stereo_depth,
    stereo_match,
    stereo_triangulate,
)
from .vo import VisualOdometry  # noqa: F401
