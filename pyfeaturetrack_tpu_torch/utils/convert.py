"""State that crosses over from the JAX package.

The slice has no weights: a config plus pyramid, feature and affine
template state is all a port step needs, so these helpers let a test start
a port step or a host-API call from exactly the state the JAX package
produced; the SfM back end adds bundle-adjustment problems, pose graphs
and pose stacks. They take plain numpy arrays (or anything ``np.asarray``
accepts) and never import JAX. Like every entry point of the port they
put their tensors on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import TrackerConfig
from ..features import AffineState, FeatureState, FeatureTable
from ..ops.track import TrackPyramids


def config_from_jax(cfg) -> TrackerConfig:
    """Copy a ``pyfeaturetrack_tpu.config.TrackerConfig``'s fields."""
    names = {f.name for f in dataclasses.fields(TrackerConfig)}
    return TrackerConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)
                            if f.name in names})


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def level_tensor(a, device) -> torch.Tensor:
    """A stored pyramid level as a tensor on ``device``: a torch tensor
    keeps its dtype; a bfloat16 array (``np.asarray`` of a JAX bfloat16
    array has ``ml_dtypes``' bfloat16 dtype, which ``torch.from_numpy``
    refuses) goes through a uint16 view into a bfloat16 tensor, bits
    unchanged; any other array becomes float32."""
    if isinstance(a, torch.Tensor):
        return a.to(device).contiguous()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return _t(arr, np.float32, device)


def pyramids_from_numpy(img_levels, gx_levels, gy_levels, *,
                        device="cuda") -> TrackPyramids:
    """Per-level image / gradx / grady arrays -> a port TrackPyramids, in
    the levels' storage dtype (bfloat16 levels stay bfloat16, bit for bit;
    others become float32)."""
    return TrackPyramids(
        img=tuple(level_tensor(a, device) for a in img_levels),
        gradx=tuple(level_tensor(a, device) for a in gx_levels),
        grady=tuple(level_tensor(a, device) for a in gy_levels))


def features_from_numpy(x, y, val, *, device="cuda"):
    """(x, y, val) arrays -> float32, float32, int32 [N] tensors."""
    return (_t(x, np.float32, device), _t(y, np.float32, device),
            _t(val, np.int32, device))


def affine_state_from_numpy(img, gradx, grady, x, y, A, valid, nit=None, *,
                            device="cuda") -> AffineState:
    """The fields of an AffineState (e.g. ``[np.asarray(a) for a in
    jax_aff]``) -> a port AffineState; ``nit`` None stays None."""
    return AffineState(
        img=_t(img, np.float32, device), gradx=_t(gradx, np.float32, device),
        grady=_t(grady, np.float32, device), x=_t(x, np.float32, device),
        y=_t(y, np.float32, device), A=_t(A, np.float32, device),
        valid=_t(valid, np.bool_, device),
        nit=None if nit is None else _t(nit, np.int32, device))


def feature_state_from_arrays(x, y, val, aff=None, *,
                              device="cuda") -> FeatureState:
    """A JAX FeatureState's fields as arrays (e.g. ``np.asarray(fl.x)``,
    ``[np.asarray(a) for a in fl.aff]`` or None for ``aff``) -> a port
    FeatureState with its AffineState."""
    x, y, val = features_from_numpy(x, y, val, device=device)
    if aff is not None:
        aff = affine_state_from_numpy(*aff, device=device)
    return FeatureState(x, y, val, aff)


def feature_table_from_numpy(x, y, val, *, device="cuda") -> FeatureTable:
    """[F, N] (x, y, val) arrays -> a port FeatureTable."""
    return FeatureTable(x=_t(x, np.float32, device), y=_t(y, np.float32, device),
                        val=_t(val, np.int32, device))


def ba_problem_from_numpy(K, cam_idx, pt_idx, uv, w, *, device="cuda"):
    """The fields of a JAX ``sfm.BAProblem`` as arrays (e.g.
    ``[np.asarray(a) for a in problem]``) -> a port BAProblem."""
    from ..sfm.ba import make_problem
    return make_problem(K, cam_idx, pt_idx, uv, w, device=device)


def pose_graph_from_numpy(edge_i, edge_j, R_meas, t_meas, w_rot, w_trans, *,
                          device="cuda"):
    """The fields of a JAX ``sfm.PoseGraph`` as arrays -> a port
    PoseGraph."""
    from ..sfm.posegraph import make_pose_graph
    return make_pose_graph(edge_i, edge_j, R_meas, t_meas, w_rot, w_trans,
                           device=device)


def poses_from_numpy(R, t, *, device="cuda"):
    """(R [M, 3, 3], t [M, 3]) pose stacks -> float32 tensors."""
    return _t(R, np.float32, device), _t(t, np.float32, device)
