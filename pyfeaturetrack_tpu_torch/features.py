"""Feature data model: structure-of-arrays feature state on torch tensors.

Reference parity: klt.py -> KLT_Feature / KLT_FeatureList (here one
structure-of-arrays NamedTuple, FeatureState) and storeFeatures.py ->
KLTCreateFeatureTable / KLTStoreFeatureList / KLTExtractFeatureList (here
FeatureTable). Port of ``pyfeaturetrack_tpu/features.py``; ``Lane`` is
one lane's state between the device sequence loop's steps. As there, the
table is updated functionally: ``store_feature_list`` returns a new table.

``val`` holds the min-eigenvalue after selection (>= 0) and the status code
after tracking, exactly like the reference. Status codes are bit-identical
(klt.py constants).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from .ops.cuda_lk import TrackCarry
    from .ops.track import TrackPyramids

KLT_TRACKED = 0
KLT_NOT_FOUND = -1
KLT_SMALL_DET = -2
KLT_MAX_ITERATIONS = -3
KLT_OOB = -4
KLT_LARGE_RESIDUE = -5
# Beyond-reference extension (the reference stops at -5): forward-
# backward consistency rejection (ops/track.track_features_pyramids_fb).
KLT_FB_INCONSISTENT = -6

STATUS_NAMES = {
    KLT_TRACKED: "tracked",
    KLT_NOT_FOUND: "not_found",
    KLT_SMALL_DET: "small_det",
    KLT_MAX_ITERATIONS: "max_iterations",
    KLT_OOB: "oob",
    KLT_LARGE_RESIDUE: "large_residue",
    KLT_FB_INCONSISTENT: "fb_inconsistent",
}


class AffineState(NamedTuple):
    """Per-feature first-frame template + warp for the consistency check.

    Reference parity: klt.py -> KLT_Feature aff_* fields. Templates are
    affine_window-sized bilinear samples centred on the feature; ``x``/``y``
    record the capture anchor (metadata: the matching math does not read
    them)."""
    img: torch.Tensor     # [N, T, T] template intensities
    gradx: torch.Tensor   # [N, T, T]
    grady: torch.Tensor   # [N, T, T]
    x: torch.Tensor       # [N] capture anchor (frame-1 position)
    y: torch.Tensor       # [N]
    A: torch.Tensor       # [N, 2, 2] warp, rows [[Axx, Axy], [Ayx, Ayy]]
    valid: torch.Tensor   # [N] bool: template captured
    # [N] int32 Gauss-Newton iteration hint of the JAX package's TPU
    # kernel (tile ordering); the math never reads it. None is normalized
    # to zeros at the affine stage.
    nit: Optional[torch.Tensor] = None


class FeatureState(NamedTuple):
    """Structure-of-arrays feature list (= reference KLT_FeatureList)."""
    x: torch.Tensor    # [N] float32
    y: torch.Tensor    # [N] float32
    val: torch.Tensor  # [N] int32: eigenvalue after select, status after track
    aff: Optional[AffineState] = None

    @property
    def nFeatures(self) -> int:
        return self.x.shape[-1]


class Lane(NamedTuple):
    """One lane's (a stream's, a chunk's) state between frame steps of the
    device sequence loop (``models/device_sequence``). ``carry`` is the
    window carry of the JAX package's lanes: the port reuses no window, so
    its steps never read it and hand out None (no window to reuse, as a
    carry with every ``ok`` cleared)."""
    pyr: TrackPyramids
    x: torch.Tensor
    y: torch.Tensor
    val: torch.Tensor
    aff: Optional[AffineState] = None
    carry: Optional[TrackCarry] = None

    def state(self) -> list:
        """The lane's state after its pyramid, in a fixed order: x, y, val
        and the AffineState's fields, a None ``nit`` as zeros (the affine
        stage reads it so)."""
        aff = () if self.aff is None else self.aff
        if aff and aff.nit is None:
            aff = aff._replace(nit=torch.zeros_like(self.val))
        return [self.x, self.y, self.val, *aff]

    def tensors(self) -> list:
        """Every tensor the steps carry: the pyramid's levels (images, x
        gradients, y gradients), then ``state()``."""
        return [*self.pyr.img, *self.pyr.gradx, *self.pyr.grady,
                *self.state()]

    @classmethod
    def from_state(cls, pyr, state) -> "Lane":
        """The lane of pyramids ``pyr`` and ``state`` (``state()``'s
        order)."""
        x, y, val, *aff = state
        return cls(pyr, x, y, val, AffineState(*aff) if aff else None)


def identity_warps(n: int, device) -> torch.Tensor:
    """[n, 2, 2] float32 identity warps."""
    return torch.eye(2, dtype=torch.float32, device=device).expand(
        n, 2, 2).contiguous()


def empty_affine_state(n_features: int, height: int, width: int,
                       device) -> AffineState:
    """An AffineState with no template captured: [n, height, width]
    zero templates, identity warps."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return AffineState(
        img=zeros(n_features, height, width),
        gradx=zeros(n_features, height, width),
        grady=zeros(n_features, height, width), x=zeros(n_features),
        y=zeros(n_features), A=identity_warps(n_features, device),
        valid=zeros(n_features, dtype=torch.bool),
        nit=zeros(n_features, dtype=torch.int32))


def create_feature_list(n_features: int, with_affine: bool = False,
                        tmpl_size: int = 15, device="cuda") -> FeatureState:
    """All slots empty (val = KLT_NOT_FOUND), on ``device``.

    Reference parity: klt.py -> KLTCreateFeatureList."""
    aff = (empty_affine_state(n_features, tmpl_size, tmpl_size, device)
           if with_affine else None)
    return FeatureState(
        x=torch.full((n_features,), -1.0, dtype=torch.float32, device=device),
        y=torch.full((n_features,), -1.0, dtype=torch.float32, device=device),
        val=torch.full((n_features,), KLT_NOT_FOUND, dtype=torch.int32,
                       device=device),
        aff=aff)


def count_remaining_features(fl: FeatureState) -> torch.Tensor:
    """Number of live features (val >= 0), as a 0-dim tensor on the
    list's device.

    Reference parity: klt.py -> KLTCountRemainingFeatures."""
    return (fl.val >= 0).sum()


def reset_affine(aff: AffineState, drop_mask: torch.Tensor) -> AffineState:
    """Invalidate templates for features in ``drop_mask`` (= the reference
    freeing aff_img and resetting the warp to identity on track loss)."""
    eye = identity_warps(aff.A.shape[0], aff.A.device)
    nit = aff.nit
    if nit is not None:
        nit = torch.where(drop_mask, 0, nit)
    return aff._replace(
        valid=aff.valid & ~drop_mask,
        A=torch.where(drop_mask[:, None, None], eye, aff.A),
        nit=nit)


class FeatureTable(NamedTuple):
    """(nFrames x nFeatures) history of (x, y, val).

    Reference parity: storeFeatures.py -> KLT_FeatureTable."""
    x: torch.Tensor    # [F, N] float32
    y: torch.Tensor    # [F, N] float32
    val: torch.Tensor  # [F, N] int32

    @property
    def nFrames(self) -> int:
        return self.x.shape[0]

    @property
    def nFeatures(self) -> int:
        return self.x.shape[1]


def create_feature_table(n_frames: int, n_features: int,
                         device="cuda") -> FeatureTable:
    """Reference parity: storeFeatures.py -> KLTCreateFeatureTable."""
    def full(v, dtype):
        return torch.full((n_frames, n_features), v, dtype=dtype,
                          device=device)

    return FeatureTable(x=full(-1.0, torch.float32), y=full(-1.0, torch.float32),
                        val=full(KLT_NOT_FOUND, torch.int32))


def store_feature_list(fl: FeatureState, ft: FeatureTable,
                       frame: int) -> FeatureTable:
    """Write the list into row ``frame`` of a copy of ``ft`` (functional
    update, as in the JAX package).

    Reference parity: storeFeatures.py -> KLTStoreFeatureList."""
    out = []
    for table, row in zip(ft, (fl.x, fl.y, fl.val)):
        table = table.clone()
        table[frame] = row
        out.append(table)
    return FeatureTable(*out)


def extract_feature_list(ft: FeatureTable, frame: int,
                         template: Optional[FeatureState] = None
                         ) -> FeatureState:
    """Read row ``frame`` back into a feature list (with ``template``'s
    AffineState, if given).

    Reference parity: storeFeatures.py -> KLTExtractFeatureList."""
    aff = template.aff if template is not None else None
    return FeatureState(x=ft.x[frame], y=ft.y[frame], val=ft.val[frame],
                        aff=aff)


def feature_state_from_numpy(arr: np.ndarray,
                             aff: Optional[AffineState] = None, *,
                             device: str | torch.device = "cuda"
                             ) -> FeatureState:
    """(N,3) float array of (x, y, val) -> FeatureState on ``device`` (with
    ``aff``): the JAX package's signature, ``device`` keyword-only."""
    a = np.asarray(arr)
    return FeatureState(
        x=torch.as_tensor(np.ascontiguousarray(a[:, 0], np.float32),
                          device=device),
        y=torch.as_tensor(np.ascontiguousarray(a[:, 1], np.float32),
                          device=device),
        val=torch.as_tensor(a[:, 2].astype(np.int64).astype(np.int32),
                            device=device),
        aff=aff,
    )


def feature_state_to_numpy(fl: FeatureState) -> np.ndarray:
    """FeatureState -> (N,3) float64 array of (x, y, val), in one
    device-to-host copy (float64 holds every int32 val exactly)."""
    return torch.stack([fl.x.detach().to(torch.float64),
                        fl.y.detach().to(torch.float64),
                        fl.val.detach().to(torch.float64)],
                       dim=1).cpu().numpy()
