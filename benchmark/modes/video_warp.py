"""Recorded footage that rolls and zooms under a burned-in overlay, tracked
with KLT's affine-consistency check: ``modes/video.py``'s loop
(``StreamingTracker(chain=k)`` fed host uint8 frames as fast as it takes
them, drained every ``drain_every`` frames) on a clip warped from the
seed's pan clip, holding the tracker's affine state at a fixed set of
chain boundaries for the check (``checks/klt_affine_steps.py``).

The warp clip is made on the card at set-up, with plain torch bilinear
sampling: frame i of the pan clip rolled by ``i * roll_deg`` and zoomed by
``zoom0 * (1 + zoom)**i`` about the frame's centre, where ``zoom0`` is the
least zoom at which no sample of any frame falls outside its pan frame;
then the static textured box ``overlay`` (rows, columns) pasted over every
frame. The box's texture is a patch of the seed's pan clip turned half a
turn, so the seed draws only textures and never the path.

Held states: at every ``HOLD_STRIDE``-th chain boundary of the window
(counted from the window's first), the tracker's ``affine_state()`` after
that chain and after the next, up to ``MAX_PAIRS`` pairs. A hold keeps
references to the program's own tensors (no copy, no sync): the first of
a pair its templates, warps and valid flags, the second its warps and
valid flags.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from modes.video import Session as VideoSession

# chain boundaries between the starts of two held pairs: 512 frames, which
# the played clip's period (2 * clip_frames - 2) does not divide, so the
# pairs fall at many places of the clip; 16 pairs keep the check near 10 s
HOLD_STRIDE = 64
MAX_PAIRS = 16


def least_zoom(n: int, h: int, w: int, roll_deg: float, zoom: float) -> float:
    """The least start zoom at which frame i's samples (roll ``i * roll_deg``,
    zoom ``zoom0 * (1 + zoom)**i``) all lie inside [0, w - 1.001] x
    [0, h - 1.001] for every i < n."""
    hx, hy = (w - 1) / 2.0, (h - 1) / 2.0
    need = 1.0
    for i in range(n):
        th = math.radians(i * roll_deg)
        c, s = abs(math.cos(th)), abs(math.sin(th))
        ex, ey = hx * c + hy * s, hx * s + hy * c
        need = max(need, max(ex / (hx - 0.001), ey / (hy - 0.001))
                   / (1.0 + zoom) ** i)
    return need * (1.0 + 1e-6)


def warp_clip(pan: np.ndarray, traffic: dict, device) -> np.ndarray:
    """The traffic's warp clip from the host uint8 pan clip [n, h, w]: each
    frame rolled and zoomed about its centre (``least_zoom``) by bilinear
    sampling on ``device``, the overlay pasted; host uint8 out."""
    n, h, w = pan.shape
    roll, zoom = float(traffic["roll_deg"]), float(traffic["zoom"])
    z0 = least_zoom(n, h, w, roll, zoom)
    src = torch.as_tensor(pan, device=device).to(torch.float32)
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device) - (h - 1) / 2.0,
        torch.arange(w, dtype=torch.float64, device=device) - (w - 1) / 2.0,
        indexing="ij")
    (r0, r1), (c0, c1) = traffic["overlay"]
    box = torch.flip(src[-1, :r1 - r0, :c1 - c0], (0, 1))
    out = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for i in range(n):
        th = math.radians(i * roll)
        z = z0 * (1.0 + zoom) ** i
        # the output pixel p shows the pan frame's point c + R(-th) p / z
        qx = ((math.cos(th) * xx + math.sin(th) * yy) / z + (w - 1) / 2.0)
        qy = ((-math.sin(th) * xx + math.cos(th) * yy) / z + (h - 1) / 2.0)
        x0, y0 = torch.floor(qx), torch.floor(qy)
        ax, ay = (qx - x0).to(torch.float32), (qy - y0).to(torch.float32)
        k = y0.long() * w + x0.long()
        f = src[i].reshape(-1)
        v = ((1 - ax) * (1 - ay) * f[k] + ax * (1 - ay) * f[k + 1]
             + (1 - ax) * ay * f[k + w] + ax * ay * f[k + w + 1])
        v[r0:r1, c0:c1] = box
        out[i] = v.floor().clamp_(0.0, 255.0).to(torch.uint8)
    return out.cpu().numpy()


class Session(VideoSession):
    """The warp clip through ``StreamingTracker(chain=k)`` with the affine
    check on; ``held`` lists (row, AffineState fields) of each held chain
    boundary, row being the last row of that chain."""

    def __init__(self, pft, cfg, config: dict, frames, traffic: dict,
                 device):
        super().__init__(pft, cfg, config, frames, traffic, device)
        # the read-only view the holds take: a program without it fails
        # here, before any work
        self._affine_state = self.tracker.affine_state
        self.chain = int(traffic["chain"])
        self.frames = warp_clip(frames, traffic, device)
        self.held: list = []
        self._holding = False
        self._boundaries = 0

    def _feed(self, traced: bool) -> None:
        super()._feed(traced)
        r = self.fed - 1
        if not self._holding or r == 0 or r % self.chain:
            return
        # row r ends a chain: hold the first of a pair on the stride, the
        # second right after it
        k = self._boundaries
        self._boundaries += 1
        aff = self._affine_state()
        if k % HOLD_STRIDE == 0 and len(self.held) < 2 * MAX_PAIRS:
            self.held.append((r, {"img": aff.img, "A": aff.A,
                                  "valid": aff.valid}))
        elif k % HOLD_STRIDE == 1 and len(self.held) % 2:
            self.held.append((r, {"A": aff.A, "valid": aff.valid}))

    def window(self, seconds: float) -> dict:
        self._holding = True
        try:
            return super().window(seconds)
        finally:
            self._holding = False
