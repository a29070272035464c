"""Seeded video clips, rendered on the device with plain torch.

The generator behind every traffic file. A clip is one camera panning over
a smooth random texture (``smooth_texture``: white noise under a binomial
filter, as the repository's chip smoke script makes it), rendered at
sub-pixel offsets by bilinear sampling and stored as uint8 grey frames,
the output of a decoder.

The pan's path is the same for every seed: its heading starts at
``HEADING_DEG`` (spread evenly over the streams of a rig) and turns
``TURNS`` times over the clip with a slow wiggle, and its speed in px a
frame swings ``SPEED_CYCLES`` times between the two ends of the traffic's
``motion_px``. Features leave a frame at a rate set by the pan's
direction, and each costs a refill, so a seeded heading would make the
seed change the work; the seed draws the texture alone. Playback runs the
clip forwards and backwards (``pingpong``), so the motion stays continuous
however long a run is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BINOMIAL = (1.0, 4.0, 6.0, 4.0, 1.0)
HEADING_DEG = 30.0
TURNS = 0.25
SPEED_CYCLES = 0.5


def _torch_seed(seed: int, *key: int) -> int:
    return int(np.random.SeedSequence([int(seed), *key])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def smooth_texture(gen: torch.Generator, shape, device) -> torch.Tensor:
    """float32 texture(s) of ``shape`` ([..., h, w]) on 0..255: uniform
    noise smoothed twice along each image axis by the 5-tap binomial
    filter (circular), then stretched to the full range per image."""
    tex = torch.rand(shape, generator=gen, device=device,
                     dtype=torch.float32) * 255.0
    for dim in (-2, -1):
        for _ in range(2):
            acc = torch.zeros_like(tex)
            for s, k in enumerate(_BINOMIAL):
                acc += (k / 16.0) * torch.roll(tex, s - 2, dims=dim)
            tex = acc
    lo = tex.amin(dim=(-2, -1), keepdim=True)
    hi = tex.amax(dim=(-2, -1), keepdim=True)
    return (tex - lo) / (hi - lo) * 255.0


def pan_path(n: int, motion_px, heading: float) -> np.ndarray:
    """[n, 2] (x, y) camera offsets in px: frame i moves by a speed within
    ``motion_px`` along a heading that starts at ``heading`` (radians) and
    turns ``TURNS`` times over the clip, with a slow wiggle."""
    lo, hi = (float(v) for v in motion_px)
    t = np.arange(n, dtype=np.float64) / max(n, 1)
    head = heading + 2.0 * math.pi * TURNS * t + 0.5 * np.sin(
        2.0 * math.pi * 3.0 * t)
    speed = lo + (hi - lo) * 0.5 * (1.0 - np.cos(
        2.0 * math.pi * SPEED_CYCLES * t))
    step = np.stack([speed * np.cos(head), speed * np.sin(head)], 1)
    step[0] = 0.0
    return np.cumsum(step, axis=0)


def render_clip(seed: int, stream: int, n: int, h: int, w: int, traffic,
                device, streams: int = 1) -> torch.Tensor:
    """uint8 [n, h, w] frames of stream ``stream`` of ``streams`` on
    ``device``. The streams' headings are spread evenly around
    ``HEADING_DEG``."""
    heading = math.radians(HEADING_DEG + 360.0 * stream / streams)
    path = pan_path(n, traffic["motion_px"], heading)
    path -= path.min(axis=0)
    th = int(math.ceil(path[:, 1].max())) + h + 2
    tw = int(math.ceil(path[:, 0].max())) + w + 2
    gen = torch.Generator(device=device)
    gen.manual_seed(_torch_seed(seed, stream, 1))
    tex = smooth_texture(gen, (th, tw), device)
    out = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for i in range(n):
        x, y = path[i]
        ix, iy = int(x), int(y)
        fx, fy = x - ix, y - iy
        win = tex[iy:iy + h + 1, ix:ix + w + 1]
        frame = ((1 - fx) * (1 - fy) * win[:h, :w] + fx * (1 - fy) * win[:h, 1:]
                 + (1 - fx) * fy * win[1:, :w] + fx * fy * win[1:, 1:])
        out[i] = frame.floor().clamp_(0.0, 255.0).to(torch.uint8)
    return out


def render_streams(seed: int, streams: int, traffic, h: int, w: int,
                   device) -> np.ndarray:
    """Host uint8 frames: [clip_frames, h, w] for one stream, else
    [clip_frames, streams, h, w] (one tick's batch is then one contiguous
    [streams, h, w] slice). Rendered on ``device`` and copied once."""
    n = int(traffic["clip_frames"])
    if streams == 1:
        return render_clip(seed, 0, n, h, w, traffic, device).cpu().numpy()
    out = np.empty((n, streams, h, w), dtype=np.uint8)
    for s in range(streams):
        out[:, s] = render_clip(seed, s, n, h, w, traffic, device,
                                streams).cpu().numpy()
    return out


def pingpong(i: int, n: int) -> int:
    """Clip index of the i-th frame played forwards then backwards."""
    if n == 1:
        return 0
    period = 2 * n - 2
    k = i % period
    return k if k < n else period - k
