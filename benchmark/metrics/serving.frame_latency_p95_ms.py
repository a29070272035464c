"""95th percentile over every tick of the window of the milliseconds from
the tick's due time on the camera clock to the return of the host pull
(the drain) of its positions: the tail of ``serving.frame_latency_p50_ms``. The
window runs untraced before the traced slice, so a traced run reads it
too."""

import numpy as np


def read(ctx):
    lat = ctx.window.get("latency_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95))
