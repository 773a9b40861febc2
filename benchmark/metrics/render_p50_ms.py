"""The median latency of the untraced window's renders, host clock from the
call to the RGB image in host memory, the same views as the p95."""

import numpy as np


def read(run):
    lat = run.window.latencies_ms
    return float(np.percentile(lat, 50)) if lat else None
