"""95th percentile of the latency of every call in the window, as the
caller waits for it (host clock, linear interpolation between ranks)."""

import numpy as np


def read(run: dict):
    lat = run.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95.0)) * 1e3
