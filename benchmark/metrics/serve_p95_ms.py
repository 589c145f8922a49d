"""serve_p95_ms: the 95th percentile of request latency, due time to
GPServer.predict's return, over every request served in the window (host
clock)."""

import numpy as np


def read(run):
    lat = [(end - due) * 1e3 for due, _, end, _ in run.requests]
    return float(np.percentile(lat, 95)) if lat else None
