"""serve_p50_ms: the median of the same latencies as serve_p95_ms."""

import numpy as np


def read(run):
    lat = [(end - due) * 1e3 for due, _, end, _ in run.requests]
    return float(np.median(lat)) if lat else None
