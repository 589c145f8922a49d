"""k3_roofline: K3 `full+diag`'s bound (harness.peaks.k3_bound_s, a copy of
chip_smoke.k3_bound with the diagonal output) over the device time of its
kernels, per evaluation, in the traced segment: the union of the intervals
of K3's kernels over its two streams (each stream's kernels clipped to the
end of the one before), so overlap between the streams is not counted
twice.  None where the trace holds no K3 kernel."""

import re

from harness import peaks

K3 = re.compile(r"\bpanel_(corr|gram|leaf|solve|finish)_kernel\b")


def read(run):
    t = run.trace
    if t is None or not run.segments:
        return None
    mine = t.ops_matching(lambda name: bool(K3.search(name)))
    dev_s = sum(b - a for a, b in mine) / 1e6
    evals = run.segments[0][3]
    if dev_s <= 0 or not evals:
        return None
    cfg = run.config
    n = -(-cfg["N"] // 128) * 128
    return 100.0 * peaks.k3_bound_s(n, cfg["q"], cfg["D"]) * evals / dev_s
