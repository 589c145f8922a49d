"""scg.host_ms.train: per SCG iteration, the time in the segments outside
the objective's evaluations: the optimiser's float64 host arithmetic and
the harness's record of each evaluation, in ms."""


def read(run):
    iters = sum(s[2] for s in run.segments)
    if not iters:
        return None
    seg = sum(s[1] - s[0] for s in run.segments)
    ev = sum(b - a for a, b in run.evals)
    return (seg - ev) / iters * 1e3
