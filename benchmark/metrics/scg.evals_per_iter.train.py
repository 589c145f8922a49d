"""scg.evals_per_iter.train: objective evaluations over SCG iterations in
the window (the initial evaluation of each segment included): 1 to 3."""


def read(run):
    iters = sum(s[2] for s in run.segments)
    return sum(s[3] for s in run.segments) / iters if iters else None
