"""eval_ms.train: the mean wall of one value_and_grad evaluation, ms.  It
ends in the host's float64 read of the objective and gradient, so it is
synchronised."""


def read(run):
    return sum(b - a for a, b in run.evals) / len(run.evals) * 1e3 if run.evals else None
