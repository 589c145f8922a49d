"""serve.wait_ms.serve: the mean time from a request's due time to the start
of its predict call (queueing behind earlier requests), ms."""


def read(run):
    w = [(start - due) * 1e3 for due, start, _, _ in run.requests]
    return sum(w) / len(w) if w else None
