"""serve.call_ms.serve: the mean wall of one GPServer.predict call, ms."""


def read(run):
    c = [(end - start) * 1e3 for _, start, end, _ in run.requests]
    return sum(c) / len(c) if c else None
